"""Import hygiene of the PyTorch port and its on-card entry points.

- Importing every module of ``distributed_tensorflow_tpu_torch`` (in a
  fresh interpreter) loads no jax, no flax, nothing of the JAX package
  and no triton, and builds no kernel.
- No module of the port, not ``chip_smoke.py`` and no ``tools/*_torch.py``
  script (the port's converters, benchmarks and convergence demos) imports
  any of them (AST scan — catches imports inside functions too). Note the name trap:
  ``"distributed_tensorflow_tpu_torch".startswith(
  "distributed_tensorflow_tpu")``, so the JAX package is matched as the
  exact name or the name followed by a dot.
- Entry points and helpers run on the card by default and raise without
  CUDA: ``ServeEngine``, ``init_params``, ``init_paged_cache``,
  ``from_jax_params``, ``run_workload`` and ``python -m
  distributed_tensorflow_tpu_torch.train`` with no device, and ``python
  chip_smoke.py``, which exits non-zero and prints no ``"ok": true`` line.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "distributed_tensorflow_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "distributed_tensorflow_tpu", "triton")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""  # as on a machine with no card
    return env


def test_forbidden_matches_exact_package_names():
    assert _forbidden("distributed_tensorflow_tpu")
    assert _forbidden("distributed_tensorflow_tpu.serve.engine")
    assert _forbidden("jax.numpy")
    assert not _forbidden("distributed_tensorflow_tpu_torch")
    assert not _forbidden("distributed_tensorflow_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def test_port_imports_without_jax_or_kernel_builds():
    code = f"""
import pkgutil, sys, importlib
before = set(sys.modules)
import distributed_tensorflow_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
new = sorted(set(sys.modules) - before)
bad = [m for m in sys.modules if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r})]
print("BAD", bad)
print("N", sum(m.startswith("distributed_tensorflow_tpu_torch") for m in new))
from distributed_tensorflow_tpu_torch.ops import _build
print("LIBS", len(_build._libs))
"""
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("N ")[1].split()[0])
    assert n >= 15  # every module was walked
    assert "LIBS 0" in out.stdout  # no kernel library was built or loaded


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: resolve against the file's package
                rel = path.relative_to(REPO).with_suffix("").parts
                base = rel[: len(rel) - node.level]
                if not base or base[0] != PKG.name:
                    yield "<relative import escaping the package>"
                    continue
                yield ".".join(base + ((node.module,) if node.module else ()))
            else:
                yield node.module


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    tools = sorted((REPO / "tools").glob("*_torch.py"))
    assert {"convergence_demo_torch.py", "convergence_demo_ctr_torch.py",
            "convergence_demo_mlm_torch.py"} <= {t.name for t in tools}
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] + tools
    assert len(files) >= 15
    bad = [(str(f.relative_to(REPO)), name) for f in files for name in _imports(f)
           if name and (_forbidden(name) or name.startswith("<"))]
    assert bad == []


def test_entry_points_raise_without_cuda(monkeypatch):
    import torch

    from distributed_tensorflow_tpu_torch.models import transformer as tfm
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    cfg = tfm.TransformerConfig(vocab_size=64, max_len=16, num_layers=1, d_model=16,
                                num_heads=2, d_ff=32, dtype="float32", causal=True,
                                pre_ln=True)
    params = tfm.init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine.with_random_params(cfg)
    eng = ServeEngine(cfg, params, device="cpu")  # explicit CPU is allowed
    assert list(eng.stream([1, 2, 3], max_new_tokens=2)) and eng.device.type == "cpu"


def test_helpers_and_training_entry_points_raise_without_cuda(monkeypatch):
    import torch

    from distributed_tensorflow_tpu_torch.models import resnet
    from distributed_tensorflow_tpu_torch.models import transformer as tfm
    from distributed_tensorflow_tpu_torch.serve.kv_cache import init_paged_cache
    from distributed_tensorflow_tpu_torch.train.__main__ import main as train_main
    from distributed_tensorflow_tpu_torch.models import cnn, mlp
    from distributed_tensorflow_tpu_torch.weights import from_jax_params, resnet_from_jax
    from distributed_tensorflow_tpu_torch.workloads import eval_workload, run_workload

    cfg = tfm.TransformerConfig(vocab_size=64, max_len=16, num_layers=1, d_model=16,
                                num_heads=2, d_ff=32, dtype="float32", causal=True,
                                pre_ln=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tfm.init_params(cfg),
                 lambda: init_paged_cache(cfg, 4, 8),
                 lambda: from_jax_params({}, cfg),
                 lambda: run_workload("gpt_lm", ["--train.num_steps=1"]),
                 lambda: train_main(["gpt_lm", "--train.num_steps=1"]),
                 lambda: resnet.init_params(resnet.ResNetConfig()),
                 lambda: resnet_from_jax({}, {}, resnet.ResNetConfig()),
                 lambda: run_workload("resnet50_imagenet", ["--train.num_steps=1"]),
                 lambda: train_main(["resnet50_imagenet", "--train.num_steps=1"]),
                 lambda: mlp.init_params(mlp.MLPConfig(), 784),
                 lambda: cnn.init_params(cnn.CNNConfig()),
                 lambda: run_workload("mnist_mlp", ["--train.num_steps=1"]),
                 lambda: eval_workload("mnist_mlp", ["--checkpoint.directory=unused"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # explicit CPU is allowed
    assert tfm.init_params(cfg, device="cpu")["pos_embed"].device.type == "cpu"
    assert init_paged_cache(cfg, 4, 8, device="cpu").k_buf.device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script_alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:  # a directory that holds chip_smoke.py and nothing else
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = _env()
    cmd = [sys.executable, str(script)]
    if alone:
        # past the CUDA check, so what fails is the missing port
        env.pop("PYTHONPATH")
        cmd = [sys.executable, "-c",
               "import runpy, torch; torch.cuda.is_available = lambda: True; "
               f"runpy.run_path({str(script)!r}, run_name='__main__')"]
    out = subprocess.run(cmd, env=env, cwd=cwd, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    if alone:
        assert "not importable" in out.stderr, out.stderr
