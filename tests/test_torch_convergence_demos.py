"""The port's three convergence demos (``tools/convergence_demo_torch.py``,
``tools/convergence_demo_ctr_torch.py``, ``tools/convergence_demo_mlm_torch.py``)
run on the CPU at reduced steps, in this process: each builds its real
data, trains through ``run_workload`` with a checkpoint, evaluates the
checkpoint through ``eval_workload`` on held-out data and prints its JSON
line. Their full-length runs, and the gates of the reference (0.9 top-1,
0.75 AUC, 0.35 masked-byte accuracy), are ``chip_smoke.py`` phase 12b's,
on the card.

Reduced gates, stated from CPU runs of these settings: the digits demo at
45 steps of batch 32 read 0.719 held-out top-1 (chance 0.1; the gate is
0.5); the CTR demo at 100 steps 0.721 AUC (chance 0.5; the gate is 0.6);
the MLM and LM demos run 2 steps each with no gate (at the demo's widths
a CPU step takes ~0.5 s), checking the path and the JSON line.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_line(capsys) -> dict:
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert lines, "no JSON line printed"
    return json.loads(lines[-1])


def test_digits_demo_learns_real_scans_from_jpeg_records(tmp_path, capsys):
    pytest.importorskip("sklearn")
    demo = _load("convergence_demo_torch")
    demo.main(["--device", "cpu", "--steps", "45", "--batch", "32", "--min-top1", "0.5",
               "--workdir", str(tmp_path)])
    out = _json_line(capsys)
    assert out["steps"] == 45 and out["device"] == "cpu"
    assert out["eval_top1"] >= 0.5 and 0.0 <= out["train_acc"] <= 1.0
    assert (tmp_path / "digits_train.dat").exists() and (tmp_path / "ck").is_dir()


def test_digits_demo_without_sklearn_exits_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    demo = _load("convergence_demo_torch")
    with pytest.raises(SystemExit, match="scikit-learn") as e:
        demo.main(["--device", "cpu", "--workdir", str(tmp_path)])
    assert e.value.code != 0
    assert not (tmp_path / "digits_train.dat").exists()  # no substitute data


def test_ctr_demo_learns_the_teacher_from_converted_records(capsys):
    demo = _load("convergence_demo_ctr_torch")
    demo.main(["--device", "cpu", "--steps", "100", "--min-auc", "0.6"])
    out = _json_line(capsys)
    assert out["steps"] == 100 and out["eval_auc"] >= 0.6
    assert out["train_loss"] > 0


@pytest.mark.parametrize("objective", ["mlm", "lm"])
def test_mlm_and_lm_demos_run_the_prose_path(objective, capsys):
    demo = _load("convergence_demo_mlm_torch")
    demo.main(["--device", "cpu", "--steps", "2", "--min-acc", "0", "--objective", objective])
    out = _json_line(capsys)
    key = "eval_masked_acc" if objective == "mlm" else "eval_next_byte_acc"
    assert out["objective"] == objective and out["steps"] == 2 and out["head_dim"] == 32
    assert 0.0 <= out[key] <= 1.0
    # on the CPU attention is dense: no kernel launches, at any head dim
    assert out["flash_launches_per_step"] == {"flash_fwd": 0.0, "flash_bwd_dkv": 0.0,
                                              "flash_bwd_dq": 0.0}
    assert out["flash_launches_by_head_dim"] == {}
    assert out["dataset"].endswith("11 train / 4 held-out files")


def test_mlm_demo_corpus_is_pinned_to_files_the_port_never_edits():
    """The corpus and its split are a fixed list: a note the port edits
    (README, ROADMAP, PERF, CHANGES, ISSUE, REVIEW), or one added or
    removed at the root, moves neither."""
    demo = _load("convergence_demo_mlm_torch")
    train, held = demo.corpus_split()
    names = lambda paths: sorted(os.path.relpath(p, demo.REPO) for p in paths)
    assert names(held) == ["ADVICE.md", "PAPERS.md", "VERDICT.md", "docs/resilience.md"]
    assert names(train + held) == sorted(demo.CORPUS) and not set(train) & set(held)
    notes = {"README.md", "ROADMAP.md", "PERF.md", "CHANGES.md", "ISSUE.md", "REVIEW.md"}
    assert not notes & set(demo.CORPUS)


def test_mlm_demo_long_is_refused_naming_the_roadmap_items():
    """``--long`` runs ring attention over a seq=4 mesh (ROADMAP item 6a,
    ported): one process is told to launch it under torchrun with four,
    and an MLM objective is refused as the reference refuses it."""
    demo = _load("convergence_demo_mlm_torch")
    with pytest.raises(SystemExit, match=r"torchrun --nproc_per_node=4") as e:
        demo.main(["--device", "cpu", "--long"])
    assert e.value.code != 0
    with pytest.raises(SystemExit) as e:
        demo.main(["--device", "cpu", "--long", "--objective", "mlm"])
    assert e.value.code != 0


@pytest.mark.slow
def test_mlm_demo_long_ring_machinery_on_four_gloo_ranks(tmp_path):
    """JAX's slow ``test_convergence_demo_long_ring_machinery``: 12 steps of
    ``--long`` (the causal LM at seq 256 through ring attention on seq=4,
    with remat) under four gloo ranks, one thread each as torchrun sets
    them; the chief prints the line, finite loss, the seq=4 mesh."""
    import subprocess

    sys.path.insert(0, os.path.dirname(__file__))
    import torch_dp_worker as worker

    port, procs = worker.free_port(), []
    for r in range(4):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="4", LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "convergence_demo_mlm_torch.py"),
             "--device", "cpu", "--long", "--steps", "12", "--min-acc", "0"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=900)[0])
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 4, outs
    lines = [json.loads(ln) for ln in outs[0].splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and not any(ln.startswith("{") for o in outs[1:]
                                       for ln in o.splitlines())
    out = lines[0]
    assert out["long"] and out["mesh"]["seq"] == 4 and out["steps"] == 12
    assert np.isfinite(out["train_loss"]) and 0.0 <= out["eval_next_byte_acc"] <= 1.0
