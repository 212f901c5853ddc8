"""The port's bench entry point (``python -m distributed_tensorflow_tpu_torch.
bench``) and its shared pieces (``utils/benchmarking.py``,
``obs/scaling.py``) on the CPU: ``--device cpu`` prints exactly one JSON
line with the JAX ``bench.py``'s fields and a provenance block that says
CPU; a non-finite loss refuses a rate; ``BENCH_DATA=jpeg`` decodes every
fed batch from a JPEG record pair (the native decoder here) and reports
the host's decode rate; without ``--device cpu`` it runs on the card or
raises.
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import bench
from distributed_tensorflow_tpu_torch.obs import scaling
from distributed_tensorflow_tpu_torch.utils import benchmarking as bm

REPO = pathlib.Path(__file__).resolve().parents[1]

#: the JAX bench.py's fields (bench.py:318-350), the fed window's losses
#: and the provenance block beside them
FIELDS = {"metric", "value", "unit", "vs_baseline", "mfu", "platform", "n_chips",
          "global_batch", "image_size", "full_resnet50", "stem", "norm_dtype", "block_impl",
          "pipeline_fed_images_per_sec_per_chip", "pipeline_efficiency", "fed_data",
          "fed_losses", "provenance"}


def test_cpu_run_prints_exactly_one_json_line():
    env = dict(os.environ, PYTHONPATH=str(REPO), BENCH_STEPS="2", CUDA_VISIBLE_DEVICES="")
    for var in ("RANK", "WORLD_SIZE", "BENCH_BLOCK_IMPL", "BENCH_DATA", "BENCH_FORCE_AB"):
        env.pop(var, None)
    out = subprocess.run([sys.executable, "-m", "distributed_tensorflow_tpu_torch.bench",
                          "--device", "cpu"], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    row = json.loads(lines[0])
    assert set(row) == FIELDS
    assert row["metric"] == "resnet50_images_per_sec_per_chip" and row["value"] > 0
    assert row["platform"] == "cpu" and row["n_chips"] == 1 and row["global_batch"] == 8
    assert row["image_size"] == 64 and row["full_resnet50"] is False
    assert row["block_impl"] == "standard" and row["fed_data"] == "synthetic"
    assert len(row["fed_losses"]) == 2 and all(math.isfinite(x) for x in row["fed_losses"])
    assert row["pipeline_efficiency"] > 0 and row["pipeline_fed_images_per_sec_per_chip"] > 0
    prov = row["provenance"]
    assert prov["platform"] == "cpu" and prov["device_kind"] == "cpu"
    assert prov["power_limit"] is None and prov["device_count"] == 1
    assert prov["mesh"]["data"] == 1 and prov["backend"] == "none"


def test_a_non_finite_loss_refuses_a_rate():
    def step(state, batch):
        return state + 1, {"loss": torch.tensor(float("nan") if state >= 2 else 1.0)}

    state, rate, losses = bm.timed_steps(step, 0, lambda: None, warmup=1, measured=1)
    assert state == 2 and rate > 0 and losses == [1.0]
    with pytest.raises(RuntimeError, match="non-finite loss"):
        bm.timed_steps(step, 0, lambda: None, warmup=1, measured=2)
    assert bm.timed_steps(step, 0, lambda: None, warmup=0, measured=2)[2] == [1.0, 1.0]


def test_jpeg_fed_window_decodes_inside_the_window():
    p = bench.run("cpu", env={"BENCH_DATA": "jpeg", "BENCH_STEPS": "2"})
    assert p["fed_data"] == "jpeg/native" and p["host_cores"] == os.cpu_count()
    assert p["host_decode_images_per_sec"] > 0 and p["pipeline_efficiency"] > 0
    assert len(p["fed_losses"]) == 2 and np.isfinite(p["fed_losses"]).all()
    assert p["image_size"] == 64 and p["global_batch"] == 8
    with pytest.raises(ValueError, match="synthetic"):
        bench.run("cpu", env={"BENCH_DATA": "tfrecord"})


def test_bench_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])


def test_describe_devices_sync_by_value_and_provenance_on_the_cpu():
    assert bm.describe_devices("cpu") == ("cpu", 1, "cpu")
    assert bm.sync_by_value({"loss": torch.tensor(2.5)}) == 2.5
    row = scaling.stamp_provenance({"value": 1.0}, device="cpu")
    prov = row["provenance"]
    assert prov["platform"] == "cpu" and prov["power_limit"] is None
    assert prov["pid"] == os.getpid() and "mesh" not in prov
    assert isinstance(prov["git_sha"], str) and np.isfinite(row["value"])


@pytest.mark.parametrize("model,knobs", [
    ("bert", {}),
    ("gpt", {"BENCH_REMAT": "1", "BENCH_FUSED_QKV": "1", "BENCH_ATTN": "blockwise"}),
], ids=["bert", "gpt_remat_fused_qkv_blockwise"])
def test_bench_bert_torch_prints_one_json_line_on_the_cpu(model, knobs, monkeypatch, capsys):
    """``tools/bench_bert_torch.py --device cpu``: the tiny model, one
    JSON line on stdout with the knobs it ran, a CPU provenance block, no
    MFU (no device peak) and no flash launches (the CPU launches none)."""
    sys.path.insert(0, str(REPO / "tools"))
    import bench_bert_torch

    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    env = {"BENCH_MODEL": model, "BENCH_SEQ": "128", "BENCH_STEPS": "2", "BENCH_BATCH": "2",
           **knobs}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    bench_bert_torch.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["metric"] == f"{model}_tokens_per_sec_per_chip" and row["value"] > 0
    assert row["global_batch"] == 2 and row["seq_len"] == 128 and row["measured_steps"] == 2
    assert row["remat"] == (model == "gpt") and row["fused_qkv"] == (model == "gpt")
    assert row["attention_impl"] == ("blockwise" if model == "gpt" else "auto")
    # the workload's K at S=128
    assert row["mlm_predictions"] == (19 if model == "bert" else None)
    assert row["mfu"] is None and row["provenance"]["platform"] == "cpu"
    assert row["flash_launches_per_step"] == {"flash_fwd": 0.0, "flash_bwd_dkv": 0.0,
                                              "flash_bwd_dq": 0.0}
    assert math.isfinite(row["final_loss"]) and not row["full_size_model"]
