"""The port's bench entry point (``python -m distributed_tensorflow_tpu_torch.
bench``) and its shared pieces (``utils/benchmarking.py``,
``obs/scaling.py``) on the CPU: ``--device cpu`` prints exactly one JSON
line with the JAX ``bench.py``'s fields and a provenance block that says
CPU; a non-finite loss refuses a rate; ``BENCH_DATA=jpeg`` raises naming
its ROADMAP item; without ``--device cpu`` it runs on the card or raises.
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


def test_jpeg_data_raises_naming_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 3.2"):
        bench.run("cpu", env={"BENCH_DATA": "jpeg"})
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
