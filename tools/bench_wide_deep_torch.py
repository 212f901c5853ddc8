#!/usr/bin/env python
"""Wide&Deep CTR training throughput of the PyTorch port — the
counterpart of tools/bench_wide_deep.py, at its accelerator shape: 26
categorical features x vocab 100000 x embed_dim 64, 13 dense features,
hidden (1024, 512, 256), 16384 rows a card, bf16 compute with f32
tables, ``optimizer.name="auto"`` (FTRL on the wide part, AdaGrad on the
deep part) at lr 0.05, on a resident batch of uniform random ids.

Recommender steps are bound by gathers and scatter-adds, not by the
tensor cores: beside examples/s per card the line reports the analytic
embedding bytes per example (the JAX bench's ``3·F·(D+1)·4``: the
forward gather plus the backward scatter-add's read-modify-write of the
same f32 rows), the traffic that implies in GB/s, and its share of the
card's own HBM rate (H100 SXM: 3.35 TB/s, NVIDIA data sheet). With
``BENCH_MESH_MODEL`` above 1 the tables are range-sharded over the
``model`` axis and every lookup runs the explicit exchange
(``ops/embedding.py``); the data axis takes the other processes.

Usage::

    python tools/bench_wide_deep_torch.py                        # one card
    BENCH_MESH_MODEL=2 torchrun --nproc_per_node=4 tools/bench_wide_deep_torch.py
    python tools/bench_wide_deep_torch.py --device cpu           # tiny, CPU

Process 0 prints ONE JSON line to stdout (with the card's name and power
limit); diagnostics go to stderr. Knobs (environment): ``BENCH_BATCH``
(rows a card, 16384; 256 on the CPU), ``BENCH_STEPS`` (measured steps,
20), ``BENCH_WD_VOCAB`` (100000; 1024 on the CPU), ``BENCH_WD_FEATURES``
(26), ``BENCH_WD_EMBED`` (64; 8 on the CPU), ``BENCH_MESH_MODEL`` (1).
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: H100 SXM HBM3 rate, NVIDIA data sheet (the card the port runs on)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def log(*a) -> None:
    from distributed_tensorflow_tpu_torch.parallel.cluster import is_chief

    if is_chief():
        print(*a, file=sys.stderr, flush=True)


def run(device="cuda", env=os.environ) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from distributed_tensorflow_tpu_torch.models import wide_deep as wd
    from distributed_tensorflow_tpu_torch.obs import goodput, scaling
    from distributed_tensorflow_tpu_torch.parallel import sharding
    from distributed_tensorflow_tpu_torch.parallel.mesh import MeshSpec, describe
    from distributed_tensorflow_tpu_torch.train import OptimizerConfig, init_train_state
    from distributed_tensorflow_tpu_torch.train import make_train_step
    from distributed_tensorflow_tpu_torch.utils import benchmarking as bm
    from distributed_tensorflow_tpu_torch.utils import flops as flops_lib
    from distributed_tensorflow_tpu_torch.workloads import runner
    from distributed_tensorflow_tpu_torch.workloads import wide_deep as wl

    on_card = not str(device).startswith("cpu")
    model_axis = int(env.get("BENCH_MESH_MODEL", "1"))
    n_feat = int(env.get("BENCH_WD_FEATURES", "26"))
    vocab = int(env.get("BENCH_WD_VOCAB", "100000" if on_card else "1024"))
    embed = int(env.get("BENCH_WD_EMBED", "64" if on_card else "8"))
    per_chip_batch = int(env.get("BENCH_BATCH", "16384" if on_card else "256"))
    measured = int(env.get("BENCH_STEPS", "20"))
    base = wl.default_config()
    mcfg = wd.WideDeepConfig(vocab_sizes=(vocab,) * n_feat, embed_dim=embed, dense_features=13,
                             hidden_sizes=(1024, 512, 256) if on_card else (64, 32))
    # the runner's own set-up (weights, placement, the auto optimizer);
    # its streams go unused: the bench feeds one resident batch
    cfg = dataclasses.replace(base, model=mcfg, mesh=MeshSpec(data=-1, model=model_axis),
                              optimizer=OptimizerConfig(name="auto", learning_rate=0.05))
    dev, mesh, parts, optimizer = runner.setup(cfg, wl.build, device)
    kind, n_chips, platform = bm.describe_devices(dev)
    global_batch = per_chip_batch * n_chips
    log(f"bench: {kind} x {n_chips} ({platform}), mesh {describe(mesh)}, tables "
        f"{n_feat}x{vocab}x{embed}, global batch {global_batch}")
    state = init_train_state(parts.model, optimizer)
    step = make_train_step(parts.loss_fn, mesh=mesh)
    # the global batch, as the JAX bench draws it; each rank takes its data
    # shard's rows (the model ranks of one shard the same)
    rng = np.random.RandomState(0)
    host = {"cat": rng.randint(0, vocab, (global_batch, n_feat)).astype(np.int32),
            "dense": rng.randn(global_batch, 13).astype(np.float32),
            "label": (rng.rand(global_batch) > 0.5).astype(np.float32)}
    batch = sharding.put_host_batch(sharding.shard_host_batch(host, mesh), dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    state, steps_per_sec, losses = bm.timed_steps(step, state, lambda: batch, warmup=3,
                                                  measured=measured, log=log)
    examples_per_sec_per_chip = steps_per_sec * global_batch / n_chips
    bytes_per_example = 3 * n_feat * (embed + 1) * 4
    embed_gbps = examples_per_sec_per_chip * bytes_per_example / 1e9
    hbm = HBM_BYTES_PER_S.get(kind) if on_card else None
    mfu = goodput.train_mfu(wd.flops_per_example(mcfg) * global_batch, steps_per_sec,
                            n_chips=n_chips, peak_per_chip=flops_lib.peak_flops_per_chip(kind))
    log(f"steps/s {steps_per_sec:.4f} examples/s/card {examples_per_sec_per_chip:.0f} "
        f"embed traffic {embed_gbps:.2f} GB/s MFU {mfu:.5f}")
    return scaling.stamp_provenance({
        "metric": "wide_deep_examples_per_sec_per_chip",
        "value": round(examples_per_sec_per_chip, 1),
        "unit": "examples/sec/chip",
        "step_ms": round(1e3 / steps_per_sec, 3),
        "embed_bytes_per_example": bytes_per_example,
        "embed_traffic_gbps": round(embed_gbps, 2),
        "embed_traffic_share_of_hbm": round(embed_gbps * 1e9 / hbm, 4) if hbm else None,
        "hbm_basis": f"{hbm / 1e12} TB/s, the card's data-sheet HBM rate" if hbm else None,
        "mfu": round(mfu, 5),
        "platform": platform,
        "n_chips": n_chips,
        "global_batch": global_batch,
        "tables": n_feat,
        "vocab_size": vocab,
        "embed_dim": embed,
        "mesh_model_axis": model_axis,
        "peak_memory_gib": (round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)
                            if on_card else None),
        "final_loss": losses[-1],
        "full_size_model": on_card,
    }, mesh)


def main(argv=None) -> None:
    from distributed_tensorflow_tpu_torch.parallel import cluster

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda by default, raises without CUDA")
    args = ap.parse_args(argv)
    try:
        payload = run(args.device)
        if cluster.is_chief():
            print(json.dumps(payload), flush=True)
    finally:
        cluster.shutdown()


if __name__ == "__main__":
    main()
