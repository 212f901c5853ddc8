"""Benchmark: ResNet-50 training throughput of the port — the counterpart of
the JAX package's ``bench.py`` (which stays at the repo root).

Usage::

    python -m distributed_tensorflow_tpu_torch.bench                  # one card
    torchrun --nproc_per_node=N -m distributed_tensorflow_tpu_torch.bench  # N cards
    python -m distributed_tensorflow_tpu_torch.bench --device cpu     # tiny, CPU

Process 0 prints exactly ONE JSON line to stdout: ``value`` in
images/s per card (the ``BASELINE.json:2`` metric) of the resident-batch
window, ``mfu`` and ``vs_baseline`` (MFU over the 0.50 north star), the
pipeline-fed window's rate and its share of the resident one
(``pipeline_efficiency``), the configuration (``n_chips``,
``global_batch``, ``image_size``, ``stem``, ``norm_dtype``,
``block_impl``, ``fed_data``) and the provenance block (card name and
power limit included). Diagnostics go to stderr.

Two windows, as the JAX bench: every process steps on its rows
(``BENCH_BATCH`` a card) of a synthetic global batch, data-parallel over
the mesh (gradients and BatchNorm statistics all-reduced); the resident
window repeats one batch already on the card, the pipeline-fed window
feeds four pre-staged bf16 host batches through the ``Prefetcher`` with
``DevicePut`` (pinned ring, side-stream copy). The optimizer is the
``resnet50_imagenet`` workload's (momentum 0.9, coupled L2 1e-4) at lr
0.1.

Runs on the card unless ``--device cpu`` is given, and then at the JAX
bench's CPU size (ResNet with one block a stage, width 16, 100 classes,
f32, 64x64, 8 images a process). Knobs (environment): ``BENCH_BATCH``,
``BENCH_STEPS`` (measured steps a window, 20), ``BENCH_STEM``,
``BENCH_NORM_DTYPE``, ``BENCH_DEBUG_METRICS=1`` (grad norm and finiteness
in the step), ``BENCH_BLOCK_IMPL`` (``fused`` | ``standard``; unset on
the card, or with ``BENCH_FORCE_AB=1``: both are timed and the faster is
reported, a variant that fails fails the run), ``BENCH_PUT_SYNC=1`` (each
copy completes on the prefetch thread), ``BENCH_DATA`` (``synthetic``;
``jpeg`` is ROADMAP Queue A item 3.2) and ``DTF_FUSED_BWD`` (the fused
blocks' backward). There is no fallback: a failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Mapping

import torch


def log(*a) -> None:
    from .parallel.cluster import is_chief

    if is_chief():
        print(*a, file=sys.stderr, flush=True)


def run(device="cuda", env: Mapping[str, str] = os.environ) -> dict:
    """Both windows on ``device`` in this process (joining the process
    group ``torchrun`` describes, if any, which is left up). Returns the
    JSON payload; its ``fed_losses`` are the pipeline-fed window's
    per-step losses."""
    from .data.pipeline import DevicePut, Prefetcher
    from .models import common, resnet
    from .obs import goodput, scaling
    from .obs.registry import default_registry
    from .parallel import cluster
    from .parallel.mesh import MeshSpec, build_mesh, describe
    from .parallel.sharding import put_host_batch, replicate
    from .train import OptimizerConfig, StepOptions, init_train_state, make_optimizer
    from .train import make_train_step
    from .utils import benchmarking as bm
    from .utils import flops as flops_lib

    fed_data = env.get("BENCH_DATA", "synthetic")
    if fed_data == "jpeg":
        raise NotImplementedError("BENCH_DATA=jpeg: the JPEG record intake (data/records.py, "
                                  "data/jpeg_records.py) is not ported yet (ROADMAP Queue A "
                                  "item 3.2)")
    if fed_data != "synthetic":
        raise ValueError(f"BENCH_DATA={fed_data!r}: only 'synthetic' is supported")
    dev = cluster.initialize(cluster.ClusterConfig(), device)
    mesh = build_mesh(MeshSpec(data=-1), dev)
    kind, n_chips, platform = bm.describe_devices(dev)
    on_card = dev.type == "cuda"
    per_chip_batch = int(env.get("BENCH_BATCH", "256" if on_card else "8"))
    image = 224 if on_card else 64
    stem = env.get("BENCH_STEM", "space_to_depth" if on_card else "conv")
    norm_dtype = env.get("BENCH_NORM_DTYPE") or None
    global_batch = per_chip_batch * n_chips
    measured = int(env.get("BENCH_STEPS", "20"))
    dbg = env.get("BENCH_DEBUG_METRICS", "0") == "1"
    log(f"bench: {kind} x {n_chips} ({platform}), mesh {describe(mesh)}, global batch "
        f"{global_batch}, image {image}")
    # each process draws its own rows of the global batch
    gen = torch.Generator().manual_seed(cluster.process_index())
    img_dtype = torch.bfloat16 if on_card else torch.float32

    def host_batch(num_classes: int) -> dict[str, torch.Tensor]:
        return {"image": torch.randn(per_chip_batch, image, image, 3, generator=gen)
                .to(img_dtype),
                "label": torch.randint(0, num_classes, (per_chip_batch,), generator=gen,
                                       dtype=torch.int32)}

    def make_cfg(block_impl: str) -> resnet.ResNetConfig:
        if on_card:
            return resnet.ResNetConfig(stem=stem, norm_dtype=norm_dtype, block_impl=block_impl)
        return resnet.ResNetConfig(stage_sizes=(1, 1, 1, 1), width=16, num_classes=100,
                                   dtype="float32", stem=stem, norm_dtype=norm_dtype,
                                   block_impl=block_impl)

    def measure_resident(block_impl: str):
        """Model, state and step of one block impl, and the resident-batch
        window's steps/s."""
        cfg = make_cfg(block_impl)
        model = resnet.build(cfg, resnet.init_params(cfg, seed=0, device=dev), dev, mesh)
        replicate(model, mesh)
        opt = make_optimizer(OptimizerConfig(name="momentum", learning_rate=0.1, momentum=0.9,
                                             weight_decay=1e-4), model.parameters())
        state = init_train_state(model, opt)
        step = make_train_step(common.classification_loss_fn(model),
                               StepOptions(compute_grad_norm=dbg, check_grads_finite=dbg),
                               mesh=mesh)
        batch = put_host_batch(host_batch(cfg.num_classes), dev)
        state, steps_per_sec, _ = bm.timed_steps(
            step, state, lambda: batch, warmup=3, measured=measured,
            log=lambda m: log(f"[{block_impl}] {m}"))
        return cfg, state, step, steps_per_sec

    pinned_impl = env.get("BENCH_BLOCK_IMPL")
    force_ab = env.get("BENCH_FORCE_AB") == "1"
    alt = None  # (impl, steps/s) of the slower variant when both were timed
    if pinned_impl or (not on_card and not force_ab):
        cfg, state, step, steps_per_sec = measure_resident(pinned_impl or "standard")
    else:
        rates = {}
        for impl in ("fused", "standard"):  # each freed before the next is built
            rates[impl] = measure_resident(impl)[3]
            if on_card:
                torch.cuda.empty_cache()
        winner = max(rates, key=rates.get)
        loser = "standard" if winner == "fused" else "fused"
        alt = (loser, rates[loser])
        log(f"block-impl A/B: fused={rates['fused']:.4f} standard={rates['standard']:.4f} "
            f"steps/s -> {winner}")
        cfg, state, step, steps_per_sec = measure_resident(winner)
    images_per_sec_per_chip = steps_per_sec * global_batch / n_chips

    # pipeline-fed window: four pre-staged host batches through the
    # Prefetcher, each copied to the card on DevicePut's side stream
    host_batches = [host_batch(cfg.num_classes) for _ in range(4)]

    def host_stream():
        i = 0
        while True:
            yield host_batches[i % len(host_batches)]
            i += 1

    put = DevicePut(dev)
    if env.get("BENCH_PUT_SYNC") == "1":
        def transform(b):
            staged = put(b)
            if staged.event is not None:
                staged.event.synchronize()
            return staged
    else:
        transform = put
    fed = iter(Prefetcher(host_stream(), depth=2, transform=transform))
    try:
        state, fed_steps_per_sec, fed_losses = bm.timed_steps(
            step, state, lambda: next(fed).wait(), warmup=2, measured=measured, log=log)
    finally:
        fed.close()
    fed_images_per_sec_per_chip = fed_steps_per_sec * global_batch / n_chips
    pipeline_efficiency = fed_steps_per_sec / steps_per_sec
    log(f"pipeline-fed: steps/s {fed_steps_per_sec:.4f} ({pipeline_efficiency:.1%} of the "
        f"resident window)")
    peak = flops_lib.peak_flops_per_chip(kind)
    mfu = goodput.train_mfu(resnet.flops_per_example(cfg, image) * global_batch, steps_per_sec,
                            n_chips=n_chips, peak_per_chip=peak, registry=default_registry())
    log(f"steps/s {steps_per_sec:.4f} images/s/chip {images_per_sec_per_chip:.2f} MFU "
        f"{mfu:.4f} (peak {peak:.3g})")
    payload = scaling.stamp_provenance({
        "metric": "resnet50_images_per_sec_per_chip",
        "value": round(images_per_sec_per_chip, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(mfu / 0.50, 4),
        "mfu": round(mfu, 4),
        "platform": platform,
        "n_chips": n_chips,
        "global_batch": global_batch,
        "image_size": image,
        "full_resnet50": on_card,
        "stem": cfg.stem,
        "norm_dtype": cfg.norm_dtype or cfg.dtype,
        "block_impl": cfg.block_impl,
        "pipeline_fed_images_per_sec_per_chip": round(fed_images_per_sec_per_chip, 2),
        "pipeline_efficiency": round(pipeline_efficiency, 4),
        "fed_data": fed_data,
        "fed_losses": fed_losses,
        **({"alt_block_impl": alt[0],
            "alt_images_per_sec_per_chip": round(alt[1] * global_batch / n_chips, 2)}
           if alt else {}),
    }, mesh)
    return payload


def main(argv=None) -> None:
    from .parallel import cluster

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
