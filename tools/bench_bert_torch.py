#!/usr/bin/env python
"""BERT-base MLM (or GPT-small LM) training throughput and MFU of the
PyTorch port — the counterpart of tools/bench_bert.py (the BASELINE.json:10
workload), with its knobs. The model is built by the workload's own
builder (``bert_pretrain`` / ``gpt_lm``: random weights from seed 0,
adamw at lr 1e-4, weight decay 0.01) through ``runner.setup``, so under
``torchrun`` it runs data-parallel, one process a card; it steps on one
resident synthetic batch (each process its rows of the global batch).

Timing contract: ``warmup`` steps first (kernel builds, library handles),
excluded; then ``BENCH_STEPS`` chained steps timed on the host clock up
to the read of the last loss, which waits for the card (the window ends
on a device sync). MFU is the model's forward FLOPs x 3 per step over
the card's published dense bf16 peak (H100 SXM: 989 TFLOP/s).

Usage::

    python tools/bench_bert_torch.py                                  # one card
    BENCH_MODEL=gpt BENCH_BATCH=8 BENCH_REMAT=1 python tools/bench_bert_torch.py
    torchrun --nproc_per_node=4 tools/bench_bert_torch.py             # data-parallel
    python tools/bench_bert_torch.py --device cpu                     # tiny, CPU

Process 0 prints ONE JSON line to stdout: tokens/s and examples/s per
card, step ms, MFU, peak ``max_memory_allocated``, the launches of each
flash kernel a step, and the provenance (the card's name and power
limit). Diagnostics go to stderr. Knobs (environment):

  BENCH_BATCH       batch a card (bert 32, gpt 8; 8 and 4 on the CPU)
  BENCH_SEQ         sequence length (512)
  BENCH_STEPS       measured steps (20)
  BENCH_MODEL       "bert" (post-LN encoder, MLM) | "gpt" (pre-LN causal LM)
  BENCH_FUSED_LN    "1": LayerNorm fused into its matmuls (gpt only)
  BENCH_REMAT       "1": each block recomputed in the backward
  BENCH_ATTN        "auto" (flash on the card) | "flash" | "dense" | "blockwise"
  BENCH_FUSED_QKV   "1": q/k/v from one [3d, d] matmul
  BENCH_HEAD_DTYPE  input dtype of the tied vocab projection ("float32")
  BENCH_XENT_CHUNK  gpt: chunk of the chunked LM loss (128 when it divides
                    BENCH_SEQ, else 0 = dense)
  BENCH_MLM_DENSE   bert: "1" for the dense-labels head (all positions)
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: steps before the timed window (kernel builds, library handles)
WARMUP = 3


def log(*a) -> None:
    from distributed_tensorflow_tpu_torch.parallel.cluster import is_chief

    if is_chief():
        print(*a, file=sys.stderr, flush=True)


def run(device="cuda", env=os.environ) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from distributed_tensorflow_tpu_torch.data.text import (
        IGNORE_INDEX,
        TextDataConfig,
        resolved_max_predictions,
    )
    from distributed_tensorflow_tpu_torch.models import transformer as tfm
    from distributed_tensorflow_tpu_torch.obs import goodput, scaling
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel import sharding
    from distributed_tensorflow_tpu_torch.parallel.mesh import MeshSpec, describe
    from distributed_tensorflow_tpu_torch.train import (
        OptimizerConfig,
        init_train_state,
        make_train_step,
    )
    from distributed_tensorflow_tpu_torch.utils import benchmarking as bm
    from distributed_tensorflow_tpu_torch.utils import flops as flops_lib
    from distributed_tensorflow_tpu_torch.workloads import bert_pretrain, gpt_lm, runner

    on_card = not str(device).startswith("cpu")
    which = env.get("BENCH_MODEL", "bert")
    if which not in ("bert", "gpt"):
        raise SystemExit(f"unknown BENCH_MODEL={which!r}")
    fused_ln = env.get("BENCH_FUSED_LN", "0") == "1"
    if fused_ln and which != "gpt":
        raise SystemExit("BENCH_FUSED_LN needs BENCH_MODEL=gpt (BERT is post-LN; the kernel "
                         "is pre-LN only)")
    seq = int(env.get("BENCH_SEQ", "512"))
    per_chip_batch = int(env.get("BENCH_BATCH", ("32" if which == "bert" else "8") if on_card
                                 else ("8" if which == "bert" else "4")))
    measured = int(env.get("BENCH_STEPS", "20"))
    xent_chunk = int(env.get("BENCH_XENT_CHUNK",
                             "128" if which == "gpt" and seq % 128 == 0 else "0"))
    mlm_dense = env.get("BENCH_MLM_DENSE", "0") == "1"
    workload = bert_pretrain if which == "bert" else gpt_lm
    base = workload.default_config()
    mcfg = tfm.bert_base() if which == "bert" else tfm.gpt_small(causal_len=max(seq, 512))
    if not on_card:  # tiny, so the CPU run finishes fast
        mcfg = dataclasses.replace(mcfg, num_layers=2, d_model=128, num_heads=4, d_ff=256,
                                   vocab_size=1024, max_len=max(seq, 128), dtype="float32")
    mcfg = dataclasses.replace(
        mcfg, fused_ln_matmul=fused_ln, remat=env.get("BENCH_REMAT", "0") == "1",
        attention_impl=env.get("BENCH_ATTN", "auto"),
        fused_qkv=env.get("BENCH_FUSED_QKV", "0") == "1",
        head_dtype=env.get("BENCH_HEAD_DTYPE", "float32"),
        xent_chunk=xent_chunk if which == "gpt" else 0)
    if seq > mcfg.max_len:
        raise SystemExit(f"BENCH_SEQ={seq} > max_len={mcfg.max_len}")
    data = dataclasses.replace(base.data, seq_len=seq, vocab_size=mcfg.vocab_size,
                               max_predictions=0 if mlm_dense else base.data.max_predictions)
    cfg = dataclasses.replace(base, model=mcfg, data=data, mesh=MeshSpec(data=-1),
                              optimizer=OptimizerConfig(name="adamw", learning_rate=1e-4,
                                                        weight_decay=0.01))
    # the runner's set-up needs the global batch: one process per card
    from distributed_tensorflow_tpu_torch.parallel import cluster

    dev = cluster.initialize(cfg.cluster, device)
    global_batch = per_chip_batch * cluster.process_count()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                            global_batch_size=global_batch))
    dev, mesh, parts, optimizer = runner.setup(cfg, workload.build, dev)
    kind, n_chips, platform = bm.describe_devices(dev)
    log(f"bench: {kind} x {n_chips} ({platform}), mesh {describe(mesh)}, model {which} "
        f"remat={mcfg.remat} attn={mcfg.attention_impl} fused_qkv={mcfg.fused_qkv} "
        f"fused_ln={fused_ln} seq={seq} global batch {global_batch}")
    state = init_train_state(parts.model, optimizer)
    step = make_train_step(parts.loss_fn, mesh=mesh)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, mcfg.vocab_size, (global_batch, seq)).astype(np.int32)
    host = {"input_ids": ids}
    n_pred = None
    if which == "bert":
        if mlm_dense:  # the dense-labels head: the vocab projection on every position
            host["labels"] = np.where(rng.rand(global_batch, seq) < 0.15, ids,
                                      IGNORE_INDEX).astype(np.int32)
        else:  # the gathered head, K by the workload's rule
            n_pred = resolved_max_predictions(TextDataConfig(seq_len=seq, max_predictions=-1))
            pos = np.sort(np.argsort(rng.rand(global_batch, seq), axis=1)[:, :n_pred],
                          axis=1).astype(np.int32)
            host["masked_positions"] = pos
            host["masked_labels"] = np.take_along_axis(ids, pos, axis=1)
    batch = sharding.put_host_batch(sharding.shard_host_batch(host, mesh), dev)
    kernels = (fa.flash_fwd, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    before = [k.launches for k in kernels]
    state, steps_per_sec, losses = bm.timed_steps(
        step, state, lambda: batch, warmup=WARMUP, measured=measured, log=log)
    launches = {k.__name__: (k.launches - b) / (WARMUP + measured)
                for k, b in zip(kernels, before)}
    tokens_per_sec_per_chip = steps_per_sec * global_batch * seq / n_chips
    fwd_flops = tfm.flops_per_example(mcfg, seq, n_predictions=n_pred) * global_batch
    mfu = (goodput.train_mfu(fwd_flops, steps_per_sec, n_chips=n_chips,
                             peak_per_chip=flops_lib.peak_flops_per_chip(kind))
           if on_card else None)
    log(f"steps/s {steps_per_sec:.4f} tokens/s/card {tokens_per_sec_per_chip:.0f} MFU {mfu}")
    return scaling.stamp_provenance({
        "metric": f"{which}_tokens_per_sec_per_chip",
        "value": round(tokens_per_sec_per_chip, 1),
        "unit": "tokens/sec/chip",
        "examples_per_sec_per_chip": round(steps_per_sec * global_batch / n_chips, 3),
        "step_ms": round(1e3 / steps_per_sec, 3),
        "mfu": round(mfu, 5) if mfu is not None else None,
        "mfu_basis": "forward FLOPs x 3 over the card's dense bf16 peak" if on_card else None,
        "peak_memory_gib": (round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)
                            if on_card else None),
        "flash_launches_per_step": launches,
        "platform": platform,
        "n_chips": n_chips,
        "global_batch": global_batch,
        "seq_len": seq,
        "model": which,
        "num_layers": mcfg.num_layers,
        "remat": mcfg.remat,
        "attention_impl": mcfg.attention_impl,
        "fused_qkv": mcfg.fused_qkv,
        "fused_ln_matmul": fused_ln,
        "xent_chunk": mcfg.xent_chunk,
        "head_dtype": mcfg.head_dtype,
        "mlm_predictions": n_pred,
        "measured_steps": measured,
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
