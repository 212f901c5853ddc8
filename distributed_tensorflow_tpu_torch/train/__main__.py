"""Train a workload on the port — the counterpart of ``examples/train.py``.

Usage:
    python -m distributed_tensorflow_tpu_torch.train gpt_lm --train.num_steps=20
    python -m distributed_tensorflow_tpu_torch.train gpt_lm --device cpu \\
        --model.num_layers=2 --model.d_model=64 --model.num_heads=4 \\
        --model.d_ff=128 --model.vocab_size=256 --data.vocab_size=256 \\
        --model.max_len=64 --data.seq_len=64 --model.xent_chunk=32 \\
        --model.dtype=float32 --data.global_batch_size=4 \\
        --train.num_steps=5 --train.log_every=1 --optimizer.warmup_steps=0
    DTF_FUSED_BWD=pallas python -m distributed_tensorflow_tpu_torch.train gpt_lm \
        --model.fused_ln_matmul=true --train.num_steps=20
    python -m distributed_tensorflow_tpu_torch.train resnet50_imagenet \
        --data.global_batch_size=256 --model.block_impl=fused --train.num_steps=20
    python -m distributed_tensorflow_tpu_torch.train resnet50_imagenet --device cpu \
        --model.stage_sizes=[1,1] --model.width=8 --model.num_classes=10 \
        --model.dtype=float32 --data.image_size=16 --data.num_classes=10 \
        --data.global_batch_size=8 --train.num_steps=3 --train.log_every=1 \
        --optimizer.warmup_steps=0 --optimizer.schedule=constant

Runs on the GPU unless ``--device cpu`` is given; with no CUDA present
the GPU default raises. Every ``--section.key=value`` override is the
JAX package's. ``--model.fused_ln_matmul=true`` runs ln1->q/k/v and
ln2->mlp_in through the fused LN+matmul kernels; ``DTF_FUSED_BWD=pallas``
(default ``xla``) picks their backward kernels, as it does for
``resnet50_imagenet --model.block_impl=fused``.
"""

from __future__ import annotations

import argparse
import logging

from ..workloads import available, run_workload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workload", choices=available())
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda by default, raises without CUDA")
    args, overrides = ap.parse_known_args(argv)
    bad = [o for o in overrides if not (o.startswith("--") and "=" in o)]
    if bad:
        ap.error(f"overrides must be --section.key=value, got {bad}")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    result = run_workload(args.workload, overrides, device=args.device)
    for row in result.history:
        print(" ".join(f"{k}={v:.6g}" for k, v in row.items()))
    print(f"trained {result.state.step} steps on {result.device}")


if __name__ == "__main__":
    main()
