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
    python -m distributed_tensorflow_tpu_torch.train bert_pretrain \
        --data.global_batch_size=32 --train.num_steps=20 --train.eval_every=10 \
        --train.eval_batches=4 --optimizer.warmup_steps=0
    python -m distributed_tensorflow_tpu_torch.train bert_pretrain --device cpu \
        --model.num_layers=2 --model.d_model=32 --model.num_heads=4 \
        --model.d_ff=64 --model.vocab_size=48 --data.vocab_size=48 \
        --data.mask_token=0 --model.max_len=16 --data.seq_len=16 \
        --model.dtype=float32 --data.global_batch_size=64 --train.num_steps=10 \
        --train.log_every=1 --train.eval_batches=2 --optimizer.warmup_steps=0 \
        --optimizer.learning_rate=3e-3

Runs on the GPU unless ``--device cpu`` is given; with no CUDA present
the GPU default raises. Data-parallel on N cards: ``torchrun
--nproc_per_node=N -m distributed_tensorflow_tpu_torch.train
resnet50_imagenet --mesh.data=N ...`` (one process a card; process 0
prints; ``bert_pretrain`` alike). A workload with an eval surface
evaluates every ``--train.eval_every`` steps and once at the end
(``--train.eval_batches``, 0 for none), and the final metrics are
printed. Every ``--section.key=value`` override is the
JAX package's. ``--model.fused_ln_matmul=true`` runs ln1->q/k/v and
ln2->mlp_in through the fused LN+matmul kernels; ``DTF_FUSED_BWD=pallas``
(default ``xla``) picks their backward kernels, as it does for
``resnet50_imagenet --model.block_impl=fused``.
"""

from __future__ import annotations

import argparse
import logging

from ..parallel import cluster
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
    try:
        result = run_workload(args.workload, overrides, device=args.device)
        if cluster.is_chief():
            for row in result.history:
                print(" ".join(f"{k}={v:.6g}" for k, v in row.items()))
            print(f"trained {result.state.step} steps on {result.device} (mesh "
                  f"{dict(result.mesh.shape)})")
            if result.eval_metrics is not None:
                print("eval " + " ".join(f"{k}={v:.6g}"
                                         for k, v in sorted(result.eval_metrics.items())))
    finally:
        cluster.shutdown()


if __name__ == "__main__":
    main()
