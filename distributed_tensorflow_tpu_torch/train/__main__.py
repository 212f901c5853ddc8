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
    python -m distributed_tensorflow_tpu_torch.train --workload=wide_deep \\
        --train.num_steps=200
    python -m distributed_tensorflow_tpu_torch.train wide_deep --device cpu \\
        --model.vocab_sizes=[64,32,16] --model.embed_dim=8 \\
        --model.dense_features=4 --model.hidden_sizes=[32,16] \\
        --model.dtype=float32 --data.global_batch_size=64 --train.num_steps=60 \\
        --train.log_every=20 --optimizer.learning_rate=0.01 --train.eval_batches=4
    torchrun --nproc_per_node=2 -m distributed_tensorflow_tpu_torch.train wide_deep \\
        --device cpu --mesh.model=2 ...  (and the same tiny overrides)
    python -m distributed_tensorflow_tpu_torch.train mnist_mlp --device cpu \\
        --train.num_steps=60 --checkpoint.directory=/tmp/ck_mlp
    torchrun --nproc_per_node=4 -m distributed_tensorflow_tpu_torch.train gpt_lm \\
        --preset=long_context   (S=8192, ring attention over --mesh.seq=4, remat)
    torchrun --nproc_per_node=8 -m distributed_tensorflow_tpu_torch.train cifar10_cnn
    python -m distributed_tensorflow_tpu_torch.train cifar10_cnn --mesh.data=-1 \\
        --train.num_steps=200   (one process: the data axis takes it)

``python -m distributed_tensorflow_tpu_torch.evaluate <workload>
--checkpoint.directory=DIR`` evaluates a run's newest checkpoint without
training.

Checkpoint and resume: with ``--checkpoint.directory=DIR`` (and e.g.
``--checkpoint.save_interval_steps=50``) the run saves on that cadence,
on SIGTERM (a clean stop) and at the end; the same command run again
restores the newest step in DIR and goes on from there (kill it at any
point: a step is either whole on disk or not there).

Runs on the GPU unless ``--device cpu`` is given; with no CUDA present
the GPU default raises. Data-parallel on N cards: ``torchrun
--nproc_per_node=N -m distributed_tensorflow_tpu_torch.train
resnet50_imagenet --mesh.data=N ...`` (one process a card; process 0
prints; ``bert_pretrain`` alike); ``wide_deep`` also shards its tables
over ``--mesh.model`` (2 by default under torchrun with an even process
count; 1 in one process). A workload with an eval surface
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
    ap.add_argument("workload", nargs="?", choices=available())
    ap.add_argument("--workload", dest="workload_flag", choices=available(),
                    help="the workload, as a flag (or give it first)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda by default, raises without CUDA")
    ap.add_argument("--preset", default=None,
                    help="one of the workload's other presets (gpt_lm: long_context)")
    args, overrides = ap.parse_known_args(argv)
    workload = args.workload or args.workload_flag
    if workload is None or (args.workload and args.workload_flag
                            and args.workload != args.workload_flag):
        ap.error("name one workload, first or as --workload")
    bad = [o for o in overrides if not (o.startswith("--") and "=" in o)]
    if bad:
        ap.error(f"overrides must be --section.key=value, got {bad}")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        result = run_workload(workload, overrides, device=args.device, preset=args.preset)
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
