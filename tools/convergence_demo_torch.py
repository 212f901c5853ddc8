#!/usr/bin/env python
"""Convergence demonstration of the PyTorch port on REAL decoded JPEG data —
the counterpart of tools/convergence_demo.py, importing torch's package
only.

The whole production path: JPEG record files -> the port's
JpegClassificationDataset (decode + augment) -> run_workload("cifar10_cnn")
(Trainer, checkpoints) -> eval_workload from the checkpoint on held-out
records.

Data: scikit-learn's bundled `load_digits` (1,797 real 8x8 handwritten
digit scans), permuted by RandomState(0), upscaled to 32x32 RGB with PIL
bilinear, written as JPEG records by data/jpeg_records.make_jpeg_record_file
and split 1500/297, as the reference does. Chance is 10%; the gate asks
for >= 90% held-out top-1 (--min-top1). Without scikit-learn the demo
exits non-zero naming it: it makes no substitute data.

Usage:  python tools/convergence_demo_torch.py [--steps 400] [--device cuda|cpu]
            [--workdir DIR] [--batch 128] [--min-top1 0.9]
Prints one JSON line: {"train_acc":..,"eval_top1":..,"steps":..,...}.
"""

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_records(workdir: str) -> tuple[str, str]:
    import numpy as np
    from PIL import Image

    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise SystemExit(f"convergence_demo_torch: scikit-learn is needed for its bundled "
                         f"digit scans (load_digits) and is not installed ({e}); no "
                         f"substitute data is made") from e

    from distributed_tensorflow_tpu_torch.data.jpeg_records import make_jpeg_record_file

    digits = load_digits()
    imgs8 = (digits.images / 16.0 * 255.0).astype(np.uint8)  # [N, 8, 8]
    order = np.random.RandomState(0).permutation(len(imgs8))
    imgs8, labels = imgs8[order], digits.target[order]

    def upscale(batch):
        out = np.empty((len(batch), 32, 32, 3), np.uint8)
        for i, im in enumerate(batch):
            big = np.asarray(Image.fromarray(im, "L").resize((32, 32), Image.BILINEAR))
            out[i] = big[..., None].repeat(3, axis=-1)
        return out

    n_train = 1500
    train = os.path.join(workdir, "digits_train")
    evalp = os.path.join(workdir, "digits_eval")
    make_jpeg_record_file(train, upscale(imgs8[:n_train]), labels[:n_train])
    make_jpeg_record_file(evalp, upscale(imgs8[n_train:]), labels[n_train:])
    print(f"records: {n_train} train / {len(imgs8) - n_train} eval real digit scans -> "
          f"{workdir}", file=sys.stderr)
    return train, evalp


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--workdir", default=None,
                    help="kept after the run; default: a temporary directory, removed")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda by default, raises without CUDA")
    ap.add_argument("--min-top1", type=float, default=0.9,
                    help="held-out accuracy gate (lower it for smoke runs)")
    args = ap.parse_args(argv)

    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
        run(args, args.workdir)
    else:
        with tempfile.TemporaryDirectory(prefix="dtf_digits_demo_") as workdir:
            run(args, workdir)


def run(args, workdir: str) -> None:
    t0 = time.perf_counter()
    train_rec, eval_rec = build_records(workdir)

    from distributed_tensorflow_tpu_torch import workloads

    ckdir = os.path.join(workdir, "ck")
    common = ["--data.image_size=32", "--data.channels=3", "--data.num_classes=10",
              f"--data.global_batch_size={args.batch}", "--mesh.data=-1"]
    log_every = max(1, min(50, args.steps // 4))
    result = workloads.run_workload("cifar10_cnn", [
        f"--data.dataset=jpeg:{train_rec}",
        f"--train.num_steps={args.steps}",
        f"--train.log_every={log_every}",
        f"--optimizer.total_steps={args.steps}",
        "--optimizer.learning_rate=0.02",
        f"--checkpoint.directory={ckdir}",
        "--train.eval_batches=2",
        *common,
    ], device=args.device)
    train_acc = float(result.history[-1].get("accuracy", 0.0))

    # standalone eval from the checkpoint on the HELD-OUT record pair: the
    # evaluate entry point's path
    eval_metrics = workloads.eval_workload("cifar10_cnn", [
        f"--data.dataset=jpeg:{eval_rec}",
        f"--checkpoint.directory={ckdir}",
        "--train.eval_batches=2",
        *common,
    ], device=args.device)
    top1 = float(eval_metrics.get("accuracy", 0.0))
    print(json.dumps({
        "train_acc": train_acc,
        "eval_top1": top1,
        "steps": args.steps,
        "device": str(result.device),
        "wall_s": time.perf_counter() - t0,
        "dataset": "sklearn load_digits (real scans), 1500/297 split",
    }))
    if top1 < args.min_top1:
        raise SystemExit(f"held-out top-1 {top1:.3f} < {args.min_top1} gate")


if __name__ == "__main__":
    main()
