#!/usr/bin/env python
"""CTR convergence demo of the PyTorch port: the whole real-data Wide&Deep
path, end to end — the counterpart of tools/convergence_demo_ctr.py,
importing torch's package only.

Teacher-labelled Criteo-FORMAT TSV -> tools/make_ctr_records_torch.py
(hashing, log1p, the record layout) -> ``--data.dataset=ctr:`` through the
native record loader -> wide_deep training (FTRL wide / AdaGrad deep) at
``model=1`` in one process (the runner refuses a checkpoint at ``model``
above 1) -> eval_workload from the checkpoint -> held-out AUC from a
separately converted file.

The corpus is synthetic but LEARNABLE (a fixed random teacher over the
hashed categorical ids and the dense values labels the clicks), so AUC
has real headroom above 0.5 and the gate means something: a broken hash,
a misaligned record layout or a dead embedding gradient all push AUC back
to ~0.5. The data, widths and flags are the reference demo's.

Usage: python tools/convergence_demo_ctr_torch.py [--steps 600] [--min-auc 0.75]
           [--device cuda|cpu]
Prints one JSON line: {"train_loss":..,"eval_auc":..,"steps":..,...}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_DENSE, N_CAT, VOCAB = 6, 4, 500


def teacher_rows(n: int, seed: int):
    """``(rows, scores)``: ``n`` Criteo-format examples (raw dense values,
    hex tokens) and the fixed teacher's score of each, over the HASHED ids
    the converter will reproduce and the log1p dense values."""
    from tools.make_ctr_records_torch import hash_token

    r = np.random.RandomState(0)  # the teacher, fixed across the splits
    tables = [r.randn(VOCAB) for _ in range(N_CAT)]
    w_dense = r.randn(N_DENSE) * 0.5

    r = np.random.RandomState(seed)  # the examples differ per split
    rows, scores = [], np.empty(n)
    for j in range(n):
        raw_dense = r.randint(0, 100, N_DENSE)
        toks = ["%06x" % r.randint(0, 16**6) for _ in range(N_CAT)]
        ids = [hash_token(t, VOCAB) for t in toks]
        scores[j] = (sum(tables[i][ids[i]] for i in range(N_CAT))
                     + float(np.log1p(raw_dense) @ w_dense))
        rows.append((raw_dense, toks))
    return rows, scores


def write_tsv(path: str, rows, scores, thresh: float) -> None:
    """Label 1 where the score passes ``thresh`` (the train split's
    median: the dense term's offset would collapse the labels at 0)."""
    with open(path, "w") as f:
        for (raw_dense, toks), sc in zip(rows, scores):
            f.write("\t".join([str(int(sc > thresh))] + [str(v) for v in raw_dense] + toks)
                    + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--min-auc", type=float, default=0.75,
                    help="held-out AUC gate (chance = 0.5)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda by default, raises without CUDA")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="dtf_ctr_demo_") as work:
        run(args, work)


def run(args, work: str) -> None:
    from distributed_tensorflow_tpu_torch import workloads

    t0 = time.perf_counter()
    train_rows, train_scores = teacher_rows(6000, seed=1)
    thresh = float(np.median(train_scores))
    eval_rows, eval_scores = teacher_rows(1500, seed=2)
    for name, rows, scores in (("train", train_rows, train_scores),
                               ("eval", eval_rows, eval_scores)):
        tsv = os.path.join(work, f"{name}.txt")
        write_tsv(tsv, rows, scores, thresh)
        subprocess.run([sys.executable, os.path.join(REPO, "tools/make_ctr_records_torch.py"),
                        os.path.join(work, f"{name}.dat"), tsv, "--vocab-size", str(VOCAB),
                        "--n-dense", str(N_DENSE)], check=True, capture_output=True)

    vocabs = "[" + ",".join([str(VOCAB)] * N_CAT) + "]"
    common = [
        f"--model.vocab_sizes={vocabs}",
        f"--model.dense_features={N_DENSE}",
        "--model.embed_dim=8",
        "--model.hidden_sizes=[32,16]",
        "--data.global_batch_size=256",
        "--optimizer.learning_rate=0.08",
        "--mesh.model=1",
    ]
    ckdir = os.path.join(work, "ck")
    result = workloads.run_workload("wide_deep", [
        f"--data.dataset=ctr:{work}/train.dat",
        f"--train.num_steps={args.steps}",
        f"--train.log_every={min(50, args.steps)}",
        "--train.eval_batches=0",
        f"--checkpoint.directory={ckdir}",
        "--checkpoint.async_save=false",
        "--checkpoint.save_on_preemption=false",
        *common,
    ], device=args.device)

    eval_metrics = workloads.eval_workload("wide_deep", [
        # an explicit held-out eval file: the unprefixed ``auc`` key (an
        # eval drawn from data.dataset would be tagged train_auc)
        f"--data.eval_dataset=ctr:{work}/eval.dat",
        f"--data.dataset=ctr:{work}/train.dat",
        f"--checkpoint.directory={ckdir}",
        "--train.eval_batches=5",
        *common,
    ], device=args.device)
    auc = float(eval_metrics.get("auc", 0.0))
    print(json.dumps({
        "train_loss": float(result.history[-1]["loss"]),
        "eval_auc": auc,
        "steps": args.steps,
        "device": str(result.device),
        "wall_s": time.perf_counter() - t0,
        "dataset": "teacher-labeled Criteo-format TSV via make_ctr_records_torch.py, "
                   "6000/1500 split",
    }))
    if auc < args.min_auc:
        raise SystemExit(f"held-out AUC {auc:.3f} < {args.min_auc} gate")


if __name__ == "__main__":
    main()
