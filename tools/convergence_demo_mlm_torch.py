#!/usr/bin/env python
"""Real-text convergence demo of the PyTorch port for the transformer
family — the counterpart of tools/convergence_demo_mlm.py, importing
torch's package only.

REAL English prose (``CORPUS``: this repo's design documents, a fixed list
of files the port never edits, so the corpus and its split do not move as
the port's own notes change) -> tools/make_token_file.py's byte tokenizer
(run as a subprocess: it imports numpy alone) -> the token-file streams ->
training -> eval_workload from the checkpoint -> held-out accuracy. The
corpus is split by FILE (``mds[::4]`` of the sorted list held out), so the
eval text was never trained on. The reference demo reads every root and
``docs/`` markdown file instead, which includes the notes each change
edits. Two objectives share the harness:

  --objective=mlm (default)  bert_pretrain over ``tokens_mlm:`` (80/10/10
      corruption, gathered positions); the gate is on held-out
      masked-byte accuracy.
  --objective=lm             gpt_lm over ``tokens:`` (causal windows); the
      gate is on held-out next-byte accuracy.

The model is the reference demo's: 3 layers, d_model 128 over 4 heads —
head_dim 32 —, d_ff 256, seq 64, global batch 64, lr 0.003, 1600 steps.
Attention is the preset's ``auto``: on the card it runs through the
flash kernels (forward, dK/dV, dQ at D = 32), whose launches over the
training run by head dim, and a step, the JSON line reports beside the
trained model's head dim; on the CPU through dense attention. Unigram guessing tops out near 13%; a broken tokenizer,
masking stream, gathered head or checkpoint restore drops the score back
toward it.

``--long`` is the reference's long-context variant at demo scale: the
causal LM at seq 256, global batch 16, trained through ring attention over
a ``seq=4`` mesh axis with remat (the ``long_context`` preset's
configuration; gate 0.25 by default, the reference's). It runs as four
processes — ``torchrun --nproc_per_node=4 tools/convergence_demo_mlm_torch.py
--long`` (gloo with ``--device cpu``, NCCL on four cards) — whose chief
makes the token files and prints the line; one process alone is told how
to launch it.

Usage: python tools/convergence_demo_mlm_torch.py [--objective mlm|lm]
           [--steps 1600] [--min-acc 0.35] [--device cuda|cpu]
       torchrun --nproc_per_node=4 tools/convergence_demo_mlm_torch.py --long
           [--steps 1600] [--min-acc 0.25] [--device cuda|cpu]
Prints one JSON line: {"objective":..,"train_loss":..,"eval_masked_acc"
(or "eval_next_byte_acc"):..,"steps":..,"head_dim":..,
"flash_launches_by_head_dim":..,...}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

VOCAB, MASK = 261, 260  # byte tokenizer: 256 bytes + 5 specials
# --long: the seq axis and the schedule (the reference's, defined once)
LONG_MESH_SEQ, LONG_SEQ_IMPL = 4, "ring"


#: the corpus: the repo's design documents, which the port never edits
CORPUS = ("ADVICE.md", "BASELINE.md", "MIGRATION.md", "PAPER.md", "PAPERS.md",
          "PERF_NOTES.md", "SNIPPETS.md", "SURVEY.md", "VERDICT.md", "docs/kernels.md",
          "docs/observability.md", "docs/parallelism.md", "docs/resilience.md",
          "docs/serving.md", "docs/static-analysis.md")


def corpus_split() -> tuple[list[str], list[str]]:
    """(train files, held-out files): ``CORPUS``, sorted, every fourth
    held out."""
    mds = sorted(os.path.join(REPO, f) for f in CORPUS)
    missing = [m for m in mds if not os.path.isfile(m)]
    if missing:
        raise SystemExit(f"convergence_demo_mlm_torch: corpus files missing: {missing}")
    held = mds[::4]
    return [m for m in mds if m not in held], held


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1600)
    ap.add_argument("--objective", choices=("mlm", "lm"), default=None)
    ap.add_argument("--min-acc", type=float, default=None,
                    help="held-out accuracy gate (unigram floor ~0.13); default 0.35, or "
                         "0.25 for --long")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda by default, raises without CUDA")
    ap.add_argument("--long", action="store_true",
                    help="the causal LM at seq 256 through ring attention on a seq=4 mesh "
                         "with remat, under torchrun --nproc_per_node=4")
    args = ap.parse_args(argv)
    if args.long and args.objective == "mlm":
        ap.error("--long is a causal-LM variant; drop --objective=mlm")
    if args.objective is None:
        args.objective = "lm" if args.long else "mlm"
    if args.min_acc is None:
        args.min_acc = 0.25 if args.long else 0.35
    if not args.long:
        with tempfile.TemporaryDirectory(prefix="dtf_mlm_demo_") as work:
            run(args, work)
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world % LONG_MESH_SEQ:
        raise SystemExit(
            f"convergence_demo_mlm_torch: --long splits the sequence over {LONG_MESH_SEQ} "
            f"processes (mesh.seq={LONG_MESH_SEQ}), and {world} process(es) run here: launch "
            f"it as torchrun --nproc_per_node={LONG_MESH_SEQ} "
            f"tools/convergence_demo_mlm_torch.py --long [--device cpu]")
    run_long(args)


def run_long(args) -> None:
    """``run`` on every rank, in one directory the chief makes (its path
    broadcast; the checkpoint the chief writes is what every rank's eval
    restores), removed by the chief when every rank is done."""
    import shutil

    from distributed_tensorflow_tpu_torch.parallel import cluster
    from distributed_tensorflow_tpu_torch.utils.multihost import broadcast_from_chief

    cluster.initialize(cluster.ClusterConfig(), args.device)
    try:
        work = tempfile.mkdtemp(prefix="dtf_mlm_demo_") if cluster.is_chief() else None
        work = broadcast_from_chief({"work": work})["work"]
        try:
            run(args, work)
        finally:
            cluster.sync_hosts("mlm_demo_done")
            if cluster.is_chief():
                shutil.rmtree(work, ignore_errors=True)
    finally:
        cluster.shutdown()


def run(args, work: str) -> None:
    from distributed_tensorflow_tpu_torch import workloads
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    from distributed_tensorflow_tpu_torch.parallel import cluster

    t0 = time.perf_counter()
    train_files, eval_files = corpus_split()
    if cluster.is_chief():
        for out, files in (("train.npy", train_files), ("eval.npy", eval_files)):
            subprocess.run([sys.executable, os.path.join(REPO, "tools/make_token_file.py"),
                            os.path.join(work, out), *files], check=True, capture_output=True)
    if args.long:
        cluster.sync_hosts("mlm_demo_tokens")

    mlm = args.objective == "mlm"
    workload = "bert_pretrain" if mlm else "gpt_lm"
    prefix = "tokens_mlm" if mlm else "tokens"
    seq = 256 if args.long else 64
    common = [
        f"--data.vocab_size={VOCAB}",
        f"--data.seq_len={seq}",
        f"--data.global_batch_size={16 if args.long else 64}",
        *([f"--data.mask_token={MASK}", "--data.max_predictions=10"] if mlm else []),
        f"--model.vocab_size={VOCAB}",
        "--model.num_layers=3",
        "--model.d_model=128",
        "--model.num_heads=4",
        "--model.d_ff=256",
        f"--model.max_len={seq}",
        "--mesh.model=1",
        # --long: ring attention over a seq axis + remat, the long_context
        # preset's configuration at demo scale; data=-1 takes the rest
        *([f"--mesh.seq={LONG_MESH_SEQ}", f"--model.seq_impl={LONG_SEQ_IMPL}",
           "--model.remat=true"] if args.long else []),
        "--mesh.data=-1",
    ]
    ckdir = os.path.join(work, "ck")
    kernels = (fa.flash_fwd, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    for k in kernels:
        k.launches = 0
        k.launches_by_d.clear()
    result = workloads.run_workload(workload, [
        f"--data.dataset={prefix}:{work}/train.npy",
        f"--train.num_steps={args.steps}",
        f"--train.log_every={min(50, args.steps)}",
        "--train.eval_batches=0",
        f"--checkpoint.directory={ckdir}",
        "--checkpoint.async_save=false",
        "--checkpoint.save_on_preemption=false",
        "--optimizer.learning_rate=0.003",
        *common,
    ], device=args.device)
    steps = int(result.state.step)
    launches = {k.__name__: k.launches for k in kernels}
    by_d = {str(d): {k.__name__: k.launches_by_d.get(d, 0) for k in kernels}
            for d in sorted({d for k in kernels for d in k.launches_by_d})}
    head_dim = result.state.model.cfg.head_dim
    train_s = time.perf_counter() - t0

    eval_metrics = workloads.eval_workload(workload, [
        f"--data.dataset={prefix}:{work}/eval.npy",
        f"--checkpoint.directory={ckdir}",
        "--train.eval_batches=5",
        *common,
    ], device=args.device)
    acc = float(eval_metrics.get("accuracy", 0.0))
    if not cluster.is_chief():
        return
    print(json.dumps({
        "objective": args.objective,
        "long": bool(args.long),
        "mesh": dict(result.mesh.shape),
        "train_loss": float(result.history[-1]["loss"]),
        "eval_masked_acc" if mlm else "eval_next_byte_acc": acc,
        "steps": steps,
        "head_dim": head_dim,
        "flash_launches": launches,
        "flash_launches_by_head_dim": by_d,
        "flash_launches_per_step": {n: c / max(steps, 1) for n, c in launches.items()},
        "device": str(result.device),
        "train_s": train_s,
        "wall_s": time.perf_counter() - t0,
        "dataset": f"repo .md prose, byte-tokenized; {len(train_files)} train / "
                   f"{len(eval_files)} held-out files",
    }))
    if acc < args.min_acc:
        raise SystemExit(f"held-out accuracy {acc:.3f} < {args.min_acc} gate")


if __name__ == "__main__":
    main()
