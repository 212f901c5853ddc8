#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (one H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, needs one CUDA card,
and exits non-zero — printing no result line — when there is none, when
the port cannot be imported (e.g. the script alone in a directory), or
when any phase fails:

1. build every kernel library from ``distributed_tensorflow_tpu_torch/ops/
   csrc`` (one nvcc per source, started together) and print ptxas's
   report: each kernel instantiation's mangled name, registers and spills
   (the bf16 flash forward, dK/dV and dQ must not spill);
2. hold each kernel against its plain PyTorch version on the card at its
   path's shapes (serving, gpt_small: H=12, D=64, bs=16; d=768 — and the
   three flash kernels at the training shapes B=8, H=12, S=1024, D=64,
   causal, bf16 and f32, with and without a kv_mask, and at BERT's,
   ``FLASH_BERT``: B=32, H=12, S=512, D=64, non-causal, bf16, with no mask
   and with a padded kv_mask whose last row attends nothing, each timed
   beside SDPA on the same inputs with its backend named), with the tolerances
   stated in ``TOL`` (the flash forward's out and the backward's dq, dk,
   dv — and lse over the rows that attend — also as relative L2 error,
   beside an out, a dk and a dq scaled by 1.01 that the gates must fail); time
   kernel, plain version, one library call and the bound with CUDA events
   and the profiler (phase 2a holds paged attention at ``PAGED_KINDS``,
   also as relative L2 error, ``TOL["paged_attention/rel_l2/*"]``, beside
   an out x 1.01 control the gate must fail, and a second call bitwise
   equal; phase 2b holds the serving LN+matmul forward at every
   ``LN_SERVE_M`` row count, n = 768 and 3072, in all three entries, also
   as relative L2 error, ``TOL["ln_matmul/rel_l2/*"]``, beside a y x 1.01
   control the gate must fail, and a second call bitwise equal; it also
   times the serving kernel against the tiled forward at
   ``LN_CROSSOVER_M`` and checks by kernel name that ln_matmul keeps the
   serving kernel below ``LN_TILED_MIN_M`` rows and takes the tiled pair
   from there);
3. serve 8 requests through ``gpt_small`` at full width (bf16, random
   weights from seed 0, 4 slots, block_size 16, prefill_chunk 64, a
   shared 128-token system prefix on four prompts, max_new 32, greedy)
   three times — plain decode, ``spec_k=4``, ``fused_ln_matmul=True`` —
   counting kernel launches and checking that drain() frees every block;
4. rerun the plain-decode pass with no kernel on the path
   (``paged_impl="gather"``, ``fused_ln_matmul=False``) and hold both
   kernel passes against it: the logits behind every delivered token
   within ``TOL["logits"]``, greedy streams equal (a stream may diverge
   only where the reference's top-2 logit margin is below that
   tolerance);
5. train ``gpt_lm`` (gpt_small, full width, S=1024, bf16, random weights
   from seed 0, global batch 8, 6 steps of adamw at a constant lr 3e-4 —
   a smoke setting, not a recipe — on a fixed corpus of SyntheticLM's
   first 8 sequences, which the steps revisit) through
   ``run_workload`` twice from the same weights and batches: with the
   flash kernels (``attention_impl="flash"``) and with no kernel on the
   path (``"dense"``); hold the step-1 gradients and the per-step losses
   of the two against each other (``TOL``), check that the loss falls and
   that each flash kernel launched exactly 12 times a step; print
   tokens/s, step ms, MFU and peak memory, the device idle share of one
   profiled step and its flash kernels' device time, and one flash run at
   global batch 64; then (phase 5b)
   the same training with ``fused_ln_matmul=True`` under
   ``DTF_FUSED_BWD=pallas`` (the LN+matmul forward — its tiled pair at
   M=8192 — dx and dw kernels, 48 launches a step each) and ``xla`` (the
   forward, 48), held to the
   unfused flash pass and to each other (losses, step-1 gradients), one
   profiled fused+pallas step, and one f32 step fused+pallas vs unfused
   gated tightly (``TOL``). (Phase 2e, before serving: the LN+matmul
   forward, dx and dw kernels against their plain versions at M=8192,
   d=768, n=768 and 3072 in bf16, f32 at two smaller shapes (one of them
   d=1024, n=8192), both w layouts, bf16 -> f32 and a ragged M for the
   forward, a bitwise repeat, timed against the bound, the plain version
   and one library call, each wrapper's time split by kernel (forward:
   statistics and product; dx: product, row pass and reduction; dw:
   product and reduction), and the dw split over M and both tile widths
   timed beside the plans the wrappers take.)
6. train ``resnet50_imagenet`` (ResNet-50 at full depth and width,
   ``space_to_depth`` stem, 224x224, 1000 classes, bf16, random weights
   from seed 0, global batch 256, 6 steps of momentum + L2 at a constant
   lr 0.1 on two fixed SyntheticClassification batches written as an
   npz) through ``run_workload`` three times from the same weights (the
   bn3 scales drawn non-zero) and batches: ``block_impl="fused"`` with
   ``DTF_FUSED_BWD=pallas`` (the four conv+BN kernels), ``fused`` with
   ``xla``, and ``standard`` (no kernel), then one f32 step fused +
   pallas and standard; hold the f32 fused step's loss, BN update and
   gradients to the f32 standard step, the bf16 kernel passes' losses and
   BN updates to the bf16 standard pass and their gradients to the f32
   standard step no further than the bf16 standard pass's (``TOL``);
   check that the loss falls and that the launch counts are the port's
   rule's (36 forwards a step, the single-pass backward where
   ``single_pass`` holds, the dx + dw pair elsewhere); print images/s,
   step ms, MFU and peak memory of each pass and the device idle share of
   one profiled fused step with its batch preloaded. (Phase 2d,
   before serving: the four kernels against their plain versions at a
   conv3 and a conv1/projection shape of each stage at batch 256, bf16,
   f32 at two shapes, a bitwise repeat, timed against the bound, the plain
   version and the product alone in ``torch.matmul``; dx also with w a
   contiguous [cin, cout] array and at a ragged M at its main shape, and
   its time split by kernel: the tiled product and the reduction (so are
   the forward's, dw's and the single-pass kernel's); the four kernels
   held to their plain versions and the single-pass kernel timed against the dx + dw
   pair at ResNet-50's four stage-0 configurations, ``CONV_BN_STAGE0``;
   the dw kernel held to its plain version and timed at the twelve
   shapes of a step's 29 two-pass launches, ``CONV_BN_DW_SWEEP``, with
   the launch-weighted sum; and the forward held to its plain version (y
   also as relative L2 error, ``TOL["conv_bn/fwd/rel_l2/*"]``, beside a y
   scaled by 1.01 that the gate must fail; a second call bitwise equal),
   its time split into product and reduction, at the sixteen shapes of a
   step's 36 forward launches, ``CONV_BN_FWD_SWEEP``, each tile width of
   ``fwd_plan`` at its main shape, and the launch-weighted sum.)
7. (a) run ``distributed_tensorflow_tpu_torch.bench`` in this process,
   in a process group of one over NCCL: ResNet-50 with the fused blocks
   and the pallas backward, 256 images, 224x224, a resident-batch and a
   pipeline-fed window (``BENCH_ENV``); print its JSON line, images/s,
   MFU and pipeline efficiency beside the card's name and power limit,
   and check that each conv+BN kernel launched the rule's count every
   step; (b) start two processes on this one card over gloo
   (``tests/torch_dp_worker.py``; NCCL refuses two ranks on one GPU) that
   take one data-parallel step of ResNet-50 at full width on their halves
   of a global batch of 64 (``DP_PASSES``: fused + pallas in bf16 and in
   f32, sync BN), and hold rank 0's loss, running statistics and updated
   parameters against one process on the same 64 images (``TOL["dp/*"]``;
   in f32 also against a control, one process on rank 0's 32 images
   alone, which must read far off), both ranks bitwise alike, each
   having launched every conv+BN kernel; (c) hold the first batches out
   of the Prefetcher's side-stream copies bitwise to their host batches,
   and check that the bench's fed window's loss is finite and falls;
8. train ``bert_pretrain`` (bert_base at full width and depth: 12 layers,
   d_model 768, S=512, the gathered MLM head, K=77; bf16, dropout 0.1,
   random weights from seed 0, global batch 32, 6 steps of adamw at a
   constant lr 1e-4 with no warmup — a smoke setting — on a fixed corpus
   of 32 random sequences, then a final eval of 4 batches) through
   ``run_workload`` with the flash kernels (non-causal) and with dense
   attention; hold the losses and step-1 gradients of the two to phase
   5's gates, the eval loss and accuracy to ``TOL["bert/eval/*"]``, check
   that the loss falls, that each flash kernel launched 12 times a step and
   ``flash_fwd`` 12 times an eval batch; then one step of each on a padded
   batch (valid lengths 384-512, one row with none, kept out of the loss)
   and one f32 step of each, within the bf16 and f32 gates; print step ms,
   tokens/s, MFU, peak memory and the eval metrics;
9. checkpoint-restart (``CKPT_*``): (a) ``gpt_lm`` at phase 5b's setting
   (fused_ln_matmul, the pallas backward, flash; the fixed corpus) with
   ``--checkpoint.directory``, async saves every 2 steps, 2 kept: a
   straight run of 6 steps with a final eval of 2 batches; a child
   process on this card (``tests/torch_dp_worker.py``'s ``ckpt`` job)
   killed by an ``AsyncCommitKill`` inside step 4's commit (it must die by
   SIGKILL, leave ``.pending/4`` and step 2 the newest); a resume here from
   step 2 with a ``Sigterm`` after step 3 (a clean stop on a save at 3),
   and a second resume to 6: the losses of steps 3-6 and every parameter
   and Adam moment bitwise the straight run's, each attempt launching
   phase 5b's count a step; ``evaluate_from_checkpoint`` of the straight
   run's step 6 bitwise its final eval; a ``truncate_shard`` of step 6 and
   ``restore(fallback=True)`` quarantining it and restoring step 4
   bitwise the straight run's; bytes a step dir, the snapshot stall, the
   async commit latency, a timed sync save and restore (the write rate is
   the host disk's); (b) ``resnet50_imagenet`` fused + pallas at batch 256
   on one SyntheticClassification batch: 4 straight steps against 2, a
   save, a restore in a fresh ``run_workload`` and 2 more — parameters,
   BN running statistics and the momentum trace bitwise, the conv+BN
   launches the rule's a step. It fails unless the checkpoint IO runs
   through the native library;
10. the real-data intake (``INTAKE_*``): 512 flat records of 224x224x3
   written here; the native record loader's stream bitwise its Python
   path's (two shards of two, from batch 0 and resumed at 3);
   ``RecordClassificationDataset(augment="crop_flip")`` batch 3 equal to a
   fresh dataset at ``index_offset=3`` (and not to one at 2); then
   ``resnet50_imagenet`` fused + pallas at batch 256 trained 6 steps from
   ``records:`` with crop_flip through ``run_workload``: the losses bitwise
   those of the same steps fed the same dataset's batches by hand, a
   control with one image of batch 1 flipped differing, the conv+BN
   launches the rule's a step; the records-fed step time beside phase 6's.
   The card's machine has no libjpeg headers, so the JPEG decoder is not
   built or run here (ROADMAP);
11. Wide&Deep CTR (``WD_*``, no kernel of its own: the lookups are
   gathers and their backward PyTorch's sort-based embedding backward):
   (a) one card, ``model=1``, the accelerator shape of
   ``tools/bench_wide_deep.py`` (26 tables of 100000 x 64 in f32, 13
   dense features, hidden 1024-512-256, bf16, 16384 rows, the ``auto``
   optimizer at lr 0.05): 12 steps through ``run_workload("wide_deep")``
   fed by the Prefetcher from ``SyntheticCTR``, a final eval of 4 batches
   (loss, accuracy, AUC); the median step ms of steps 3-12, examples/s,
   the embedding traffic in GB/s (``3·F·(D+1)·4`` bytes an example), peak
   memory and the idle share of one profiled step; the loss must fall;
   two same-seed runs of 3 steps bitwise equal (losses and every
   parameter) and a seed + 1 control that differs; one f32 step on the
   card against the same step on the CPU (same weights, a batch of
   ``WD_F32_BATCH``) within ``TOL["wd/f32/*"]``, beside an update x 1.01
   control the gate must fail; (b) two processes on this card over gloo
   (``tests/torch_dp_worker.py``'s ``wide_deep`` job) at ``data=1,
   model=2``: 3 f32 steps of a global batch of ``WD_DP_GLOBAL`` through
   ``run_workload`` with the tables range-sharded over ``model`` (the
   exchange: all-reduces only, as gloo has no CUDA all-gather), held
   against one process at ``model=1`` on the same rows (losses and every
   parameter, the tables reassembled from the shards, ``TOL["wd/dp/*"]``;
   whether they are bitwise is printed);
12. the slice of the MNIST MLP and the CIFAR-10 CNN (``SMALL_*``, no
   kernel of their own: the products are ``F.linear`` and the
   convolutions cuDNN's): (a) ``mnist_mlp`` and ``cifar10_cnn`` at their
   presets' widths and batches with ``--mesh.data=-1``, 20 steps each
   through ``run_workload`` and a final eval of 4 batches: the loss must
   fall and the eval be finite; step ms and examples/s; two same-seed runs
   of 3 steps bitwise equal (losses, parameters, BatchNorm buffers) and a
   seed + 1 control that differs; one f32 step on the card against the
   same step on the CPU within ``TOL["small/f32/*"]``, beside an update x
   1.01 control the gate must fail; and the MLP trained by the JAX
   package's convergence test's recipe (``MLP_CONVERGE``) beating its
   thresholds (accuracy > 0.3, top-5 > 0.7); (b) the convergence demos
   (``DEMOS``), each a process of its own with its default steps and gate
   — CTR (Wide&Deep from converted Criteo-format TSV, AUC >= 0.75), MLM and
   LM (the repo's design documents, a pinned corpus, held-out accuracy
   >= 0.35, through the flash kernels at head_dim 32: the wrappers' counts
   by head dim must show all three every step, at 32 alone) and the
   digits demo where scikit-learn imports (it is not installed on the
   card's machine: the log says so) — each printing its JSON line and
   seconds. (Phase 2c also holds the three flash kernels at head_dim 32,
   ``FLASH_D32``: B=64, H=4, S=64 — the MLM/LM demos' attention — bf16 and
   f32, causal and not, with no mask and a padded kv_mask, with their
   relative-L2 gates and x1.01 controls, timed beside SDPA non-causal and
   causal in bf16; ptxas's report of every bf16 D=32 instantiation must
   show no spill, as D=64's and D=128's);
13. the transformer training options (``T13_*``): (a) ``gpt_lm`` at
   phase 5's setting (gpt_small, S=1024, B=8, bf16, dropout 0.1, the
   fixed corpus), 4 steps through ``run_workload`` each: plain, with
   ``remat`` (losses and step-1 gradients bitwise the plain run's; a
   control with the dropout generator's replay removed must differ; 24
   flash forwards a step, 12 dK/dV and dQ; peak memory below the plain
   run's), fused QKV with remat from the split weights fused (within
   phase 5's limits), remat with ``fused_ln_matmul`` and the pallas
   backward (the LN+matmul forward twice a step); (b) ``attention_impl=
   "blockwise"`` (two key blocks) against dense, 3 steps; (c) rmsprop,
   lamb and adafactor 3 steps each at full size (the loss must fall), and
   2 f32 updates of each at 2 layers on the card against the CPU within
   ``TOL["opt/f32/*"]`` beside an update x 1.01 control; (d) data-parallel
   gpt_lm (``tests/torch_dp_worker.py``'s ``gpt`` job) on two gloo ranks
   on this card, 2 layers of gpt_small's widths in f32, plain and at
   dropout 0.1 with remat, against one process within phase 7b's f32
   limits; (e) a run with ``Profiler`` (its trace names the flash
   kernels), ``--train.summary_dir`` (the event file read back, every CRC
   checked), ``TelemetryCallback`` (``train_steps_total`` 6) and a
   ``Watchdog``, then a run whose step stalls past an ``abort_on_stall``
   watchdog's budget (``StalledError``, classified ``stalled``); (f)
   ``tools/bench_bert_torch.py`` at bert_base (B=32, S=512: flash, flash +
   remat, flash + fused QKV, blockwise) and gpt B=64 S=1024 with remat,
   5 timed steps each, each line printed. (Phase 2c also holds ``flash_attention`` at head
   dims 8 and 16, zero-padded to 32, against the plain versions at that
   head dim, with its gates and controls and the launches counted at 32
   and at the caller's head dim, and times it beside SDPA.)
14. tensor and fully-sharded data parallelism (``T14_*``, ``phase_tp``):
   (a) ``gpt_lm`` at gpt_small (S=1024, B=8, bf16, flash, fused LN+matmul
   with the pallas backward, the chunked loss at 256, adamw, dropout 0)
   at data=1 x model=2 in two gloo processes on this card
   (``tests/torch_dp_worker.py``'s ``tp`` job), 3 steps from the weights
   of one seed, against the same steps in one process
   (``TOL["tp/bf16/*"]``: the losses with an x 1.01 control, each
   parameter's update with a half-batch control; the ranks bitwise alike,
   no replicated parameter drifting between them); every flash and
   LN+matmul kernel launched on every rank; (b) ``bert_pretrain`` at
   bert_base (S=512, B=32, the gathered MLM head, a padded kv_mask,
   dropout 0.1) at fsdp=2 x model=2 in four processes, 2 steps, the same
   gates, then its step dir (gathered whole by the chief) restored in one
   process at model=1 — every leaf's SHA-256 the ranks' gathered one's —
   and by each rank at its mesh bitwise; each rank's step ms printed as
   gloo-on-one-card numbers, not tensor-parallel throughput; (c)
   ``gpt_lm`` at head dim 256 (d_model 1024 over 4 heads) through
   ``run_workload``: the D=256 kernels' launches. (Phase 2c also holds the
   three kernels at D=256, ``FLASH_D256``, bf16, causal and not, with no
   mask and a padded kv_mask, with their gates and controls, timed beside
   SDPA; ``flash_attention`` at D=192 padded to 256 likewise; and the f32
   check kernels at 256, timed beside bf16.)
15. sequence parallelism (``T15_*``, ``phase_sp``): (a)
   ``sequence_parallel_attention`` of the ring, Ulysses and the all-gather
   at seq=2 in two gloo processes on this card (phase 14a's: its launch
   runs 15a's calls before its case and 15b's steps after it; the permute
   emulated by an all-reduce), gpt_small's heads, S=2048, B=2,
   bf16 and f32, causal and non-causal with a padded kv_mask, against the
   same call in one process (``TOL["sp/attn/*"]``, x 1.01 controls) with
   each call's flash launches counted (``T15_LAUNCHES``); (b) ``gpt_lm``'s
   ``long_context`` at gpt_small's width (S=8192, remat, bf16) at seq=2,
   the ring and Ulysses, 2 steps at a global batch of 2 (the preset's 8
   cut), against one process (the ring against dense attention, Ulysses
   against flash) with phase 14's gates (``TOL["sp/bf16/*"]``), each
   rank's step ms and peak memory printed. (Phase 2c also holds and times
   the flash kernels at the schedules' shapes, ``FLASH_SP``: all-gather's
   Sq=1024 against Sk=2048, non-causal and padded; Ulysses' S=8192
   causal.)
16. pipeline parallelism (``T16_*``, ``phase_pp``): (a) ``gpt_lm`` at
   gpt_small (S=1024, B=8, bf16, flash, fused LN+matmul with the pallas
   backward, adamw, dropout 0) at pipe=2 in two gloo processes on this
   card (phase 14a's, after its case: one launch of two ranks and one of
   four serve both phases), M=4 microbatches, one chunk a stage, 3 steps from the weights of
   one seed, against the dense model's same steps in one process with
   phase 14's gates and controls; (b) the same with two virtual chunks a
   stage (the interleaved schedule); (c) unfused at pipe=2 x model=2 in
   four processes; (d) one ``bert_pretrain`` step at bert_base (S=512,
   B=16, padded keys, the gathered MLM head, dropout 0) at data=2 x pipe=2
   on the same four; each rank's flash (and in a/b LN+matmul) launches
   equal to ``T16_LAUNCHES``, its step ms and peak GiB printed as
   gloo-on-one-card numbers; then the flash kernels at the microbatch
   shape (``T16_FLASH``) and the LN+matmul pair at its rows (``T16_LN``)
   against their plain versions and timed, the ``*_pipe`` rows below, and
   untimed at the path's other shapes (``T16_FLASH_CHECKS``: 16c's six
   local heads, 16d's padded BERT microbatch; ``T16_LN_CHECKS``: q, k and
   v's n=768).
17. print the ``kernels`` JSON line (twenty-four entries: ``ln_matmul`` is
   the serving forward at M=8, ``ln_matmul_train`` the tiled forward at
   M=8192; ``flash_*_d32`` and ``flash_*_d256`` the flash kernels'
   head_dim-32 and -256 instantiations; the ``*_pipe`` rows phase 16's
   shapes and launches), then the ``ok`` line last.

TF32 is off for every f32 product compared here
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import re
import subprocess
import sys
import time
import traceback
from unittest import mock

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,     # dense tensor-core bf16
            "float32": 67e12}       # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20

#: stated tolerances (atol, rtol) and why
TOL = {
    # same f32 arithmetic, other summation order over up to 1024 keys /
    # 768 features
    "paged_attention/float32": (5e-5, 5e-5),
    "ln_matmul/float32": (1e-4, 1e-4),
    # both versions round one f32 result to bf16 at the end (and
    # ln_matmul its normalised rows), so they may differ by one bf16 ulp:
    # 2^-8 relative
    "paged_attention/bfloat16": (1e-2, 2 ** -7),
    "ln_matmul/bfloat16": (1e-2, 2 ** -7),
    # flash kernels vs their plain versions: f32 — the same f32 math in
    # another summation order over up to 1024 keys; bf16 — both round p
    # and ds to bf16 before their products and each result once at the
    # end, so one bf16 ulp (2^-7 relative at worst) plus what a p or ds
    # rounded the other way moves a 1024-term sum
    # (the bf16 dK/dV kernel takes p as exp2(s*scale*log2(e) - lse*log2(e)),
    # the plain version exp(s*scale - lse): a rounding difference of a few
    # f32 ulps in p, far inside these)
    "flash/float32": (1e-4, 1e-4),
    "flash/bfloat16": (1e-2, 2 ** -7),
    "flash/lse": (1e-4, 1e-5),
    # lse beside that gate, relative L2 over the rows that attend a key
    # (a row that attends nothing holds NEG_INF on both sides): f32 on both
    # sides, the kernel's exp2 against the plain version's exp
    "flash/lse/rel_l2": 1e-5,
    # the backward kernels' dq, dk, dv beside that elementwise gate,
    # relative L2 over the whole output: at S=1024 causal the median |dk|
    # and |dv| are ~0.03 and a quarter of them lie under its atol, so a dk
    # 30% off passes it. On an H100 (PERF.md) the dK/dV kernel before its
    # redesign read at most 1.35e-4 against the plain version (bf16: p and
    # ds rounded to bf16 on either side of a tie) and 1.1e-7 (f32: another
    # summation order); the redesigned dQ kernel at most 1.0e-4 (the
    # first design 9.4e-5); a dk or a dq scaled by 1.01 (the printed
    # controls) reads 1.0e-2
    "flash/bwd/rel_l2/bfloat16": 1e-3,
    "flash/bwd/rel_l2/float32": 1e-5,
    # the forward's out beside the same elementwise gate, relative L2 over
    # the whole output: at S=1024 causal a late row averages hundreds of
    # values of v, so |out| is small next to that gate's atol of 1e-2 and an
    # out far off could pass it. On an H100 (PERF.md) PR 2's forward and
    # the redesigned one read alike against the plain version, at most
    # 1.31e-3 (bf16: out rounded once on either side of a tie, p rounded
    # against the running max, not the row's final one); f32 (PR 2's kernel
    # still) at most 1.75e-7; an out scaled by 1.01 (the printed control)
    # reads 1.01e-2
    "flash/fwd/rel_l2/bfloat16": 3e-3,
    "flash/fwd/rel_l2/float32": 1e-5,
    # the serving LN+matmul forward's y beside its elementwise gate,
    # relative L2 over the whole output, keyed by x's dtype (bf16 covers
    # both the bf16 and the f32 output): |y| is ~0.5 at gpt_small's widths,
    # so the atol of 1e-2 passes a y 2% off. On an H100 (PERF.md) the
    # redesigned kernel read at most 1.8e-4 with a bf16 y and 2.8e-4 with an
    # f32 y from bf16 x (an h on a rounding tie falls the other way), 4.2e-7
    # in f32 (another summation order); a y scaled by 1.01 (the printed
    # control) reads 1.0e-2
    "ln_matmul/rel_l2/bfloat16": 1e-3,
    "ln_matmul/rel_l2/float32": 1e-5,
    # paged attention's output beside its elementwise gate, relative L2
    # over the whole output: a decode row averages up to 1000 values of v,
    # so |out| is ~0.03 next to that gate's atol of 1e-2 (bf16), and an out
    # far off could pass it. Both versions take P in f32 (the kernel as a
    # bf16 high part and residual) and round the output once, so an out
    # rounded to the other side of a tie (bf16) or summation order (f32) is
    # the whole difference. On an H100 (PERF.md) the redesigned kernel read
    # at most 8.1e-5 (bf16) and 5.0e-7 (f32) at phase 2a's shapes; an out
    # scaled by 1.01 (the printed control) reads 1.0e-2
    "paged_attention/rel_l2/bfloat16": 1e-3,
    "paged_attention/rel_l2/float32": 1e-5,
    # gpt_lm training, flash pass vs dense pass (bf16 model): the two
    # attention paths round p to bf16 at other points (online vs final
    # max), and the difference runs through 12 layers forward and back.
    # Step-1 gradient: relative L2 error per parameter; per-step loss:
    # absolute (a mean over 8k tokens of ~10.8 nats)
    "train/grad_rel_l2": 5e-2,
    "train/loss": 2e-2,
    # gpt_lm with fused_ln_matmul (phase 5b), bf16, against phase 5's
    # unfused flash pass: the kernel's two-pass LayerNorm variance against
    # flax's fast one, and the normalised rows rounded to bf16 inside the
    # kernel, move each layer's input by rounding, carried through 12
    # layers forward and back — the same kind of difference as flash vs
    # dense, so flash vs dense's gradient limit and a few times the loss
    # difference measured on an H100 (PERF.md); pallas vs xla: the same
    # forward, the backward kernels' sums in another order than cuBLAS's
    # (dx rounded to bf16 once on each side)
    "train/fused/loss": 5e-3,                 # measured 1.34e-3
    "train/fused/grad_rel_l2": 5e-2,          # 1.57e-2
    "train/fused/bwd/grad_rel_l2": 2.5e-2,    # 8.44e-3
    # one f32 step, fused + pallas vs unfused (flash both): f32 rounding
    # only (LayerNorm variance formula, summation orders) through 12
    # layers, where a kernel fault would show: ~10x what was measured
    "train/f32/loss": 1e-5,                   # 9.5e-7
    "train/f32/grad_rel_l2": 3e-5,            # 3.27e-6
    # bert_pretrain's eval, flash vs dense on the same random weights in
    # f32 (phase 8, bert_eval_same_weights), per eval batch of 32 x 77
    # predictions: the relative difference of the evaluator's loss_sum,
    # and the relative L2 of the eval forward's gathered logits. In bf16
    # the two paths' rounding alone moves the logits by 1.21e-2 relative
    # L2 and the loss_sum by up to 1.18e-5, more than the x1.01 control
    # (1.47e-2 and 6.9e-6..1.8e-5 with that rounding in): no limit there
    # can fail a wrong forward (PERF.md). In f32, measured on an H100:
    # loss_sum 0 or 7.6e-8 (one f32 ulp of a sum near 25800), logits
    # 1.58e-6; the control 4.2e-6..8.6e-6 and 5.24e-3. The limits, about
    # 13x the readings, must be exceeded by the control
    "bert/eval/loss_sum": 1e-6,
    "bert/eval/logits": 2e-5,
    # f32 logits of the bf16 model, kernel path vs the gather path with no
    # kernel: one-ulp bf16 differences in attention / LN+matmul outputs,
    # carried through 12 residual layers (logits of random weights have
    # std ~0.5)
    "logits": 5e-2,
    # fused 1x1 conv + BN kernels vs their plain versions. Elementwise
    # outputs (y, dx): f32 — the same f32 math in another summation order
    # over up to 2048 channels; bf16 — both round one f32 result (and h, g
    # before the products) to bf16, so one ulp (2^-7 relative at worst).
    # Reductions over M (the statistics, dw, dscale, dshift: up to 802816
    # rows), relative L2 error: f32 — f32 sums in another order; bf16 —
    # an h or g rounded to bf16 on the other side of a tie (the kernel
    # fuses x*scale+shift into one FMA) moves a term by one ulp
    # LN+matmul backward kernels vs their plain versions. dx: f32 — the
    # same f32 math in another summation order over up to 3072 columns of
    # dy; bf16 — both round one f32 result to bf16, so one ulp (2^-7
    # relative at worst; atol for values near 0, where the f32 results
    # differ by ~1e-6). Sums over M (dgamma, dbeta, dbias over 8192 rows;
    # dw, then rounded to w's dtype), relative L2: f32 — another order;
    # bf16 — dw rounded to bf16 once from sums taken in another order (a
    # value near a rounding tie lands one ulp, 2^-8, away) and an h on a tie
    # rounded the other way (the kernel fuses xhat*gamma+beta into one FMA)
    "ln_bwd/float32": (1e-4, 1e-4),
    "ln_bwd/bfloat16": (1e-3, 2 ** -7),
    "ln_bwd/reduction/float32": 1e-5,
    "ln_bwd/reduction/bfloat16": 2e-3,
    "conv_bn/float32": (1e-4, 1e-4),
    "conv_bn/bfloat16": (1e-2, 2 ** -7),
    "conv_bn/reduction/float32": 1e-5,
    "conv_bn/reduction/bfloat16": 2e-3,
    # conv+BN dx (both backward kernels' dx) beside its elementwise gate,
    # relative L2 over the whole output: dy is scaled by 1/sqrt(M), so dx
    # is small next to that gate's atol and a dx off by a share of every
    # value (or one missing stage of cout) passes it. On an H100 (PERF.md)
    # the kernels read at most 7.7e-7 (f32: another summation order) and
    # 1.04e-4 (bf16: a few roundings flipped near ties); one extra bf16
    # rounding of dh before the epilogue (the printed control) reads
    # 2.8e-3, a 30% error 0.3 and a dropped 64-deep stage of cout ~0.35
    "conv_bn/dx/float32": 1e-5,
    "conv_bn/dx/bfloat16": 1e-3,
    # conv+BN forward's y beside its elementwise gate, relative L2 over the
    # whole output, as for dx: the elementwise atol of 1e-2 lets a y off by
    # a share of every small value pass. Both versions round h identically
    # and y once from f32 sums taken in another order, so a y rounded to the
    # other side of a tie is the whole difference (bf16), or summation order
    # alone (f32). On an H100 (PERF.md) the redesigned forward read at most
    # 1.03e-4 (bf16) and 0 (f32); a y scaled by 1.01 (the printed control,
    # which must fail the gate) reads 1.0e-2
    "conv_bn/fwd/rel_l2/float32": 1e-5,
    "conv_bn/fwd/rel_l2/bfloat16": 1e-3,
    # resnet50_imagenet training, B=256, every pass from the same weights
    # with non-zero bn3 scales (RESNET_BN3_SCALE). A step-1 gradient of
    # this 50-layer net at init is exponentially sensitive to rounding:
    # each BatchNorm backward cancels most of its input gradient and passes
    # on what rounding left, so summation order alone moves the f32
    # gradients by a median 7.4e-3 and bf16 rounding moves the bf16
    # standard model's gradients by a median 0.46 from the f32 one (on an
    # H100, PERF.md; each limit below stands beside what was measured
    # there). So:
    # - f32, one step, fused + pallas (all four kernels) vs standard:
    #   gradients per parameter (relative L2) within a few times that f32
    #   floor; the loss and the BN statistics' step-1 update (the forward
    #   alone) within a few times f32 summation order;
    "resnet/f32/loss": 1e-5,                  # measured 0
    "resnet/f32/bn_update": 1e-4,             # 3.1e-5
    "resnet/f32/grad_rel_l2": 4e-2,           # 1.06e-2
    "resnet/f32/grad_rel_l2/median": 2.5e-2,  # 7.4e-3
    # - bf16, each kernel pass vs the standard pass (BatchNorm applied as
    #   x*scale+shift vs (x-mean)*mul+bias, the residual added in f32 vs
    #   bf16, 1x1 products summed in another order): the step-1 loss and
    #   BN update (the forward alone) within a few ulps' worth, the
    #   per-step loss over 6 steps (absolute, ~7 nats) a few times what
    #   diverging trajectories measured; the step-1 gradients' median
    #   distance to the f32 standard model at most 1.2x the bf16 standard
    #   model's — no noisier than the model with no kernel;
    "resnet/loss/step1": 3e-4,                # 6.5e-5
    "resnet/loss": 5e-3,                      # 1.03e-3
    "resnet/bn_update": 1e-2,                 # 2.8e-3
    "resnet/grad_vs_f32": 1.2,                # 0.99 (0.452 vs 0.457)
    # - bf16, pallas vs xla: the same forward, so the backward kernels
    #   against the plain math alone, worst and median
    "resnet/grad_rel_l2/bwd": 6e-2,           # 1.89e-2
    "resnet/grad_rel_l2/bwd/median": 3e-2,    # 8.6e-3
    # phase 7b: rank 0 of one data-parallel step (two processes, 32 images
    # each, BN statistics and gradients all-reduced) against one process on
    # the same 64 images, from the same weights: the loss, the running
    # statistics' update (relative L2, the worst buffer) and the
    # parameters' updates (relative L2 per parameter: the worst and the
    # median). The ranks sum their BN columns and gradients in another
    # order, and cuDNN may pick other algorithms at 32 images than at 64.
    # f32: the loss and the BN update as phase 6's f32 gates; the updates
    # as phase 6's f32 step-1 gradients ("resnet/f32/grad_rel_l2"): f32
    # rounding moves a ResNet-50 step-1 gradient by ~1e-2 relative (a ReLU
    # input within rounding of 0 falls on the other side; BN over few rows
    # amplifies it). The control — the same step on rank 0's half alone —
    # must read 10x past the BN limit
    # phase 14: tensor / fully-sharded data parallelism, gloo ranks on this
    # card against one process on the global batches, bf16, from the same
    # weights: the losses as a relative difference (control: the ranks'
    # losses x 1.01 must fail), each parameter's update over the steps as
    # relative L2 (the worst and the median; the attention's key bias left
    # out: its gradient is 0 in exact arithmetic, so each run moves it by
    # normalised rounding alone). The ranks' row-parallel products are
    # rounded to bf16 before their sum, one process's after it. Control:
    # the one-process steps on the first half of each global batch must
    # fail the median
    "tp/bf16/loss": 2e-3,
    "tp/bf16/worst": 1.0,
    "tp/bf16/median": 0.2,
    # phase 15a: sequence_parallel_attention on two gloo ranks at seq=2
    # against the same call in one process, relative L2 over the whole
    # tensor. The ring folds two key chunks with the online-softmax merge
    # where one process folds one (f32 either way); the all-gather's dK and
    # dV are each rank's partial sums, rounded to the dtype before the
    # reduce-scatter adds them (one process rounds once); Ulysses runs the
    # same kernel on the same (b, h) slices. bf16: one ulp of a term in a
    # sum of two; the x 1.01 controls read 1e-2 and must fail
    "sp/attn/fwd/bfloat16": 3e-3,
    "sp/attn/bwd/bfloat16": 5e-3,
    "sp/attn/fwd/float32": 1e-5,
    "sp/attn/bwd/float32": 1e-5,
    # phase 15b: the long_context steps on two ranks against one process, as
    # phase 14's (the ring's f32 fold against the dense reference, whose
    # probabilities are rounded to bf16 before the value product; Ulysses
    # against the same flash kernels): the same limits and controls
    "sp/bf16/loss": 2e-3,
    "sp/bf16/worst": 1.0,
    "sp/bf16/median": 0.2,
    "dp/f32/loss": 1e-4,                      # measured 0
    "dp/f32/bn": 1e-3,                        # 1.42e-5
    "dp/f32/worst": 4e-2,                     # 8.93e-3
    "dp/f32/median": 2.5e-2,                  # 6.33e-3
    # bf16: the loss and the BN update as phase 6's bf16 gates
    # ("resnet/loss", "resnet/bn_update"); the parameters' updates, whose
    # step-1 gradients bf16 rounding dominates (phase 6), held to the f32
    # one-process step's no further than the one-process bf16 step's
    # ("resnet/grad_vs_f32")
    "dp/bf16/loss": 5e-3,                     # 5.89e-4
    "dp/bf16/bn": 1e-2,                       # 4.28e-3
    "dp/bf16/vs_f32": 1.2,                    # 0.99 (0.459 vs 0.463)
    # phase 11a: one f32 wide_deep step on the card vs the same step on the
    # CPU (same weights, same batch): other summation orders in the MLP
    # products and the embedding backward; the loss as a relative
    # difference, each parameter's update as relative L2 error. A table's
    # update is led by its hottest rows (a Zipf head id and the clipped
    # tail, hundreds of rows each at batch 2048), whose gradient is a sum
    # of hundreds of terms that largely cancel, so the order shows at
    # ~1e-4 there. The update x 1.01 control reads 1e-2 and must fail
    "wd/f32/loss": 1e-5,                      # 6.45e-8 measured on an H100 at 700 W
    "wd/f32/update": 1e-3,                    # 8.58e-5 (table_2)
    # phase 11b: two ranks at model=2 vs one process at model=1, f32: the
    # only difference allowed is the order in which a table shard's
    # embedding backward sums duplicate ids (a shard also sums the zero
    # rows of the ids it does not own), so the same bounds
    "wd/dp/loss": 1e-5,                       # 0 measured: bitwise
    "wd/dp/update": 1e-3,                     # 0
    # phase 12a: one f32 step of mnist_mlp / cifar10_cnn on the card vs the
    # same step on the CPU (same weights, same batch of 64, TF32 off,
    # deterministic cuDNN): the products and convolutions summed in another
    # order; the loss as a relative difference, each parameter's and
    # BatchNorm buffer's update as relative L2 error. The update x 1.01
    # control reads 1e-2 and must fail
    "small/f32/loss": 1e-5,                   # measured 9.7e-8 on an H100 at 700 W
    "small/f32/update": 1e-3,                 # 1.6e-6 (mnist_mlp dense_1.weight)
    # ... except a convolution bias under BatchNorm, whose gradient is zero
    # in exact arithmetic: its update (lr x rounding noise) is held
    # absolutely; the weights' updates are ~1e-2 in size
    "small/f32/zero_grad": 1e-6,
}

REPO = os.path.dirname(os.path.abspath(__file__))

#: where the tensors go (a rehearsal on the CPU may point this elsewhere)
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


#: (seconds since the line before, that line) for every line ``log``
#: printed: where the run's time went, in its summary
LOG_GAPS: list[tuple[float, str]] = []
_LAST_LOG = [time.perf_counter(), "(start)"]


def log(msg: str = "") -> None:
    now = time.perf_counter()
    LOG_GAPS.append((now - _LAST_LOG[0], _LAST_LOG[1]))
    _LAST_LOG[:] = [now, msg]
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


#: spin-kernel launches that open each profiler trace of ``cuda_ms``, and
#: the pad records that traces kept, of those launched
PAD_LAUNCHES = 4
PAD_RECORDS = [0, 0]
#: traces ``cuda_ms`` may take beyond its ``traces`` while the fullest trace
#: of a kernel still lacks more than a tenth of its records
EXTRA_TRACES = 3
#: traces ``cuda_ms`` may retake, a pause apart, when one recorded no device
#: record but its spin pads (CUPTI delivered nothing), and the count of
#: such traces over the run
BLANK_RETAKES, BLANK_PAUSE_S = 4, 0.1
BLANK_TRACES = [0]


def cuda_ms(torch, fns, iters: int = 50, warmup: int = 5, traces: int = 3,
            launches: dict | None = None) -> dict:
    """Time one call, cycling through ``fns`` (closures over independent
    input sets, together larger than L2, so each call finds its inputs
    cold as the serve path does). Returns ``device_ms``: the device time
    of every kernel the calls launched, per call, from ``torch.profiler``
    (CUPTI, ``traces`` traces of ``iters`` calls, the device activity
    alone: the host's operators are not recorded, which halves the
    trace's processing) — the kernel's own time, free of the Python
    wrapper's host overhead; ``by_name``: that device
    time split by kernel name; and ``call_ms``: CUDA events around the
    back-to-back calls, per call, which includes the host time between
    launches whenever that exceeds the device time.

    CUPTI drops records: on an H100 a trace loses up to two of its first
    device records (PERF.md §6), so each trace starts with ``PAD_LAUNCHES``
    launches of torch's spin kernel, left out of the times and tallied in
    ``PAD_RECORDS``. A kernel's time a call is its mean record, from the
    trace that holds the most of its records, times its launches a call.
    Those launches are ``launches[part]`` for the kernels whose names hold
    a key ``part`` of ``launches`` (the caller's count), else the most
    records of any trace over ``iters``, rounded up. Every shortfall is
    logged; while one is of more than a tenth of a kernel's records, up to
    ``EXTRA_TRACES`` more traces are taken, and one left after them fails
    the run. A trace that holds no device record but its pads is blank:
    CUPTI now and then delivers nothing for a whole trace, so a blank
    trace is retaken (up to ``BLANK_RETAKES`` times, tallied in
    ``BLANK_TRACES``) and counts for nothing. If every trace was blank,
    a call timed for its total alone (no ``launches``) takes ``call_ms``,
    the CUDA events' time, as its device time, logged so, with an empty
    ``by_name``; one timed for its kernels fails the run."""
    call_ms = event_ms(torch, fns, iters, warmup)
    act = torch.profiler.ProfilerActivity
    launches = launches or {}
    most = {}  # kernel name -> (records, ms) of the trace with the most records of it

    def shortfalls():
        by_name, short = {}, []
        for k, (n, ms) in most.items():
            each = next((c for part, c in launches.items() if part in k), -(-n // iters))
            by_name[k] = ms / n * each
            if n != each * iters:  # more than the caller's count is a shortfall of the count
                short.append((k[:60], n, each * iters))
        return by_name, short, [k for k, n, want in short if 10 * abs(want - n) > want]

    def missing():
        return [part for part in launches if not any(part in k for k in most)]

    taken = blank = 0
    while taken < traces or (taken < traces + EXTRA_TRACES and (shortfalls()[2] or missing())):
        with torch.profiler.profile(activities=[act.CUDA]) as prof:
            for _ in range(PAD_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        PAD_RECORDS[1] += PAD_LAUNCHES
        events = device_events(torch, prof)
        PAD_RECORDS[0] += sum(e.count for e in events if "spin_kernel" in e.key)
        events = [e for e in events if "spin_kernel" not in e.key]
        if not events:
            blank += 1
            BLANK_TRACES[0] += 1
            if blank > BLANK_RETAKES:
                break
            time.sleep(BLANK_PAUSE_S)
            continue
        taken += 1
        for e in events:
            if e.count > most.get(e.key, (0, 0.0))[0]:
                most[e.key] = (e.count, e.self_device_time_total / 1e3)
    if blank:
        log(f"    ({blank} blank profiler traces; {taken} traces hold device records)")
    if not most and not launches:
        log(f"    (torch.profiler recorded no device time in {blank} traces: device time from "
            f"CUDA events, {call_ms:.5f} ms a call)")
        return {"device_ms": call_ms, "by_name": {}, "call_ms": call_ms}
    for part in launches:
        if not any(part in k for k in most):
            raise SmokeFailure(f"torch.profiler recorded no launch of {part} in {taken} traces")
    by_name, short, bad = shortfalls()
    if short:
        log(f"    (records in the fullest of {taken} traces: "
            f"{'; '.join(f'{k} {n} of {want}' for k, n, want in short)})")
    if bad:
        raise SmokeFailure(f"torch.profiler lost more than a tenth of the records of {bad}")
    if sum(by_name.values()) <= 0:
        raise SmokeFailure(f"torch.profiler recorded no device time in {taken} traces")
    return {"device_ms": sum(by_name.values()), "by_name": by_name, "call_ms": call_ms}


def event_ms(torch, fns, iters: int = 20, warmup: int = 5) -> float:
    """CUDA events around ``iters`` back-to-back calls cycling through
    ``fns``, per call (after ``warmup`` calls): device time whenever the
    calls are device-bound, as every LN+matmul call at M=8192 is."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


#: calls over which ``plain_time`` times a plain version
PLAIN_ITERS = 10


def plain_time(torch, fns) -> dict:
    """A plain PyTorch version's time a call (``device_ms``), by CUDA
    events over ``PLAIN_ITERS`` calls (``event_ms``): the plain versions
    are device-bound yardsticks at 10–100x their kernels' time. Profiled,
    50 calls in three traces of flash's plain forward took 1.7 s of a 7.4
    s ``time_flash`` at gpt_small's shape, and over 10 calls CUPTI's lost
    records could pass a tenth of a kernel's, which fails ``cuda_ms``
    (NVIDIA H100 80GB HBM3, 700 W)."""
    return {"device_ms": event_ms(torch, fns, PLAIN_ITERS, warmup=2)}


def device_events(torch, prof):
    """The profiler's device-side entries (kernels, copies, memsets).
    The CPU-side operator entries carry their kernels' device time too,
    and so do the device-side ranges of annotations such as
    ``Optimizer.step#AdamW.step``, so summing every entry would count it
    twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages()
            if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]


def copies_for(nbytes: int) -> int:
    """Input sets to cycle so that together they exceed twice the L2."""
    return max(1, -(-2 * L2_BYTES // max(nbytes, 1)))


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in f32."""
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def state_of(torch, model) -> dict:
    """The model's parameters and buffers, f32 on the host."""
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items()}


def update_errs(torch, got: dict, want: dict, init: dict) -> tuple[float, str]:
    """The worst relative L2 error of a parameter's update, and its name."""
    return max((rel_l2(got[k] - init[k], want[k] - init[k]), k) for k in want)


def check_close(torch, name, got, want, tol) -> float:
    atol, rtol = tol
    if not torch.isfinite(got.float()).all():
        raise SmokeFailure(f"{name}: non-finite kernel output")
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    bad = int((err > lim).sum())
    max_abs = float(err.max()) if err.numel() else 0.0
    rel = float((err / want.float().abs().clamp_min(1e-6)).max()) if err.numel() else 0.0
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={rel:.3e} "
        f"tol=(atol {atol:g}, rtol {rtol:g}) {'OK' if not bad else f'{bad} FAIL'}")
    if bad:
        raise SmokeFailure(f"{name}: {bad} elements outside tolerance")
    return max_abs


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def paged_case(torch, np, rng, kind, dtype, H=12, D=64, bs=16, MB=64):
    """Inputs for one paged-attention case. Tables are non-contiguous
    random block ids with sentinel tails; the cases carry an idle row
    (all-sentinel table, past-the-table q_pos) and padded rows
    (q_pos = -1) as the serve path and the JAX tests do."""
    oob = MB * bs
    if kind == "decode":            # B=8 slots, S=1, ragged contexts 1..1000
        B, S = 8, 1
        ctx = rng.integers(1, 1001, size=B)
        ctx[0], ctx[1] = 1000, 1
        rows = [("live", [c - 1]) for c in ctx[:6]] + [("idle", None), ("live", [-1])]
        nblk = [-(-int(c) // bs) for c in ctx[:6]] + [0, 4]
    elif kind == "serve_decode":    # the serve pass's decode: 4 slots, contexts 48..932
        B, S = 4, 1
        ctx = rng.integers(48, 933, size=B)
        rows = [("live", [c - 1]) for c in ctx]
        nblk = [-(-int(c) // bs) for c in ctx]
    elif kind == "prefill":         # one chunk of 64 at positions 500..553, 10 padded
        B, S = 1, 64
        pos = list(range(500, 554)) + [-1] * 10
        rows = [("live", pos)]
        nblk = [-(-554 // bs)]
    else:                           # verify: 4 slots, S = K+1 = 5
        B, S = 4, 5
        rows = [("live", list(range(300, 305))), ("live", list(range(17, 20)) + [oob, oob]),
                ("idle", None), ("live", list(range(990, 995)))]
        nblk = [-(-305 // bs), 2, 0, -(-995 // bs)]
    NB = sum(nblk) + 8
    perm = rng.permutation(NB)
    table = np.full((B, MB), NB, np.int32)
    q_pos = np.full((B, S), oob, np.int32)
    used = 0
    for b, ((state, pos), n) in enumerate(zip(rows, nblk)):
        table[b, :n] = perm[used: used + n]
        used += n
        if state == "live":
            q_pos[b, :len(pos)] = pos
    dev = DEVICE
    mk = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
    return dict(q=mk(B, H, S, D), k_pool=mk(NB, H, bs, D), v_pool=mk(NB, H, bs, D),
                block_table=torch.from_numpy(table).to(dev),
                q_pos=torch.from_numpy(q_pos).to(dev))


#: phase 2a's cases, each checked in both dtypes and timed in bf16: decode
#: (8 slots, ragged contexts, an idle and a padded slot), a 64-row prefill
#: chunk, speculative verify (S=5), the serve pass's decode (4 slots)
PAGED_KINDS = ("decode", "prefill", "verify", "serve_decode")


def check_paged_out(torch, name, got, want, dn) -> float:
    """The paged kernel's output against the plain version: elementwise
    within ``TOL["paged_attention/<dn>"]`` and relative L2 within
    ``TOL["paged_attention/rel_l2/<dn>"]``, beside an output scaled by
    1.01 that the relative-L2 gate must fail (the run fails otherwise)."""
    err = check_close(torch, name, got, want, TOL[f"paged_attention/{dn}"])
    lim, l2 = TOL[f"paged_attention/rel_l2/{dn}"], rel_l2(got, want)
    control = rel_l2(got.float() * 1.01, want)
    log(f"    {name}: rel_l2={l2:.3e} (limit {lim:g}; out x 1.01 reads {control:.3e})")
    if l2 > lim:
        raise SmokeFailure(f"{name}: relative L2 error {l2:.3e} over {lim:g}")
    if control <= lim:
        raise SmokeFailure(f"{name}: the relative-L2 gate passes an output scaled by 1.01")
    return err


def paged_bound_ms(case, dtype_name) -> tuple[float, str]:
    """Least time for the work these inputs need: K/V of every attended
    position read once, q/table/positions read and the output written
    once; 4*D operations per (query, attended key) pair per head."""
    q, kp = case["q"], case["k_pool"]
    B, H, S, D = q.shape
    bs = kp.shape[2]
    MB = case["block_table"].shape[1]
    pos = case["q_pos"].long().cpu()
    attended = (pos + 1).clamp(0, MB * bs)            # [B,S]
    ctx = attended.max(dim=1).values                  # positions row b reads
    esz = q.element_size()
    nbytes = (2 * H * int(ctx.sum()) * D * esz + 2 * q.numel() * esz
              + case["block_table"].numel() * 4 + case["q_pos"].numel() * 4)
    ops = 4 * H * D * int(attended.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ln_case(torch, np, rng, M, d, n, dtype, linear_layout=True):
    dev = DEVICE
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev)
    w_nd = (0.02 * f(n, d)).to(dtype)  # nn.Linear weight [n, d]
    return dict(x=f(M, d).to(dtype), gamma=1 + 0.1 * f(d), beta=0.1 * f(d),
                w=w_nd.t() if linear_layout else w_nd.t().contiguous(),
                bias=0.02 * f(n))


def ln_bound_ms(c, dtype_name) -> tuple[float, str]:
    M, d = c["x"].shape
    n = c["w"].shape[1]
    esz = c["x"].element_size()
    nbytes = esz * (M * d + d * n + M * n) + 4 * (2 * d + n)
    ops = 2 * M * d * n + 8 * M * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(torch, np, F):
    from distributed_tensorflow_tpu_torch.ops import attention as att
    from distributed_tensorflow_tpu_torch.ops.fused_ln_matmul import (
        ln_matmul, ln_matmul_plain)
    from distributed_tensorflow_tpu_torch.ops.paged_attention import (
        paged_attention_plain, paged_flash_attention)

    rng = np.random.default_rng(0)
    results = {"paged_attention": {"err": 0.0, "rows": []},
               "ln_matmul": {"err": 0.0, "rows": []}}
    log("tolerances (atol, rtol): f32 kernel vs plain — same f32 math in another "
        "summation order; bf16 — both round one f32 result (ln_matmul also its "
        "normalised rows) to bf16, so they may differ by one bf16 ulp (2^-8 "
        f"relative): {TOL}")
    log("phase 2a: paged attention kernel vs plain version "
        "(H=12, D=64, bs=16, MB=64)")
    for kind in PAGED_KINDS:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            c = paged_case(torch, np, rng, kind, dtype)
            kw = dict(q_pos=c["q_pos"])
            args = (c["q"], c["k_pool"], c["v_pool"], c["block_table"])
            got = paged_flash_attention(*args, **kw)
            want = paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            name = f"paged_attention/{kind}/{dn} B={c['q'].shape[0]} S={c['q'].shape[2]}"
            err = check_paged_out(torch, name, got, want, dn)
            results["paged_attention"]["err"] = max(results["paged_attention"]["err"], err)
            if not torch.equal(got, paged_flash_attention(*args, **kw)):
                raise SmokeFailure(f"{name}: a second call is not bitwise equal")
            if dtype != torch.bfloat16:
                continue
            # timing on cold inputs: independent copies of the pools
            nbytes = 2 * c["k_pool"].numel() * c["k_pool"].element_size()
            sets = [c] + [dict(c, k_pool=c["k_pool"].clone(), v_pool=c["v_pool"].clone())
                          for _ in range(copies_for(nbytes) - 1)]
            kern = [lambda s=s: paged_flash_attention(
                s["q"], s["k_pool"], s["v_pool"], s["block_table"], q_pos=s["q_pos"])
                for s in sets]
            plain = [lambda s=s: paged_attention_plain(
                s["q"], s["k_pool"], s["v_pool"], s["block_table"], q_pos=s["q_pos"])
                for s in sets]
            # library yardstick: SDPA over the gathered K/V, timed only
            lib_in = []
            for s in sets:
                kg = att.paged_gather_kv(s["k_pool"], s["block_table"])
                vg = att.paged_gather_kv(s["v_pool"], s["block_table"])
                M = kg.shape[2]
                mask = (torch.arange(M, device=DEVICE)[None, None, :]
                        <= s["q_pos"].long()[:, :, None])[:, None]
                lib_in.append((s["q"], kg, vg, mask))
            lib = [lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3])
                   for a in lib_in]
            before = paged_flash_attention.launches
            tk, tp, tl = (cuda_ms(torch, f) for f in (kern, plain, lib))
            row = dict(case=kind, B=c["q"].shape[0], S=c["q"].shape[2],
                       ms=tk["device_ms"], plain_ms=tp["device_ms"],
                       library_ms=tl["device_ms"], call_ms=tk["call_ms"])
            paged_flash_attention.launches = before  # comparison launches do not count
            row["bound_ms"], row["bound_by"] = paged_bound_ms(c, dn)
            results["paged_attention"]["rows"].append(row)
            log(f"    {kind} bf16: kernel_ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
                f"library_ms={row['library_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
                f"({row['bound_by']}); wrapper call_ms={row['call_ms']:.4f}")

    # how the time grows with the context: one batch row (12 heads) at
    # 128 keys and at 1024
    step_ms = []
    for ctx in (128, 1024):
        c = paged_case(torch, np, rng, "decode", torch.bfloat16)
        c["q"], c["block_table"] = c["q"][:1], c["block_table"][:1]
        c["q_pos"] = torch.full((1, 1), ctx - 1, dtype=torch.int32, device=DEVICE)
        c["block_table"][0, :ctx // 16] = torch.arange(ctx // 16, device=DEVICE)
        before = paged_flash_attention.launches
        step_ms.append(cuda_ms(torch, [lambda c=c: paged_flash_attention(
            c["q"], c["k_pool"], c["v_pool"], c["block_table"], q_pos=c["q_pos"])])["device_ms"])
        paged_flash_attention.launches = before
    log(f"    one batch row, context 128 vs 1024 keys: {step_ms[0]:.5f} vs "
        f"{step_ms[1]:.5f} ms")

    log("phase 2b: ln_matmul serving kernel vs plain version (d=768)")
    #: x dtype, out dtype, w layouts: the three entries, bf16 in both layouts
    entries = ((torch.bfloat16, torch.bfloat16, (True, False)),
               (torch.bfloat16, torch.float32, (True,)), (torch.float32, torch.float32, (True,)))
    for n in (768, 3072):
        for M in LN_SERVE_M:
            for dtype, out_dtype, layouts in entries:
                dn, on = (str(t).split(".")[-1] for t in (dtype, out_dtype))
                for linear_layout in layouts:
                    c = ln_case(torch, np, rng, M, 768, n, dtype, linear_layout)
                    args = (c["x"], c["gamma"], c["beta"], c["w"], c["bias"])
                    got = ln_matmul(*args, out_dtype=out_dtype)
                    want = ln_matmul_plain(*args, out_dtype=out_dtype)
                    torch.cuda.synchronize()
                    lay = "w=linear.weight.t()" if linear_layout else "w contiguous [d,n]"
                    err = check_ln_y(torch, f"ln_matmul/{dn}->{on} M={M} n={n} {lay}", got,
                                     want, dn)
                    results["ln_matmul"]["err"] = max(results["ln_matmul"]["err"], err)
                    if not torch.equal(got, ln_matmul(*args, out_dtype=out_dtype)):
                        raise SmokeFailure(f"ln_matmul/{dn}->{on} M={M} n={n} {lay}: a second "
                                           f"call is not bitwise equal")
                if (dtype, out_dtype) != (torch.bfloat16, torch.bfloat16):
                    continue
                nbytes = c["w"].numel() * c["w"].element_size()
                sets = [ln_case(torch, np, rng, M, 768, n, dtype)
                        for _ in range(copies_for(nbytes))]
                kern = [lambda s=s: ln_matmul(s["x"], s["gamma"], s["beta"], s["w"], s["bias"])
                        for s in sets]
                plain = [lambda s=s: ln_matmul_plain(s["x"], s["gamma"], s["beta"], s["w"],
                                                     s["bias"]) for s in sets]
                lib_in = [(s["x"], s["gamma"].to(dtype), s["beta"].to(dtype),
                           s["w"].t(), s["bias"].to(dtype)) for s in sets]
                lib = [lambda a=a: F.linear(F.layer_norm(a[0], (768,), a[1], a[2], 1e-6),
                                            a[3], a[4]) for a in lib_in]
                before = ln_matmul.launches
                tk, tp, tl = (cuda_ms(torch, f) for f in (kern, plain, lib))
                row = dict(M=M, n=n, ms=tk["device_ms"], plain_ms=tp["device_ms"],
                           library_ms=tl["device_ms"], call_ms=tk["call_ms"])
                ln_matmul.launches = before
                row["bound_ms"], row["bound_by"] = ln_bound_ms(sets[0], dn)
                results["ln_matmul"]["rows"].append(row)
                log(f"    M={M} n={n} bf16: kernel_ms={row['ms']:.5f} "
                    f"plain_ms={row['plain_ms']:.5f} library_ms={row['library_ms']:.5f} "
                    f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}); "
                    f"wrapper call_ms={row['call_ms']:.4f}")
    results["ln_matmul"]["crossover"] = ln_crossover(torch, np, rng)
    return results


#: rows of phase 2b's serving checks and timings: decode at 1, 4 (the
#: serve pass's slots) and 8 slots, prefill chunks of 40 and 64 rows
LN_SERVE_M = (1, 4, 8, 40, 64)


def check_ln_y(torch, name, got, want, dn) -> float:
    """The serving forward's y against the plain version: elementwise within
    ``TOL["ln_matmul/<dn>"]`` and relative L2 within
    ``TOL["ln_matmul/rel_l2/<dn>"]`` (dn: x's dtype), beside a y scaled by
    1.01 that the relative-L2 gate must fail (the run fails otherwise)."""
    err = check_close(torch, name, got, want, TOL[f"ln_matmul/{dn}"])
    lim, l2 = TOL[f"ln_matmul/rel_l2/{dn}"], rel_l2(got, want)
    control = rel_l2(got.float() * 1.01, want)
    log(f"    {name}: rel_l2={l2:.3e} (limit {lim:g}; y x 1.01 reads {control:.3e})")
    if l2 > lim:
        raise SmokeFailure(f"{name}: relative L2 error {l2:.3e} over {lim:g}")
    if control <= lim:
        raise SmokeFailure(f"{name}: the relative-L2 gate passes a y scaled by 1.01")
    return err


#: rows at which phase 2b times the row-tile forward against the tiled
#: pair (n=3072, bf16): the evidence for fwd_plan's LN_TILED_MIN_M
LN_CROSSOVER_M = (64, 128, 160, 192, 256, 1024, 8192)
#: the forward's kernels, by the device name the profiler gives each
LN_FWD_ROWS_KERNEL = "ln_matmul_kernel"
LN_FWD_PARTS = {"stats": "ln_stats_kernel", "product": "ln_matmul_tiled_kernel"}


def ln_crossover(torch, np, rng) -> dict:
    """At each ``LN_CROSSOVER_M`` (n=3072, bf16, cold inputs) ``ln_matmul``
    as a caller gets it, its route read from the profiler's kernel names
    (the row-tile kernel below ``LN_TILED_MIN_M`` rows, the tiled pair from
    there; also checked one row below the threshold), beside the other
    route, forced. Returns M -> device ms of (the row-tile
    kernel, the tiled pair)."""
    from distributed_tensorflow_tpu_torch.ops import fused_ln_matmul as fln

    before = (fln.ln_matmul.launches, fln.ln_matmul.tiled_launches)
    d, n, dt = 768, 3072, torch.bfloat16
    parts = {"rows": LN_FWD_ROWS_KERNEL, **LN_FWD_PARTS}
    out = {}
    for M in (*LN_CROSSOVER_M, fln.LN_TILED_MIN_M - 1):
        sets = [ln_case(torch, np, rng, M, d, n, dt)
                for _ in range(copies_for(2 * (M * d + d * n + M * n)))]
        args = [(s["x"], s["gamma"], s["beta"], s["w"], s["bias"], 1e-6, dt) for s in sets]
        routed = cuda_ms(torch, [lambda a=a: fln.ln_matmul(*a[:5]) for a in args], iters=20)
        got = {p for p, ms in kernel_split(routed["by_name"], parts, f"ln_matmul at M={M}").items()
               if ms > 0}
        tiled = M >= fln.LN_TILED_MIN_M
        want = set(LN_FWD_PARTS) if tiled else {"rows"}
        log(f"  ln_matmul at M={M} launched {sorted(got)}: {sorted(routed['by_name'])}")
        if got != want:
            raise SmokeFailure(f"ln_matmul at M={M} launched {sorted(got)}, want {sorted(want)}")
        if M in LN_CROSSOVER_M:
            other = fln._launch_fwd_rows if tiled else fln._launch_fwd_tiled
            forced = cuda_ms(torch, [lambda a=a: other(*a) for a in args], iters=20)["device_ms"]
            out[M] = (forced, routed["device_ms"]) if tiled else (routed["device_ms"], forced)
        del sets, args
    log(f"  crossover, n={n} bf16, the row-tile kernel vs the tiled pair (device ms): "
        + "; ".join(f"M={M} " + " vs ".join(f"{t:.5f}" for t in ts) for M, ts in out.items())
        + f"; fwd_plan takes the tiled pair from M={fln.LN_TILED_MIN_M}")
    fln.ln_matmul.launches, fln.ln_matmul.tiled_launches = before
    return out


# ---------------------------------------------------------------------------
# phase 2c: the flash attention kernels at the training shapes
# ---------------------------------------------------------------------------


#: BERT's attention shape (phase 2c's second shape, phase 8's path):
#: bert_base at phase 8's batch, S=512, non-causal
FLASH_BERT = dict(B=32, H=12, S=512, D=64)
#: the valid lengths of a padded BERT batch: each row's drawn from this
#: range (inclusive), the last row none
BERT_PAD_LENGTHS = (384, 512)
#: head_dim 32 (phase 2c's third shape): the MLM and LM convergence demos'
#: attention (d_model 128 over 4 heads, S=64, batch 64), timed non-causal
#: (the MLM demo) and causal (the LM demo), bf16; a padded kv_mask's rows
#: attend a prefix of ``FLASH_D32_PAD`` keys
FLASH_D32 = dict(B=64, H=4, S=64, D=32)
FLASH_D32_PAD = (16, 64)
#: head_dim 256 (phase 2c's D=256 shape: Gemma's head dim, 8 heads at
#: S=1024), bf16 only (the f32 check kernels stop at 128); D=192 runs
#: zero-padded to 256 at the same shape; a padded kv_mask's rows attend a
#: prefix of ``FLASH_D256_PAD`` keys
FLASH_D256 = dict(B=4, H=8, S=1024, D=256)
FLASH_D256_PAD = (512, 1024)


def flash_case(torch, np, rng, dtype, masked, B=8, H=12, S=1024, D=64, pad_lengths=None,
               Sk=None):
    """q/k/v/dout as the model makes them ([B,S,H,D] viewed as
    [B,H,S,D]; k and v of ``Sk`` keys when given, else S); with ``masked``
    a kv_mask of ~75% keys whose last batch row attends nothing; with
    ``masked="padded"`` the mask of a padded batch, each row's keys a
    valid prefix of a length drawn from ``pad_lengths`` (default
    ``BERT_PAD_LENGTHS``), the last row none."""
    Sk = Sk or S
    mk = lambda n: torch.from_numpy(  # noqa: E731
        rng.standard_normal((B, n, H, D), dtype=np.float32)).to(DEVICE, dtype).transpose(1, 2)
    c = dict(q=mk(S), k=mk(Sk), v=mk(Sk), dout=mk(S), mask=None)
    if masked == "padded":
        c["mask"] = torch.from_numpy(padded_mask(np, rng, B, Sk, pad_lengths)).to(DEVICE)
    elif masked:
        m = rng.random((B, Sk)) > 0.25
        m[:, 0] = True
        m[-1] = False
        c["mask"] = torch.from_numpy(m).to(DEVICE)
    return c


def padded_mask(np, rng, B, S, lengths=None):
    """[B, S] bool: row b attends its first lens[b] keys, lens drawn from
    ``lengths`` (default ``BERT_PAD_LENGTHS``; clipped to S), the last row
    none."""
    lo, hi = (min(x, S) for x in lengths or BERT_PAD_LENGTHS)
    lens = rng.integers(lo, hi + 1, B)
    lens[-1] = 0
    return np.arange(S)[None, :] < lens[:, None]


def flash_bound_ms(torch, c, kind, dtype_name, causal=True) -> tuple[float, str]:
    """Least time for the work these inputs need: each input read once and
    each output written once (forward: q, k, v -> out, lse; dK/dV: q, k,
    v, out, dout, lse -> dk, dv; dQ: the same inputs -> dq), and 2*D
    operations per attended (query, key) pair for each of the kernel's
    products (forward 2: QK^T, PV; dK/dV 4: QK^T, dO V^T, P^T dO, dS^T Q;
    dQ 3: QK^T, dO V^T, dS K); a pair is attended where the kv_mask (if
    any) and, when ``causal``, the causal order (aligned at Sk - Sq)
    allow it."""
    q = c["q"]
    B, H, S, D = q.shape
    Sk = c["k"].shape[2]
    tq, tk = q.numel() * q.element_size(), c["k"].numel() * c["k"].element_size()
    lse = B * H * S * 4
    rows = torch.arange(S, device=q.device) + (Sk - S)
    cols = torch.arange(Sk, device=q.device)
    keys = ((cols[None, :] <= rows[:, None]) if causal            # [S, Sk]
            else torch.ones(S, Sk, dtype=torch.bool, device=q.device))
    if c["mask"] is not None:
        pairs = int((keys[None] & c["mask"][:, None, :]).sum()) * H
    else:
        pairs = int(keys.sum()) * B * H
    mask_bytes = c["mask"].numel() if c["mask"] is not None else 0
    nbytes, products = {  # q, out, dout, dq: tq each; k, v, dk, dv: tk each
        "fwd": (tq + 2 * tk + mask_bytes + tq + lse, 2),
        "dkv": (3 * tq + 2 * tk + lse + mask_bytes + 2 * tk, 4),
        "dq": (3 * tq + 2 * tk + lse + mask_bytes + tq, 3),
    }[kind]
    ops = products * 2 * D * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_flash(torch, fa, c, causal, tag, dn) -> dict[str, list[float]]:
    """The three kernels on case ``c`` against their plain versions: the
    elementwise gates (``TOL["flash/<dtype>"]``, lse ``TOL["flash/lse"]``),
    relative L2 on out, lse (attended rows), dq, dk and dv beside the
    controls (out x 1.01; with no mask also dk and dq x 1.01) the gates
    must fail, and zeros / NEG_INF on a row that attends nothing. Returns
    each kernel's max abs errors."""
    tol, lim = TOL[f"flash/{dn}"], TOL[f"flash/bwd/rel_l2/{dn}"]
    lim_out, lim_lse = TOL[f"flash/fwd/rel_l2/{dn}"], TOL["flash/lse/rel_l2"]
    masked = c["mask"] is not None
    args = (c["q"], c["k"], c["v"], c["mask"])
    out, lse = fa.flash_fwd(*args, causal=causal)
    dk, dv = fa.flash_bwd_dkv(*args, out, lse, c["dout"], causal=causal)
    dq = fa.flash_bwd_dq(*args, out, lse, c["dout"], causal=causal)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_plain(*args, causal=causal)
    want = fa.flash_attention_bwd_plain(*args, out, lse, c["dout"], causal=causal)
    errs = {"flash_fwd": [check_close(torch, f"flash_fwd/out {tag}", out, want_out, tol),
                          check_close(torch, f"flash_fwd/lse {tag}", lse, want_lse,
                                      TOL["flash/lse"])],
            "flash_bwd_dkv": [check_close(torch, f"flash_bwd_dkv/dk {tag}", dk, want[1], tol),
                              check_close(torch, f"flash_bwd_dkv/dv {tag}", dv, want[2], tol)],
            "flash_bwd_dq": [check_close(torch, f"flash_bwd_dq/dq {tag}", dq, want[0], tol)]}
    l2_out = rel_l2(out, want_out)
    attended = want_lse > fa.NEG_INF / 2
    l2_lse = rel_l2(lse[attended], want_lse[attended])
    # the control: the forward's gate must fail an out 1% off
    control_out = rel_l2(out.float() * 1.01, want_out)
    log(f"  flash forward {tag}: out relative L2 {l2_out:.2e} (tol {lim_out:g}); "
        f"control, out x 1.01: {control_out:.2e}; lse relative L2 over attended rows "
        f"{l2_lse:.2e} (tol {lim_lse:g})")
    if control_out <= lim_out:
        raise SmokeFailure(f"flash: the forward's relative-L2 gate {lim_out:g} passes "
                           f"out x 1.01")
    if l2_out > lim_out or l2_lse > lim_lse:
        raise SmokeFailure(f"flash {tag}: out off by {l2_out:.2e} > {lim_out:g} or lse by "
                           f"{l2_lse:.2e} > {lim_lse:g} relative L2")
    l2 = {n: rel_l2(got, w) for n, got, w in
          (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2]))}
    # the controls: the gate must fail a dk and a dq 1% off
    controls = {} if masked else {n: rel_l2(got.float() * 1.01, w) for n, got, w in
                                  (("dk", dk, want[1]), ("dq", dq, want[0]))}
    log(f"  flash backward {tag}: relative L2 " + ", ".join(
        f"{n} {e:.2e}" for n, e in l2.items()) + f" (tol {lim:g})" + "".join(
        f"; control, {n} x 1.01: {e:.2e}" for n, e in controls.items()))
    passed = [n for n, e in controls.items() if e <= lim]
    if passed:
        raise SmokeFailure(f"flash: the relative-L2 gate {lim:g} passes "
                           f"{', '.join(n + ' x 1.01' for n in passed)}")
    bad = [n for n, e in l2.items() if e > lim]
    if bad:
        raise SmokeFailure(f"flash {tag}: {bad} off by more than {lim:g} relative L2")
    if masked and (out[-1].float().abs().sum() or dq[-1].float().abs().sum()
                   or dk[-1].float().abs().sum() or dv[-1].float().abs().sum()
                   or (lse[-1] != fa.NEG_INF).any()):
        raise SmokeFailure("flash: a row that attends nothing is not 0 / NEG_INF")
    return errs


def sdpa_backend(by_name: dict) -> str:
    """The backend SDPA picked, from the names of the kernels it launched."""
    if not by_name:
        return "not recorded"
    names = " ".join(by_name).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                         ("efficient", "efficient")):
        if key in names:
            return backend
    return "math"


def time_flash(torch, np, F, fa, rng, c, causal, dn, shape, iters=50) -> dict[str, dict]:
    """Each kernel and SDPA (forward; its whole backward through autograd)
    on cold copies of case ``c``'s inputs, three traces of ``iters`` calls
    deep (``cuda_ms``), the plain versions by ``plain_time``, beside the
    bound of this case's attended pairs. SDPA takes ``is_causal`` or, with a kv_mask, the
    boolean ``attn_mask``; its backend is read from its kernels' names.
    With Sq != Sk a causal SDPA call would align at 0, not at Sk - Sq:
    such a case is timed non-causal only."""
    fa_args = lambda st: (st["q"], st["k"], st["v"], st["mask"])  # noqa: E731
    tensor = c["q"].numel() * c["q"].element_size()
    masked = c["mask"] is not None
    sets = [c] + [flash_case(torch, np, rng, c["q"].dtype, "padded" if masked else False,
                             **shape) for _ in range(copies_for(5 * tensor) - 1)]
    for st in sets:
        st["out"], st["lse"] = fa.flash_fwd(*fa_args(st), causal=causal)
    bwd_in = lambda st: (*fa_args(st), st["out"], st["lse"], st["dout"])  # noqa: E731
    kern = {
        "flash_fwd": [lambda st=st: fa.flash_fwd(*fa_args(st), causal=causal) for st in sets],
        "flash_bwd_dkv": [lambda st=st: fa.flash_bwd_dkv(*bwd_in(st), causal=causal)
                          for st in sets],
        "flash_bwd_dq": [lambda st=st: fa.flash_bwd_dq(*bwd_in(st), causal=causal)
                         for st in sets],
    }
    plain_fwd = [lambda st=st: fa.flash_attention_plain(*fa_args(st), causal=causal)
                 for st in sets]
    plain_bwd = [lambda st=st: fa.flash_attention_bwd_plain(*bwd_in(st), causal=causal)
                 for st in sets]

    def sdpa(st, q, k, v):  # library yardstick, timed only
        if st["mask"] is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=st["mask"][:, None, None, :])

    lib_fwd = [lambda st=st: sdpa(st, st["q"], st["k"], st["v"]) for st in sets]
    lib_graphs = []
    for st in sets:
        leaves = [t.detach().requires_grad_() for t in (st["q"], st["k"], st["v"])]
        lib_graphs.append((sdpa(st, *leaves), leaves, st["dout"]))
    lib_bwd = [lambda g=g: torch.autograd.grad(g[0], g[1], g[2], retain_graph=True)
               for g in lib_graphs]
    t_plain_fwd, t_plain_bwd = plain_time(torch, plain_fwd), plain_time(torch, plain_bwd)
    t_lib_fwd, t_lib_bwd = cuda_ms(torch, lib_fwd, iters), cuda_ms(torch, lib_bwd, iters)
    backend = sdpa_backend(t_lib_fwd["by_name"])
    rows = {}
    for n in kern:
        tk = cuda_ms(torch, kern[n], iters)
        fwd = n == "flash_fwd"
        row = dict(ms=tk["device_ms"], call_ms=tk["call_ms"],
                   plain_ms=(t_plain_fwd if fwd else t_plain_bwd)["device_ms"],
                   library_ms=(t_lib_fwd["device_ms"] if fwd else
                               t_lib_bwd["device_ms"] if n == "flash_bwd_dkv" else None),
                   sdpa_backend=backend)
        row["bound_ms"], row["bound_by"] = flash_bound_ms(
            torch, c, {"flash_fwd": "fwd", "flash_bwd_dkv": "dkv", "flash_bwd_dq": "dq"}[n],
            dn, causal=causal)
        rows[n] = row
        lib = f"{row['library_ms']:.5f}" if row["library_ms"] is not None else "null"
        log(f"    {n} {dn}: kernel_ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
            f"library_ms={lib} bound_ms={row['bound_ms']:.5f} ({row['bound_by']}); "
            f"wrapper call_ms={row['call_ms']:.4f}")
    log(f"    SDPA ({backend}; kernels {sorted(k[:60] for k in t_lib_fwd['by_name'])}) backward "
        f"(dq, dk, dv in one call) {t_lib_bwd['device_ms']:.5f} ms vs dK/dV + dQ kernels "
        f"{rows['flash_bwd_dkv']['ms'] + rows['flash_bwd_dq']['ms']:.5f} ms; plain backward "
        f"(all three) {t_plain_bwd['device_ms']:.5f} ms")
    return rows


def phase_flash(torch, np, F):
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(1)
    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    results = {n: {"err": 0.0, "rows": [], "bert": {}} for n in names}
    log("phase 2c: flash attention kernels vs plain versions (B=8 H=12 S=1024 D=64, "
        "causal; kv_mask cases hold a batch row that attends nothing)")
    before = {n: getattr(fa, n).launches for n in names}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for masked in (False, True):
            c = flash_case(torch, np, rng, dtype, masked)
            tag = f"{dn} {'kv_mask' if masked else 'no mask'}"
            errs = check_flash(torch, fa, c, True, tag, dn)
            for n in names:
                results[n]["err"] = max(results[n]["err"], *errs[n])
            if dtype != torch.bfloat16 or masked:
                continue
            rows = time_flash(torch, np, F, fa, rng, c, True, dn, {})
            for n in names:
                results[n]["rows"].append(rows[n])
    shape = FLASH_BERT
    log(f"phase 2c, BERT's shape: B={shape['B']} H={shape['H']} S={shape['S']} D={shape['D']}, "
        f"non-causal, bf16, with no mask and with a padded kv_mask (each row's valid length "
        f"drawn from {BERT_PAD_LENGTHS[0]}-{BERT_PAD_LENGTHS[1]}, the last row none)")
    for masked in (False, "padded"):
        c = flash_case(torch, np, rng, torch.bfloat16, masked, **shape)
        tag = f"bfloat16 BERT {'padded kv_mask' if masked else 'no mask'}"
        errs = check_flash(torch, fa, c, False, tag, "bfloat16")
        rows = time_flash(torch, np, F, fa, rng, c, False, "bfloat16", shape)
        for n in names:
            results[n]["err"] = max(results[n]["err"], *errs[n])
            results[n]["bert"]["padded" if masked else "no mask"] = rows[n]
        del c
    shape = FLASH_D32
    log(f"phase 2c, head_dim 32 (the MLM/LM demos' shape): B={shape['B']} H={shape['H']} "
        f"S={shape['S']} D={shape['D']}, bf16 and f32, causal and not, with no mask and with a "
        f"padded kv_mask (each row's valid length drawn from {FLASH_D32_PAD[0]}-"
        f"{FLASH_D32_PAD[1]}, the last row none)")
    for n in names:
        results[f"{n}_d32"] = {"err": 0.0, "rows": [], "timed": {}}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for causal in (False, True):
            for masked in (False, "padded"):
                c = flash_case(torch, np, rng, dtype, masked, pad_lengths=FLASH_D32_PAD,
                               **shape)
                tag = (f"{dn} D=32 {'causal' if causal else 'non-causal'} "
                       f"{'padded kv_mask' if masked else 'no mask'}")
                errs = check_flash(torch, fa, c, causal, tag, dn)
                for n in names:
                    results[f"{n}_d32"]["err"] = max(results[f"{n}_d32"]["err"], *errs[n])
                if dtype != torch.bfloat16 or masked:
                    continue
                rows = time_flash(torch, np, F, fa, rng, c, causal, dn, shape)
                for n in names:
                    results[f"{n}_d32"]["timed"]["causal" if causal else "non-causal"] = rows[n]
    for n in names:  # the kernels line's row: the MLM demo's (non-causal)
        results[f"{n}_d32"]["rows"].append(results[f"{n}_d32"]["timed"]["non-causal"])
    results.update(flash_d256(torch, np, F, fa, rng))
    results["padded"] = flash_padded(torch, np, F, fa, rng)
    results["sp"] = flash_sp(torch, np, F, fa, rng)
    torch.cuda.empty_cache()
    for n in names:  # comparison launches do not count
        getattr(fa, n).launches = before[n]
    return results


def flash_d256(torch, np, F, fa, rng) -> dict:
    """Phase 2c's D=256 part: the three kernels at ``FLASH_D256`` (bf16,
    causal and not, no mask and a padded kv_mask) against their plain
    versions with the gates and controls of ``check_flash``, timed with no
    mask; ``flash_attention`` at D=192 zero-padded to 256 likewise
    (``check_padded_flash``), timed causal; the f32 check kernels at 256
    (32-row tiles), causal with no mask and non-causal padded, timed
    causal."""
    shape = FLASH_D256
    log(f"phase 2c, head_dim 256: B={shape['B']} H={shape['H']} S={shape['S']} D=256, bf16, "
        f"causal and not, no mask and a padded kv_mask ({FLASH_D256_PAD[0]}-"
        f"{FLASH_D256_PAD[1]} keys, the last row none); D=192 zero-padded to 256")
    out = {f"{n}_d256": {"err": 0.0, "rows": [], "timed": {}} for n in FLASH_NAMES}
    for causal in (True, False):
        for masked in (False, "padded"):
            c = flash_case(torch, np, rng, torch.bfloat16, masked, pad_lengths=FLASH_D256_PAD,
                           **shape)
            tag = (f"bfloat16 D=256 {'causal' if causal else 'non-causal'} "
                   f"{'padded kv_mask' if masked else 'no mask'}")
            errs = check_flash(torch, fa, c, causal, tag, "bfloat16")
            for n in FLASH_NAMES:
                out[f"{n}_d256"]["err"] = max(out[f"{n}_d256"]["err"], *errs[n])
            if not masked:
                rows = time_flash(torch, np, F, fa, rng, c, causal, "bfloat16", shape)
                for n in FLASH_NAMES:
                    out[f"{n}_d256"]["timed"]["causal" if causal else "non-causal"] = rows[n]
            del c
    for n in FLASH_NAMES:  # the kernels line's row: causal (a decoder's)
        out[f"{n}_d256"]["rows"].append(out[f"{n}_d256"]["timed"]["causal"])
    shape192 = dict(shape, D=192)
    out["padded192"] = {"err": {n: 0.0 for n in FLASH_NAMES}, "timed": {}}
    for causal in (True, False):
        for masked in (False, "padded"):
            c = flash_case(torch, np, rng, torch.bfloat16, masked, pad_lengths=FLASH_D256_PAD,
                           **shape192)
            tag = (f"bfloat16 D=192 {'causal' if causal else 'non-causal'} "
                   f"{'padded kv_mask' if masked else 'no mask'}")
            errs = check_padded_flash(torch, fa, c, causal, tag, "bfloat16")
            for n in FLASH_NAMES:
                out["padded192"]["err"][n] = max(out["padded192"]["err"][n], *errs[n])
            if causal and not masked:
                out["padded192"]["timed"]["D=192 causal"] = time_padded_flash(
                    torch, np, F, fa, rng, c, causal, "bfloat16", shape192)
            del c
    # the f32 check kernels at D=256 (32-row tiles): checked causal with no
    # mask and non-causal with a padded one, timed causal beside bf16
    out["f32_d256"] = {"err": {n: 0.0 for n in FLASH_NAMES}, "timed": {}}
    for causal, masked in ((True, False), (False, "padded")):
        c = flash_case(torch, np, rng, torch.float32, masked, pad_lengths=FLASH_D256_PAD,
                       **shape)
        tag = (f"float32 D=256 {'causal' if causal else 'non-causal'} "
               f"{'padded kv_mask' if masked else 'no mask'}")
        errs = check_flash(torch, fa, c, causal, tag, "float32")
        for n in FLASH_NAMES:
            out["f32_d256"]["err"][n] = max(out["f32_d256"]["err"][n], *errs[n])
        if causal:
            out["f32_d256"]["timed"]["causal"] = time_flash(torch, np, F, fa, rng, c, True,
                                                            "float32", shape, iters=10)
        del c
    torch.cuda.empty_cache()
    return out


#: phase 2c's sequence-parallel shapes (phase 15's): the all-gather
#: schedule's local queries against the whole sequence (gpt_small's heads,
#: S=2048 over seq=2), non-causal with a padded kv_mask; Ulysses at
#: long_context's S=8192 over seq=2 (6 of the 12 heads a rank), causal
FLASH_SP = {"allgather": dict(B=2, H=12, S=1024, Sk=2048, D=64),
            "ulysses": dict(B=2, H=6, S=8192, D=64)}
FLASH_SP_PAD = (1536, 2048)


def flash_sp(torch, np, F, fa, rng) -> dict:
    """Phase 2c's sequence-parallel part: the three kernels at
    ``FLASH_SP`` (bf16) against their plain versions with the gates and
    controls of ``check_flash``, each timed beside SDPA and its bound:
    all-gather's Sq = S/seq != Sk = S, non-causal with a padded kv_mask;
    Ulysses' S=8192 causal (64 q tiles on the grid)."""
    out = {}
    for name, causal, masked in (("allgather", False, "padded"), ("ulysses", True, False)):
        shape = FLASH_SP[name]
        mask_note = ("padded kv_mask (%d-%d keys, the last row none)" % FLASH_SP_PAD
                     if masked else "no mask")
        log(f"phase 2c, {name}'s shape: {shape}, bf16, "
            f"{'causal' if causal else 'non-causal'}, {mask_note}")
        c = flash_case(torch, np, rng, torch.bfloat16, masked, pad_lengths=FLASH_SP_PAD,
                       **shape)
        errs = check_flash(torch, fa, c, causal, f"bfloat16 {name}", "bfloat16")
        rows = time_flash(torch, np, F, fa, rng, c, causal, "bfloat16", shape,
                          iters=10 if shape["S"] <= 2048 else 5)
        out[name] = {"err": {n: max(errs[n]) for n in FLASH_NAMES}, "timed": rows,
                     "shape": shape, "causal": causal, "masked": bool(masked)}
        del c
        torch.cuda.empty_cache()
    return out


def check_padded_flash(torch, fa, c, causal, tag, dn) -> dict:
    """``flash_attention`` at a head dim the kernels are not built for
    (zero-padded to ``padded_head_dim``, sliced back) against the plain
    versions at that head dim: out and, through autograd, dq, dk, dv,
    elementwise (``TOL["flash/<dtype>"]``) and as relative L2 beside the
    out, dk and dq x 1.01 controls; each wrapper must count one launch at
    the padded head dim and one for the caller's. Returns the max abs
    errors."""
    import torch.nn.functional as F

    D = c["q"].shape[-1]
    Dp = fa.padded_head_dim(D)
    wrappers = [getattr(fa, n) for n in FLASH_NAMES]
    before = [(w.launches_by_d.get(Dp, 0), w.launches_by_asked_d.get(D, 0)) for w in wrappers]
    leaves = [c[n].detach().requires_grad_() for n in ("q", "k", "v")]
    out = fa.flash_attention(*leaves, causal=causal, kv_mask=c["mask"])
    dq, dk, dv = torch.autograd.grad(out, leaves, c["dout"])
    out = out.detach()
    torch.cuda.synchronize()
    counted = [(w.launches_by_d.get(Dp, 0) - b[0], w.launches_by_asked_d.get(D, 0) - b[1])
               for w, b in zip(wrappers, before)]
    if counted != [(1, 1)] * 3:
        raise SmokeFailure(f"flash {tag}: launches at D={Dp} / asked D={D}: {counted}, want "
                           f"one each of every kernel")
    args = (c["q"], c["k"], c["v"], c["mask"])
    want_out, _ = fa.flash_attention_plain(*args, causal=causal)
    # the backward's plain version on the forward kernel's out and LSE (as
    # check_flash's), so the backward gate reads the backward kernels alone:
    # at D=192 and S=1024 the bf16 outs of the two forwards differ by 1.5e-3
    # relative L2, which moves dq and dk through rowsum(dO * O) by as much
    _, lse = fa.flash_fwd(*(F.pad(t, (0, Dp - D)) for t in args[:3]), c["mask"],
                          causal=causal, sm_scale=D ** -0.5)
    want = fa.flash_attention_bwd_plain(*args, out.detach(), lse, c["dout"], causal=causal)
    tol = TOL[f"flash/{dn}"]
    errs = {"flash_fwd": [check_close(torch, f"flash_fwd/out {tag}", out, want_out, tol)],
            "flash_bwd_dkv": [check_close(torch, f"flash_bwd_dkv/dk {tag}", dk, want[1], tol),
                              check_close(torch, f"flash_bwd_dkv/dv {tag}", dv, want[2], tol)],
            "flash_bwd_dq": [check_close(torch, f"flash_bwd_dq/dq {tag}", dq, want[0], tol)]}
    lim_out, lim = TOL[f"flash/fwd/rel_l2/{dn}"], TOL[f"flash/bwd/rel_l2/{dn}"]
    l2 = {"out": (rel_l2(out, want_out), lim_out), "dq": (rel_l2(dq, want[0]), lim),
          "dk": (rel_l2(dk, want[1]), lim), "dv": (rel_l2(dv, want[2]), lim)}
    controls = {"out": (rel_l2(out.float() * 1.01, want_out), lim_out)}
    if c["mask"] is None:
        controls.update(dk=(rel_l2(dk.float() * 1.01, want[1]), lim),
                        dq=(rel_l2(dq.float() * 1.01, want[0]), lim))
    log(f"  flash {tag} (padded to D={Dp}): relative L2 " + ", ".join(
        f"{n} {e:.2e} (tol {t:g})" for n, (e, t) in l2.items()) + "; controls x 1.01: "
        + ", ".join(f"{n} {e:.2e}" for n, (e, _) in controls.items()))
    passed = [n for n, (e, t) in controls.items() if e <= t]
    if passed:
        raise SmokeFailure(f"flash {tag}: the relative-L2 gate passes {passed} x 1.01")
    bad = [n for n, (e, t) in l2.items() if e > t]
    if bad:
        raise SmokeFailure(f"flash {tag}: {bad} outside the relative-L2 gate")
    return errs


def time_padded_flash(torch, np, F, fa, rng, c, causal, dn, shape) -> dict[str, dict]:
    """The padded call's forward (the pads, the forward kernel at the
    padded head dim, the slice) and its backward through autograd (the
    dout pad, dK/dV, dQ, the slices), each kernel's device time by name,
    beside the plain versions and SDPA at the caller's head dim, and the
    bound of the work that head dim asks (``flash_bound_ms``)."""
    tensor = c["q"].numel() * c["q"].element_size()
    masked = c["mask"] is not None
    sets = [c] + [flash_case(torch, np, rng, c["q"].dtype, "padded" if masked else False,
                             **shape) for _ in range(copies_for(5 * tensor) - 1)]
    graphs = []
    for st in sets:
        leaves = [st[n].detach().requires_grad_() for n in ("q", "k", "v")]
        graphs.append((fa.flash_attention(*leaves, causal=causal, kv_mask=st["mask"]), leaves,
                       st["dout"]))
    fwd = [lambda st=st: fa.flash_attention(st["q"], st["k"], st["v"], causal=causal,
                                            kv_mask=st["mask"]) for st in sets]
    bwd = [lambda g=g: torch.autograd.grad(g[0], g[1], g[2], retain_graph=True)
           for g in graphs]
    fa_args = lambda st: (st["q"], st["k"], st["v"], st["mask"])  # noqa: E731
    for st in sets:
        st["out"], st["lse"] = fa.flash_attention_plain(*fa_args(st), causal=causal)
    plain_fwd = [lambda st=st: fa.flash_attention_plain(*fa_args(st), causal=causal)
                 for st in sets]
    plain_bwd = [lambda st=st: fa.flash_attention_bwd_plain(
        *fa_args(st), st["out"], st["lse"], st["dout"], causal=causal) for st in sets]

    def sdpa(st, q, k, v):
        if st["mask"] is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=st["mask"][:, None, None, :])

    lib_fwd = [lambda st=st: sdpa(st, st["q"], st["k"], st["v"]) for st in sets]
    lib_graphs = []
    for st in sets:
        leaves = [st[n].detach().requires_grad_() for n in ("q", "k", "v")]
        lib_graphs.append((sdpa(st, *leaves), leaves, st["dout"]))
    lib_bwd = [lambda g=g: torch.autograd.grad(g[0], g[1], g[2], retain_graph=True)
               for g in lib_graphs]
    with torch.no_grad():
        t_fwd = cuda_ms(torch, fwd)
    t_bwd = cuda_ms(torch, bwd)
    t_plain_fwd, t_plain_bwd = cuda_ms(torch, plain_fwd), cuda_ms(torch, plain_bwd)
    t_lib_fwd, t_lib_bwd = cuda_ms(torch, lib_fwd), cuda_ms(torch, lib_bwd)
    rows = {}
    for n, kernel, t, kind in (("flash_fwd", "flash_fwd_", t_fwd, "fwd"),
                               ("flash_bwd_dkv", "flash_bwd_dkv_", t_bwd, "dkv"),
                               ("flash_bwd_dq", "flash_bwd_dq_", t_bwd, "dq")):
        own = sum(ms for k, ms in t["by_name"].items() if kernel in k)
        if own <= 0:
            raise SmokeFailure(f"padded flash: the profiler recorded no {kernel} kernel in "
                               f"{sorted(t['by_name'])}")
        row = dict(ms=own, call_ms=t["device_ms"],
                   plain_ms=(t_plain_fwd if kind == "fwd" else t_plain_bwd)["device_ms"],
                   library_ms=(t_lib_fwd["device_ms"] if kind == "fwd" else
                               t_lib_bwd["device_ms"] if kind == "dkv" else None),
                   sdpa_backend=sdpa_backend(t_lib_fwd["by_name"]))
        row["bound_ms"], row["bound_by"] = flash_bound_ms(torch, c, kind, dn, causal=causal)
        rows[n] = row
    log(f"    padded D={c['q'].shape[-1]} {dn} {'causal' if causal else 'non-causal'}: "
        + "; ".join(f"{n} kernel {r['ms']:.5f} ms (the whole padded "
                    f"{'forward' if n == 'flash_fwd' else 'backward'} {r['call_ms']:.5f}) / "
                    f"bound {r['bound_ms']:.5f} ({r['bound_by']}) / plain {r['plain_ms']:.5f}"
                    f" / SDPA " + (f"{r['library_ms']:.5f} ({r['sdpa_backend']})"
                                    if r["library_ms"] is not None else "null")
                    for n, r in rows.items()))
    return rows


#: head dims below the instantiated ones (the JAX package's tools' d_model
#: 64 over 4 heads and over 8), zero-padded to 32 by ``flash_attention``;
#: at the head_dim-32 shape's B, H and S
FLASH_PADDED_DIMS = (8, 16)


def flash_padded(torch, np, F, fa, rng) -> dict:
    """Phase 2c's padded head dims (``FLASH_PADDED_DIMS``): bf16 and f32,
    causal and not, with no mask and a padded kv_mask, checked; bf16 with
    no mask timed causal and not."""
    shape0 = dict(FLASH_D32)
    log(f"phase 2c, padded head dims {FLASH_PADDED_DIMS} (zero-padded to "
        f"{fa.padded_head_dim(FLASH_PADDED_DIMS[0])} inside flash_attention): B={shape0['B']} "
        f"H={shape0['H']} S={shape0['S']}, bf16 and f32, causal and not, no mask and a padded "
        f"kv_mask ({FLASH_D32_PAD[0]}-{FLASH_D32_PAD[1]} keys, the last row none)")
    out = {"err": {n: 0.0 for n in FLASH_NAMES}, "timed": {}}
    for D in FLASH_PADDED_DIMS:
        shape = dict(shape0, D=D)
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            for causal in (False, True):
                for masked in (False, "padded"):
                    c = flash_case(torch, np, rng, dtype, masked, pad_lengths=FLASH_D32_PAD,
                                   **shape)
                    tag = (f"{dn} D={D} {'causal' if causal else 'non-causal'} "
                           f"{'padded kv_mask' if masked else 'no mask'}")
                    errs = check_padded_flash(torch, fa, c, causal, tag, dn)
                    for n in FLASH_NAMES:
                        out["err"][n] = max(out["err"][n], *errs[n])
                    if dtype == torch.bfloat16 and not masked:
                        out["timed"][f"D={D} {'causal' if causal else 'non-causal'}"] = \
                            time_padded_flash(torch, np, F, fa, rng, c, causal, dn, shape)
    return out


# ---------------------------------------------------------------------------
# phase 2e: the LN+matmul kernels at gpt_small's training shapes
# ---------------------------------------------------------------------------

#: (M, d, n, dtype): gpt_small at B=8, S=1024 — q/k/v (n=768) and mlp_in
#: (n=3072) — in bf16, timed; two smaller f32 shapes, checked only: the
#: second, d=1024 and n=8192, is one the whole-row dx design refused (its
#: CTA held 32 rows of dh in shared memory)
LN_TRAIN_SHAPES = [(8192, 768, 768, "bfloat16"), (8192, 768, 3072, "bfloat16"),
                   (1000, 768, 3072, "float32"), (256, 1024, 8192, "float32")]
#: the dx and dw wrappers' kernels, by the device name the profiler gives
#: each (the forward's: LN_FWD_PARTS)
LN_DX_PARTS = {"dh": "ln_bwd_dh_kernel", "rows": "ln_bwd_dx_rows_kernel",
               "reduce": "reduce2_kernel"}
LN_DW_PARTS = {"product": "ln_bwd_dw_kernel", "reduce": "reduce_kernel"}
#: the dw split over M timed at each training shape (dw_plan picks one)
LN_DW_SWEEP_G = (1, 2, 4, 7, 8)
#: the n of each backward kernel's row in the kernels line
LN_BWD_MAIN_N = 3072


def ln_bwd_case(torch, np, rng, M, d, n, dtype, linear_layout=True):
    """x, gamma, beta, w (the nn.Linear weight's [d, n] view, or contiguous)
    and an output gradient dy, as the fused model's backward gives them."""
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(DEVICE)  # noqa: E731
    w_nd = (0.02 * f(n, d)).to(dtype)
    return dict(x=f(M, d).to(dtype), gamma=1 + 0.1 * f(d), beta=0.1 * f(d),
                w=w_nd.t() if linear_layout else w_nd.t().contiguous(), bias=0.02 * f(n),
                dy=f(M, n).to(dtype))


def ln_bwd_bound_ms(c, kind, dtype_name) -> tuple[float, str]:
    """Least time for the work: each input read once, each output written
    once (dx: x, gamma, w, dy -> dx, dgamma, dbeta, dbias and the rows'
    mean and rstd; dw: x, gamma, beta, dy and the rows' mean and rstd ->
    dw in w's dtype), and 2*M*d*n operations for the one product of each."""
    M, d = c["x"].shape
    n = c["dy"].shape[1]
    e = c["x"].element_size()
    nbytes = {"dx": e * (2 * M * d + d * n + M * n) + 4 * (3 * d + n) + 8 * M,
              "dw": e * (M * d + M * n + d * n) + 8 * d + 8 * M}[kind]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * M * d * n / PEAK_OPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_split(by_name: dict, parts: dict, what: str) -> dict:
    """A wrapper's device time per call split by kernel into ``parts``
    (part -> kernel name, matched within the profiler's name); fails on a
    kernel name it does not know, so the split always adds up to the
    row's time."""
    split = dict.fromkeys(parts, 0.0)
    for key, ms in by_name.items():
        part = next((p for p, name in parts.items() if name in key), None)
        if part is None:
            raise SmokeFailure(f"{what} launched an unexpected kernel: {key}")
        split[part] += ms
    return split


def fmt_split(split: dict) -> str:
    return ", ".join(f"{p} {ms:.5f}" for p, ms in split.items())


def phase_ln_train(torch, np, F):
    from distributed_tensorflow_tpu_torch.ops import fused_ln_matmul as fln

    rng = np.random.default_rng(5)
    names = ("ln_matmul/train", "ln_matmul_bwd_dx", "ln_matmul_bwd_dw")
    results = {n: {"err": 0.0, "rows": []} for n in names}
    results["sweep"] = {}
    before = {n: k.launches for n, k in fln.KERNELS.items()}
    tiled_before = fln.ln_matmul.tiled_launches
    log("phase 2e: LN+matmul forward and backward kernels vs plain versions at gpt_small's "
        "training shapes (M = B*S = 8192, d=768; bf16, f32 at two smaller shapes; w as "
        "linear.weight.t() and contiguous) — dx (atol, rtol), sums over M as relative L2 "
        "error")

    for M, d, n, dn in LN_TRAIN_SHAPES:
        dtype = getattr(torch, dn)
        tol, rtol = TOL[f"ln_bwd/{dn}"], TOL[f"ln_bwd/reduction/{dn}"]
        for linear_layout in (True, False):
            c = ln_bwd_case(torch, np, rng, M, d, n, dtype, linear_layout)
            tag = f"{dn} M={M} d={d} n={n} " + ("w=linear.weight.t()" if linear_layout
                                                 else "w contiguous [d,n]")
            args = (c["x"], c["gamma"], c["beta"], c["w"])
            tiled0 = fln.ln_matmul.tiled_launches
            y = fln.ln_matmul(*args, c["bias"])
            dx, dg, db, dbias, mean, rstd = fln.ln_matmul_bwd_dx(
                c["x"], c["gamma"], c["w"], c["dy"])
            dw = fln.ln_matmul_bwd_dw(c["x"], c["gamma"], c["beta"], c["dy"], mean, rstd)
            torch.cuda.synchronize()
            want_y = fln.ln_matmul_plain(*args, c["bias"])
            want = fln.ln_matmul_bwd_plain(*args, c["dy"])
            err_y = check_close(torch, f"ln_matmul/y {tag}", y, want_y, TOL[f"ln_matmul/{dn}"])
            if dn == "bfloat16":  # the bf16 -> f32 entry, and a ragged M
                check_close(torch, f"ln_matmul/y bf16->f32 {tag}",
                            fln.ln_matmul(*args, c["bias"], out_dtype=torch.float32),
                            fln.ln_matmul_plain(*args, c["bias"], out_dtype=torch.float32),
                            TOL["ln_matmul/bfloat16"])
                rag = (c["x"][:M - 56], *args[1:], c["bias"])
                check_close(torch, f"ln_matmul/y M={M - 56} {tag}", fln.ln_matmul(*rag),
                            fln.ln_matmul_plain(*rag), TOL[f"ln_matmul/{dn}"])
            if fln.ln_matmul.tiled_launches - tiled0 != (3 if dn == "bfloat16" else 1):
                raise SmokeFailure(f"ln_matmul {tag}: the forward did not take the tiled path")
            err_dx = check_close(torch, f"ln_matmul_bwd_dx/dx {tag}", dx, want[0], tol)
            reds = {"dgamma": rel_l2(dg, want[1]), "dbeta": rel_l2(db, want[2]),
                    "dbias": rel_l2(dbias, want[4]), "dw": rel_l2(dw, want[3])}
            log(f"    {tag} sums over M, relative L2 (tol {rtol:g}): "
                + " ".join(f"{k}={v:.2e}" for k, v in reds.items()))
            if max(reds.values()) > rtol:
                raise SmokeFailure(f"ln_matmul backward {tag}: a sum is off by "
                                   f"{max(reds.values()):.3e}")
            results["ln_matmul/train"]["err"] = max(results["ln_matmul/train"]["err"], err_y)
            results["ln_matmul_bwd_dx"]["err"] = max(results["ln_matmul_bwd_dx"]["err"], err_dx)
            results["ln_matmul_bwd_dw"]["err"] = max(
                results["ln_matmul_bwd_dw"]["err"], float((dw.float() - want[3].float()).abs().max()))
            # bitwise repeat: one fixed summation order, no float atomics
            again = fln.ln_matmul_bwd_dx(c["x"], c["gamma"], c["w"], c["dy"])
            if not (all(torch.equal(a, b) for a, b in zip(again, (dx, dg, db, dbias, mean, rstd)))
                    and torch.equal(dw, fln.ln_matmul_bwd_dw(c["x"], c["gamma"], c["beta"],
                                                             c["dy"], *again[4:]))
                    and torch.equal(y, fln.ln_matmul(*args, c["bias"]))):
                raise SmokeFailure(f"ln_matmul {tag}: a second call is not bitwise equal")
            if dn != "bfloat16" or not linear_layout:
                continue
            # timing on cold inputs (the model's layout), as the path calls them
            nbytes = c["x"].numel() * 2 * 2 + c["dy"].numel() * 2
            sets = [c] + [ln_bwd_case(torch, np, rng, M, d, n, dtype)
                          for _ in range(copies_for(nbytes) - 1)]
            for st in sets:
                st["stats"] = fln.ln_matmul_bwd_dx(st["x"], st["gamma"], st["w"], st["dy"])[4:]
                mu, rs = (t[:, None] for t in st["stats"])
                st["h"] = ((st["x"].float() - mu) * rs * st["gamma"] + st["beta"]).to(dtype)
            kern = {
                "ln_matmul/train": [lambda s=s: fln.ln_matmul(s["x"], s["gamma"], s["beta"],
                                                              s["w"], s["bias"]) for s in sets],
                "ln_matmul_bwd_dx": [lambda s=s: fln.ln_matmul_bwd_dx(
                    s["x"], s["gamma"], s["w"], s["dy"]) for s in sets],
                "ln_matmul_bwd_dw": [lambda s=s: fln.ln_matmul_bwd_dw(
                    s["x"], s["gamma"], s["beta"], s["dy"], *s["stats"]) for s in sets],
            }
            plain = {"fwd": [lambda s=s: fln.ln_matmul_plain(s["x"], s["gamma"], s["beta"],
                                                             s["w"], s["bias"]) for s in sets],
                     "bwd": [lambda s=s: fln.ln_matmul_bwd_plain(s["x"], s["gamma"], s["beta"],
                                                                 s["w"], s["dy"]) for s in sets]}
            # library yardsticks, timed only: layer_norm + linear for the
            # forward; the product alone for each backward kernel
            lib = {"ln_matmul/train": [lambda s=s: F.linear(F.layer_norm(
                       s["x"], (d,), s["gamma"].to(dtype), s["beta"].to(dtype), 1e-6),
                       s["w"].t(), s["bias"].to(dtype)) for s in sets],
                   "ln_matmul_bwd_dx": [lambda s=s: torch.mm(s["dy"], s["w"].t())
                                        for s in sets],
                   "ln_matmul_bwd_dw": [lambda s=s: torch.mm(s["h"].t(), s["dy"])
                                        for s in sets]}
            parts = {"ln_matmul/train": LN_FWD_PARTS, "ln_matmul_bwd_dx": LN_DX_PARTS,
                     "ln_matmul_bwd_dw": LN_DW_PARTS}
            t_plain = {k: plain_time(torch, v) for k, v in plain.items()}
            for k in kern:
                tk, tl = cuda_ms(torch, kern[k], iters=20), cuda_ms(torch, lib[k], iters=20)
                if k == "ln_matmul/train":
                    bound = ln_bound_ms(c, dn)
                else:
                    bound = ln_bwd_bound_ms(c, k.split("_")[-1], dn)
                row = dict(M=M, d=d, n=n, ms=tk["device_ms"], call_ms=tk["call_ms"],
                           library_ms=tl["device_ms"],
                           plain_ms=t_plain["fwd" if k == "ln_matmul/train" else "bwd"][
                               "device_ms"], bound_ms=bound[0], bound_by=bound[1],
                           split=kernel_split(tk["by_name"], parts[k], k))
                results[k]["rows"].append(row)
                log(f"    {k} M={M} n={n}: kernel_ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f}"
                    f" library_ms={row['library_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
                    f"({row['bound_by']}) ({row['bound_ms'] / row['ms']:.1%} of bound); "
                    f"wrapper call_ms={row['call_ms']:.4f}; device ms by kernel "
                    f"{fmt_split(row['split'])}")
            results["sweep"][n] = ln_plan_sweep(torch, fln, sets)
            del sets, kern, plain, lib
            torch.cuda.empty_cache()
    for n, k in fln.KERNELS.items():  # comparison launches do not count
        k.launches = before[n]
    fln.ln_matmul.tiled_launches = tiled_before
    for n in names:
        results[n]["main"] = next(r for r in results[n]["rows"] if r["n"] == LN_BWD_MAIN_N)
    return results


def ln_plan_sweep(torch, fln, sets) -> dict:
    """dw split into each G of ``LN_DW_SWEEP_G``, beside the G that
    ``dw_plan`` takes, on the same cold inputs (CUDA events, ms a call)."""
    M, d = sets[0]["x"].shape
    n = sets[0]["dy"].shape[1]
    dw = lambda G: [lambda s=s: fln._launch_dw(  # noqa: E731
        s["x"], s["gamma"], s["beta"], s["dy"], *s["stats"], G) for s in sets]
    out = {f"dw G={G}": event_ms(torch, dw(G)) for G in LN_DW_SWEEP_G}
    plan = fln.dw_plan(M, d, n, fln._sms(sets[0]["x"].device))
    log(f"    dw plans at M={M} n={n} (CUDA events, ms a call; dw_plan takes "
        f"{plan['tile'][0]}x{plan['tile'][1]} G={plan['G']}): "
        + ", ".join(f"{k} {v:.5f}" for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# phase 2d: the fused 1x1 conv + BN kernels at ResNet-50's batch-256 shapes
# ---------------------------------------------------------------------------

#: (M, cin, cout, prologue): one conv3 (bn2 + ReLU prologue) and one conv1
#: or projection (no prologue) of each stage; every one emits statistics
CONV_BN_SHAPES = [
    (802816, 64, 256, True), (802816, 256, 64, False),
    (200704, 128, 512, True), (200704, 256, 512, False),
    (50176, 256, 1024, True), (50176, 1024, 256, False),
    (12544, 512, 2048, True), (12544, 2048, 512, False),
]
#: f32 checks (no timing): a stage-3 conv3 (two-pass) and a stage-0 conv3
#: (single-pass: the f32 kernel's ~220 KB of shared memory)
CONV_BN_F32_SHAPES = [(12544, 512, 2048), (12544, 64, 256)]
#: the shape of each kernel's row in the kernels line and PERF.md
CONV_BN_MAIN = {"conv_bn_fwd": (802816, 64, 256, True),
                "conv_bn_bwd_dx": (200704, 128, 512, True),
                "conv_bn_bwd_dw": (200704, 128, 512, True),
                "conv_bn_bwd_single": (802816, 64, 256, True)}
#: ResNet-50's four stage-0 single-pass configurations at batch 256 (conv3
#: with the bn2 + ReLU prologue, the projection, conv1 of blocks 2-3 and of
#: block 1), each held to the plain version like CONV_BN_SHAPES and timed
#: against the dx + dw pair on the same inputs
CONV_BN_STAGE0 = [(802816, 64, 256, True), (802816, 64, 256, False),
                  (802816, 256, 64, False), (802816, 64, 64, False)]
#: the wrappers' kernels, by the device name the profiler gives each
CONV_PARTS = {"conv_bn_fwd": {"product": "conv_bn_fwd_kernel", "reduce": "reduce_kernel"},
              "conv_bn_bwd_dx": {"product": "conv_bn_dx_kernel", "reduce": "reduce_kernel"},
              "conv_bn_bwd_dw": {"product": "conv_bn_dw_kernel", "reduce": "reduce_kernel"},
              "conv_bn_bwd_single": {"sweep": "conv_bn_single_kernel",
                                     "reduce": "reduce_kernel"}}


def conv_launches(n: str, prologue: bool) -> dict:
    """Launches a call of a conv+BN wrapper's kernels, for ``cuda_ms``
    (every call here emits the statistics): the product once, and
    ``reduce_kernel`` once for each sum of G partials (the forward's sum and
    sumsq; dw; dscale and dshift with the prologue)."""
    product = next(k for p, k in CONV_PARTS[n].items() if p != "reduce")
    reduces = {"conv_bn_fwd": 2, "conv_bn_bwd_dx": 0, "conv_bn_bwd_dw": 1,
               "conv_bn_bwd_single": 1}[n]
    reduces += 2 * (prologue and n in ("conv_bn_bwd_dx", "conv_bn_bwd_single"))
    return {product: 1, "reduce_kernel": reduces} if reduces else {product: 1}

#: (M, cin, cout, prologue, launches a step): the twelve shapes of ResNet-50's
#: 29 two-pass dw launches at batch 256 (resnet_launch_rule; conv1 runs at
#: the block input's resolution), each held to the plain dw and timed
CONV_BN_DW_SWEEP = [
    (802816, 256, 128, False, 1), (200704, 256, 512, False, 1), (200704, 128, 512, True, 4),
    (200704, 512, 128, False, 3), (200704, 512, 256, False, 1), (50176, 512, 1024, False, 1),
    (50176, 256, 1024, True, 6), (50176, 1024, 256, False, 5), (50176, 1024, 512, False, 1),
    (12544, 1024, 2048, False, 1), (12544, 512, 2048, True, 3), (12544, 2048, 512, False, 2),
]
#: (M, cin, cout, prologue, launches a step): the sixteen shapes of
#: ResNet-50's 36 forward launches at batch 256 (resnet_launch_rule): the
#: four stage-0 convs of the single-pass backward, then the convs of the
#: two-pass dw sweep, each held to the plain forward and timed
CONV_BN_FWD_SWEEP = [
    (802816, 64, 64, False, 1), (802816, 64, 256, True, 3), (802816, 64, 256, False, 1),
    (802816, 256, 64, False, 2), *CONV_BN_DW_SWEEP,
]
#: rows cut from the dx main shape's M for its ragged-M check (the dx tile
#: is 128 rows)
CONV_DX_RAGGED = 40


def conv_bn_case(torch, np, rng, dtype, M, cin, cout, prologue):
    """x, the OIHW weight's [cin, cout] view, the previous BN's affine and
    the backward's cotangents, as the ResNet path gives them."""
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(DEVICE)
    return dict(x=f(M, cin).to(dtype), w=(f(cout, cin) / cin ** 0.5).to(dtype).t(),
                scale=1 + 0.2 * f(cin) if prologue else None,
                shift=0.2 * f(cin) if prologue else None,
                dy=(f(M, cout) / M ** 0.5).to(dtype), dsum=f(cout) / M, dssq=f(cout) / M)


def conv_bn_bound_ms(c, kind, dtype_name) -> tuple[float, str]:
    """Least time for the work: each input read once, each output written
    once (forward: x, w, scale/shift -> y, sum, sumsq; dx: y, dy, w,
    dsum/dssq and, with a prologue only, x and scale/shift -> dx and, with
    a prologue, dscale, dshift; dw: x, y, dy, scale/shift, dsum/dssq -> dw
    f32; single: both), and 2*M*cin*cout operations per product (one, one,
    one, two)."""
    M, cin = c["x"].shape
    cout = c["dy"].shape[1] if "dy" in c else c["w"].shape[1]
    e = c["x"].element_size()
    aff = 8 * cin if c["scale"] is not None else 0
    mat = {"fwd": (M * cin * e + cin * cout * e + aff, M * cout * e + 8 * cout, 1),
           "dx": (M * 2 * cout * e + (aff and M * cin * e) + cin * cout * e + aff + 8 * cout,
                  M * cin * e + (aff and 8 * cin), 1),
           "dw": (M * (cin + 2 * cout) * e + aff + 8 * cout, 4 * cin * cout, 1),
           "single": (M * (cin + 2 * cout) * e + cin * cout * e + aff + 8 * cout,
                      M * cin * e + 4 * cin * cout + (aff and 8 * cin), 2)}[kind]
    t_bytes = (mat[0] + mat[1]) / HBM_BYTES_PER_S
    t_ops = mat[2] * 2 * M * cin * cout / PEAK_OPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_fwd_y(torch, name, got, want, dn) -> float:
    """The forward's y against the plain version's: elementwise within
    ``TOL["conv_bn/<dn>"]`` and relative L2 within
    ``TOL["conv_bn/fwd/rel_l2/<dn>"]``, beside a y scaled by 1.01 that the
    relative-L2 gate must fail. Returns the largest absolute error."""
    err = check_close(torch, name, got, want, TOL[f"conv_bn/{dn}"])
    lim, l2 = TOL[f"conv_bn/fwd/rel_l2/{dn}"], rel_l2(got, want)
    control = rel_l2(got.float() * 1.01, want)
    log(f"  {name}: relative L2 {l2:.2e} (tol {lim:g}); control, y x 1.01: {control:.2e}")
    if l2 > lim:
        raise SmokeFailure(f"{name}: y is off by {l2:.3e} relative L2")
    if control <= lim:
        raise SmokeFailure(f"{name}: the relative-L2 gate passes y x 1.01")
    return err


def fwd_sweep(torch, fcb) -> dict:
    """The forward wrapper at each shape of ``CONV_BN_FWD_SWEEP`` (bf16,
    inputs drawn on the card from seed 10), held to the plain forward (y by
    ``check_fwd_y``, the statistics by relative L2 within
    ``TOL["conv_bn/reduction/bfloat16"]``, a second call bitwise equal) and
    timed (device ms, profiler, split by kernel) beside ``x@w`` in
    ``torch.matmul`` and the bound; at the main shape also each tile width
    of ``fwd_plan``. Returns the rows, the launch-weighted sum of a step's
    forward time and the largest absolute error of y."""
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    lim = TOL["conv_bn/reduction/bfloat16"]
    rows, total, err = [], 0.0, 0.0
    for M, cin, cout, prologue, n in CONV_BN_FWD_SWEEP:
        def f(*shape):
            return torch.randn(*shape, generator=gen, device=DEVICE)
        c = dict(x=f(M, cin).to(torch.bfloat16),
                 w=(f(cout, cin) / cin ** 0.5).to(torch.bfloat16).t(),  # the OIHW view
                 scale=1 + 0.2 * f(cin) if prologue else None,
                 shift=0.2 * f(cin) if prologue else None)
        args = (c["x"], c["w"], c["scale"], c["shift"])
        tag = f"M={M} {cin}->{cout} {'bn+relu' if prologue else 'no prologue'}"
        y, s, q = fcb.conv1x1_bn_fwd(*args)
        wy, wsum, wsq = fcb.conv1x1_bn_act_plain(*args)
        err = max(err, check_fwd_y(torch, f"conv_bn_fwd/y {tag}", y, wy, "bfloat16"))
        red = max(rel_l2(s, wsum), rel_l2(q, wsq))
        if red > lim:
            raise SmokeFailure(f"conv_bn_fwd {tag}: the statistics are off by {red:.3e}")
        if not all(torch.equal(a, b) for a, b in zip((y, s, q), fcb.conv1x1_bn_fwd(*args))):
            raise SmokeFailure(f"conv_bn_fwd {tag}: a second call is not bitwise equal")
        each = conv_launches("conv_bn_fwd", prologue)
        tk = cuda_ms(torch, [lambda: fcb.conv1x1_bn_fwd(*args)], iters=20, launches=each)
        lib = cuda_ms(torch, [lambda: torch.matmul(c["x"], c["w"])], iters=20)["device_ms"]
        bound, by = conv_bn_bound_ms(c, "fwd", "bfloat16")
        sms = fcb._sms(c["x"].device)
        row = dict(M=M, cin=cin, cout=cout, prologue=prologue, launches=n, ms=tk["device_ms"],
                   split=kernel_split(tk["by_name"], CONV_PARTS["conv_bn_fwd"], "conv_bn_fwd"),
                   library_ms=lib, bound_ms=bound, bound_by=by, rel_l2=rel_l2(y, wy),
                   stats_rel_l2=red, plan=fcb.fwd_plan(M, cin, cout, sms, fcb.fwd_tile()))
        plan = f", tile {row['plan']['tile'][0]}x{row['plan']['tile'][1]} G={row['plan']['G']}"
        if (M, cin, cout, prologue) == CONV_BN_MAIN["conv_bn_fwd"]:
            row["widths"] = {}
            for wd in fcb.FWD_WIDTHS:
                with mock.patch.object(fcb, "FWD_WIDTHS", (wd,)):
                    p = fcb.fwd_plan(M, cin, cout, sms, fcb.fwd_tile())
                t = cuda_ms(torch, [lambda p=p: fcb._launch_fwd(*args, True, True, p)],
                            iters=20, launches=each)["device_ms"]
                row["widths"][f"{p['tile'][0]}x{p['tile'][1]} G={p['G']}"] = t
            plan += "; each width at its plan: " + ", ".join(
                f"{k} {t:.5f}" for k, t in row["widths"].items())
        rows.append(row)
        total += n * row["ms"]
        ms = row["ms"]
        log(f"    fwd {tag} x{n}: kernel_ms={ms:.5f} (device ms by kernel "
            f"{fmt_split(row['split'])}) x@w_ms={lib:.5f} bound_ms={bound:.5f} ({by}, "
            f"{bound / ms:.1%} of it; {2 * M * cin * cout / ms / 1e9:.1f} TFLOP/s); statistics "
            f"relative L2 {red:.2e} (tol {lim:g}){plan}")
        del c, args, y, s, q, wy, wsum, wsq
        torch.cuda.empty_cache()
    log(f"  forward over a ResNet-50 step's {sum(r['launches'] for r in rows)} launches (sum "
        f"of launches x kernel_ms): {total:.4f} ms")
    return {"rows": rows, "step_ms": total, "err": err}


def dw_sweep(torch, fcb) -> dict:
    """The dw wrapper at each shape of ``CONV_BN_DW_SWEEP`` (bf16, inputs
    drawn on the card from seed 9), held to the plain dw by relative L2
    (``TOL["conv_bn/reduction/bfloat16"]``) and timed (device ms,
    profiler) beside ``h^T@g`` in ``torch.matmul`` and the bound; at the
    main shape also each tile width of ``dw_plan``. Returns the rows and
    the launch-weighted sum of a step's dw time."""
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    lim = TOL["conv_bn/reduction/bfloat16"]
    rows, total = [], 0.0
    for M, cin, cout, prologue, n in CONV_BN_DW_SWEEP:
        def f(*shape):
            return torch.randn(*shape, generator=gen, device=DEVICE)
        c = dict(x=f(M, cin).to(torch.bfloat16), y=f(M, cout).to(torch.bfloat16),
                 dy=(f(M, cout) / M ** 0.5).to(torch.bfloat16),
                 scale=1 + 0.2 * f(cin) if prologue else None,
                 shift=0.2 * f(cin) if prologue else None, dsum=f(cout) / M, dssq=f(cout) / M)
        args = (c["x"], c["y"], c["dy"], c["scale"], c["shift"], c["dsum"], c["dssq"])
        dw = fcb.conv1x1_bn_bwd_dw(*args)
        h = fcb._hq(c["x"], c["scale"], c["shift"], True)
        g = fcb._gq(c["y"], c["dy"], c["dsum"], c["dssq"], True)
        ref = fcb.mm_exact(h.t(), g)
        err = float((dw - ref).norm() / ref.norm())
        if err > lim:
            raise SmokeFailure(f"conv_bn_bwd_dw M={M} {cin}->{cout}: relative L2 {err:.3e}")
        each = conv_launches("conv_bn_bwd_dw", prologue)
        ms = cuda_ms(torch, [lambda: fcb.conv1x1_bn_bwd_dw(*args)], iters=20,
                     launches=each)["device_ms"]
        lib = cuda_ms(torch, [lambda: torch.matmul(h.t(), g)], iters=20)["device_ms"]
        bound, by = conv_bn_bound_ms(c, "dw", "bfloat16")
        sms = fcb._sms(c["x"].device)
        row = dict(M=M, cin=cin, cout=cout, prologue=prologue, launches=n, ms=ms, library_ms=lib,
                   bound_ms=bound, bound_by=by, rel_l2=err,
                   plan=fcb.dw_plan(M, cin, cout, sms, fcb.dw_tile()))
        plan = f", tile {row['plan']['tile'][0]}x{row['plan']['tile'][1]} G={row['plan']['G']}"
        if (M, cin, cout, prologue) == CONV_BN_MAIN["conv_bn_bwd_dw"]:
            row["widths"] = {}
            for w in fcb.DW_WIDTHS:
                with mock.patch.object(fcb, "DW_WIDTHS", (w,)):
                    p = fcb.dw_plan(M, cin, cout, sms, fcb.dw_tile())
                t = cuda_ms(torch, [lambda p=p: fcb._launch_dw(*args, True, True, p)],
                            iters=20, launches=each)["device_ms"]
                row["widths"][f"{p['tile'][0]}x{p['tile'][1]} G={p['G']}"] = t
            plan += "; each width at its plan: " + ", ".join(
                f"{k} {t:.5f}" for k, t in row["widths"].items())
        rows.append(row)
        total += n * ms
        log(f"    dw M={M} {cin}->{cout} {'bn+relu' if prologue else 'no prologue'} x{n}: "
            f"kernel_ms={ms:.5f} h^T@g_ms={lib:.5f} bound_ms={bound:.5f} ({by}, "
            f"{bound / ms:.1%} of it); relative L2 {err:.2e} (tol {lim:g}){plan}")
        del c, args, dw, h, g, ref
        torch.cuda.empty_cache()
    log(f"  dw over a ResNet-50 step's {sum(r['launches'] for r in rows)} two-pass launches "
        f"(sum of launches x kernel_ms): {total:.4f} ms")
    return {"rows": rows, "step_ms": total}


def phase_conv_bn(torch, np):
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    rng = np.random.default_rng(4)
    names = tuple(fcb.KERNELS)
    results = {n: {"err": 0.0, "rows": []} for n in names}
    before = {n: k.launches for n, k in fcb.KERNELS.items()}
    log("phase 2d: fused 1x1 conv + BN kernels vs plain versions at ResNet-50's batch-256 "
        "shapes (bf16; f32 at two) — elementwise outputs (atol, rtol), reductions over M as "
        "relative L2 error")

    def check_dx_l2(name, got, want, dn, control=None):
        """dx's relative L2 error, beside its elementwise gate; control: the
        same reading of the plain dx with dh rounded to bf16 before the
        epilogue (one extra rounding), for the record."""
        lim, err = TOL[f"conv_bn/dx/{dn}"], rel_l2(got, want)
        log(f"  {name}: relative L2 {err:.2e} (tol {lim:g})" + (
            "" if control is None else f"; control, dh rounded to bf16: {control:.2e}"))
        if err > lim:
            raise SmokeFailure(f"{name}: dx is off by {err:.3e} relative L2")

    def check(c, dtype, tag, timed):
        dn = str(dtype).split(".")[-1]
        tol, rtol = TOL[f"conv_bn/{dn}"], TOL[f"conv_bn/reduction/{dn}"]
        M, cin = c["x"].shape
        cout = c["w"].shape[1]
        aff = (c["scale"], c["shift"])
        y, s, q = fcb.conv1x1_bn_fwd(c["x"], c["w"], *aff)
        bwd = (c["x"], y, c["dy"], c["w"], *aff, c["dsum"], c["dssq"])
        dx, dsc, dsh = fcb.conv1x1_bn_bwd_dx(*bwd)
        dw = fcb.conv1x1_bn_bwd_dw(c["x"], y, c["dy"], *aff, c["dsum"], c["dssq"])
        single = fcb.conv1x1_bn_bwd_single(*bwd) if fcb.single_pass(cin, cout) else None
        torch.cuda.synchronize()
        wy, ws, wq = fcb.conv1x1_bn_act_plain(c["x"], c["w"], *aff)
        ref = fcb.conv1x1_bn_bwd_plain(*bwd)
        errs = {"conv_bn_fwd": [check_fwd_y(torch, f"conv_bn_fwd/y {tag}", y, wy, dn)]}
        reds = {"sum": rel_l2(s, ws), "sumsq": rel_l2(q, wq)}
        errs["conv_bn_bwd_dx"] = [check_close(torch, f"conv_bn_bwd_dx/dx {tag}", dx, ref[0], tol)]
        control = None
        if dtype == torch.bfloat16:
            def mm_rounded(a, b):
                return fcb.mm_exact(a, b).to(torch.bfloat16).float()
            control = rel_l2(fcb._bwd_math(*bwd, relu=True, emit_stats=True, mm=mm_rounded)[0],
                             ref[0])
        check_dx_l2(f"conv_bn_bwd_dx/dx {tag}", dx, ref[0], dn, control)
        reds["dw"] = rel_l2(dw, ref[1])
        if aff[0] is not None:
            reds.update(dscale=rel_l2(dsc, ref[2]), dshift=rel_l2(dsh, ref[3]))
        if single is not None:
            errs["conv_bn_bwd_single"] = [check_close(
                torch, f"conv_bn_bwd_single/dx {tag}", single[0], ref[0], tol)]
            check_dx_l2(f"conv_bn_bwd_single/dx {tag}", single[0], ref[0], dn)
            reds["single/dw"] = rel_l2(single[1], ref[1])
            if aff[0] is not None:
                reds.update({"single/dscale": rel_l2(single[2], ref[2]),
                             "single/dshift": rel_l2(single[3], ref[3])})
        # max_abs_err: the elementwise outputs (y, dx); dw, the dw kernel's
        # only output, is held by its relative L2 error like every reduction
        errs["conv_bn_bwd_dw"] = [float((dw - ref[1]).abs().max())]
        log(f"    {tag} reductions, relative L2 (tol {rtol:g}): "
            + " ".join(f"{k}={v:.2e}" for k, v in reds.items()))
        if max(reds.values()) > rtol:
            raise SmokeFailure(f"conv_bn {tag}: a reduction is off by {max(reds.values()):.3e}")
        for n, e in errs.items():
            results[n]["err"] = max(results[n]["err"], *e)
        # bitwise repeat: the reductions use no float atomics
        if not all(torch.equal(a, b) for a, b in zip((y, s, q), fcb.conv1x1_bn_fwd(
                c["x"], c["w"], *aff))):
            raise SmokeFailure(f"conv_bn_fwd {tag}: a second call is not bitwise equal")
        if timed and not (torch.equal(dw, fcb.conv1x1_bn_bwd_dw(
                              c["x"], y, c["dy"], *aff, c["dsum"], c["dssq"]))
                          and torch.equal(dx, fcb.conv1x1_bn_bwd_dx(*bwd)[0])
                          and (single is None
                               or all(a is None and b is None or torch.equal(a, b)
                                      for a, b in zip(single,
                                                      fcb.conv1x1_bn_bwd_single(*bwd))))):
            raise SmokeFailure(f"conv_bn {tag}: a second call is not bitwise equal")
        return y

    def check_dx_more(c, y, tag):
        """dx once more with w a contiguous [cin, cout] array (the model
        passes the OIHW weight's view) and at a ragged M."""
        tol, rtol = TOL["conv_bn/bfloat16"], TOL["conv_bn/reduction/bfloat16"]
        M, rest = c["x"].shape[0] - CONV_DX_RAGGED, (c["scale"], c["shift"], c["dsum"], c["dssq"])
        for what, bwd in (("w contiguous", (c["x"], y, c["dy"], c["w"].contiguous(), *rest)),
                          (f"M={M}", (c["x"][:M], y[:M], c["dy"][:M], c["w"], *rest))):
            dx, dsc, dsh = fcb.conv1x1_bn_bwd_dx(*bwd)
            torch.cuda.synchronize()
            ref = fcb.conv1x1_bn_bwd_plain(*bwd)
            err = check_close(torch, f"conv_bn_bwd_dx/dx {tag} {what}", dx, ref[0], tol)
            check_dx_l2(f"conv_bn_bwd_dx/dx {tag} {what}", dx, ref[0], "bfloat16")
            results["conv_bn_bwd_dx"]["err"] = max(results["conv_bn_bwd_dx"]["err"], err)
            red = max(rel_l2(dsc, ref[2]), rel_l2(dsh, ref[3]))
            log(f"    {what}: dscale, dshift relative L2 {red:.2e} (tol {rtol:g})")
            if red > rtol:
                raise SmokeFailure(f"conv_bn_bwd_dx {tag} {what}: a reduction is off by {red:.3e}")

    for M, cin, cout, prologue in CONV_BN_SHAPES:
        c = conv_bn_case(torch, np, rng, torch.bfloat16, M, cin, cout, prologue)
        tag = f"bf16 M={M} {cin}->{cout} {'bn+relu prologue' if prologue else 'no prologue'}"
        y = check(c, torch.bfloat16, tag, timed=True)
        if (M, cin, cout, prologue) == CONV_BN_MAIN["conv_bn_bwd_dx"]:
            check_dx_more(c, y, tag)
        aff = (c["scale"], c["shift"])
        bwd = (c["x"], y, c["dy"], c["w"], *aff, c["dsum"], c["dssq"])
        g = (c["dy"].float() + c["dsum"] + 2 * y.float() * c["dssq"]).to(torch.bfloat16)
        h = fcb._hq(c["x"], *aff, True)
        kern = {"conv_bn_fwd": lambda: fcb.conv1x1_bn_fwd(c["x"], c["w"], *aff),
                "conv_bn_bwd_dx": lambda: fcb.conv1x1_bn_bwd_dx(*bwd),
                "conv_bn_bwd_dw": lambda: fcb.conv1x1_bn_bwd_dw(c["x"], y, c["dy"], *aff,
                                                                c["dsum"], c["dssq"])}
        if fcb.single_pass(cin, cout):
            kern["conv_bn_bwd_single"] = lambda: fcb.conv1x1_bn_bwd_single(*bwd)
        # library yardstick, the product alone: x@w, g@w^T, h^T@g (both for single)
        lib = {"conv_bn_fwd": lambda: torch.matmul(c["x"], c["w"]),
               "conv_bn_bwd_dx": lambda: torch.matmul(g, c["w"].t()),
               "conv_bn_bwd_dw": lambda: torch.matmul(h.t(), g),
               "conv_bn_bwd_single": lambda: (torch.matmul(g, c["w"].t()),
                                              torch.matmul(h.t(), g))}
        plain = {"fwd": plain_time(torch, [lambda: fcb.conv1x1_bn_act_plain(c["x"], c["w"],
                                                                           *aff)]),
                 "bwd": plain_time(torch, [lambda: fcb.conv1x1_bn_bwd_plain(*bwd)])}
        for n, fn in kern.items():
            tk = cuda_ms(torch, [fn], iters=20, launches=conv_launches(n, prologue))
            tl = cuda_ms(torch, [lib[n]], iters=20)
            kind = n.split("_")[-1]
            row = dict(M=M, cin=cin, cout=cout, prologue=prologue, ms=tk["device_ms"],
                       call_ms=tk["call_ms"], library_ms=tl["device_ms"],
                       plain_ms=plain["fwd" if kind == "fwd" else "bwd"]["device_ms"])
            row["bound_ms"], row["bound_by"] = conv_bn_bound_ms(c, kind, "bfloat16")
            row["split"] = kernel_split(tk["by_name"], CONV_PARTS[n], n)
            split = f"; device ms by kernel {fmt_split(row['split'])}"
            results[n]["rows"].append(row)
            log(f"    {n} M={M} {cin}->{cout}: kernel_ms={row['ms']:.5f} "
                f"plain_ms={row['plain_ms']:.5f} library_ms={row['library_ms']:.5f} "
                f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
                f"({row['bound_ms'] / row['ms']:.1%} of bound); wrapper call_ms={row['call_ms']:.4f}"
                f"{split}")
        del c, y, g, h, bwd, kern, lib
        torch.cuda.empty_cache()
    for M, cin, cout in CONV_BN_F32_SHAPES:
        c = conv_bn_case(torch, np, rng, torch.float32, M, cin, cout, True)
        check(c, torch.float32, f"f32 M={M} {cin}->{cout} bn+relu prologue", timed=False)
    log("  stage 0 at batch 256 (bf16): the kernels against their plain versions, then the "
        "single-pass kernel timed against the dx + dw pair on the same inputs (device ms, "
        "profiler)")
    for M, cin, cout, prologue in CONV_BN_STAGE0:
        c = conv_bn_case(torch, np, rng, torch.bfloat16, M, cin, cout, prologue)
        aff = (c["scale"], c["shift"])
        y = check(c, torch.bfloat16, f"bf16 stage 0 M={M} {cin}->{cout} "
                  f"{'bn+relu prologue' if prologue else 'no prologue'}", timed=False)
        bwd = (c["x"], y, c["dy"], c["w"], *aff, c["dsum"], c["dssq"])
        ts = cuda_ms(torch, [lambda: fcb.conv1x1_bn_bwd_single(*bwd)], iters=20,
                     launches=conv_launches("conv_bn_bwd_single", prologue))["device_ms"]
        dx_n, dw_n = (conv_launches(n, prologue) for n in ("conv_bn_bwd_dx", "conv_bn_bwd_dw"))
        pair_n = {k: dx_n.get(k, 0) + dw_n.get(k, 0) for k in {**dx_n, **dw_n}}
        tp = cuda_ms(torch, [lambda: (fcb.conv1x1_bn_bwd_dx(*bwd), fcb.conv1x1_bn_bwd_dw(
            c["x"], y, c["dy"], *aff, c["dsum"], c["dssq"]))], iters=20,
            launches=pair_n)["device_ms"]
        bound, by = conv_bn_bound_ms(c, "single", "bfloat16")
        log(f"    M={M} {cin}->{cout} {'bn+relu prologue' if prologue else 'no prologue'}: "
            f"single {ts:.5f}, dx + dw {tp:.5f} ({tp / ts:.2f}x the single); bound {bound:.5f} "
            f"({by}), single at {bound / ts:.1%} of it")
        del c, y, bwd
        torch.cuda.empty_cache()
    log("  dw at the twelve shapes of ResNet-50's two-pass launches at batch 256 (bf16; device "
        "ms, profiler)")
    results["conv_bn_bwd_dw"]["sweep"] = dw_sweep(torch, fcb)
    log("  the forward at the sixteen shapes of ResNet-50's 36 forward launches at batch 256 "
        "(bf16; device ms, profiler)")
    sweep = results["conv_bn_fwd"]["sweep"] = fwd_sweep(torch, fcb)
    results["conv_bn_fwd"]["err"] = max(results["conv_bn_fwd"]["err"], sweep["err"])
    for n in names:  # comparison launches do not count
        fcb.KERNELS[n].launches = before[n]
    for n in names:
        results[n]["main"] = next(r for r in results[n]["rows"]
                                  if (r["M"], r["cin"], r["cout"], r["prologue"]) == CONV_BN_MAIN[n])
    return results


# ---------------------------------------------------------------------------
# phase 5: train gpt_lm at full width, flash kernels vs no kernel
# ---------------------------------------------------------------------------

TRAIN_OVERRIDES = [
    "--train.log_every=1", "--optimizer.warmup_steps=0", "--optimizer.schedule=constant",
    "--optimizer.learning_rate=3e-4",
    "--train.eval_batches=0",  # no eval pass: phase 8 drives the evaluator
]


FLASH_NAMES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
#: the device names of their kernels in a bf16 step, matched by substring:
#: the bf16 kernels on tile_mma.cuh (``flash_fwd_kernel<D>``,
#: ``flash_bwd_dkv_kernel<D>``, ``flash_bwd_dq_kernel<D>``; their f32
#: kernels are ``flash_fwd_f32_kernel``, ``flash_bwd_dkv_f32_kernel`` and
#: ``flash_bwd_dq_f32_kernel``, which these do not match). Every
#: instantiation (D = 64, 128) must build with no spill (phase 1 fails
#: otherwise).
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
LN_NAMES = ("ln_matmul", "ln_matmul_bwd_dx", "ln_matmul_bwd_dw")


@contextlib.contextmanager
def fused_bwd(bwd):
    """``DTF_FUSED_BWD=bwd`` inside the block (``None``: as it is), its
    old value restored after, so no phase inherits another's backward."""
    old = os.environ.get("DTF_FUSED_BWD")
    if bwd is not None:
        os.environ["DTF_FUSED_BWD"] = bwd
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("DTF_FUSED_BWD", None)
        else:
            os.environ["DTF_FUSED_BWD"] = old


def train_pass(torch, np, impl, batch=8, steps=6, extra=(), bwd=None, workload="gpt_lm",
               overrides=TRAIN_OVERRIDES):
    """One ``run_workload(workload, ...)`` on the card (global batch
    ``batch``, ``steps`` steps; ``DTF_FUSED_BWD=bwd`` when given) with the
    launch counts of the flash and LN+matmul kernels set to 0 just before
    it, read when the steps end (``launches``) and again after the run's
    final eval (the difference: ``eval_launches``), and the step-1
    gradient captured where the step hands it to the optimizer."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import fused_ln_matmul as fln
    from distributed_tensorflow_tpu_torch.train import callbacks as tcb
    from distributed_tensorflow_tpu_torch.train import optimizers as topt
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    captured = {}
    update = topt.Optimizer.update

    def spy(self, grads):
        if self.count == 0:
            captured["grads"] = [g.detach().float().clone() for g in grads]
        return update(self, grads)

    counters = {**{n: getattr(fa, n) for n in FLASH_NAMES}, **fln.KERNELS}

    def read():
        out = {n: k.launches for n, k in counters.items()}
        out["ln_matmul_train"] = fln.ln_matmul.tiled_launches
        return out

    class StepsEnd(tcb.Callback):  # the launches of the steps, before any eval
        def on_train_end(self, trainer):
            captured["launches"] = read()

    topt.Optimizer.update = spy
    try:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        for k in counters.values():
            k.launches = 0  # main path starts
        fln.ln_matmul.tiled_launches = 0
        t0 = time.perf_counter()
        with fused_bwd(bwd):
            res = run_workload(workload, overrides + [
                f"--model.attention_impl={impl}", f"--data.global_batch_size={batch}",
                f"--train.num_steps={steps}", *extra], device=DEVICE,
                extra_callbacks=[StepsEnd()])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = captured["launches"]  # main path read
        total = read()
    finally:
        topt.Optimizer.update = update
    hist = res.history
    steady = [r for r in hist if "steps_per_sec" in r]  # none in a one-step pass
    step_ms = (1e3 / float(np.median([r["steps_per_sec"] for r in steady])) if steady
               else np.nan)
    return dict(impl=impl, batch=batch, res=res, losses=[r["loss"] for r in hist],
                wall_s=wall, step_ms=step_ms,
                tok_s=batch * res.state.model.cfg.max_len * 1e3 / step_ms,
                mfu=float(np.median([r.get("mfu", np.nan) for r in steady])) if steady
                else np.nan,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, held_gib=held,
                grads=captured.get("grads"), launches=launches,
                eval_launches={n: total[n] - launches[n] for n in total},
                eval_metrics=res.eval_metrics,
                names=[n for n, _ in res.state.model.named_parameters()])


def profile_train_step(torch, res, batch=8, label="flash"):
    """Where the time of a training step goes: one more step of the
    trained state under torch.profiler — device time by kernel, and the
    device's busy share of the step's wall time."""
    from distributed_tensorflow_tpu_torch.data.text import SyntheticLM, TextDataConfig
    from distributed_tensorflow_tpu_torch.models import transformer as tfm
    from distributed_tensorflow_tpu_torch.train import make_train_step

    model = res.state.model
    cfg = model.cfg
    step = make_train_step(tfm.causal_lm_loss(model, cfg.xent_chunk))
    data = SyntheticLM(TextDataConfig(dataset="synthetic_lm", global_batch_size=batch,
                                      seq_len=cfg.max_len, vocab_size=cfg.vocab_size))
    host = data.batch(100)
    dev = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    state, m = step(res.state, dev)
    float(m["loss"])
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, dev)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in device_events(torch, prof) if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"  profiled {label} step (B={batch}, profiler on): wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% (idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    flash = {k: [(e.self_device_time_total / 1e3, e.count) for e in events if k in e.key]
             for k in FLASH_KERNELS}
    log("    flash kernels of the step (device ms, launches): " + "; ".join(
        f"{k} {sum(ms for ms, _ in v):.3f} ms {sum(n for _, n in v)}x" for k, v in flash.items()))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def train_diffs(torch, p, q) -> dict:
    """Pass ``p`` against pass ``q``: the largest per-step loss difference
    and the step-1 gradients' relative L2 error per parameter (worst and
    median; attn.key.bias, whose exact gradient is 0 — softmax ignores a
    shift shared by a row's logits — holds rounding noise only and is
    left out)."""
    rows = []
    for name, a, b in zip(p["names"], p["grads"], q["grads"]):
        if not torch.isfinite(a).all():
            raise SmokeFailure(f"step-1 gradient of {name}: non-finite")
        if not name.endswith("attn.key.bias"):
            rows.append((float((a - b).norm() / b.norm().clamp_min(1e-30)), name))
    rows.sort(reverse=True)
    return dict(loss=max(abs(a - b) for a, b in zip(p["losses"], q["losses"])),
                worst=rows[0][0], worst_name=rows[0][1], median=rows[len(rows) // 2][0],
                n=len(rows))


def gate_train(d, tag, loss_tol, grad_tol) -> dict:
    log(f"  {tag}: per-step |loss diff| max {d['loss']:.3e} (tol {loss_tol}); step-1 "
        f"gradients relative L2 worst {d['worst']:.3e} ({d['worst_name']}; tol {grad_tol}), "
        f"median {d['median']:.3e} over {d['n']} parameters")
    if d["loss"] > loss_tol or d["worst"] > grad_tol:
        raise SmokeFailure(f"{tag}: outside tolerance ({d})")
    return {k: d[k] for k in ("loss", "worst", "median")}


def phase_train_fused(torch, np, card, data, flash):
    """Phase 5b: ``fused_ln_matmul=True`` through run_workload with both
    backward impls, held to phase 5's unfused flash pass ``flash`` (the
    same weights and batches), then one f32 step fused + pallas vs
    unfused."""
    log(f"phase 5b: train gpt_lm with fused_ln_matmul=True (ln1->q/k/v and ln2->mlp_in "
        f"through the LN+matmul kernels; flash attention) at phase 5's setting, "
        f"DTF_FUSED_BWD=pallas and =xla, against phase 5's unfused flash pass; on {card}")
    fused = ["--model.fused_ln_matmul=true", *data]
    layers, steps = flash["res"].state.model.cfg.num_layers, len(flash["losses"])
    per_step = 4 * layers  # q, k, v and mlp_in of every layer
    passes = {}
    for bwd in ("pallas", "xla"):
        p = passes[bwd] = train_pass(torch, np, "flash", extra=fused, bwd=bwd)
        log(f"  fused + {bwd}: losses {[round(x, 5) for x in p['losses']]}; step "
            f"{p['step_ms']:.2f} ms (median of steps 2-{steps}), {p['tok_s']:.0f} tokens/s, "
            f"MFU {100 * p['mfu']:.2f}%, peak memory {p['peak_gib']:.2f} GiB, run wall "
            f"{p['wall_s']:.1f} s, launches {p['launches']}")
        if not np.isfinite(p["losses"]).all():
            raise SmokeFailure(f"fused + {bwd}: non-finite loss")
        if not p["losses"][-1] < p["losses"][0]:
            raise SmokeFailure(f"fused + {bwd}: loss did not fall ({p['losses']})")
        want = {**{n: layers * steps for n in FLASH_NAMES}, "ln_matmul": per_step * steps,
                "ln_matmul_train": per_step * steps,
                "ln_matmul_bwd_dx": per_step * steps if bwd == "pallas" else 0,
                "ln_matmul_bwd_dw": per_step * steps if bwd == "pallas" else 0}
        if p["launches"] != want:
            raise SmokeFailure(f"fused + {bwd}: launches {p['launches']}, want {want}")
    out = {"passes": {bwd: {k: p[k] for k in ("losses", "step_ms", "tok_s", "mfu", "peak_gib",
                                               "launches")} for bwd, p in passes.items()}}
    out["compare"] = {
        f"fused/{bwd} vs unfused": gate_train(
            train_diffs(torch, p, flash), f"fused + {bwd} vs unfused (bf16)",
            TOL["train/fused/loss"], TOL["train/fused/grad_rel_l2"])
        for bwd, p in passes.items()}
    out["compare"]["pallas vs xla"] = gate_train(
        train_diffs(torch, passes["pallas"], passes["xla"]), "fused: pallas vs xla backward (bf16)",
        TOL["train/fused/loss"], TOL["train/fused/bwd/grad_rel_l2"])
    with fused_bwd("pallas"):
        out["fused_profile"] = profile_train_step(torch, passes["pallas"]["res"],
                                                  label="fused + pallas")
    del passes
    torch.cuda.empty_cache()
    f32 = {}
    for name, extra, bwd in (("fused + pallas", fused, "pallas"), ("unfused", data, None)):
        f32[name] = train_pass(torch, np, "flash", steps=1,
                               extra=[*extra, "--model.dtype=float32"], bwd=bwd)
        f32[name]["res"] = None
        log(f"  f32 {name}, one step: loss {f32[name]['losses'][0]:.6f}, peak memory "
            f"{f32[name]['peak_gib']:.2f} GiB, launches {f32[name]['launches']}")
        torch.cuda.empty_cache()
    if not (f32["fused + pallas"]["launches"]["ln_matmul_bwd_dw"]
            == f32["fused + pallas"]["launches"]["ln_matmul_train"] == per_step):
        raise SmokeFailure(f"f32 fused pass: launches {f32['fused + pallas']['launches']}")
    out["compare"]["f32"] = gate_train(
        train_diffs(torch, f32["fused + pallas"], f32["unfused"]),
        "f32 one step, fused + pallas vs unfused", TOL["train/f32/loss"],
        TOL["train/f32/grad_rel_l2"])
    out["launches"] = out["passes"]["pallas"]["launches"]
    return out


def lm_corpus(np, path: str) -> str:
    """Phase 5's fixed corpus, written to ``path`` as a token file: on the
    SyntheticLM stream every step brings 8k fresh next-token pairs of a
    50k-entry map, so 6 steps do not lower the loss (on an H100 it stayed
    within +-0.01 of 10.97 at lr 3e-4; PERF.md). The smoke therefore
    trains on SyntheticLM's first 8 sequences: the steps revisit their
    pairs, and the loss falls if the backward is right."""
    import dataclasses

    from distributed_tensorflow_tpu_torch.data.text import SyntheticLM
    from distributed_tensorflow_tpu_torch.utils.config import apply_overrides
    from distributed_tensorflow_tpu_torch.workloads import gpt_lm

    data_cfg = apply_overrides(gpt_lm.default_config(), TRAIN_OVERRIDES).data
    corpus = SyntheticLM(dataclasses.replace(data_cfg, global_batch_size=8)).batch(0)
    np.save(path, np.append(corpus["input_ids"].reshape(-1), 0).astype(np.int32))
    log(f"  corpus: SyntheticLM batch 0 ({corpus['input_ids'].shape} tokens) as tokens:{path}")
    return path


def phase_train(torch, np, card):
    log(f"phase 5: train gpt_lm (gpt_small, S=1024, bf16, random weights from seed 0, "
        f"SyntheticLM tokens, adamw at constant lr 3e-4, dropout 0.1 — a smoke setting) "
        f"through run_workload, flash kernels vs no kernel; on {card}")
    import tempfile

    tmp = tempfile.TemporaryDirectory()
    data = [f"--data.dataset=tokens:{lm_corpus(np, os.path.join(tmp.name, 'corpus.npy'))}"]
    with tmp:
        passes = {impl: train_pass(torch, np, impl, extra=data) for impl in ("flash", "dense")}
        flash, dense = passes["flash"], passes["dense"]
        fused = phase_5(torch, np, flash, dense)
        fused.update(phase_train_fused(torch, np, card, data, flash))
    return fused


def phase_5(torch, np, flash, dense):
    """Phase 5's gates and measurements on its flash and dense passes."""
    passes = {"flash": flash, "dense": dense}
    steps, layers = len(flash["losses"]), flash["res"].state.model.cfg.num_layers
    for p in passes.values():
        log(f"  {p['impl']}: losses {[round(x, 5) for x in p['losses']]}; step "
            f"{p['step_ms']:.2f} ms (median of steps 2-{steps}), {p['tok_s']:.0f} tokens/s, "
            f"MFU {100 * p['mfu']:.2f}% (flops_per_example x3 over 989e12), peak memory "
            f"{p['peak_gib']:.2f} GiB, run wall {p['wall_s']:.1f} s, launches {p['launches']}")
        if not np.isfinite(p["losses"]).all():
            raise SmokeFailure(f"{p['impl']}: non-finite loss")
        if not p["losses"][-1] < p["losses"][0]:
            raise SmokeFailure(f"{p['impl']}: loss did not fall ({p['losses']})")
    if any(flash["launches"][n] != layers * steps for n in FLASH_NAMES) \
            or any(flash["launches"][n] for n in LN_NAMES):
        raise SmokeFailure(f"flash pass: want {layers} launches a step of each flash kernel "
                           f"over {steps} steps and none of LN+matmul, got {flash['launches']}")
    if any(dense["launches"].values()):
        raise SmokeFailure(f"dense pass launched a flash kernel: {dense['launches']}")
    loss_diff = max(abs(a - b) for a, b in zip(flash["losses"], dense["losses"]))
    log(f"  per-step |loss flash - loss dense| max {loss_diff:.3e} (tol {TOL['train/loss']})")
    if loss_diff > TOL["train/loss"]:
        raise SmokeFailure(f"losses differ by {loss_diff}")
    worst, worst_name, skipped = 0.0, "", []
    for name, a, b in zip(flash["names"], flash["grads"], dense["grads"]):
        if not torch.isfinite(a).all():
            raise SmokeFailure(f"step-1 gradient of {name}: non-finite")
        if name.endswith("attn.key.bias"):
            # its exact gradient is 0 (softmax ignores a shift shared by a
            # row's logits): both passes hold rounding noise only
            skipped.append(f"{float(a.norm()):.1e}/{float(b.norm()):.1e}")
            continue
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    log(f"  step-1 gradients: worst relative L2 error {worst:.3e} ({worst_name}; tol "
        f"{TOL['train/grad_rel_l2']}) over {len(flash['names']) - len(skipped)} parameters; "
        f"attn.key.bias (exact gradient 0) norms flash/dense {skipped[:3]}...")
    if worst > TOL["train/grad_rel_l2"]:
        raise SmokeFailure(f"step-1 gradient of {worst_name} differs by {worst}")
    prof = profile_train_step(torch, flash["res"])
    out = {k: flash[k] for k in ("losses", "step_ms", "tok_s", "mfu", "peak_gib")}
    out.update(dense_step_ms=dense["step_ms"], loss_diff=loss_diff, grad_rel=worst,
               profile=prof, flash_launches={n: flash["launches"][n] for n in FLASH_NAMES})
    dense["res"] = None
    torch.cuda.empty_cache()
    big = train_pass(torch, np, "flash", batch=64, steps=3)
    log(f"  flash at global batch 64: losses {[round(x, 5) for x in big['losses']]}; step "
        f"{big['step_ms']:.2f} ms, {big['tok_s']:.0f} tokens/s, MFU {100 * big['mfu']:.2f}%, "
        f"peak memory {big['peak_gib']:.2f} GiB")
    out["batch64"] = {k: big[k] for k in ("step_ms", "tok_s", "mfu", "peak_gib")}
    return out


# ---------------------------------------------------------------------------
# phase 6: train resnet50_imagenet at full size, fused kernels vs standard
# ---------------------------------------------------------------------------

#: momentum 0.9 with the preset's coupled L2 1e-4 at a constant lr 0.1 (the
#: preset's 0.4 scaled to batch 256; its 6255-step warmup would train at
#: lr ~0 for the smoke's 6 steps) — a smoke setting, not a recipe
RESNET_OVERRIDES = [
    "--train.log_every=1", "--optimizer.warmup_steps=0", "--optimizer.schedule=constant",
    "--optimizer.learning_rate=0.1", "--data.global_batch_size=256", "--train.num_steps=6",
    "--train.eval_batches=0",  # no eval pass: phase 8 drives the evaluator
]
#: parameters listed with their gradient errors, worst first
RESNET_SHOW = 5
#: (mean, std) of the bn3 scales every pass starts from (numpy, seed 5) in
#: place of flax's zero init, so that step 1's branch gradients are not 0
RESNET_BN3_SCALE = (0.25, 0.05)
#: (block_impl, DTF_FUSED_BWD) of the three passes; the last is the reference
RESNET_PASSES = (("fused", "pallas"), ("fused", "xla"), ("standard", "xla"))
#: the f32 check: one step of the fused model with every kernel and one of
#: the standard model, which every bf16 pass's gradient is held to
RESNET_F32_PASSES = (("fused", "pallas"), ("standard", "xla"))
RESNET_F32_OVERRIDES = ("--model.dtype=float32", "--train.num_steps=1")


def resnet_launch_rule(cfg) -> dict[str, int]:
    """Launches a step the port's rule predicts for the fused model under
    bwd_impl="pallas": one forward per 1x1 conv; the single-pass backward
    where ``single_pass`` holds, else the dx + dw pair."""
    from distributed_tensorflow_tpu_torch.ops.fused_conv_bn import single_pass

    convs, cin = [], cfg.width
    for stage, blocks in enumerate(cfg.stage_sizes):
        f = cfg.width * 2 ** stage
        for block in range(blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            convs += [(cin, f), (f, 4 * f)] + ([(cin, 4 * f)] if cin != 4 * f or stride != 1
                                               else [])
            cin = 4 * f
    single = sum(single_pass(*c) for c in convs)
    return {"conv_bn_fwd": len(convs), "conv_bn_bwd_single": single,
            "conv_bn_bwd_dx": len(convs) - single, "conv_bn_bwd_dw": len(convs) - single}


def resnet_pass(torch, np, impl, bwd, path, extra=()):
    """One ``run_workload("resnet50_imagenet", ...)`` with the launch counts
    set to 0 just before it and read just after, from the workload's
    random weights with the bn3 scales drawn from ``RESNET_BN3_SCALE``.
    Where step 1 hands its gradient to the optimizer it captures the
    gradient and the BN running statistics' step-1 update (running minus
    initial: the batch statistics of step 1's forward, times 0.1)."""
    from distributed_tensorflow_tpu_torch.models import resnet
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb
    from distributed_tensorflow_tpu_torch.train import optimizers as topt
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    captured = {}
    update, init_params, build = topt.Optimizer.update, resnet.init_params, resnet.build

    def spy(self, grads):
        if self.count == 0:
            captured["grads"] = [g.detach().float().clone() for g in grads]
            captured["bn_update"] = {n: b.detach().float() - captured["bn_init"][n]
                                     for n, b in captured["model"].named_buffers()}
        return update(self, grads)

    def perturbed_init(*args, **kw):
        params = init_params(*args, **kw)
        rng = np.random.default_rng(5)
        for name in sorted(params):
            if name.endswith("bn3.weight"):
                params[name] = torch.from_numpy(rng.normal(
                    *RESNET_BN3_SCALE, params[name].shape).astype(np.float32)).to(params[name])
        return params

    def recording_build(*args, **kw):
        model = captured["model"] = build(*args, **kw)
        captured["bn_init"] = {n: b.detach().float().clone() for n, b in model.named_buffers()}
        return model

    topt.Optimizer.update, resnet.init_params, resnet.build = spy, perturbed_init, recording_build
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in fcb.KERNELS.values():
            k.launches = 0  # main path starts
        t0 = time.perf_counter()
        with fused_bwd(bwd):
            res = run_workload("resnet50_imagenet", RESNET_OVERRIDES + [
                f"--model.block_impl={impl}", f"--data.dataset=npz:{path}", *extra],
                device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in fcb.KERNELS.items()}  # main path read
    finally:
        topt.Optimizer.update, resnet.init_params, resnet.build = update, init_params, build
    if "grads" not in captured:
        raise SmokeFailure(f"resnet {impl}/{bwd}: no step-1 gradient reached the optimizer")
    hist = res.history
    steady = [r for r in hist if "steps_per_sec" in r]  # none in a one-step pass

    def median(key):
        return float(np.median([r.get(key, np.nan) for r in steady])) if steady else np.nan

    step_ms = 1e3 / median("steps_per_sec")
    model = res.state.model
    batch = resnet_run_cfg().data.global_batch_size
    return dict(impl=impl, bwd=bwd, res=res, losses=[r["loss"] for r in hist], wall_s=wall,
                step_ms=step_ms, img_s=batch * 1e3 / step_ms, mfu=median("mfu"),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                grads=captured["grads"], bn_update=captured["bn_update"], launches=launches,
                names=[n for n, _ in model.named_parameters()])


def profile_resnet_step(torch, np, res, path):
    """One more fused step (bwd_impl="pallas") of the trained state under
    torch.profiler, its batch already on the device: device time by
    kernel, and the device's busy share of the step's wall time (the
    timed steps of ``run_workload`` also gather and copy their batch)."""
    from distributed_tensorflow_tpu_torch.data.pipeline import NpzDataset
    from distributed_tensorflow_tpu_torch.models import common
    from distributed_tensorflow_tpu_torch.train import make_train_step

    model = res.state.model
    step = make_train_step(common.classification_loss_fn(model, label_smoothing=0.1))
    host = NpzDataset(path, resnet_run_cfg().data).batch(0)
    dev = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    act = torch.profiler.ProfilerActivity
    with fused_bwd("pallas"):
        state, m = step(res.state, dev)
        float(m["loss"])
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, dev)
            float(m["loss"])
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in device_events(torch, prof) if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"  profiled fused step (B=256, bwd pallas, batch preloaded on the device, profiler "
        f"on): wall {wall_ms:.2f} ms, device "
        f"busy {busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% (idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    conv = {}
    for e in events:
        # the port's kernels of fused_conv_bn.cu (PyTorch has a reduce_kernel too)
        m = re.search(r"\(anonymous namespace\)::(conv_bn_\w+_kernel|reduce_kernel)\b", e.key)
        if m:
            ms, n = conv.get(m.group(1), (0.0, 0))
            conv[m.group(1)] = (ms + e.self_device_time_total / 1e3, n + e.count)
    log("  conv+BN kernels of the profiled step (device ms, launches): " + ", ".join(
        f"{k} {ms:.3f} ({n}x)" for k, (ms, n) in sorted(conv.items())))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "conv_bn": conv}


def resnet_run_cfg():
    """The RunConfig the passes run (before their block_impl and dataset)."""
    from distributed_tensorflow_tpu_torch.utils.config import apply_overrides
    from distributed_tensorflow_tpu_torch.workloads import resnet50_imagenet

    return apply_overrides(resnet50_imagenet.default_config(), RESNET_OVERRIDES)


def resnet_diffs(torch, p, q) -> dict:
    """Pass ``p`` against pass ``q``: the step-1 loss difference, the
    largest per-step loss difference, the worst relative L2 error of the
    BN statistics' step-1 update (per buffer), and the step-1 gradients'
    relative L2 errors per parameter (``rows``, worst first)."""
    def rel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    rows = []
    for name, a, b in zip(p["names"], p["grads"], q["grads"]):
        if not torch.isfinite(a).all():
            raise SmokeFailure(f"resnet {p['tag']}: step-1 gradient of {name} is non-finite")
        rows.append((rel(a, b), name, float((a - b).norm()), float(b.norm())))
    rows.sort(reverse=True)
    return dict(tag=f"{p['tag']} vs {q['tag']}", rows=rows, worst=rows[0][0],
                median=rows[len(rows) // 2][0], loss1=abs(p["losses"][0] - q["losses"][0]),
                loss=max(abs(a - b) for a, b in zip(p["losses"], q["losses"])),
                bn=max((rel(a, q["bn_update"][n]), n) for n, a in p["bn_update"].items()))


def gate_resnet(d, limits: dict, note: str = "") -> dict:
    """Log ``d`` (``resnet_diffs``) with the ``RESNET_SHOW`` worst
    gradients and fail if a number named in ``limits`` exceeds its limit."""
    got = {"loss1": d["loss1"], "loss": d["loss"], "bn": d["bn"][0], "worst": d["worst"],
           "median": d["median"]}
    lim = lambda k: f" (limit {limits[k]:.3g})" if k in limits else ""  # noqa: E731
    log(f"  {d['tag']}: step-1 |loss diff| {d['loss1']:.3e}{lim('loss1')}, per-step max "
        f"{d['loss']:.3e}{lim('loss')}; BN step-1 update worst relative L2 {d['bn'][0]:.3e} "
        f"({d['bn'][1]}){lim('bn')}; step-1 gradients relative L2: worst {d['worst']:.3e} "
        f"({d['rows'][0][1]}){lim('worst')}, median {d['median']:.3e}{lim('median')} over "
        f"{len(d['rows'])} parameters{note}")
    for rel, name, err, ref in d["rows"][:RESNET_SHOW]:
        log(f"    {name}: relative {rel:.3e}, |a-b| {err:.3e}, |b| {ref:.3e}")
    bad = {k: got[k] for k in limits if not got[k] <= limits[k]}
    if bad:
        raise SmokeFailure(f"resnet {d['tag']}: outside tolerance: {bad}")
    return got


def phase_resnet(torch, np, card):
    log(f"phase 6: train resnet50_imagenet (ResNet-50, space_to_depth stem, 224x224, 1000 "
        f"classes, bf16, random weights from seed 0 with bn3 scales ~N{RESNET_BN3_SCALE}, "
        f"global batch 256, momentum + L2 1e-4 at "
        f"a constant lr 0.1, label smoothing 0.1, 6 steps — a smoke setting) through "
        f"run_workload: fused + pallas backward, fused + xla backward, standard; then one f32 "
        f"step fused + pallas and standard; on {card}")
    import tempfile

    from distributed_tensorflow_tpu_torch.data.pipeline import SyntheticClassification

    # two SyntheticClassification batches (a 602 MB teacher and a 77 GFLOP
    # host product each), built once and written as an npz: the steps
    # revisit its 512 images, so the loss falls if the backward is right
    t0 = time.perf_counter()
    data = SyntheticClassification(resnet_run_cfg().data)
    corpus = [data.batch(i) for i in range(2)]
    del data
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "images.npz")
    np.savez(path, image=np.concatenate([b["image"] for b in corpus]),
             label=np.concatenate([b["label"] for b in corpus]))
    del corpus
    log(f"  corpus: SyntheticClassification batches 0-1 (512 images) as npz:{path} in "
        f"{time.perf_counter() - t0:.1f}s")
    passes, f32 = [], []
    with tmp:
        for impl, bwd in RESNET_PASSES:
            passes.append(resnet_pass(torch, np, impl, bwd, path))
            p = passes[-1]
            p["tag"] = f"{impl}/{bwd}"
            log(f"  {impl} ({bwd} backward): losses {[round(x, 5) for x in p['losses']]}; step "
                f"{p['step_ms']:.2f} ms (median of steps 2-6), {p['img_s']:.1f} images/s, MFU "
                f"{100 * p['mfu']:.2f}% (flops_per_example x 256 x 3 over 989e12), peak memory "
                f"{p['peak_gib']:.2f} GiB, run wall {p['wall_s']:.1f} s, launches {p['launches']}")
            if not np.isfinite(p["losses"]).all():
                raise SmokeFailure(f"resnet {impl}/{bwd}: non-finite loss")
            if not p["losses"][-1] < p["losses"][0]:
                raise SmokeFailure(f"resnet {impl}/{bwd}: loss did not fall ({p['losses']})")
            if impl == "fused" and bwd == "pallas":
                prof = profile_resnet_step(torch, np, p["res"], path)
            p["res"] = None  # keep the numbers, free the model
            torch.cuda.empty_cache()
        for impl, bwd in RESNET_F32_PASSES:
            f32.append(resnet_pass(torch, np, impl, bwd, path, RESNET_F32_OVERRIDES))
            f32[-1].update(res=None, tag=f"f32 {impl}/{bwd}")
            log(f"  f32 {impl} ({bwd} backward), one step: loss {f32[-1]['losses'][0]:.6f}, "
                f"peak memory {f32[-1]['peak_gib']:.2f} GiB, launches {f32[-1]['launches']}")
            torch.cuda.empty_cache()
    pallas, xla, ref = passes
    f32_pallas, f32_ref = f32
    rule = resnet_launch_rule(resnet_run_cfg().model)
    steps = len(ref["losses"])
    want = {"fused/pallas": {n: c * steps for n, c in rule.items()},
            "fused/xla": {n: (c * steps if n == "conv_bn_fwd" else 0) for n, c in rule.items()},
            "standard/xla": {n: 0 for n in rule}, "f32 fused/pallas": rule,
            "f32 standard/xla": {n: 0 for n in rule}}
    for p in passes + f32:
        if p["launches"] != want[p["tag"]]:
            raise SmokeFailure(f"resnet {p['tag']}: launches {p['launches']}, the rule predicts "
                               f"{want[p['tag']]} ({rule} a step)")
    log(f"  launches a step by the port's rule (fused, pallas): {rule}; every pass matched")
    out = {"launches": pallas["launches"], "rule": rule, "profile": prof, "compare": {},
           "passes": {}}
    # f32: every kernel against the standard model, where rounding is small
    # enough for a step-1 gradient to show a kernel's fault
    out["compare"]["f32"] = f32_diff = gate_resnet(resnet_diffs(torch, f32_pallas, f32_ref), {
        "loss1": TOL["resnet/f32/loss"], "bn": TOL["resnet/f32/bn_update"],
        "worst": TOL["resnet/f32/grad_rel_l2"], "median": TOL["resnet/f32/grad_rel_l2/median"]})
    # bf16: the step-1 gradient is held to the f32 standard model, no
    # further from it than the bf16 standard model is (nor than f32's own
    # summation order moves it)
    floor = gate_resnet(resnet_diffs(torch, ref, f32_ref), {}, " (the bf16 noise floor)")
    floor = max(floor["median"], f32_diff["median"])
    for p in (pallas, xla):
        out["compare"][f"{p['tag']} vs standard/xla"] = gate_resnet(resnet_diffs(torch, p, ref), {
            "loss1": TOL["resnet/loss/step1"], "loss": TOL["resnet/loss"],
            "bn": TOL["resnet/bn_update"]})
        limit = TOL["resnet/grad_vs_f32"] * floor
        out["compare"][f"{p['tag']} vs f32"] = gate_resnet(
            resnet_diffs(torch, p, f32_ref), {"median": limit},
            f" (limit: {TOL['resnet/grad_vs_f32']} x the noise floor's median)")
    out["compare"]["bwd"] = gate_resnet(resnet_diffs(torch, pallas, xla), {
        "bn": TOL["resnet/bn_update"], "worst": TOL["resnet/grad_rel_l2/bwd"],
        "median": TOL["resnet/grad_rel_l2/bwd/median"]})
    for p in passes:
        out["passes"][p["tag"]] = {
            k: p[k] for k in ("step_ms", "img_s", "mfu", "peak_gib", "losses")}
    return out


# ---------------------------------------------------------------------------
# phase 7: the bench, data-parallel ResNet-50 on the card, the fed path
# ---------------------------------------------------------------------------

#: phase 7a: ``distributed_tensorflow_tpu_torch.bench`` in this process, in
#: a process group of one over NCCL: ResNet-50 with the fused blocks and the
#: pallas backward, 256 images, 224x224, BENCH_STEPS measured steps a window
BENCH_ENV = {"BENCH_BLOCK_IMPL": "fused", "BENCH_BATCH": "256", "BENCH_STEPS": "6"}
#: the bench's steps: 3 warmup + BENCH_STEPS resident, 2 warmup + BENCH_STEPS fed
BENCH_STEPS_RUN = 3 + 6 + 2 + 6
#: phase 7b: two processes on the one card over gloo (NCCL refuses two
#: ranks on one GPU), ResNet-50 at full width from phase 6's weights (the
#: bn3 scales drawn non-zero), one step on a global batch of DP_GLOBAL
#: (half a rank), fused + pallas in bf16 and in f32, held against one
#: process on the same global batch
DP_GLOBAL = 64
DP_PASSES = (("fused", "pallas", "bfloat16"), ("fused", "pallas", "float32"))
#: phase 7c: host batches of the bench's shape through Prefetcher +
#: DevicePut (a 2-slot pinned ring, so every slot is refilled)
FED_CHECK_BATCHES = 6


def load_dp_worker():
    """``tests/torch_dp_worker.py`` (the ranks' script and the one-process
    reference's ``train_steps``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_dp_worker", os.path.join(REPO, "tests", "torch_dp_worker.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_world1(torch, np, card):
    """Phase 7a: the bench's two windows in this process at world 1 over
    NCCL, the conv+BN launch counts set to 0 just before and read just
    after; fails unless every kernel launched the rule's count a step."""
    from distributed_tensorflow_tpu_torch import bench
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb
    from distributed_tensorflow_tpu_torch.parallel import cluster

    worker = load_dp_worker()
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(worker.free_port())}
    for k in fcb.KERNELS.values():
        k.launches = 0  # main path starts
    t0 = time.perf_counter()
    try:
        with mock.patch.dict(os.environ, env), fused_bwd("pallas"):
            row = bench.run(DEVICE, env=BENCH_ENV)
            backend = row["provenance"]["backend"]
    finally:
        cluster.shutdown()
    launches = {n: k.launches for n, k in fcb.KERNELS.items()}  # main path read
    wall = time.perf_counter() - t0
    rule = resnet_launch_rule(resnet_run_cfg().model)
    want = {n: c * BENCH_STEPS_RUN for n, c in rule.items()}
    prov = row["provenance"]
    log(f"  7a bench (world 1, {backend}, fused + pallas, batch {row['global_batch']}, "
        f"{row['image_size']}x{row['image_size']}, {BENCH_ENV['BENCH_STEPS']} measured steps a "
        f"window): {row['value']} images/s per card, MFU {row['mfu']}, fed "
        f"{row['pipeline_fed_images_per_sec_per_chip']} images/s, pipeline_efficiency "
        f"{row['pipeline_efficiency']}; {prov['device_kind']}, {prov['power_limit']}; "
        f"wall {wall:.1f} s; launches {launches}")
    log(f"  7a bench line: {json.dumps(row)}")
    if backend != ("nccl" if DEVICE == "cuda" else "gloo"):
        raise SmokeFailure(f"phase 7a: the bench ran over {backend!r}")
    if launches != want:
        raise SmokeFailure(f"phase 7a: launches {launches}, the rule predicts {want} "
                           f"({rule} a step x {BENCH_STEPS_RUN} steps)")
    # the measured fed steps take host batches 2, 3, 0, 1, 2, 3 (the warmup 0, 1)
    fed_losses = row["fed_losses"]
    first, last = np.mean(fed_losses[:2]), np.mean(fed_losses[-2:])
    log(f"  7c fed window losses {[round(x, 5) for x in fed_losses]}: batches 2 and 3 at "
        f"their first visit {first:.5f}, at their second {last:.5f}")
    if len(fed_losses) < 6 or not np.isfinite(fed_losses).all() or not last < first:
        raise SmokeFailure(f"phase 7c: the fed window's loss is not finite and falling "
                           f"({fed_losses})")
    return {"row": row, "launches": launches, "fed_losses": fed_losses, "wall_s": wall}


def fed_bitwise(torch, np):
    """Phase 7c: the first FED_CHECK_BATCHES batches out of the Prefetcher's
    side-stream copies equal their host batches bit for bit."""
    from distributed_tensorflow_tpu_torch.data.pipeline import DevicePut, Prefetcher

    data = resnet_run_cfg().data  # the bench's batch and image size
    b, size = data.global_batch_size, data.image_size
    gen = torch.Generator().manual_seed(7)
    host = [{"image": torch.randn(b, size, size, 3, generator=gen).to(torch.bfloat16),
             "label": torch.randint(0, 1000, (b,), generator=gen, dtype=torch.int32)}
            for _ in range(FED_CHECK_BATCHES)]
    put = DevicePut(DEVICE)
    for i, staged in enumerate(Prefetcher(host, depth=2, transform=put)):
        got = staged.wait()
        for k, v in got.items():
            if v.device != put.device or not torch.equal(v.cpu(), host[i][k]):
                raise SmokeFailure(f"phase 7c: batch {i}'s {k} after the side-stream copy "
                                   f"differs from its host batch")
    log(f"  7c {FED_CHECK_BATCHES} batches ({b}x{size}x{size}x3 bf16 + labels) through Prefetcher "
        f"+ DevicePut ({put.SLOTS} pinned slots): bitwise equal to their host batches")
    return FED_CHECK_BATCHES


def dp_diff(np, got: dict, ref: dict, init: dict) -> dict:
    """One step (``{"losses": ..., <state dict>}``) against a reference step
    from the same ``init`` state dict: |loss diff|, the worst relative L2
    error of a BN running
    statistic's update, and the parameters' updates' relative L2 errors
    (worst, median)."""
    def rel(a, b):
        return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-30)

    bn, upd = [], []
    for name, want in ref.items():
        if name == "losses":
            continue
        r = rel(got[name] - init[name], want - init[name])
        (bn if "running_" in name else upd).append((r, name))
    upd.sort(reverse=True)
    return {"loss": abs(float(got["losses"][0]) - float(ref["losses"][0])), "bn": max(bn),
            "worst": upd[0], "median": upd[len(upd) // 2][0]}


def dp_one_card(torch, np):
    """Phase 7b: the dp2 job on the one card over gloo, against one-process
    steps on the global batch run here meanwhile (and phase 7c's bitwise
    check), with the f32 pass also against a one-process step on rank
    0's half alone (the control: it must be far off)."""
    import dataclasses
    import tempfile

    from distributed_tensorflow_tpu_torch.models import resnet

    worker = load_dp_worker()
    cfg, size = resnet_run_cfg().model, resnet_run_cfg().data.image_size
    sd = resnet.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    for name in sorted(sd):
        if name.endswith("bn3.weight"):
            sd[name] = torch.from_numpy(rng.normal(*RESNET_BN3_SCALE, sd[name].shape)
                                        .astype(np.float32))
    sd = {k: v.numpy() for k, v in sd.items()}
    rng = np.random.default_rng(70)
    batch = {"image": rng.standard_normal((DP_GLOBAL, size, size, 3)).astype(np.float32),
             "label": rng.integers(0, cfg.num_classes, DP_GLOBAL).astype(np.int32)}
    cfg_dict = dataclasses.asdict(cfg)
    with tempfile.TemporaryDirectory() as out:
        inputs = os.path.join(out, "inputs.npz")
        np.savez(inputs, **{f"sd/{k}": v for k, v in sd.items()},
                 **{f"{k}0": v for k, v in batch.items()})
        t0 = time.perf_counter()
        procs = worker.launch({"job": "resnet", "device": DEVICE, "backend": "gloo",
                               "out": out, "inputs": inputs,
                               "cfg": cfg_dict, "impls": [list(p) for p in DP_PASSES]})
        refs = {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            n_fed = fed_bitwise(torch, np)
            for impl, bwd, dtype in DP_PASSES:
                c = dataclasses.replace(cfg, block_impl=impl, dtype=dtype)
                refs[f"{impl}/{bwd}/{dtype}"] = worker.train_steps(c, sd, [batch], DEVICE, bwd=bwd)
                torch.cuda.empty_cache()
            half = {k: v[:DP_GLOBAL // 2] for k, v in batch.items()}
            control = worker.train_steps(dataclasses.replace(cfg, dtype="float32"), sd, [half],
                                         DEVICE, bwd="pallas")
        except BaseException:
            worker.stop(procs)
            raise
        finally:
            torch.backends.cudnn.deterministic = deterministic
        ranks = worker.wait(procs, out, timeout=600)
        wall = time.perf_counter() - t0
    rule = resnet_launch_rule(cfg)
    out = {"passes": {}, "wall_s": wall, "fed_bitwise": n_fed}
    flat = lambda res: {"losses": res["losses"], **res["state"]}  # noqa: E731
    f32_ref = flat(refs["fused/pallas/float32"])
    for impl, bwd, dtype in DP_PASSES:
        tag = f"{impl}/{bwd}/{dtype}"
        got = [{"losses": r[f"{tag}/losses"], **{k[len(tag) + 7:]: v for k, v in r.items()
                                                 if k.startswith(f"{tag}/state/")}}
               for r in ranks]
        for i, r in enumerate(ranks):
            launches = {n: int(r[f"{tag}/launches/{n}"]) for n in rule}
            if launches != rule:
                raise SmokeFailure(f"phase 7b {tag}: rank {i} launched {launches}, the rule "
                                   f"predicts {rule}")
        if not all(np.array_equal(got[0][k], got[1][k]) for k in got[0]):
            raise SmokeFailure(f"phase 7b {tag}: the two ranks' weights or losses differ")
        d = dp_diff(np, got[0], flat(refs[tag]), sd)
        got_n = {"loss": d["loss"], "bn": d["bn"][0], "worst": d["worst"][0],
                 "median": d["median"]}
        key = "f32" if dtype == "float32" else "bf16"
        lim = {k: TOL[f"dp/{key}/{k}"] for k in got_n if f"dp/{key}/{k}" in TOL}
        note = ""
        if dtype != "float32":
            # bf16: a step-1 gradient is rounding-dominated (phase 6), so the
            # updates are held to the f32 one-process step no further than
            # the bf16 one-process step is
            floor = dp_diff(np, flat(refs[tag]), f32_ref, sd)["median"]
            vs = dp_diff(np, got[0], f32_ref, sd)["median"]
            got_n["vs_f32"], lim["vs_f32"] = vs, TOL["dp/bf16/vs_f32"] * floor
            note = (f"; updates vs the f32 one-process step: median {vs:.3e} (limit "
                    f"{lim['vs_f32']:.3e}: {TOL['dp/bf16/vs_f32']} x the one-process bf16 "
                    f"step's {floor:.3e})")
        log(f"  7b {tag}: rank losses {[float(g['losses'][0]) for g in got]}, one process "
            f"{float(refs[tag]['losses'][0]):.6f}; |loss diff| {d['loss']:.3e}; BN update "
            f"worst relative L2 {d['bn'][0]:.3e} ({d['bn'][1]}); parameter updates relative "
            f"L2 worst {d['worst'][0]:.3e} ({d['worst'][1]}), median {d['median']:.3e}{note}; "
            f"limits {lim}; ranks bitwise alike; launches a rank {rule}")
        bad = {k: got_n[k] for k in lim if not got_n[k] <= lim[k]}
        if bad:
            raise SmokeFailure(f"phase 7b {tag}: outside tolerance: {bad}")
        out["passes"][tag] = got_n
        if dtype == "float32":
            ctl = dp_diff(np, got[0], flat(control), sd)
            log(f"  7b control, {tag} against one process on rank 0's half alone: BN update "
                f"worst relative L2 {ctl['bn'][0]:.3e} ({ctl['bn'][1]}), parameter updates "
                f"median {ctl['median']:.3e}")
            if not ctl["bn"][0] > 10 * lim["bn"]:
                raise SmokeFailure(f"phase 7b: the half-batch control is within 10x the BN "
                                   f"limit ({ctl['bn'][0]:.3e}): the gate cannot tell sync BN")
            out["control_bn"] = ctl["bn"][0]
    return out


def phase_dp(torch, np, card):
    log(f"phase 7: the bench at world 1 over NCCL (ResNet-50 fused + pallas, 256 images, "
        f"224x224), ResNet-50 data-parallel in two processes on this card over gloo (global "
        f"batch {DP_GLOBAL}, one step, bf16 and f32) against one process, and the fed path; "
        f"on {card}")
    t0 = time.perf_counter()
    out = {"bench": bench_world1(torch, np, card)}
    torch.cuda.empty_cache()
    out["dp"] = dp_one_card(torch, np)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 7 wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 8: train bert_pretrain at full width, flash kernels (non-causal) vs no kernel
# ---------------------------------------------------------------------------

#: bert_base (12 layers, d_model 768, 12 heads, d_ff 3072, vocab 30528,
#: S=512, the gathered MLM head: K=77), bf16, dropout 0.1, at global batch
#: 32 (a memory choice for one card without remat, not the preset's 256):
#: adamw at a constant lr 1e-4 with no warmup (the preset's 1000-step
#: warmup would leave the loss where it starts in 6 steps) — a smoke
#: setting, not a recipe; the final eval of 4 batches
BERT_OVERRIDES = [
    "--train.log_every=1", "--optimizer.warmup_steps=0", "--optimizer.schedule=constant",
    "--optimizer.learning_rate=1e-4", "--train.eval_batches=4",
]
BERT_BATCH, BERT_STEPS = 32, 6


def bert_cfg(extra=()):
    from distributed_tensorflow_tpu_torch.utils.config import apply_overrides
    from distributed_tensorflow_tpu_torch.workloads import bert_pretrain

    return apply_overrides(bert_pretrain.default_config(), BERT_OVERRIDES + [
        f"--data.global_batch_size={BERT_BATCH}", *extra])


def bert_step(torch, np, impl, batch, extra=()):
    """One step of ``bert_pretrain``'s model, loss and optimizer (the
    workload's ``build``, random weights from its seed) on the host
    ``batch``, with ``attention_impl=impl``: the loss, the step-1
    gradients and the flash launches of the step."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.train import (
        init_train_state, make_optimizer, make_train_step, optimizers as topt)
    from distributed_tensorflow_tpu_torch.workloads import bert_pretrain

    cfg = bert_cfg([f"--model.attention_impl={impl}", *extra])
    parts = bert_pretrain.build(cfg, torch.device(DEVICE))
    opt = make_optimizer(cfg.optimizer, parts.model.parameters())
    state = init_train_state(parts.model, opt, seed=cfg.train.seed)
    step = make_train_step(parts.loss_fn)
    captured, update = {}, topt.Optimizer.update

    def spy(self, grads):
        captured["grads"] = [g.detach().float().clone() for g in grads]
        return update(self, grads)

    dev = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    topt.Optimizer.update = spy
    try:
        for n in FLASH_NAMES:
            getattr(fa, n).launches = 0  # main path starts
        state, m = step(state, dev)
        losses = [float(m["loss"])]
        launches = {n: getattr(fa, n).launches for n in FLASH_NAMES}  # main path read
    finally:
        topt.Optimizer.update = update
    names = [n for n, _ in parts.model.named_parameters()]
    del parts, state, opt, step
    torch.cuda.empty_cache()
    return dict(losses=losses, grads=captured["grads"], names=names, launches=launches)


def padded_bert_batch(np, batch, rng):
    """``batch`` with an attention_mask of ``padded_mask``'s lengths, each
    row's gathered positions redrawn in its valid prefix, and the row that
    attends nothing kept out of the loss (its labels IGNORE_INDEX, as the
    JAX streams' padding is)."""
    from distributed_tensorflow_tpu_torch.data.text import IGNORE_INDEX

    B, S = batch["input_ids"].shape
    K = batch["masked_positions"].shape[1]
    mask = padded_mask(np, rng, B, S)
    lens = mask.sum(1)
    out = dict(batch, attention_mask=mask.astype(np.int32))
    out["masked_positions"] = np.stack(
        [np.sort(rng.choice(n, K, replace=False)) if n else np.arange(K)
         for n in lens]).astype(np.int32)
    out["masked_labels"] = np.where(lens[:, None] > 0, batch["masked_labels"],
                                    IGNORE_INDEX).astype(np.int32)
    return out


def bert_eval_same_weights(torch, extra=()) -> dict:
    """Phase 8's eval gate: ``bert_pretrain``'s eval (``mlm_eval_fn``
    through a ``ShardedEvaluator``) with flash and with dense attention on
    the same random weights (the workload's seed) in f32, before any step
    moves them apart, over the workload's held-out eval batches. Per batch: the
    relative difference of ``loss_sum`` and the relative L2 of the eval
    forward's gathered logits, flash against dense, beside a control
    (dense with its attention output x1.01) that each limit must fail.
    (The trained passes' eval metrics are printed, not gated: six steps
    on two paths diverge, and the accuracy of random weights reads 0.)"""
    from distributed_tensorflow_tpu_torch.models import transformer as tfm
    from distributed_tensorflow_tpu_torch.obs.registry import Registry
    from distributed_tensorflow_tpu_torch.parallel.sharding import put_host_batch
    from distributed_tensorflow_tpu_torch.train.evaluation import ShardedEvaluator
    from distributed_tensorflow_tpu_torch.train.step import TrainState
    from distributed_tensorflow_tpu_torch.workloads import bert_pretrain

    cfg = bert_cfg(extra)
    parts = {impl: bert_pretrain.build(bert_cfg([*extra, "--model.dtype=float32",
                                                 f"--model.attention_impl={impl}"]),
                                       torch.device(DEVICE)) for impl in ("flash", "dense")}
    batches = list(parts["dense"].eval_dataset_fn(cfg.train.eval_batches))
    attention = tfm.attention

    def scaled(*a, **k):
        return attention(*a, **k) * 1.01

    ref_logits: list = []
    readings = {}
    for name, impl in (("dense", "dense"), ("flash", "flash"), ("control", "dense")):
        p = parts[impl]
        evaluator = ShardedEvaluator(p.eval_fn, registry=Registry())
        state = TrainState(step=0, model=p.model, optimizer=None, generator=None)
        tfm.attention = scaled if name == "control" else attention
        sums, correct, l2 = [], [], []
        try:
            for i, b in enumerate(batches):
                totals = evaluator.run(state, [b])
                sums.append(float(totals["loss_sum"]))
                correct.append(float(totals["correct"]))
                dev = put_host_batch(b, DEVICE)
                p.model.eval()
                with torch.no_grad():
                    logits = p.model(dev["input_ids"], dev.get("attention_mask"),
                                     positions=dev["masked_positions"])
                p.model.train()
                if name == "dense":
                    ref_logits.append(logits)
                else:
                    l2.append(rel_l2(logits, ref_logits[i]))
        finally:
            tfm.attention = attention
        readings[name] = dict(loss_sum=sums, correct=correct, logits_rel_l2=l2)
    ref = readings["dense"]["loss_sum"]
    for name in ("flash", "control"):
        r = readings[name]
        r["loss_sum_rel"] = [abs(a - b) / abs(b) for a, b in zip(r["loss_sum"], ref)]
    log(f"  f32 eval on the same random weights ({len(batches)} held-out batches of "
        f"{BERT_BATCH} x {batches[0]['masked_positions'].shape[1]} predictions), per batch vs "
        f"dense: " + "; ".join(
            f"{name}: loss_sum relative diff {[f'{x:.3e}' for x in readings[name]['loss_sum_rel']]}"
            f", logits relative L2 {[f'{x:.3e}' for x in readings[name]['logits_rel_l2']]}, "
            f"correct {readings[name]['correct']}" for name in ("flash", "control"))
        + f"; dense loss_sum {[f'{x:.4f}' for x in ref]}, correct {readings['dense']['correct']}"
        f"; limits: loss_sum {TOL['bert/eval/loss_sum']}, logits {TOL['bert/eval/logits']}")
    for key, tol in (("loss_sum_rel", TOL["bert/eval/loss_sum"]),
                     ("logits_rel_l2", TOL["bert/eval/logits"])):
        if max(readings["flash"][key]) > tol:
            raise SmokeFailure(f"bert eval, flash vs dense: {key} {readings['flash'][key]} > "
                               f"{tol}")
        if not max(readings["control"][key]) > tol:
            raise SmokeFailure(f"bert eval control (attention x1.01) passes the {key} limit "
                               f"{tol}: {readings['control'][key]}")
    del parts, ref_logits
    torch.cuda.empty_cache()
    return {name: {k: readings[name][k] for k in ("loss_sum_rel", "logits_rel_l2")}
            for name in ("flash", "control")}


def phase_bert(torch, np, card):
    """Phase 8: ``bert_pretrain`` through ``run_workload`` with the flash
    kernels (non-causal) and with dense attention, held to each other;
    one padded step and one f32 step of each; the final eval of both."""
    import tempfile

    from distributed_tensorflow_tpu_torch.data.text import (
        make_text_dataset, resolved_max_predictions)

    t_phase = time.perf_counter()
    cfg = bert_cfg()
    m, K = cfg.model, resolved_max_predictions(cfg.data)
    log(f"phase 8: train bert_pretrain (bert_base: {m.num_layers} layers, d_model {m.d_model}, "
        f"{m.num_heads} heads, d_ff {m.d_ff}, vocab {m.vocab_size}, S={cfg.data.seq_len}, "
        f"gathered head K={K}; bf16, dropout {m.dropout}, random weights from seed "
        f"{cfg.train.seed}) at global batch {BERT_BATCH}, {BERT_STEPS} steps of adamw at a "
        f"constant lr 1e-4 with no warmup (so the loss can move in {BERT_STEPS} steps: a "
        f"smoke setting), then eval of {cfg.train.eval_batches} batches; flash kernels "
        f"(non-causal) vs dense attention through run_workload; on {card}")
    # As in phase 5, a fresh synthetic stream brings new tokens every step,
    # so the MLM loss would not move in 6 steps: the steps revisit a fixed
    # corpus of 32 random sequences (a token file, tokens_mlm:), fresh
    # masks every batch
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "corpus.npy")
    np.save(path, np.random.default_rng(0).integers(
        0, m.vocab_size, BERT_BATCH * cfg.data.seq_len + 1).astype(np.int32))
    data = [f"--data.dataset=tokens_mlm:{path}"]
    log(f"  corpus: {BERT_BATCH} x {cfg.data.seq_len} random tokens as tokens_mlm:{path}")
    layers = m.num_layers
    with tmp:
        passes = {impl: train_pass(torch, np, impl, batch=BERT_BATCH, steps=BERT_STEPS,
                                   extra=data, workload="bert_pretrain",
                                   overrides=BERT_OVERRIDES) for impl in ("flash", "dense")}
        for p in passes.values():
            p["res"] = None
            ev = p["eval_metrics"]
            log(f"  {p['impl']}: losses {[round(x, 5) for x in p['losses']]}; step "
                f"{p['step_ms']:.2f} ms (median of steps 2-{BERT_STEPS}), {p['tok_s']:.0f} "
                f"tokens/s, MFU {100 * p['mfu']:.2f}% (flops_per_example with n_predictions={K}, "
                f"x3 over 989e12), peak memory {p['peak_gib']:.2f} GiB, run wall "
                f"{p['wall_s']:.1f} s; launches: steps {p['launches']}, eval "
                f"{p['eval_launches']}; eval loss {ev['loss']:.5f}, accuracy "
                f"{ev['accuracy']:.5f} over {ev['count']:.0f} predictions")
            if not np.isfinite(p["losses"]).all():
                raise SmokeFailure(f"bert {p['impl']}: non-finite loss")
            if not p["losses"][-1] < p["losses"][0]:
                raise SmokeFailure(f"bert {p['impl']}: loss did not fall ({p['losses']})")
        flash, dense = passes["flash"], passes["dense"]
        want = {n: layers * BERT_STEPS for n in FLASH_NAMES}
        want_eval = {"flash_fwd": layers * cfg.train.eval_batches, "flash_bwd_dkv": 0,
                     "flash_bwd_dq": 0}
        got = {n: flash["launches"][n] for n in FLASH_NAMES}
        got_eval = {n: flash["eval_launches"][n] for n in FLASH_NAMES}
        if got != want or got_eval != want_eval or any(
                flash["launches"][n] or flash["eval_launches"][n] for n in LN_NAMES):
            raise SmokeFailure(f"bert flash pass: want {want} in the steps and {want_eval} in "
                               f"the eval, got {got} and {got_eval}")
        if any(dense["launches"].values()) or any(dense["eval_launches"].values()):
            raise SmokeFailure(f"bert dense pass launched a kernel: {dense['launches']}, "
                               f"{dense['eval_launches']}")
        out = {"compare": {"flash vs dense": gate_train(
            train_diffs(torch, flash, dense), "bert flash vs dense (bf16, 6 steps)",
            TOL["train/loss"], TOL["train/grad_rel_l2"])}}
        out["eval"] = bert_eval_same_weights(torch, data)
        out["passes"] = {k: {f: p[f] for f in ("losses", "step_ms", "tok_s", "mfu", "peak_gib",
                                               "eval_metrics")} for k, p in passes.items()}
        out["launches"] = {"steps": got, "eval": got_eval}
        del passes, flash, dense
        torch.cuda.empty_cache()
        batch = make_text_dataset(bert_cfg(data).data).batch(0)
    padded = padded_bert_batch(np, batch, np.random.default_rng(3))
    lens = padded["attention_mask"].sum(1)
    steps = {impl: bert_step(torch, np, impl, padded) for impl in ("flash", "dense")}
    log(f"  padded step (valid lengths {int(lens[:-1].min())}-{int(lens.max())}, the last row "
        f"none and out of the loss): loss flash {steps['flash']['losses'][0]:.6f}, dense "
        f"{steps['dense']['losses'][0]:.6f}; flash launches {steps['flash']['launches']}")
    if steps["flash"]["launches"] != {n: layers for n in FLASH_NAMES} \
            or any(steps["dense"]["launches"].values()):
        raise SmokeFailure(f"bert padded step launches: {steps['flash']['launches']}, "
                           f"{steps['dense']['launches']}")
    out["compare"]["padded"] = gate_train(
        train_diffs(torch, steps["flash"], steps["dense"]), "bert padded step, flash vs dense "
        "(bf16)", TOL["train/loss"], TOL["train/grad_rel_l2"])
    f32 = {impl: bert_step(torch, np, impl, batch, ["--model.dtype=float32"])
           for impl in ("flash", "dense")}
    log(f"  f32 step: loss flash {f32['flash']['losses'][0]:.7f}, dense "
        f"{f32['dense']['losses'][0]:.7f}; flash launches {f32['flash']['launches']}")
    if f32["flash"]["launches"] != {n: layers for n in FLASH_NAMES}:
        raise SmokeFailure(f"bert f32 step launches: {f32['flash']['launches']}")
    out["compare"]["f32"] = gate_train(
        train_diffs(torch, f32["flash"], f32["dense"]), "bert f32 step, flash vs dense",
        TOL["train/f32/loss"], TOL["train/f32/grad_rel_l2"])
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 8 wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 9: checkpoint-restart on the card
# ---------------------------------------------------------------------------

#: phase 9a: phase 5b's gpt_lm setting (gpt_small, S=1024, bf16, the fixed
#: corpus, global batch 8, adamw at a constant lr, fused_ln_matmul with the
#: pallas backward, flash), checkpoints every 2 steps, the newest 2 kept
CKPT_STEPS = 6
CKPT_OVERRIDES = ["--model.attention_impl=flash", "--data.global_batch_size=8",
                  "--model.fused_ln_matmul=true", "--checkpoint.save_interval_steps=2",
                  "--checkpoint.max_to_keep=2", f"--train.num_steps={CKPT_STEPS}"]
#: the straight run's final eval, held bitwise to evaluate_from_checkpoint
CKPT_EVAL_BATCHES = 2
#: the AsyncCommitKill child (tests/torch_dp_worker.py's "ckpt" job) dies in
#: this step's commit; the resumed run gets a SIGTERM after CKPT_SIGTERM_AT
CKPT_KILL_AT, CKPT_SIGTERM_AT = 4, 3
CKPT_CHILD_TIMEOUT_S = 300
#: phase 9b: phase 6's ResNet-50 setting (fused + pallas, batch 256), one
#: SyntheticClassification batch as an npz: straight steps against half of
#: them, a save, a restore in a fresh run_workload and the other half
CKPT_RESNET_STEPS = 4


def lm_launch_rule(cfg) -> dict[str, int]:
    """Launches a step of phase 5b's fused + pallas pass (and of phase 9a):
    each flash kernel once a layer, the LN+matmul forward, dx and dw at q,
    k, v and mlp_in of every layer."""
    return {**{n: cfg.num_layers for n in FLASH_NAMES},
            **{n: 4 * cfg.num_layers for n in LN_NAMES}}


def ckpt_pass(torch, workload, overrides, counters, extra_callbacks=()):
    """One ``run_workload`` with ``counters``' launch counts set to 0 just
    before it and read when its steps end (before any eval)."""
    from distributed_tensorflow_tpu_torch.train import callbacks as tcb
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    seen = {}

    class StepsEnd(tcb.Callback):
        def on_train_end(self, trainer):
            seen.update({n: k.launches for n, k in counters.items()})

    torch.cuda.synchronize()
    for k in counters.values():
        k.launches = 0  # main path starts
    t0 = time.perf_counter()
    res = run_workload(workload, overrides, device=DEVICE,
                       extra_callbacks=[StepsEnd(), *extra_callbacks])
    torch.cuda.synchronize()
    return res, seen, time.perf_counter() - t0  # main path read: seen


def state_diff(torch, a, b) -> list[str]:
    """The checkpoint leaves (``train/step.state_leaves``) in which states
    ``a`` and ``b`` differ, bit for bit."""
    from distributed_tensorflow_tpu_torch.train.step import state_leaves

    la, lb = dict(state_leaves(a)), dict(state_leaves(b))
    if la.keys() != lb.keys():
        return sorted(set(la) ^ set(lb))
    return [n for n in la if la[n].dtype != lb[n].dtype or not torch.equal(la[n], lb[n])]


def steps_on_disk(d) -> list[int]:
    return sorted(int(n) for n in os.listdir(d) if n.isdigit())


def hist_read(name):
    """(count, sum) of a histogram of the process registry."""
    from distributed_tensorflow_tpu_torch.obs.registry import default_registry

    h = default_registry().histogram(name)
    return h.count, h.sum


def gate_resume(torch, tag, straight, parts, resumed, rule):
    """``resumed`` (the last attempt, after ``parts``) against the straight
    run: per-step losses and every state leaf bit for bit, and each
    attempt's launches ``rule`` a step."""
    hist = [h for p in parts for h in p[0].history]
    got = {h["step"]: h["loss"] for h in hist}
    want = {h["step"]: h["loss"] for h in straight.history}
    if [h["step"] for h in hist] != sorted(got) or any(got[k] != want[k] for k in got):
        raise SmokeFailure(f"phase 9 {tag}: resumed losses {got} differ from the straight run's "
                           f"{want}")
    diff = state_diff(torch, resumed.state, straight.state)
    if diff:
        raise SmokeFailure(f"phase 9 {tag}: the resumed state differs from the straight run's "
                           f"in {len(diff)} leaves: {diff[:6]}")
    for p in parts:
        steps = len(p[0].history)
        if p[1] != {n: c * steps for n, c in rule.items()}:
            raise SmokeFailure(f"phase 9 {tag}: an attempt of {steps} steps launched {p[1]}, "
                               f"the rule is {rule} a step")
    return {"steps": sorted(got), "losses": [got[k] for k in sorted(got)]}


def ckpt_gpt(torch, np, root):
    """Phase 9a: gpt_lm straight against killed + preempted + resumed."""
    import signal

    from distributed_tensorflow_tpu_torch import resilience as rz
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import fused_ln_matmul as fln
    from distributed_tensorflow_tpu_torch.train import checkpoint as tck
    from distributed_tensorflow_tpu_torch.utils.config import apply_overrides
    from distributed_tensorflow_tpu_torch.workloads import gpt_lm, runner

    counters = {**{n: getattr(fa, n) for n in FLASH_NAMES}, **fln.KERNELS}
    corpus = lm_corpus(np, os.path.join(root, "corpus.npy"))
    base = TRAIN_OVERRIDES + CKPT_OVERRIDES + [f"--data.dataset=tokens:{corpus}"]
    dir_a, dir_b = os.path.join(root, "straight"), os.path.join(root, "resumed")
    cfg_a = apply_overrides(gpt_lm.default_config(), base + [
        f"--checkpoint.directory={dir_a}", f"--train.eval_batches={CKPT_EVAL_BATCHES}"])
    rule = lm_launch_rule(cfg_a.model)
    resumed_args = base + [f"--checkpoint.directory={dir_b}"]
    out, copies = {}, []
    snapshot = tck._snapshot

    def timed_snapshot(*args):  # each save's host copy, in order
        t0 = time.perf_counter()
        snap = snapshot(*args)
        copies.append(1e3 * (time.perf_counter() - t0))
        return snap

    with fused_bwd("pallas"):
        snap0, commit0 = hist_read(tck.CKPT_SNAPSHOT_SECONDS), hist_read(
            tck.CKPT_ASYNC_COMMIT_SECONDS)
        with mock.patch.object(tck, "_snapshot", timed_snapshot):
            a, a_launch, a_wall = ckpt_pass(torch, "gpt_lm", base + [
                f"--checkpoint.directory={dir_a}", f"--train.eval_batches={CKPT_EVAL_BATCHES}"],
                counters)
        snap, commit = hist_read(tck.CKPT_SNAPSHOT_SECONDS), hist_read(
            tck.CKPT_ASYNC_COMMIT_SECONDS)
        n_async = snap[0] - snap0[0]
        out.update(snapshot_ms=1e3 * (snap[1] - snap0[1]) / max(n_async, 1),
                   host_copy_ms=copies,
                   commit_s=(commit[1] - commit0[1]) / max(commit[0] - commit0[0], 1),
                   async_saves=n_async, straight_wall_s=a_wall)
        log(f"  9a straight: {CKPT_STEPS} steps, losses {[round(h['loss'], 5) for h in a.history]}"
            f", {n_async} async saves, steps on disk {steps_on_disk(dir_a)}, launches {a_launch}, "
            f"eval {a.eval_metrics}, wall {a_wall:.1f} s")
        if a_launch != {n: c * CKPT_STEPS for n, c in rule.items()}:
            raise SmokeFailure(f"phase 9a straight run: launches {a_launch}, rule {rule} a step")

        # a child on this card dies by SIGKILL inside step 4's commit
        worker = load_dp_worker()
        child = os.path.join(root, "child")
        os.makedirs(child)
        t0 = time.perf_counter()
        (proc, child_log), = worker.launch(
            {"job": "ckpt", "device": DEVICE, "out": child, "workload": "gpt_lm",
             "overrides": resumed_args + ["--train.eval_batches=0"],
             "runs": [{"num_steps": CKPT_STEPS, "kill_at": CKPT_KILL_AT}]}, world=1)
        try:
            code = proc.wait(CKPT_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            code = None
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            child_log.close()
        tail = open(os.path.join(child, "rank0.log")).read()[-3000:]
        if code != -signal.SIGKILL:
            raise SmokeFailure(f"phase 9a: the AsyncCommitKill child exited {code}, not by "
                               f"SIGKILL:\n{tail}")
        pending = sorted(os.listdir(os.path.join(dir_b, tck.PENDING_DIRNAME)))
        on_disk = steps_on_disk(dir_b)
        log(f"  9a child killed by SIGKILL in step {CKPT_KILL_AT}'s commit after "
            f"{time.perf_counter() - t0:.1f} s: .pending {pending}, steps on disk {on_disk}")
        if pending != [str(CKPT_KILL_AT)] or on_disk[-1] != 2:
            raise SmokeFailure(f"phase 9a: after the kill .pending holds {pending} and the "
                               f"newest step is {on_disk}, want [{CKPT_KILL_AT!r}] and 2")

        # resume from 2 here; a SIGTERM after step 3 stops it on a save
        b1, b1_launch, b1_wall = ckpt_pass(
            torch, "gpt_lm", resumed_args + ["--train.eval_batches=0"], counters,
            [rz.FaultPlan((rz.Sigterm(CKPT_SIGTERM_AT),)).callback()])
        on_disk = steps_on_disk(dir_b)
        log(f"  9a resume 1 (SIGTERM after step {CKPT_SIGTERM_AT}): steps "
            f"{[h['step'] for h in b1.history]}, preempted {b1.preempted}, steps on disk "
            f"{on_disk}, launches {b1_launch}, wall {b1_wall:.1f} s")
        if not b1.preempted or on_disk[-1] != CKPT_SIGTERM_AT:
            raise SmokeFailure(f"phase 9a: resume 1 did not stop on a save at step "
                               f"{CKPT_SIGTERM_AT} (preempted {b1.preempted}, {on_disk})")
        b2, b2_launch, b2_wall = ckpt_pass(
            torch, "gpt_lm", resumed_args + ["--train.eval_batches=0"], counters)
        log(f"  9a resume 2: steps {[h['step'] for h in b2.history]}, launches {b2_launch}, "
            f"wall {b2_wall:.1f} s")
        out["gate"] = gate_resume(torch, "9a", a, [(b1, b1_launch), (b2, b2_launch)], b2, rule)
        del b1
        log(f"  9a the resumed losses (steps 3-6), parameters and Adam moments are bitwise the "
            f"straight run's; each attempt launched {rule} a step")

        # evaluate_from_checkpoint on the straight run's newest step
        ev = runner.evaluate_from_checkpoint(cfg_a, gpt_lm.build, num_batches=CKPT_EVAL_BATCHES,
                                             device=DEVICE)
        if ev.pop("step") != CKPT_STEPS or ev != a.eval_metrics:
            raise SmokeFailure(f"phase 9a: evaluate_from_checkpoint {ev} differs from the "
                               f"run's own final eval {a.eval_metrics}")
        log(f"  9a evaluate_from_checkpoint(step {CKPT_STEPS}) == the run's final eval: {ev}")

        # a synchronous save and restore of the step-6 state, timed
        sync_dir = os.path.join(root, "sync")
        ck = tck.Checkpointer(tck.CheckpointConfig(directory=sync_dir, async_save=False,
                                                   save_on_preemption=False))
        try:
            t0 = time.perf_counter()
            ck.save(CKPT_STEPS, a.state, force=True, trigger="final")
            out["sync_save_s"] = time.perf_counter() - t0
            d = tck.step_dir(sync_dir, CKPT_STEPS)
            out["step_bytes"] = sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))
            out["files"] = len(os.listdir(d))
            t0 = time.perf_counter()
            ck.restore(a.state)
            torch.cuda.synchronize()
            out["restore_s"] = time.perf_counter() - t0
        finally:
            ck.close()
        out["write_gb_s"] = out["step_bytes"] / out["sync_save_s"] / 1e9

        # a torn newest step: the fallback quarantines 6 and restores 4
        rz.truncate_shard(dir_b, CKPT_STEPS)
        cfg_b = apply_overrides(gpt_lm.default_config(), resumed_args +
                                ["--checkpoint.save_on_preemption=false"])
        ck_b, ck_a = (tck.Checkpointer(c.checkpoint) for c in (
            cfg_b, apply_overrides(cfg_a, ["--checkpoint.save_on_preemption=false"])))
        try:
            t0 = time.perf_counter()
            ck_b.restore(b2.state, fallback=True)
            out["fallback_restore_s"] = time.perf_counter() - t0
            corrupt = os.listdir(os.path.join(dir_b, tck.CORRUPT_DIRNAME))
            ck_a.restore(a.state, step=4)
        finally:
            ck_b.close()
            ck_a.close()
        diff = state_diff(torch, b2.state, a.state)
        log(f"  9a truncate_shard(step {CKPT_STEPS}) + restore(fallback=True): restored step "
            f"{b2.state.step}, .corrupt {corrupt}, bitwise the straight run's step 4: "
            f"{not diff}")
        if b2.state.step != 4 or corrupt != [str(CKPT_STEPS)] or diff:
            raise SmokeFailure(f"phase 9a: fallback restored step {b2.state.step}, .corrupt "
                               f"{corrupt}, differing leaves {diff[:6]}")
    del a, b2
    torch.cuda.empty_cache()
    return out


def ckpt_resnet(torch, np, root):
    """Phase 9b: ResNet-50 fused + pallas, straight against save + restore
    in a fresh run_workload: parameters, BN running statistics and the
    momentum trace bitwise."""
    from distributed_tensorflow_tpu_torch.data.pipeline import SyntheticClassification
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    path = os.path.join(root, "images.npz")
    batch = SyntheticClassification(resnet_run_cfg().data).batch(0)
    np.savez(path, **batch)
    base = RESNET_OVERRIDES + ["--model.block_impl=fused", f"--data.dataset=npz:{path}"]
    ck = [f"--checkpoint.directory={os.path.join(root, 'resnet')}",
          "--checkpoint.save_interval_steps=2"]
    half = CKPT_RESNET_STEPS // 2
    rule = resnet_launch_rule(resnet_run_cfg().model)
    with fused_bwd("pallas"):
        s, s_launch, s_wall = ckpt_pass(torch, "resnet50_imagenet", base + [
            f"--train.num_steps={CKPT_RESNET_STEPS}"], fcb.KERNELS)
        r1 = ckpt_pass(torch, "resnet50_imagenet", base + ck + [f"--train.num_steps={half}"],
                       fcb.KERNELS)
        r2 = ckpt_pass(torch, "resnet50_imagenet", base + ck + [
            f"--train.num_steps={CKPT_RESNET_STEPS}"], fcb.KERNELS)
    if s_launch != {n: c * CKPT_RESNET_STEPS for n, c in rule.items()}:
        raise SmokeFailure(f"phase 9b straight run: launches {s_launch}, rule {rule} a step")
    gate = gate_resume(torch, "9b", s, [r1, r2], r2[0], rule)
    log(f"  9b resnet50_imagenet (fused + pallas, batch 256): {CKPT_RESNET_STEPS} straight steps "
        f"({s_wall:.1f} s) against {half} + save + restore + {CKPT_RESNET_STEPS - half} "
        f"({r1[2]:.1f} + {r2[2]:.1f} s): losses {gate['losses']}, parameters, BN running "
        f"statistics and momentum bitwise; each attempt launched {rule} a step")
    del s, r1, r2
    torch.cuda.empty_cache()
    return gate


def phase_ckpt(torch, np, card):
    """Phase 9: checkpoint-restart on the card (module docstring)."""
    import shutil
    import tempfile

    from distributed_tensorflow_tpu_torch.runtime import native

    t_phase = time.perf_counter()
    log(f"phase 9: checkpoint-restart through run_workload: gpt_lm at phase 5b's setting "
        f"(fused_ln_matmul, pallas backward, flash; saves every 2 steps, 2 kept) killed in a "
        f"commit, preempted and resumed against a straight run; resnet50_imagenet fused + "
        f"pallas saved and resumed; on {card}")
    if not native.available():
        raise SmokeFailure(f"phase 9: the native IO library is not in use ({native.failure})")
    log(f"  native IO: {native.library_path()}")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        out = ckpt_gpt(torch, np, root)
        out["resnet"] = ckpt_resnet(torch, np, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  9a checkpoint IO ({card}; write rate of the card machine's host disk, not the "
        f"card): {out['step_bytes']} bytes a step dir ({out['files']} files), step-boundary "
        f"snapshot stall {out['snapshot_ms']:.1f} ms (mean of {out['async_saves']} async "
        f"saves; the host copy of each, in order: "
        f"{[round(ms, 1) for ms in out['host_copy_ms']]} ms, the first two allocate the "
        f"pinned buffers), async commit {out['commit_s']:.3f} s (mean "
        f"ckpt_async_commit_seconds, enqueue to publish, queue wait included), "
        f"sync save {out['sync_save_s']:.3f} s = {out['write_gb_s']:.3f} GB/s, restore "
        f"{out['restore_s']:.3f} s, fallback restore {out['fallback_restore_s']:.3f} s; "
        f"phase 9 wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the real-data intake, ResNet-50 fed from flat records
# ---------------------------------------------------------------------------

#: the records phase 10 writes: 224x224x3 uint8 images (77 MB) and labels
#: below 1000, from numpy's default_rng(INTAKE_SEED); at least 2 x 256, so
#: every batch of 256 is whole
INTAKE_RECORDS, INTAKE_SEED = 512, 10
#: the images' side and the global batch: the preset's 224 and phase 6's 256
INTAKE_IMAGE, INTAKE_BATCH = 224, 256
#: the loader gate: two shards of two, 64 records a batch (4 batches an
#: epoch a shard), INTAKE_LOADER_BATCHES from batch 0 and from each start
INTAKE_LOADER_BATCH, INTAKE_LOADER_BATCHES, INTAKE_LOADER_STARTS = 64, 6, (0, 3)
#: ResNet-50 fused + pallas at batch 256 from records: with crop_flip, as many
#: steps as phase 6 (its step time is the median of steps 2-6 there too)
INTAKE_STEPS = 6
#: then a timing run of as many steps: its second half, after the batches
#: the Prefetcher staged during the model's build are used up, is the
#: steady state of a records-fed run
INTAKE_TIMED_STEPS = 24
INTAKE_OVERRIDES = ["--model.block_impl=fused", "--data.augment=crop_flip",
                    f"--train.num_steps={INTAKE_STEPS}"]


def intake_loader_gate(np, path, record_bytes) -> int:
    """The native loader's stream bitwise the Python path's, for both
    shards of two, from batch 0 and resumed at each start; a resumed
    stream is the full one's tail. Returns the batches compared."""
    from distributed_tensorflow_tpu_torch.runtime.loader import RecordFileLoader

    compared = 0
    for shard in (0, 1):
        full = None
        for start in INTAKE_LOADER_STARTS:
            kw = dict(seed=1, shard=shard, n_shards=2, start_batch=start,
                      num_batches=INTAKE_LOADER_BATCHES - start)
            fast, slow = (list(RecordFileLoader(path, record_bytes, INTAKE_LOADER_BATCH,
                                                use_native=n, **kw)) for n in (True, False))
            if len(fast) != len(slow) or not all(np.array_equal(a, b)
                                                 for a, b in zip(fast, slow)):
                raise SmokeFailure(f"phase 10: shard {shard} from batch {start}: the native "
                                   f"loader's stream differs from the Python path's")
            full = fast if full is None else full
            if not all(np.array_equal(a, b) for a, b in zip(fast, full[start:])):
                raise SmokeFailure(f"phase 10: shard {shard} resumed at {start} is not the "
                                   f"stream's tail")
            compared += len(fast)
    return compared


def intake_resume_gate(np, path, out) -> None:
    """``RecordClassificationDataset(augment="crop_flip")``: a fresh
    dataset at ``index_offset=3`` gives the stream's batch 3, one at 2 does
    not (the control); the stream's host rate (loader + crop_flip + cast)."""
    from distributed_tensorflow_tpu_torch.data.records import RecordClassificationDataset

    def ds(**kw):
        return RecordClassificationDataset(path, (INTAKE_IMAGE, INTAKE_IMAGE, 3), INTAKE_BATCH,
                                           augment="crop_flip", **kw)

    t0 = time.perf_counter()
    stream = list(ds(num_batches=4))
    out["host_images_s"] = 4 * INTAKE_BATCH / (time.perf_counter() - t0)
    resumed, control = (next(iter(ds(index_offset=i))) for i in (3, 2))
    if not all(np.array_equal(resumed[k], stream[3][k]) for k in resumed):
        raise SmokeFailure("phase 10: crop_flip batch 3 of a dataset started at "
                           "index_offset=3 differs from the stream's batch 3")
    if np.array_equal(control["image"], stream[3]["image"]):
        raise SmokeFailure("phase 10: the control (index_offset=2) equals batch 3")


def phase_intake(torch, np, card, resnet_step_ms):
    """Phase 10: flat records written here, the loader and crop_flip
    gates, and ResNet-50 fused + pallas at batch 256 trained from
    ``records:`` through ``run_workload`` against the same steps fed by
    hand (``tests/torch_dp_worker.train_steps``), with a control."""
    import itertools
    import shutil
    import tempfile

    from distributed_tensorflow_tpu_torch.data import native_jpeg
    from distributed_tensorflow_tpu_torch.data.pipeline import make_dataset
    from distributed_tensorflow_tpu_torch.data.records import make_record_file
    from distributed_tensorflow_tpu_torch.models import resnet
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb
    from distributed_tensorflow_tpu_torch.runtime import native
    from distributed_tensorflow_tpu_torch.utils.config import apply_overrides
    from distributed_tensorflow_tpu_torch.workloads import resnet50_imagenet

    t_phase = time.perf_counter()
    log(f"phase 10: the real-data intake: {INTAKE_RECORDS} flat records of {INTAKE_IMAGE}x"
        f"{INTAKE_IMAGE}x3 through the native loader, crop_flip, and resnet50_imagenet (fused + "
        f"pallas, batch {INTAKE_BATCH}, {INTAKE_STEPS} steps) from records: through run_workload "
        f"against the same steps fed by hand; on {card}")
    jpeg_ok = native_jpeg.available()
    log(f"  native loader in use: {native.available()}; native libjpeg decoder: {jpeg_ok}"
        + ("" if jpeg_ok else " (" + next((line for line in native_jpeg.failure.splitlines()
                                            if "error" in line), native_jpeg.failure)[:160] + ")")
        + f"; jpeg: decoder='auto' would use {'native' if jpeg_ok else 'pil'}; os.cpu_count() "
        f"{os.cpu_count()}")
    if not native.available():
        raise SmokeFailure(f"phase 10: the native loader is not in use ({native.failure})")
    root = tempfile.mkdtemp(prefix="chip_smoke_intake_")
    out = {}
    try:
        path = os.path.join(root, "train.rec")
        rng = np.random.default_rng(INTAKE_SEED)
        record_bytes = make_record_file(
            path, rng.integers(0, 256, (INTAKE_RECORDS, INTAKE_IMAGE, INTAKE_IMAGE, 3),
                               dtype=np.uint8),
            rng.integers(0, 1000, INTAKE_RECORDS).astype(np.int32))
        out["compared"] = intake_loader_gate(np, path, record_bytes)
        log(f"  loader: native == Python for shards 0 and 1 of 2 from batches "
            f"{INTAKE_LOADER_STARTS} ({out['compared']} batches of {INTAKE_LOADER_BATCH})")
        intake_resume_gate(np, path, out)
        log(f"  crop_flip: index_offset=3 == the stream's batch 3, index_offset=2 differs; host "
            f"stream (native loader + crop_flip + f32) {out['host_images_s']:.1f} images/s on "
            f"{os.cpu_count()} cores")

        overrides = RESNET_OVERRIDES + INTAKE_OVERRIDES + [f"--data.dataset=records:{path}"]
        cfg = apply_overrides(resnet50_imagenet.default_config(), overrides)
        rule = resnet_launch_rule(cfg.model)
        with fused_bwd("pallas"):
            res, launches, wall = ckpt_pass(torch, "resnet50_imagenet", overrides, fcb.KERNELS)
            losses = [h["loss"] for h in res.history]
            steady = [h["steps_per_sec"] for h in res.history if "steps_per_sec" in h]
            out.update(losses=losses, launches=launches, wall_s=wall,
                       step_ms=1e3 / float(np.median(steady)))
            del res
            torch.cuda.empty_cache()
            batches = list(itertools.islice(make_dataset(cfg.data), INTAKE_STEPS))
            sd = resnet.init_params(cfg.model, seed=cfg.train.seed, device=DEVICE)
            worker = load_dp_worker()
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                hand = worker.train_steps(cfg.model, sd, batches, DEVICE, bwd="pallas")
                batches[1]["image"][0] = batches[1]["image"][0, :, ::-1].copy()
                control = worker.train_steps(cfg.model, sd, batches, DEVICE, bwd="pallas")
            finally:
                torch.backends.cudnn.deterministic = deterministic
        log(f"  records-fed run: losses {losses}, launches {launches}, step "
            f"{out['step_ms']:.2f} ms (median of steps 2-{INTAKE_STEPS}; phase 6's fused + "
            f"pallas step from an npz: {resnet_step_ms:.2f} ms, ratio "
            f"{out['step_ms'] / resnet_step_ms:.4f}), run wall {wall:.1f} s")
        log(f"  hand-fed: losses {list(map(float, hand['losses']))}; control (batch 1's image 0 "
            f"flipped): {list(map(float, control['losses']))}")
        want = {n: c * INTAKE_STEPS for n, c in rule.items()}
        if launches != want or hand["launches"] != want:
            raise SmokeFailure(f"phase 10: launches {launches} (hand-fed {hand['launches']}), "
                               f"the rule predicts {want}")
        if losses != list(map(float, hand["losses"])):
            raise SmokeFailure(f"phase 10: the records-fed losses {losses} differ from the "
                               f"hand-fed {list(hand['losses'])}")
        if list(map(float, control["losses"])) == losses:
            raise SmokeFailure("phase 10: the control (an image flipped) gave the same losses")
        if not np.isfinite(losses).all():
            raise SmokeFailure(f"phase 10: non-finite loss {losses}")
        log(f"  the records-fed losses are bitwise the hand-fed steps'; the control differs; "
            f"launches {rule} a step")
        with fused_bwd("pallas"):
            timed, timed_launches, timed_wall = ckpt_pass(
                torch, "resnet50_imagenet",
                overrides + [f"--train.num_steps={INTAKE_TIMED_STEPS}"], fcb.KERNELS)
        rates = [h["steps_per_sec"] for h in timed.history if "steps_per_sec" in h]
        out["steady_ms"] = 1e3 / float(np.median(rates[len(rates) // 2:]))
        del timed
        if timed_launches != {n: c * INTAKE_TIMED_STEPS for n, c in rule.items()}:
            raise SmokeFailure(f"phase 10: the timing run launched {timed_launches}, the rule "
                               f"is {rule} a step")
        log(f"  records-fed timing run, {INTAKE_TIMED_STEPS} steps: step {out['steady_ms']:.2f} "
            f"ms = {INTAKE_BATCH * 1e3 / out['steady_ms']:.1f} images/s (median of steps "
            f"{INTAKE_TIMED_STEPS // 2 + 1}-{INTAKE_TIMED_STEPS}), run wall {timed_wall:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 10 wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: Wide&Deep CTR, tables sharded over the model axis
# ---------------------------------------------------------------------------

#: tools/bench_wide_deep.py's accelerator shape: 26 tables of 100000 x 64
#: (f32), 13 dense features, hidden 1024-512-256, bf16, 16384 rows a card,
#: the auto optimizer (FTRL wide, AdaGrad deep) at lr 0.05
WD_FEATURES, WD_VOCAB, WD_EMBED, WD_BATCH = 26, 100000, 64, 16384
WD_OVERRIDES = [f"--model.vocab_sizes=[{','.join([str(WD_VOCAB)] * WD_FEATURES)}]",
                f"--model.embed_dim={WD_EMBED}", "--model.dense_features=13",
                "--model.hidden_sizes=[1024,512,256]", "--model.dtype=bfloat16",
                f"--data.global_batch_size={WD_BATCH}", "--optimizer.learning_rate=0.05",
                "--train.log_every=1", "--mesh.model=1"]
WD_STEPS = 12
WD_EVAL_BATCHES = 4
WD_REPEAT_STEPS = 3
#: rows of the f32 card-vs-CPU step (the CPU's share of the phase's time)
WD_F32_BATCH = 2048
#: phase 11b: two ranks on the card, data=1 x model=2, f32
WD_DP_GLOBAL = 2048
WD_DP_STEPS = 3


def wd_bytes_per_example() -> int:
    """The JAX bench's embedding traffic an example: the forward gather and
    the backward scatter-add's read-modify-write of the f32 rows, deep
    (D) and wide (1) columns of every feature."""
    return 3 * WD_FEATURES * (WD_EMBED + 1) * 4


def wd_f32_step(torch, np):
    """One f32 step of the auto optimizer on the card and on the CPU from
    the same whole weights and batch: the loss's relative difference and
    the worst relative L2 error of a parameter's update, beside an update
    x 1.01 control."""
    from distributed_tensorflow_tpu_torch.data.recsys import RecsysConfig, SyntheticCTR
    from distributed_tensorflow_tpu_torch.models import wide_deep as wd
    from distributed_tensorflow_tpu_torch.train import init_train_state, make_train_step
    from distributed_tensorflow_tpu_torch.utils.config import apply_overrides
    from distributed_tensorflow_tpu_torch.workloads import wide_deep as wl

    cfg = apply_overrides(wl.default_config(), WD_OVERRIDES + ["--model.dtype=float32"])
    sd = wd.init_params(cfg.model, seed=0, device="cpu")
    data = SyntheticCTR(RecsysConfig(vocab_sizes=cfg.model.vocab_sizes, dense_features=13,
                                     global_batch_size=WD_F32_BATCH, seed=3))
    host = data.batch(0)
    out = {}
    for dev in (DEVICE, "cpu"):
        model = wd.build(cfg.model, sd, dev)
        state = init_train_state(model, wl._canonical_tx(cfg)(model))
        step = make_train_step(wd.ctr_loss_fn(model))
        state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in host.items()})
        out[dev] = (float(m["loss"]), state_of(torch, model))
        del model, state
    (loss_c, card), (loss_h, cpu) = out[DEVICE], out["cpu"]
    loss_err = abs(loss_c - loss_h) / abs(loss_h)
    worst = update_errs(torch, card, cpu, sd)
    ctl = update_errs(torch, {k: sd[k] + 1.01 * (v - sd[k]) for k, v in card.items()}, cpu,
                      sd)
    log(f"  11a f32 step, card vs CPU (batch {WD_F32_BATCH}): loss {loss_c:.8f} vs "
        f"{loss_h:.8f} (relative {loss_err:.3e}, limit {TOL['wd/f32/loss']}); updates worst "
        f"relative L2 {worst[0]:.3e} ({worst[1]}, limit {TOL['wd/f32/update']}); control "
        f"(card update x 1.01) {ctl[0]:.3e}")
    if not (loss_err <= TOL["wd/f32/loss"] and worst[0] <= TOL["wd/f32/update"]):
        raise SmokeFailure(f"phase 11a: the f32 card step is off the CPU step: loss "
                           f"{loss_err:.3e}, update {worst}")
    if ctl[0] <= TOL["wd/f32/update"]:
        raise SmokeFailure(f"phase 11a: the x1.01 control passes the update gate ({ctl[0]:.3e})")
    return {"loss": loss_err, "update": worst[0], "control": ctl[0]}


def wd_profile_step(torch, res) -> dict:
    """One more step of the trained state under torch.profiler, its batch
    resident: wall, device busy time and the top kernels."""
    from distributed_tensorflow_tpu_torch.data.recsys import RecsysConfig, SyntheticCTR
    from distributed_tensorflow_tpu_torch.models import wide_deep as wd
    from distributed_tensorflow_tpu_torch.train import make_train_step

    model = res.state.model
    data = SyntheticCTR(RecsysConfig(vocab_sizes=model.cfg.vocab_sizes, dense_features=13,
                                     global_batch_size=WD_BATCH, seed=11))
    return profiled_step(torch, make_train_step(wd.ctr_loss_fn(model)), res.state,
                         data.batch(0), f"11a profiled step (B={WD_BATCH}")


def profiled_step(torch, step, state, host_batch, label: str, top: int = 12) -> dict:
    """One warm-up step, then one more under torch.profiler with the batch
    resident on the card: wall, device busy time and the top kernels."""
    dev = {k: torch.from_numpy(v).to(DEVICE) for k, v in host_batch.items()}
    state, m = step(state, dev)
    float(m["loss"])
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, dev)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in device_events(torch, prof) if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"  {label}, batch resident, profiler on): wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% (idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in events)} device records")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def wd_one_card(torch, np, card) -> dict:
    """Phase 11a (module docstring)."""
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    out = {}
    # the run's own peak: what earlier phases still hold is counted apart
    gc.collect()
    torch.cuda.empty_cache()
    out["held_gib"] = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_workload("wide_deep", WD_OVERRIDES + [
        f"--train.num_steps={WD_STEPS}", f"--train.eval_batches={WD_EVAL_BATCHES}"],
        device=DEVICE)
    wall = time.perf_counter() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 - out["held_gib"]
    losses = [h["loss"] for h in res.history]
    rates = [h["steps_per_sec"] for h in res.history if "steps_per_sec" in h and h["step"] >= 3]
    out["step_ms"] = 1e3 / float(np.median(rates))
    out["ex_s"] = WD_BATCH * 1e3 / out["step_ms"]
    out["embed_gbps"] = out["ex_s"] * wd_bytes_per_example() / 1e9
    out["eval"] = res.eval_metrics
    out["losses"] = losses
    log(f"  11a run_workload('wide_deep'), {WD_STEPS} steps + an eval of {WD_EVAL_BATCHES} "
        f"batches (run wall {wall:.1f} s, the SyntheticCTR teacher and init included): losses "
        f"{[round(x, 5) for x in losses]}; step {out['step_ms']:.3f} ms (median of steps "
        f"3-{WD_STEPS}, each timed by MetricsLogger's read of its loss) = {out['ex_s']:.0f} "
        f"examples/s, embed traffic {out['embed_gbps']:.2f} GB/s ({wd_bytes_per_example()} "
        f"bytes an example); peak memory {out['peak_gib']:.3f} GiB above the "
        f"{out['held_gib']:.3f} GiB held before the run; eval {res.eval_metrics}; "
        f"{card}")
    if not (np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise SmokeFailure(f"phase 11a: the loss does not fall ({losses})")
    if not (res.eval_metrics and np.isfinite(res.eval_metrics.get("auc", np.nan))):
        raise SmokeFailure(f"phase 11a: the eval has no finite auc ({res.eval_metrics})")
    out["profile"] = wd_profile_step(torch, res)
    del res
    torch.cuda.empty_cache()
    runs = []
    for seed in (0, 0, 1):
        r = run_workload("wide_deep", WD_OVERRIDES + [
            f"--train.num_steps={WD_REPEAT_STEPS}", "--train.eval_batches=0",
            f"--train.seed={seed}"], device=DEVICE)
        runs.append(([h["loss"] for h in r.history], state_of(torch, r.state.model)))
        del r
    (la, a), (lb, b), (lc, c) = runs
    same = la == lb and all(torch.equal(a[k], b[k]) for k in a)
    differs = la != lc and not all(torch.equal(a[k], c[k]) for k in a)
    log(f"  11a repeat: two seed-0 runs of {WD_REPEAT_STEPS} steps: losses {la} and {lb}, "
        f"bitwise equal (losses and every parameter): {same}; seed-1 control {lc}, differs: "
        f"{differs}")
    if not same:
        raise SmokeFailure("phase 11a: two same-seed runs differ")
    if not differs:
        raise SmokeFailure("phase 11a: the seed + 1 control equals the seed-0 run")
    del runs, a, b, c
    torch.cuda.empty_cache()
    out["f32"] = wd_f32_step(torch, np)
    return out


def wd_two_ranks(torch, np) -> dict:
    """Phase 11b (module docstring)."""
    import tempfile

    from distributed_tensorflow_tpu_torch.models import wide_deep as wd
    from distributed_tensorflow_tpu_torch.utils.config import apply_overrides
    from distributed_tensorflow_tpu_torch.workloads import run_workload
    from distributed_tensorflow_tpu_torch.workloads import wide_deep as wl

    worker = load_dp_worker()
    over = WD_OVERRIDES + ["--model.dtype=float32", f"--data.global_batch_size={WD_DP_GLOBAL}",
                           f"--train.num_steps={WD_DP_STEPS}", "--train.eval_batches=0"]
    sharded = over + ["--mesh.data=1", "--mesh.model=2"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = worker.launch({"job": "wide_deep", "device": DEVICE, "backend": "gloo",
                               "out": d, "runner": sharded})
        try:
            ref = run_workload("wide_deep", over, device=DEVICE)
            ref_losses = [h["loss"] for h in ref.history]
            ref_sd = state_of(torch, ref.state.model)
            del ref
            cfg = apply_overrides(wl.default_config(), over).model
            init = {k: v.cpu() for k, v in wd.init_params(cfg, seed=0, device=DEVICE).items()}
        except BaseException:
            worker.stop(procs)
            raise
        ranks = worker.wait(procs, d, timeout=600)
        wall = time.perf_counter() - t0
    shards = [{k[len("runner/state/"):]: torch.from_numpy(v) for k, v in r.items()
               if k.startswith("runner/state/")} for r in ranks]
    # the tables reassembled from the ranks' range shards (no padding at
    # 100000 rows over 2), the replicated parameters rank 0's
    whole = {k: torch.cat([sh[k] for sh in shards])[:cfg.vocab_sizes[0]]
             if "table_" in k else shards[0][k] for k in ref_sd}
    want = ref_sd
    losses = [list(map(float, r["runner/losses"])) for r in ranks]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses[0], ref_losses))
    worst = update_errs(torch, whole, want, init)
    bitwise = losses[0] == ref_losses and all(torch.equal(whole[k], want[k]) for k in want)
    models = [int(r["runner/mesh_model"]) for r in ranks]
    log(f"  11b two ranks on this card over gloo, data=1 x model=2 (tables range-sharded, "
        f"{WD_VOCAB // 2} rows a rank), {WD_DP_STEPS} f32 steps of {WD_DP_GLOBAL} rows through "
        f"run_workload (wall {wall:.1f} s): rank losses {losses}, one process at model=1 "
        f"{ref_losses}; worst loss relative difference {loss_err:.3e} (limit "
        f"{TOL['wd/dp/loss']}); updates worst relative L2 {worst[0]:.3e} ({worst[1]}, limit "
        f"{TOL['wd/dp/update']}); bitwise: {bitwise}; mesh model axis on the ranks {models}")
    replicated = [k for k in ref_sd if "table_" not in k]
    if models != [2, 2] or losses[0] != losses[1] or not all(
            torch.equal(shards[0][k], shards[1][k]) for k in replicated):
        raise SmokeFailure(f"phase 11b: the ranks ran model={models}, or disagree on the loss "
                           f"or on a replicated parameter")
    if not (loss_err <= TOL["wd/dp/loss"] and worst[0] <= TOL["wd/dp/update"]):
        raise SmokeFailure(f"phase 11b: model=2 is off the one-process run: loss {loss_err:.3e}, "
                           f"update {worst}")
    return {"loss": loss_err, "update": worst[0], "bitwise": bitwise, "wall_s": wall}


def phase_wide_deep(torch, np, card) -> dict:
    log(f"phase 11: Wide&Deep CTR (tables {WD_FEATURES} x {WD_VOCAB} x {WD_EMBED} f32, hidden "
        f"1024-512-256, bf16, {WD_BATCH} rows, the auto optimizer): one card at model=1, then "
        f"two ranks on this card at model=2; on {card}")
    t0 = time.perf_counter()
    out = wd_one_card(torch, np, card)
    torch.cuda.empty_cache()
    out["dp"] = wd_two_ranks(torch, np)
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 11 wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the MNIST MLP and CIFAR-10 CNN workloads, the convergence demos
# ---------------------------------------------------------------------------

#: the two small workloads at their presets' widths and batches (mnist_mlp:
#: 784-512-512-10, batch 128, sgd 0.1; cifar10_cnn: channels 32-64-128,
#: dense 256, batch 256, momentum 0.9 at 0.05, cosine over 2000), one
#: process: the data axis takes it (--mesh.data=-1)
SMALL_WORKLOADS = ("mnist_mlp", "cifar10_cnn")
SMALL_COMMON = ["--mesh.data=-1", "--train.log_every=1"]
SMALL_STEPS = 20
SMALL_EVAL_BATCHES = 4
SMALL_REPEAT_STEPS = 3
#: rows of the f32 card-vs-CPU step
SMALL_F32_BATCH = 64
#: the JAX package's test_mnist_mlp_converges recipe (60 steps, batch 256,
#: lr 0.3), whose thresholds the MLP's eval must beat: accuracy > 0.3,
#: top-5 > 0.7 (at the preset's batch and lr, 20 steps read 0.127 top-1 on
#: an H100: too few for those thresholds)
MLP_CONVERGE = ["--train.num_steps=60", "--data.global_batch_size=256",
                "--optimizer.learning_rate=0.3", "--train.eval_batches=4"]
#: phase 12b: the convergence demos, each a process of its own with its
#: default steps and gate; "digits" needs scikit-learn's bundled scans
DEMOS = (("ctr", "convergence_demo_ctr_torch.py", ()),
         ("mlm", "convergence_demo_mlm_torch.py", ("--objective", "mlm")),
         ("lm", "convergence_demo_mlm_torch.py", ("--objective", "lm")),
         ("digits", "convergence_demo_torch.py", ()))
DEMO_TIMEOUT_S = 300


def small_f32_step(torch, np, name) -> dict:
    """One f32 step of the preset's optimizer on the card and on the CPU
    from the same weights and batch (cuDNN deterministic, TF32 off): the
    loss's relative difference and the worst relative L2 error of a
    parameter's or BatchNorm buffer's update, beside an update x 1.01
    control that the gate must fail."""
    from distributed_tensorflow_tpu_torch.data.pipeline import SyntheticClassification
    from distributed_tensorflow_tpu_torch.models import common
    from distributed_tensorflow_tpu_torch.train import (
        init_train_state, make_optimizer, make_train_step)
    from distributed_tensorflow_tpu_torch.utils.config import apply_overrides
    from distributed_tensorflow_tpu_torch.workloads import get

    cfg = apply_overrides(get(name).default_config(),
                          [f"--data.global_batch_size={SMALL_F32_BATCH}"])
    host = SyntheticClassification(cfg.data).batch(0)
    # weights drawn on the CPU (the workload's build, seed 0) and copied to
    # the card, so both sides start alike
    base = get(name).build(cfg, torch.device("cpu")).model
    init = state_of(torch, base)
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dev in (DEVICE, "cpu"):
            model = copy.deepcopy(base).to(dev)
            state = init_train_state(model, make_optimizer(cfg.optimizer, model.parameters()))
            step = make_train_step(common.classification_loss_fn(model))
            state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in host.items()})
            out[dev] = (float(m["loss"]), state_of(torch, model))
            del model, state
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (loss_c, card), (loss_h, cpu) = out[DEVICE], out["cpu"]
    loss_err = abs(loss_c - loss_h) / abs(loss_h)
    # a convolution's bias under BatchNorm has a zero gradient in exact
    # arithmetic (the mean it adds is subtracted), so its update is
    # rounding noise on both sides: held absolutely, not relatively
    zero = {f"conv_{i}.bias" for i in range(len(getattr(cfg.model, "channels", ())))
            if cfg.model.use_batchnorm}
    rest = {k: v for k, v in cpu.items() if k not in zero}
    worst = update_errs(torch, card, rest, init)
    ctl = update_errs(torch, {k: init[k] + 1.01 * (v - init[k]) for k, v in card.items()},
                      rest, init)
    noise = max([float((d[k] - init[k]).abs().max()) for k in zero for d in (card, cpu)],
                default=0.0)
    log(f"  12a {name} f32 step, card vs CPU (batch {SMALL_F32_BATCH}): loss {loss_c:.8f} vs "
        f"{loss_h:.8f} (relative {loss_err:.3e}, limit {TOL['small/f32/loss']}); updates worst "
        f"relative L2 {worst[0]:.3e} ({worst[1]}, limit {TOL['small/f32/update']}); control "
        f"(card update x 1.01) {ctl[0]:.3e}"
        + (f"; the conv biases under BatchNorm (zero gradient): largest |update| on either "
           f"side {noise:.3e} (limit {TOL['small/f32/zero_grad']})" if zero else ""))
    if not (loss_err <= TOL["small/f32/loss"] and worst[0] <= TOL["small/f32/update"]
            and noise <= TOL["small/f32/zero_grad"]):
        raise SmokeFailure(f"phase 12a: {name}'s f32 card step is off the CPU step: loss "
                           f"{loss_err:.3e}, update {worst}, zero-gradient update {noise:.3e}")
    if ctl[0] <= TOL["small/f32/update"]:
        raise SmokeFailure(f"phase 12a: the x1.01 control passes the update gate ({ctl[0]:.3e})")
    return {"loss": loss_err, "update": worst[0], "control": ctl[0], "zero_grad": noise}


def small_one(torch, np, name, card) -> dict:
    """Phase 12a for one workload (module docstring)."""
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    t0 = time.perf_counter()
    res = run_workload(name, SMALL_COMMON + [
        f"--train.num_steps={SMALL_STEPS}", f"--train.eval_batches={SMALL_EVAL_BATCHES}"],
        device=DEVICE)
    wall = time.perf_counter() - t0
    batch = get_batch(name)
    losses = [h["loss"] for h in res.history]
    rates = [h["steps_per_sec"] for h in res.history if "steps_per_sec" in h and h["step"] >= 3]
    out = {"step_ms": 1e3 / float(np.median(rates)), "losses": losses, "eval": res.eval_metrics}
    out["ex_s"] = batch * 1e3 / out["step_ms"]
    log(f"  12a run_workload({name!r}) at the preset's widths, batch {batch}, {SMALL_STEPS} "
        f"steps + an eval of {SMALL_EVAL_BATCHES} batches (run wall {wall:.1f} s, init "
        f"included): losses {[round(x, 5) for x in losses]}; step {out['step_ms']:.3f} ms "
        f"(median of steps 3-{SMALL_STEPS}, each timed by MetricsLogger's read of its loss) = "
        f"{out['ex_s']:.0f} examples/s; eval {res.eval_metrics}; {card}")
    if not (np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise SmokeFailure(f"phase 12a: {name}'s loss does not fall ({losses})")
    if not (res.eval_metrics and np.isfinite(res.eval_metrics["loss"])):
        raise SmokeFailure(f"phase 12a: {name}'s eval is not finite ({res.eval_metrics})")
    out["profile"] = small_profile(torch, res, name)
    del res
    runs = []
    for seed in (0, 0, 1):
        r = run_workload(name, SMALL_COMMON + [
            f"--train.num_steps={SMALL_REPEAT_STEPS}", "--train.eval_batches=0",
            f"--train.seed={seed}"], device=DEVICE)
        runs.append(([h["loss"] for h in r.history], state_of(torch, r.state.model)))
        del r
    (la, a), (lb, b), (lc, c) = runs
    same = la == lb and all(torch.equal(a[k], b[k]) for k in a)
    differs = la != lc and not all(torch.equal(a[k], c[k]) for k in a)
    log(f"  12a {name} repeat: two seed-0 runs of {SMALL_REPEAT_STEPS} steps: losses {la} and "
        f"{lb}, bitwise equal (losses, parameters, buffers): {same}; seed-1 control {lc}, "
        f"differs: {differs}")
    if not same:
        raise SmokeFailure(f"phase 12a: two same-seed {name} runs differ")
    if not differs:
        raise SmokeFailure(f"phase 12a: the seed + 1 {name} control equals the seed-0 run")
    out["f32"] = small_f32_step(torch, np, name)
    torch.cuda.empty_cache()
    return out


def small_profile(torch, res, name) -> dict:
    """One more step of the trained state under the profiler, a batch of
    the workload's synthetic stream resident on the card."""
    from distributed_tensorflow_tpu_torch.data.pipeline import SyntheticClassification
    from distributed_tensorflow_tpu_torch.models import common
    from distributed_tensorflow_tpu_torch.train import make_train_step
    from distributed_tensorflow_tpu_torch.workloads import get

    data = SyntheticClassification(get(name).default_config().data)
    step = make_train_step(common.classification_loss_fn(res.state.model))
    return profiled_step(torch, step, res.state, data.batch(7),
                         f"12a {name} profiled step (B={get_batch(name)}", top=8)


def get_batch(name: str) -> int:
    from distributed_tensorflow_tpu_torch.workloads import get

    return get(name).default_config().data.global_batch_size


def mlp_converges(np, card) -> dict:
    """The MLP trained by the JAX package's convergence test's recipe
    (``MLP_CONVERGE``): the loss falls and the eval beats its thresholds."""
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    res = run_workload("mnist_mlp", SMALL_COMMON + MLP_CONVERGE, device=DEVICE)
    losses = [h["loss"] for h in res.history]
    ev = res.eval_metrics
    log(f"  12a mnist_mlp by the JAX test's recipe ({' '.join(MLP_CONVERGE)}): loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; eval accuracy {ev['accuracy']:.5f} (must be > "
        f"0.3), top-5 {ev['top5_accuracy']:.5f} (> 0.7); {card}")
    if not (losses[-1] < losses[0] and ev["accuracy"] > 0.3 and ev["top5_accuracy"] > 0.7
            and ev["top5_accuracy"] >= ev["accuracy"]):
        raise SmokeFailure(f"phase 12a: mnist_mlp misses the JAX test's thresholds ({ev})")
    return ev


def run_demo(name: str, script: str, args) -> dict:
    """One convergence demo as a process of its own (its default steps and
    gate): its JSON line and its wall seconds; a non-zero exit fails."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", script), *args],
                              cwd=REPO, capture_output=True, text=True, timeout=DEMO_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"phase 12b: the {name} demo ran past {DEMO_TIMEOUT_S} s") from e
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise SmokeFailure(f"phase 12b: the {name} demo exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    out = json.loads(lines[-1])
    out["process_s"] = wall
    log(f"  12b {name} demo ({script} {' '.join(args)}; {wall:.1f} s as a process): {lines[-1]}")
    return out


def phase_small(torch, np, card) -> dict:
    """Phase 12 (module docstring)."""
    import importlib.util

    log(f"phase 12: the MNIST MLP and CIFAR-10 CNN workloads at their presets' widths, then "
        f"the convergence demos; on {card}")
    t0 = time.perf_counter()
    out = {n: small_one(torch, np, n, card) for n in SMALL_WORKLOADS}
    out["mlp_converge"] = mlp_converges(np, card)
    torch.cuda.empty_cache()
    out["demos"] = {}
    # one at a time: two processes on one card take turns on it (a demo
    # beside another ran at half speed, PERF.md)
    for name, script, args in DEMOS:
        if name == "digits" and importlib.util.find_spec("sklearn") is None:
            log("  12b digits demo: not run — scikit-learn, whose bundled digit scans it "
                "trains on, is not installed on this machine (ROADMAP)")
            continue
        out["demos"][name] = run_demo(name, script, args)
    for name in ("mlm", "lm"):
        # the wrappers' own counts by head dim: every launch at 32, each
        # kernel at least once a step
        d = out["demos"][name]
        by_d, steps = d["flash_launches_by_head_dim"], d["steps"]
        if (d["head_dim"] != 32 or set(by_d) != {"32"}
                or not all(c >= steps > 0 for c in by_d["32"].values())):
            raise SmokeFailure(f"phase 12b: the {name} demo did not run every flash kernel at "
                               f"head_dim 32 each step (model head_dim {d['head_dim']}, "
                               f"{steps} steps, launches by head dim {by_d})")
    out["flash_d32_launches"] = {
        n: sum(out["demos"][d]["flash_launches_by_head_dim"]["32"][n] for d in ("mlm", "lm"))
        for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 12 wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: transformer training options — remat, fused QKV, blockwise
# attention, rmsprop/lamb/adafactor, data-parallel gpt_lm, the callbacks,
# the BERT bench
# ---------------------------------------------------------------------------

#: phase 13a/13b: steps of each gpt_lm pass (phase 5's setting otherwise)
T13_STEPS, T13_BLOCKWISE_STEPS = 4, 3
#: phase 13c: each optimizer's constant lr on phase 5's corpus (dropout
#: off, so that 3 steps show the loss fall): rmsprop's first updates are
#: ~3.2 lr an element, lamb's and adafactor's lr x the parameter's norm or
#: RMS — each a smoke setting, not a recipe
T13_OPTIMIZERS = (("rmsprop", 1e-4), ("lamb", 1e-2), ("adafactor", 1e-2))
T13_OPT_STEPS = 3
#: the f32 card-vs-CPU check of the optimizers: gpt_small's widths at 2
#: layers, a batch of 2 x 64 tokens, 2 updates
T13_F32 = dict(layers=2, batch=2, seq=64, steps=2)
#: phase 13d: data-parallel gpt_lm, two gloo ranks on this card, f32
T13_DP = dict(layers=2, global_batch=8, steps=3, chunk=256)
#: phase 13e: the callbacks' run (gpt_lm, 2 layers)
T13_CB_LAYERS, T13_CB_STEPS = 2, 6
#: phase 13f: tools/bench_bert_torch.py's runs: (label, environment)
T13_BENCH_STEPS = "5"
T13_BENCH = (
    ("bert flash", {"BENCH_MODEL": "bert", "BENCH_BATCH": "32", "BENCH_ATTN": "flash"}),
    ("bert flash + remat", {"BENCH_MODEL": "bert", "BENCH_BATCH": "32", "BENCH_ATTN": "flash",
                            "BENCH_REMAT": "1"}),
    ("bert flash + fused QKV", {"BENCH_MODEL": "bert", "BENCH_BATCH": "32",
                                "BENCH_ATTN": "flash", "BENCH_FUSED_QKV": "1"}),
    ("bert blockwise", {"BENCH_MODEL": "bert", "BENCH_BATCH": "32", "BENCH_ATTN": "blockwise"}),
    ("gpt B=64 flash + remat", {"BENCH_MODEL": "gpt", "BENCH_BATCH": "64", "BENCH_SEQ": "1024",
                                "BENCH_ATTN": "flash", "BENCH_REMAT": "1",
                                "BENCH_XENT_CHUNK": "256"}),
)

TOL.update({
    # phase 13a: fused QKV (one [3d, d] GEMM, q/k/v copied out) vs split
    # (three GEMMs), both with remat, bf16: the products summed in another
    # tiling — phase 5's flash-vs-dense kind of difference, so its limits
    "train/fused_qkv/loss": TOL["train/loss"],
    "train/fused_qkv/grad_rel_l2": TOL["train/grad_rel_l2"],
    # phase 13c: f32 optimizer updates, card vs CPU, each from the CPU's
    # state before it (weights, optimizer state; TF32 off). Given the CPU's
    # gradients, the card's update is the same elementwise f32 arithmetic
    # and the same whole-parameter sums in another order: each parameter's
    # update within 1e-5 relative L2 (the x1.01 control reads 1e-2; lamb's
    # first reading, 4.6e-3 on tok_embed.weight, was the CPU's
    # torch.linalg.vector_norm, off by 2.2e-3 over that 38.6M-element
    # table: Lamb now sums the squares). With its own gradients (its
    # forward and backward: the products and flash's sums in another
    # order) the loss within 1e-5 and the median parameter within 1e-5; the
    # worst is printed, not gated: attn.key.bias has an exact gradient of
    # 0, which rmsprop and lamb normalise from rounding noise on each side
    # (its relative L2 read 0.9-2.6), and the LayerNorm scales' gradients
    # sum every token's products in another order (up to 2.0e-5 for
    # final_ln.weight; H100, 700 W)
    "opt/f32/update": 1e-5,
    "opt/f32/step/median": 1e-5,
    "opt/f32/loss": 1e-5,
})


def phase13_corpus(np, tmp) -> list:
    return [f"--data.dataset=tokens:{lm_corpus(np, os.path.join(tmp, 'corpus13.npy'))}"]


@contextlib.contextmanager
def fused_qkv_weights(torch):
    """While open, ``init_params`` of a ``fused_qkv`` config gives the
    split config's weights of the same seed, fused (``weights.fuse_qkv``):
    the fused run starts from the split run's function."""
    import dataclasses

    from distributed_tensorflow_tpu_torch import weights
    from distributed_tensorflow_tpu_torch.models import transformer as tfm

    init = tfm.init_params

    def fused_init(cfg, seed=0, device="cuda", trainable=False):
        if not cfg.fused_qkv:
            return init(cfg, seed=seed, device=device, trainable=trainable)
        split = dataclasses.replace(cfg, fused_qkv=False)
        return weights.fuse_qkv(init(split, seed=seed, device=device, trainable=trainable),
                                split)

    with mock.patch.object(tfm, "init_params", fused_init):
        yield


def remat_phase(torch, np, card, data) -> dict:
    """Phase 13a (module docstring)."""
    from distributed_tensorflow_tpu_torch import weights
    from distributed_tensorflow_tpu_torch.models import transformer as tfm

    steps = T13_STEPS
    passes = {}

    def run(tag, extra, bwd=None):
        p = passes[tag] = train_pass(torch, np, "flash", steps=steps, extra=[*data, *extra],
                                     bwd=bwd)
        p["cfg"], p["res"] = p["res"].state.model.cfg, None  # the next pass starts clean
        gc.collect()
        torch.cuda.empty_cache()

    run("split", [])
    run("remat", ["--model.remat=true"])
    with mock.patch.object(tfm, "_generator_snapshot", lambda generator: None):
        run("control", ["--model.remat=true"])
    with fused_qkv_weights(torch):
        run("fused_qkv", ["--model.remat=true", "--model.fused_qkv=true"])
    run("fused_ln", ["--model.remat=true", "--model.fused_ln_matmul=true"], bwd="pallas")
    layers = passes["split"]["cfg"].num_layers
    for tag, p in passes.items():
        log(f"  13a {tag}: losses {p['losses']}; step {p['step_ms']:.2f} ms (median of steps "
            f"2-{steps}), {p['tok_s']:.0f} tokens/s, MFU {100 * p['mfu']:.2f}%, peak "
            f"{p['peak_gib']:.3f} GiB ({p['peak_gib'] - p['held_gib']:.3f} above the "
            f"{p['held_gib']:.3f} held before), launches {p['launches']}")
        if not np.isfinite(p["losses"]).all() or not p["losses"][-1] < p["losses"][0]:
            raise SmokeFailure(f"13a {tag}: the loss is not finite or did not fall")
    if passes["remat"]["losses"] != passes["split"]["losses"]:
        raise SmokeFailure(f"13a: remat's losses {passes['remat']['losses']} are not bitwise "
                           f"the plain run's {passes['split']['losses']}")
    if passes["control"]["losses"] == passes["split"]["losses"]:
        raise SmokeFailure("13a: the control (remat without the generator replay) passes the "
                           "bitwise gate: the gate cannot see the dropout masks")
    same_grads = all(torch.equal(a, b) for a, b in zip(passes["remat"]["grads"],
                                                       passes["split"]["grads"]))
    if not same_grads:
        raise SmokeFailure("13a: remat's step-1 gradients are not bitwise the plain run's")
    per = {"split": (1, 1), "remat": (2, 1), "control": (2, 1), "fused_qkv": (2, 1),
           "fused_ln": (2, 1)}
    for tag, (fwd, bwd) in per.items():
        want = {"flash_fwd": fwd * layers * steps, "flash_bwd_dkv": bwd * layers * steps,
                "flash_bwd_dq": bwd * layers * steps}
        got = {n: passes[tag]["launches"][n] for n in FLASH_NAMES}
        if got != want:
            raise SmokeFailure(f"13a {tag}: flash launches {got}, want {want}")
    ln = passes["fused_ln"]["launches"]
    want_ln = {"ln_matmul_train": 2 * 4 * layers * steps, "ln_matmul_bwd_dx": 4 * layers * steps,
               "ln_matmul_bwd_dw": 4 * layers * steps}
    if {n: ln[n] for n in want_ln} != want_ln:
        raise SmokeFailure(f"13a fused_ln: LN+matmul launches {ln}, want {want_ln}")
    above = {tag: p["peak_gib"] - p["held_gib"] for tag, p in passes.items()}
    if not above["remat"] < above["split"]:
        raise SmokeFailure(f"13a: remat's peak {above['remat']:.3f} GiB (above what was held "
                           f"before its run) is not below the plain run's {above['split']:.3f}")
    # fused QKV: its gradients in the split pass's names
    cfg = passes["fused_qkv"]["cfg"]
    fq = passes["fused_qkv"]
    fused = weights.split_qkv(dict(zip(fq["names"], fq["grads"])), cfg)
    fq_split = dict(fq, names=passes["remat"]["names"],
                    grads=[fused[n] for n in passes["remat"]["names"]])
    out = {"compare": {
        "fused_qkv vs split (remat both)": gate_train(
            train_diffs(torch, fq_split, passes["remat"]), "13a fused QKV vs split (remat, bf16)",
            TOL["train/fused_qkv/loss"], TOL["train/fused_qkv/grad_rel_l2"]),
        "remat + fused_ln vs plain": gate_train(
            train_diffs(torch, passes["fused_ln"], passes["split"]),
            "13a remat + fused_ln_matmul (pallas) vs plain unfused", TOL["train/fused/loss"],
            TOL["train/fused/grad_rel_l2"])}}
    diverge = next(i for i, (a, b) in enumerate(zip(passes["control"]["losses"],
                                                    passes["split"]["losses"])) if a != b)
    log(f"  13a remat: losses and step-1 gradients bitwise the plain run's; control (no "
        f"replay): first differing loss at step {diverge + 1}; peak above held "
        f"{above['remat']:.3f} GiB vs {above['split']:.3f} GiB; step "
        f"{passes['remat']['step_ms']:.2f} ms vs {passes['split']['step_ms']:.2f} ms")
    out["passes"] = {tag: {**{k: p[k] for k in ("losses", "step_ms", "tok_s", "mfu", "launches")},
                           "peak_gib": above[tag]} for tag, p in passes.items()}
    out["control_diverges_at"] = diverge + 1
    del passes, fq, fq_split, fused
    torch.cuda.empty_cache()
    return out


def blockwise_phase(torch, np, data) -> dict:
    """Phase 13b: blockwise attention (two key blocks at S=1024) vs dense."""
    passes = {impl: train_pass(torch, np, impl, steps=T13_BLOCKWISE_STEPS, extra=data)
              for impl in ("blockwise", "dense")}
    for impl, p in passes.items():
        log(f"  13b {impl}: losses {p['losses']}; step {p['step_ms']:.2f} ms, peak "
            f"{p['peak_gib']:.3f} GiB, flash launches {[p['launches'][n] for n in FLASH_NAMES]}")
        if any(p["launches"][n] for n in FLASH_NAMES):
            raise SmokeFailure(f"13b {impl}: launched a flash kernel")
    d = train_diffs(torch, passes["blockwise"], passes["dense"])
    out = {"compare": gate_train(d, "13b blockwise vs dense (bf16)", TOL["train/loss"],
                                 TOL["train/grad_rel_l2"])}
    out["passes"] = {impl: {k: p[k] for k in ("losses", "step_ms", "peak_gib")}
                     for impl, p in passes.items()}
    del passes
    torch.cuda.empty_cache()
    return out


def optimizer_f32(torch, np, name, lr) -> dict:
    """``T13_F32`` f32 updates of optimizer ``name`` on the CPU; each again
    on the card from the CPU's state before it (``state_leaves`` /
    ``load_state_leaves``), once given the CPU's gradients (every
    parameter's update within ``TOL["opt/f32/update"]``, beside a card
    update x 1.01 control) and once as a whole step with the card's own
    gradients (the loss and the median parameter's update; the worst is
    printed)."""
    import dataclasses

    from distributed_tensorflow_tpu_torch.models import transformer as tfm
    from distributed_tensorflow_tpu_torch.train import (
        OptimizerConfig, init_train_state, make_optimizer, make_train_step)
    from distributed_tensorflow_tpu_torch.train import step as step_lib

    f = T13_F32
    cfg = dataclasses.replace(tfm.gpt_small(causal_len=f["seq"]), num_layers=f["layers"],
                              dtype="float32", dropout=0.0)
    params = tfm.init_params(cfg, seed=0, device="cpu", trainable=True)
    ids = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (f["batch"], f["seq"])).astype(np.int64))

    def make(dev):
        model = tfm.build(cfg, params, dev, trainable=True)
        state = init_train_state(model, make_optimizer(
            OptimizerConfig(name=name, learning_rate=lr, weight_decay=0.01),
            model.parameters()))
        return state, make_train_step(tfm.lm_loss_fn(model))

    def leaves(state):
        return {n: v.detach().cpu().clone() for n, v in step_lib.state_leaves(state)
                if n.startswith("model/")}

    def rel(got, want, start):
        return [(rel_l2(got[k] - start[k], want[k] - start[k]), k[6:]) for k in want]

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        (cpu, cpu_step), (card, card_step) = make("cpu"), make(DEVICE)
        grads = []
        update = cpu.optimizer.update
        cpu.optimizer.update = lambda g: (grads.append([t.clone() for t in g]), update(g))
        same, own, ctl, losses = [], [], 0.0, []
        for i in range(f["steps"]):
            start = {n: v.detach().clone() for n, v in step_lib.state_leaves(cpu)}
            cpu, m = cpu_step(cpu, {"input_ids": ids})
            want = leaves(cpu)
            step_lib.load_state_leaves(card, start)
            card.optimizer.update([g.to(DEVICE) for g in grads[-1]])
            got = leaves(card)
            model0 = {k: v for k, v in start.items() if k.startswith("model/")}
            same += [(e, f"{n} update {i + 1}") for e, n in rel(got, want, model0)]
            ctl = max(ctl, max(rel_l2(1.01 * (got[k] - model0[k]), want[k] - model0[k])
                               for k in want))
            step_lib.load_state_leaves(card, start)
            card, mc = card_step(card, {"input_ids": ids.to(DEVICE)})
            own += [(e, f"{n} update {i + 1}") for e, n in rel(leaves(card), want, model0)]
            losses.append((float(mc["loss"]), float(m["loss"])))
        del cpu, card
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same.sort(reverse=True)
    own.sort(reverse=True)
    median = own[len(own) // 2][0]
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    log(f"  13c {name} f32 card vs CPU ({f['layers']} layers of gpt_small's widths, "
        f"{f['batch']}x{f['seq']} tokens, {f['steps']} updates at lr {lr}, each from the CPU's "
        f"state before it): given the CPU's gradients, updates relative L2 worst "
        f"{same[0][0]:.3e} ({same[0][1]}; limit {TOL['opt/f32/update']}), control (card update "
        f"x 1.01) {ctl:.3e}; the card's own step: losses {losses} (relative {loss_err:.3e}, limit "
        f"{TOL['opt/f32/loss']}), updates median {median:.3e} (limit "
        f"{TOL['opt/f32/step/median']}) over {len(own)}, worst {own[0][0]:.3e} ({own[0][1]}), "
        f"above 1e-5: {[f'{n} {e:.2e}' for e, n in own if e > 1e-5][:8]}")
    if not (same[0][0] <= TOL["opt/f32/update"] and loss_err <= TOL["opt/f32/loss"]
            and median <= TOL["opt/f32/step/median"]):
        raise SmokeFailure(f"13c {name}: the f32 card update is off the CPU's: given the same "
                           f"gradients {same[0]}; own step: loss {loss_err:.3e}, median "
                           f"{median:.3e}")
    if ctl <= TOL["opt/f32/update"]:
        raise SmokeFailure(f"13c {name}: the x1.01 control passes the update gate ({ctl:.3e})")
    return {"update": same[0][0], "control": ctl, "loss": loss_err, "step_median": median,
            "step_worst": own[0][0], "step_worst_name": own[0][1]}


def optimizers_phase(torch, np, data) -> dict:
    """Phase 13c: rmsprop, lamb and adafactor through run_workload at
    gpt_small's full size (the loss must fall), then f32 card vs CPU."""
    out = {}
    for name, lr in T13_OPTIMIZERS:
        p = train_pass(torch, np, "flash", steps=T13_OPT_STEPS, extra=[
            *data, f"--optimizer.name={name}", f"--optimizer.learning_rate={lr}",
            "--model.dropout=0.0"])
        opt = p["res"].state.optimizer
        kinds = sorted({k for keys in opt.param_state_keys() for k in keys})
        factored = sum(1 for keys in opt.param_state_keys() if "v_row" in keys)
        log(f"  13c {name} (lr {lr}): losses {p['losses']}; step {p['step_ms']:.2f} ms, peak "
            f"{p['peak_gib']:.3f} GiB; state {kinds}"
            + (f", {factored} of {len(opt.params)} parameters factored" if factored else ""))
        if not np.isfinite(p["losses"]).all() or not p["losses"][-1] < p["losses"][0]:
            raise SmokeFailure(f"13c {name}: the loss did not fall ({p['losses']})")
        if name == "adafactor" and not factored:
            raise SmokeFailure("13c adafactor: no parameter is factored at d_model 768")
        out[name] = {"losses": p["losses"], "step_ms": p["step_ms"], "peak_gib": p["peak_gib"]}
        del p, opt
        torch.cuda.empty_cache()
        out[name]["f32"] = optimizer_f32(torch, np, name, lr)
        torch.cuda.empty_cache()
    return out


def dp_phase(torch, np) -> dict:
    """Phase 13d: the ``gpt`` job of ``tests/torch_dp_worker.py`` on two
    gloo ranks on this card — gpt_small's widths (vocab 50304, S 1024) at
    ``T13_DP``'s depth, f32, the chunked loss, adamw, plain and at dropout
    0.1 with remat — against one process on the global batches run here
    meanwhile, with phase 7b's f32 limits."""
    import dataclasses
    import tempfile

    from distributed_tensorflow_tpu_torch.models import transformer as tfm

    worker = load_dp_worker()
    d = T13_DP
    cfg = dataclasses.replace(tfm.gpt_small(), num_layers=d["layers"], dtype="float32",
                              dropout=0.0)
    sd = {k: v.numpy() for k, v in tfm.init_params(cfg, seed=0, device="cpu",
                                                   trainable=True).items()}
    rng = np.random.default_rng(130)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (d["global_batch"], cfg.max_len))
                .astype(np.int32)} for _ in range(d["steps"])]
    opt = dict(name="adamw", learning_rate=1e-4, weight_decay=0.01)
    passes = (("plain", {}), ("dropout", {"dropout": 0.1, "remat": True}))
    with tempfile.TemporaryDirectory() as out:
        inputs = os.path.join(out, "inputs.npz")
        np.savez(inputs, **{f"sd/{k}": v for k, v in sd.items()},
                 **{f"train{i}/input_ids": b["input_ids"] for i, b in enumerate(batches)})
        t0 = time.perf_counter()
        procs = worker.launch({"job": "gpt", "device": DEVICE, "backend": "gloo", "out": out,
                               "inputs": inputs, "cfg": dataclasses.asdict(cfg),
                               "optimizer": opt, "dropout": 0.1, "chunk": d["chunk"]})
        refs = {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for tag, kw in passes:
                refs[tag] = worker.bert_steps(dataclasses.replace(cfg, **kw), sd, batches, opt,
                                              DEVICE, lm_chunk=d["chunk"])
                refs[tag].pop("model")
                torch.cuda.empty_cache()
        except BaseException:
            worker.stop(procs)
            raise
        finally:
            torch.backends.cudnn.deterministic = deterministic
        ranks = worker.wait(procs, out, timeout=600)
        wall = time.perf_counter() - t0
    res = {"wall_s": wall}
    for tag, _ in passes:
        got = [{"losses": r[f"{tag}/losses"], **{k[len(tag) + 7:]: v for k, v in r.items()
                                                 if k.startswith(f"{tag}/state/")}}
               for r in ranks]
        if not all(np.array_equal(got[0][k], got[1][k]) for k in got[0]):
            raise SmokeFailure(f"13d {tag}: the two ranks' weights or losses differ")
        ref = refs[tag]
        loss = float(np.abs(np.asarray(got[0]["losses"]) - ref["losses"]).max())
        upd = sorted(((float(np.linalg.norm((got[0][k] - sd[k]) - (v - sd[k])))
                       / max(float(np.linalg.norm(v - sd[k])), 1e-30), k)
                      for k, v in ref["state"].items() if not k.endswith("attn.key.bias")),
                     reverse=True)
        got_n = {"loss": loss, "worst": upd[0][0], "median": upd[len(upd) // 2][0]}
        lim = {k: TOL[f"dp/f32/{k}"] for k in got_n}
        log(f"  13d {tag}: rank losses {[float(x) for x in got[0]['losses']]}, one process "
            f"{[float(x) for x in ref['losses']]}; |loss diff| max {loss:.3e}; updates over "
            f"{d['steps']} steps "
            f"relative L2 worst {upd[0][0]:.3e} ({upd[0][1]}), median {got_n['median']:.3e}; "
            f"limits {lim}; ranks bitwise alike")
        bad = {k: v for k, v in got_n.items() if not v <= lim[k]}
        if bad:
            raise SmokeFailure(f"13d {tag}: outside phase 7b's f32 limits: {bad}")
        res[tag] = got_n
    log(f"  13d wall {wall:.1f} s (two processes started, {d['steps']} steps x 2 passes each)")
    return res


class _Stall:
    """A callback that, after step ``at``, moves the watchdog's clock past
    its budget and then waits (the hung step) until the abort arrives."""

    def __init__(self, clock, at: int, wait_s: float = 60.0):
        self.clock, self.at, self.wait_s = clock, at, wait_s

    def on_train_start(self, trainer):
        pass

    def on_train_end(self, trainer):
        pass

    def on_step_end(self, trainer, step, metrics):
        if step == self.at:
            self.clock.t += 1e4
            deadline = time.monotonic() + self.wait_s
            while time.monotonic() < deadline:
                time.sleep(0.001)
            raise SmokeFailure("13e: the watchdog never aborted the stalled step")


class _ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def callbacks_phase(torch, np, data) -> dict:
    """Phase 13e: a gpt_lm run with the four callbacks, then a stalled one."""
    import tempfile

    from distributed_tensorflow_tpu_torch.obs import flightrec
    from distributed_tensorflow_tpu_torch.obs.registry import Registry
    from distributed_tensorflow_tpu_torch.resilience.supervisor import STALLED, classify_failure
    from distributed_tensorflow_tpu_torch.train import callbacks as tcb
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    small = [*TRAIN_OVERRIDES, *data, f"--model.num_layers={T13_CB_LAYERS}",
             "--model.attention_impl=flash", "--data.global_batch_size=8"]
    rec = flightrec.FlightRecorder()
    # a trace with no device kernel record at all is blank (cuda_ms): the
    # run is made again, from new callbacks
    for _ in range(1 + BLANK_RETAKES):
        reg = Registry()
        with tempfile.TemporaryDirectory() as tmp:
            prof = tcb.Profiler(os.path.join(tmp, "prof"), start_step=2, num_steps=2)
            tel = tcb.TelemetryCallback(registry=reg, every_n=1)
            wd = tcb.Watchdog(budget_s=600.0, registry=reg, flightrec=rec)
            res = run_workload("gpt_lm", small + [f"--train.num_steps={T13_CB_STEPS}",
                                                  f"--train.summary_dir={tmp}/tb"],
                               device=DEVICE, extra_callbacks=[prof, tel, wd])
            trace = open(prof.path).read()
            named = {k: trace.count(k) for k in FLASH_KERNELS}
            (event_file,) = os.listdir(os.path.join(tmp, "tb"))
            records = tcb.read_records(os.path.join(tmp, "tb", event_file))  # checks every CRC
        if re.search(r'"cat":\s*"kernel"', trace):
            break
        BLANK_TRACES[0] += 1
        log("  13e: the profiler's trace holds no device kernel record; the run is made again")
    scalars = len(res.history[-1]) - 1  # every metric of a logged step but "step"
    steps_total = reg.get("train_steps_total").value
    log(f"  13e callbacks ({T13_CB_LAYERS} layers, {T13_CB_STEPS} steps): profiler trace of "
        f"steps 2-4 names the flash kernels {named}; event file {event_file}: {len(records)} "
        f"records, every CRC checked; telemetry train_steps_total {steps_total}, "
        f"train_step_seconds count {reg.get('train_step_seconds').count}; watchdog stalls "
        f"{reg.get('train_watchdog_stalls_total').value}")
    if not all(named.values()):
        raise SmokeFailure(f"13e: the profiler's trace lacks a flash kernel: {named}")
    if steps_total != T13_CB_STEPS:
        raise SmokeFailure(f"13e: train_steps_total {steps_total}, want {T13_CB_STEPS}")
    if len(records) < 1 + T13_CB_STEPS * 2:
        raise SmokeFailure(f"13e: {len(records)} event records for {T13_CB_STEPS} steps of "
                           f"{scalars} scalars")
    clock = _ManualClock()
    stall_wd = tcb.Watchdog(budget_s=5.0, registry=Registry(), poll_s=0.01, clock=clock,
                            flightrec=rec, abort_on_stall=True)
    t0 = time.perf_counter()
    try:
        run_workload("gpt_lm", small + ["--train.num_steps=4"], device=DEVICE,
                     extra_callbacks=[stall_wd, _Stall(clock, at=2)])
        raise SmokeFailure("13e: the stalled run finished")
    except tcb.StalledError as e:
        cls = classify_failure(e)
    stall_s = time.perf_counter() - t0
    log(f"  13e stall: StalledError after step 2 ({stall_s:.1f} s run), classified {cls!r}; "
        f"flight recorder: {[ev['kind'] for ev in rec.events() if ev['kind'] == 'watchdog_stall']}")
    if cls != STALLED:
        raise SmokeFailure(f"13e: StalledError classified {cls!r}, want {STALLED!r}")
    torch.cuda.empty_cache()
    return {"flash_in_trace": named, "records": len(records), "steps_total": steps_total,
            "stall_class": cls}


def bench_phase(torch, np) -> dict:
    """Phase 13f: ``tools/bench_bert_torch.py`` in this process, each
    ``T13_BENCH`` configuration ``T13_BENCH_STEPS`` timed steps."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_bert_torch", os.path.join(REPO, "tools", "bench_bert_torch.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    out = {}
    for label, env in T13_BENCH:
        row = bench.run(DEVICE, {**env, "BENCH_STEPS": T13_BENCH_STEPS})
        log(f"  13f {label}: " + json.dumps(row))
        if not (row["value"] > 0 and np.isfinite(row["final_loss"])):
            raise SmokeFailure(f"13f {label}: no rate or a non-finite loss")
        flash = row["flash_launches_per_step"]
        layers = row["num_layers"]
        if env["BENCH_ATTN"] == "flash":
            want = {"flash_fwd": layers * (2 if env.get("BENCH_REMAT") else 1),
                    "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
        else:
            want = {n: 0 for n in FLASH_NAMES}
        if flash != want:
            raise SmokeFailure(f"13f {label}: flash launches a step {flash}, want {want}")
        out[label] = {k: row[k] for k in ("value", "step_ms", "mfu", "peak_memory_gib",
                                          "flash_launches_per_step", "global_batch")}
        torch.cuda.empty_cache()
    return out


def phase_transformer(torch, np, card) -> dict:
    """Phase 13 (module docstring)."""
    import tempfile

    log(f"phase 13: transformer training options on gpt_lm at full width (gpt_small, S=1024, "
        f"B=8, bf16, phase 5's corpus and setting) — remat, fused QKV, blockwise attention, "
        f"rmsprop/lamb/adafactor — data-parallel gpt_lm on two ranks, the callbacks, and "
        f"tools/bench_bert_torch.py; on {card}")
    walls, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data = phase13_corpus(np, tmp)
        for key, fn, args in (("13a", remat_phase, (torch, np, card, data)),
                              ("13b", blockwise_phase, (torch, np, data)),
                              ("13c", optimizers_phase, (torch, np, data)),
                              ("13d", dp_phase, (torch, np)),
                              ("13e", callbacks_phase, (torch, np, data)),
                              ("13f", bench_phase, (torch, np))):
            out[key] = timed(walls, key, fn, *args)
    out["walls"] = walls
    log("  phase 13 walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return out


# ---------------------------------------------------------------------------
# phases 3-4: serve gpt_small at full width
# ---------------------------------------------------------------------------


def make_prompts(np, vocab: int, n: int = 8, seed: int = 0):
    """8 prompts of 48..900 tokens from a seeded generator; four open
    with the same 128-token system prefix (prefix reuse), and the last of
    those repeats another one whole (copy-on-write)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=128).tolist()
    lens = rng.integers(48, 901, size=n)
    lens[0], lens[1] = 900, 48
    prompts = []
    for i, L in enumerate(lens):
        if i % 2 == 0:
            L = max(int(L), 160)
            prompts.append(system + rng.integers(0, vocab, size=L - 128).tolist())
        else:
            prompts.append(rng.integers(0, vocab, size=int(L)).tolist())
    # a repeated prompt maps every block of the first, including the one
    # holding its last position, which it must rewrite: copy-on-write
    prompts[6] = list(prompts[4])
    return prompts


def serve_pass(torch, np, cfg, params, prompts, label, *, record=False, **kw):
    """One engine run over ``prompts``; returns streams, stats and (with
    ``record``) the logits row behind every delivered token."""
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, device=DEVICE, num_slots=4, block_size=16,
                      prefill_chunk=64, seed=0, **kw)
    rows: dict[tuple[int, int], object] = {}
    if record:
        last = {}
        pre, dec, app = eng._prefill_chunk_fn, eng._decode, eng.sched.append_token

        def prefill(*a):
            logits, cache = pre(*a)
            last["src"] = ("prefill", logits)
            return logits, cache

        def decode(*a):
            logits, cache = dec(*a)
            last["src"] = ("decode", logits)
            return logits, cache

        def append_token(slot, token):
            req = eng.sched.slots[slot]
            kind, logits = last["src"]
            rows[(req.uid, len(req.generated))] = (
                logits if kind == "prefill" else logits[slot]).float().clone()
            return app(slot, token)

        eng._prefill_chunk_fn, eng._decode = prefill, decode
        eng.sched.append_token = append_token
    uids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while eng.sched.has_work:
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = eng.drain()
    streams = {u: list(done[u].generated) for u in uids}
    reg = eng.registry
    ntok = sum(len(s) for s in streams.values())
    ttft = [r.t_first_token - r.t_submit for r in done.values()]
    tpot = [(r.t_finish - r.t_first_token) / max(len(r.generated) - 1, 1)
            for r in done.values()]
    out = dict(label=label, streams=streams, rows=rows, steps=steps, wall_s=wall,
               tokens=ntok, tok_s=ntok / wall,
               ttft_p50_ms=1e3 * float(np.median(ttft)),
               tpot_p50_ms=1e3 * float(np.median(tpot)),
               ttft_p50_bucket_ms=1e3 * reg.get("serve_ttft_seconds").percentile(0.5),
               reuse_hits=int(reg.get("prefix_reuse_hits_total").value),
               cow_copies=eng.alloc.cow_copies,
               preemptions=sum(r.preemptions for r in done.values()),
               spec_rate=reg.get("spec_acceptance_rate").value,
               blocks_free=eng.alloc.blocks_free, num_blocks=eng.cache.num_blocks)
    if out["blocks_free"] != out["num_blocks"]:
        raise SmokeFailure(f"{label}: block leak after drain(): "
                           f"{out['blocks_free']} of {out['num_blocks']} free")
    if any(len(s) != 32 for s in streams.values()):
        raise SmokeFailure(f"{label}: a stream did not reach max_new=32")
    return out


def compare_passes(torch, got, ref, tol):
    """Logits behind each delivered token within ``tol``; greedy streams
    equal, or diverging only at a reference top-2 margin below ``tol``."""
    worst, diverged = 0.0, []
    for uid, ref_stream in ref["streams"].items():
        stream = got["streams"][uid]
        for t, (a, b) in enumerate(zip(stream, ref_stream)):
            ra, rb = got["rows"][(uid, t)], ref["rows"][(uid, t)]
            if not torch.isfinite(ra).all():
                raise SmokeFailure(f"{got['label']}: non-finite logits (uid {uid}, token {t})")
            worst = max(worst, float((ra - rb).abs().max()))
            if a != b:
                top2 = torch.topk(rb, 2).values
                margin = float(top2[0] - top2[1])
                diverged.append((uid, t, margin))
                if margin >= tol:
                    raise SmokeFailure(
                        f"{got['label']}: uid {uid} diverges at token {t} with reference "
                        f"top-2 margin {margin:.4f} >= tol {tol}")
                break  # conditioning differs from here on
    log(f"  {got['label']} vs {ref['label']}: max |logits diff| = {worst:.4e} "
        f"(tol {tol}); streams equal {len(ref['streams']) - len(diverged)}/"
        f"{len(ref['streams'])}; divergences (uid, token, margin) {diverged}")
    if worst > tol:
        raise SmokeFailure(f"{got['label']}: logits differ by {worst} > {tol}")
    return worst


def phase_serve(torch, np, card):
    import dataclasses

    from distributed_tensorflow_tpu_torch.models import transformer as tfm
    from distributed_tensorflow_tpu_torch.ops.fused_ln_matmul import ln_matmul
    from distributed_tensorflow_tpu_torch.ops.paged_attention import paged_flash_attention

    cfg = tfm.gpt_small()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    log(f"phase 3: gpt_small (L={cfg.num_layers} d={cfg.d_model} H={cfg.num_heads} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}), random weights "
        f"from seed 0 in {time.perf_counter() - t0:.2f}s; 4 slots, block_size 16, "
        f"prefill_chunk 64, 8 requests, max_new 32, greedy; on {card}")
    prompts = make_prompts(np, cfg.vocab_size)
    log(f"  prompt lengths {[len(p) for p in prompts]}")
    # warm-up: one short request per configuration (cuBLAS handles, caches)
    for kw in ({}, {"spec_k": 4}):
        from distributed_tensorflow_tpu_torch.serve import ServeEngine
        w = ServeEngine(dataclasses.replace(cfg, fused_ln_matmul=True), params,
                        device=DEVICE, num_slots=4, prefill_chunk=64, **kw)
        w.submit(prompts[1][:40], max_new_tokens=4)
        w.run()
    torch.cuda.synchronize()

    passes, counts = {}, {}
    paged_flash_attention.launches = ln_matmul.launches = 0  # main path starts
    ln_matmul.tiled_launches = 0
    for label, c, kw in (("spec_k=0", cfg, {}),
                         ("spec_k=4", cfg, {"spec_k": 4}),
                         ("fused_ln_matmul", dataclasses.replace(cfg, fused_ln_matmul=True), {})):
        a0, l0 = paged_flash_attention.launches, ln_matmul.launches
        passes[label] = serve_pass(torch, np, c, params, prompts, label,
                                   record=label != "spec_k=4", **kw)
        p = passes[label]
        counts[label] = (paged_flash_attention.launches - a0, ln_matmul.launches - l0)
        log(f"  {label}: {p['tokens']} tokens in {p['wall_s']:.3f}s = {p['tok_s']:.1f} tok/s, "
            f"TTFT p50 {p['ttft_p50_ms']:.2f} ms (registry bucket {p['ttft_p50_bucket_ms']:.0f}), "
            f"TPOT p50 {p['tpot_p50_ms']:.3f} ms, "
            f"{p['steps']} steps, launches paged_attention={counts[label][0]} "
            f"ln_matmul={counts[label][1]}, reuse_hits={p['reuse_hits']} "
            f"cow_copies={p['cow_copies']} preemptions={p['preemptions']} "
            f"spec_acceptance={p['spec_rate']:.3f} blocks_free={p['blocks_free']}/"
            f"{p['num_blocks']}")
    launches = {"paged_attention": paged_flash_attention.launches,
                "ln_matmul": ln_matmul.launches}  # main path read
    if min(launches.values()) < 1 or counts["fused_ln_matmul"][1] < 1 \
            or min(c[0] for c in counts.values()) < 1:
        raise SmokeFailure(f"a kernel of the path never launched: {counts}")
    if ln_matmul.tiled_launches:  # serving stays on the row-tile forward
        raise SmokeFailure(f"serving took the tiled forward {ln_matmul.tiled_launches} times")
    if passes["spec_k=0"]["reuse_hits"] < 1 or passes["spec_k=0"]["cow_copies"] < 1:
        raise SmokeFailure("the shared prefix was never reused or never copied on write")
    same = sum(passes["spec_k=4"]["streams"][u] == s
               for u, s in passes["spec_k=0"]["streams"].items())
    log(f"  spec_k=4 greedy streams equal to spec_k=0: {same}/8 (bf16 verify rows may "
        f"flip near-ties; not a gate)")

    log("phase 4: the spec_k=0 pass with no kernel on the path "
        "(paged_impl='gather', fused_ln_matmul=False) as the reference")
    paged_flash_attention.launches = ln_matmul.launches = 0
    ref = serve_pass(torch, np, cfg, params, prompts, "gather", record=True,
                     paged_impl="gather")
    if paged_flash_attention.launches or ln_matmul.launches:
        raise SmokeFailure("the reference pass launched a kernel")
    log(f"  gather: {ref['tok_s']:.1f} tok/s, TTFT p50 {ref['ttft_p50_ms']:.2f} ms, "
        f"TPOT p50 {ref['tpot_p50_ms']:.3f} ms")
    for label in ("spec_k=0", "fused_ln_matmul"):
        compare_passes(torch, passes[label], ref, TOL["logits"])
    profile_pass(torch, np, dataclasses.replace(cfg, fused_ln_matmul=True), params, prompts)
    steps = {k: v["steps"] for k, v in passes.items()}
    return launches, counts, steps


def profile_pass(torch, np, cfg, params, prompts):
    """Where the time goes: one more pass (both kernels on the path)
    under torch.profiler — device time by kernel, and the device's busy
    share of the pass's wall time (the rest is the host: Python, eager
    dispatch, host<->device copies of tokens and tables). The device
    activity alone is recorded: with the host's operators too, the trace
    of the pass's 89 steps took over a minute to process (NVIDIA H100
    80GB HBM3, 700 W), and their recording lengthened the wall."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        p = serve_pass(torch, np, cfg, params, prompts, "profiled fused_ln_matmul")
    events = [e for e in device_events(torch, prof) if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = 1e3 * p["wall_s"]
    log(f"  profiled pass (fused_ln_matmul, profiler on): wall {wall_ms:.1f} ms, device "
        f"busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% (idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f}%), {p['steps']} steps")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


def check_spills(report: str, kernels, head_dims=()) -> None:
    """ptxas's report of one library: each instantiation of ``kernels``
    (matched by substring of its mangled name) with its registers and
    spills, logged; fails where one spills, where none was reported, or
    where a kernel has no instantiation at one of ``head_dims``."""
    lines = report.splitlines()
    found = {k: 0 for k in kernels}
    dims = {k: set() for k in kernels}
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for (\S+)", line)
        k = next((k for k in kernels if m and k in m.group(1)), None)
        if k is None:
            continue
        found[k] += 1
        after = " ".join(lines[i + 1:i + 3])
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill", after)]
        regs = re.search(r"Used (\d+) registers", after)
        d = re.search(r"ILi(\d+)E", m.group(1))
        if d:
            dims[k].add(int(d.group(1)))
        log(f"  ptxas {k}<{d.group(1) if d else '?'}>: {regs.group(1) if regs else '?'} "
            f"registers, spill stores/loads {spills}")
        if any(spills):
            raise SmokeFailure(f"ptxas: {m.group(1)} spills {spills} bytes")
    if not all(found.values()):
        raise SmokeFailure(f"ptxas reported no instantiation of {found}")
    missing = {k: sorted(set(head_dims) - d) for k, d in dims.items() if set(head_dims) - d}
    if missing:
        raise SmokeFailure(f"ptxas reported no instantiation at head dims {missing}")


# ---------------------------------------------------------------------------
# phase 14: tensor and fully-sharded data parallelism
# ---------------------------------------------------------------------------

#: 14a: gpt_lm at gpt_small's full width, data=1 x model=2, two gloo ranks
#: on this card; 14b: bert_pretrain at bert_base's, fsdp=2 x model=2, four
#: ranks; 14c: a head dim of 256 through run_workload (gpt_lm at d_model
#: 1024 over 4 heads)
T14_GPT = dict(global_batch=8, steps=3, chunk=256, mesh={"model": 2})
T14_BERT = dict(global_batch=32, steps=2, mesh={"fsdp": 2, "model": 2}, pad=(384, 512))
T14_D256 = ["--model.num_layers=2", "--model.d_model=1024", "--model.num_heads=4",
            "--model.d_ff=4096", "--data.global_batch_size=4", "--train.num_steps=2",
            "--train.eval_batches=0", "--train.log_every=1", "--model.xent_chunk=256"]
#: the LN+matmul backward of the fused passes (so dx and dw launch too)
T14_ENV = {"DTF_FUSED_BWD": "pallas"}


def tp_gates(np, tag, ranks, ref, ctl, init, phase="14", tol="tp/bf16") -> dict:
    """Phase 14's gates (``TOL["tp/bf16/*"]``; phase 15b's ``sp/bf16``):
    every rank bitwise alike (the SHA-256 of every gathered leaf, and no
    drift of a replicated parameter across the ranks after any step); the
    losses and each parameter's update against one process on the global
    batches, with their controls (the losses x 1.01; one process on the
    first half of each batch). ``init``: the whole initial parameters by
    name."""
    digests = [{k: str(v) for k, v in r.items() if k.startswith(f"{tag}/digest/")}
               for r in ranks]
    if any(d != digests[0] for d in digests[1:]) or not digests[0]:
        raise SmokeFailure(f"{phase} {tag}: the ranks' gathered states differ")
    if any(np.asarray(r[f"{tag}/drift"]).any() for r in ranks):
        raise SmokeFailure(f"{phase} {tag}: a replicated parameter differs across the ranks")
    got = {k[len(f"{tag}/whole/model/"):]: v for k, v in ranks[0].items()
           if k.startswith(f"{tag}/whole/model/")}

    def updates(state):
        rels = sorted(((float(np.linalg.norm((state[k] - init[k]) - (v - init[k]))
                              / max(float(np.linalg.norm(v - init[k])), 1e-30)), k)
                       for k, v in ((k[len("whole/model/"):], v) for k, v in ref.items()
                                    if k.startswith("whole/model/"))
                       if not k.endswith("attn.key.bias")), reverse=True)
        return rels[0], rels[len(rels) // 2][0]

    losses = np.asarray(ranks[0][f"{tag}/losses"])
    rel = lambda a: float(np.abs(a - ref["losses"]).max() / np.abs(ref["losses"]).max())  # noqa
    loss, loss_ctl = rel(losses), rel(losses * 1.01)
    (worst, worst_name), median = updates(got)
    ctl_state = {k[len("whole/model/"):]: v for k, v in ctl.items()
                 if k.startswith("whole/model/")}
    _, median_ctl = updates(ctl_state)
    lim = {k: TOL[f"{tol}/{k}"] for k in ("loss", "worst", "median")}
    log(f"  {phase} {tag}: rank losses {[float(x) for x in losses]}, one process "
        f"{[float(x) for x in ref['losses']]}; loss relative {loss:.3e} (control x 1.01: "
        f"{loss_ctl:.3e}); updates relative L2 worst {worst:.3e} ({worst_name}), median "
        f"{median:.3e} (control, half batch: {median_ctl:.3e}); limits {lim}; ranks bitwise "
        f"alike over {len(digests[0])} gathered leaves")
    if loss_ctl <= lim["loss"] or median_ctl <= lim["median"]:
        raise SmokeFailure(f"{phase} {tag}: a control passes its gate")
    bad = {k: v for k, v in (("loss", loss), ("worst", worst), ("median", median))
           if not v <= lim[k]}
    if bad:
        raise SmokeFailure(f"{phase} {tag}: outside the limits: {bad}")
    return {"loss": loss, "worst": worst, "median": median, "control_median": median_ctl}


def tp_case(worker, torch, np, tag, cfg, mesh, batches, opt, world, out, smi, more=None,
            **extra):
    """One phase-14 case: the ranks' ``tp`` job (``tests/torch_dp_worker.py``)
    run to its end first, so that their step times are theirs alone, then
    the one-process reference and the half-batch control on this card.
    ``more``: other phases' work for the same ranks (``shared_launches``):
    ``cases``, (case, batches) run after this one, and ``attention``, the
    ``seq`` job's calls on ``arrays``, run before it (the results under
    their tags in the ranks'). Returns (ranks, reference, control)."""
    import dataclasses

    more = more or {}
    case = dict(tag=tag, seed=0, cfg=dataclasses.asdict(cfg), mesh=mesh, optimizer=opt,
                options={}, whole="params", env=T14_ENV, mlm=not cfg.causal, **extra)
    cases = [(case, batches), *more.get("cases", ())]
    inputs = os.path.join(out, f"{tag}.npz")
    np.savez(inputs, **more.get("arrays", {}),
             **{f"{c['tag']}/train{i}/{k}": v for c, bs in cases
                for i, b in enumerate(bs) for k, v in b.items()})
    spec = {"job": "tp", "device": DEVICE, "backend": "gloo", "out": out, "inputs": inputs,
            "cases": [c for c, _ in cases]}
    if more.get("attention"):
        spec.update(job="seq", attention=more["attention"])
    procs = worker.launch(spec, world=world)
    ranks = worker.wait(procs, out, timeout=900)
    for r, rank in enumerate(ranks):
        log(f"  14 {tag} rank {r}: step ms {[round(float(x), 2) for x in rank[tag + '/step_ms']]}"
            f" (gloo, {world} ranks on one card: not tensor-parallel throughput; {smi}); "
            f"launches over the steps " + ", ".join(
                f"{k[len(tag) + 10:]} {int(v)}" for k, v in rank.items()
                if k.startswith(f"{tag}/launches/")))
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    old = {k: os.environ.get(k) for k in T14_ENV}
    os.environ.update(T14_ENV)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        one = dict(case, save=False)
        ref = worker.tp_steps(one, None, batches, [], DEVICE)
        ref.pop("model")
        torch.cuda.empty_cache()
        ctl = worker.tp_steps(one, None, half, [], DEVICE)
        ctl.pop("model")
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ranks, ref, ctl


def phase_tp(torch, np, smi, more=None) -> dict:
    """Phase 14: 14a gpt_lm (gpt_small, S=1024, B=8, bf16, flash, fused
    LN+matmul with the pallas backward, the chunked loss at 256, adamw,
    dropout 0, f32 head) at data=1 x model=2 in two gloo processes on this
    card, 3 steps from the weights of one seed, against the same steps in
    one process (``tp_gates``), the flash and LN+matmul kernels launched on
    every rank at its local shapes (6 heads, 1152 q/k/v columns, 1536
    mlp_in columns); 14b bert_pretrain (bert_base, S=512, B=32, the
    gathered MLM head, a padded kv_mask, dropout 0.1) at fsdp=2 x model=2 in
    four processes, 2 steps, against one process, then its step dir
    (written gathered by the chief) restored in one process at model=1,
    every leaf bitwise the ranks' gathered one (SHA-256); 14c the D=256
    flash kernels' launches through ``run_workload`` (gpt_lm at d_model
    1024 over 4 heads). ``more``: world size -> phases 15's and 16's work
    for the same two and four ranks (``shared_launches``; a launch each
    saved); the ranks' results by those phases' tags in ``res["more"]``."""
    import dataclasses
    import tempfile

    from distributed_tensorflow_tpu_torch.data import text
    from distributed_tensorflow_tpu_torch.models import transformer as tfm
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.train import checkpoint as ck_lib
    from distributed_tensorflow_tpu_torch.train import optimizers as topt
    from distributed_tensorflow_tpu_torch.train import step as tstep

    worker = load_dp_worker()
    res = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        # 14a
        g = T14_GPT
        cfg = dataclasses.replace(tfm.gpt_small(), fused_ln_matmul=True, dropout=0.0,
                                  xent_chunk=g["chunk"])
        rng = np.random.default_rng(140)
        batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (g["global_batch"],
                                                                 cfg.max_len)).astype(np.int32)}
                   for _ in range(g["steps"])]
        log(f"phase 14a: gpt_lm gpt_small B={g['global_batch']} S={cfg.max_len} bf16 at "
            f"{g['mesh']}, fused LN+matmul (pallas backward), flash, xent_chunk {g['chunk']}")
        more = more or {}
        ranks, ref, ctl = tp_case(worker, torch, np, "gpt", cfg, g["mesh"], batches,
                                  dict(name="adamw", learning_rate=1e-4, weight_decay=0.1), 2,
                                  out, smi, more=more.get(2), chunk=g["chunk"], save=False)
        res["more"] = {t: ranks for t in more.get(2, {}).get("tags", ())}
        init = {k: v.float().cpu().numpy() for k, v in tfm.init_params(
            cfg, seed=0, device=DEVICE, trainable=True).items()}
        res["14a"] = tp_gates(np, "gpt", ranks, ref, ctl, init)
        need = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "ln_matmul", "ln_matmul_bwd_dx",
                "ln_matmul_bwd_dw")
        launches = [{n: int(r[f"gpt/launches/{n}"]) for n in need} for r in ranks]
        if any(v <= 0 for per in launches for v in per.values()):
            raise SmokeFailure(f"14a: a kernel was not launched on a rank: {launches}")
        res["14a"]["launches_per_step"] = {n: launches[0][n] / g["steps"] for n in need}
        res["14a"]["step_ms"] = [[float(x) for x in r["gpt/step_ms"]] for r in ranks]
        del init, ref, ctl, ranks
        torch.cuda.empty_cache()
        # 14b
        b = T14_BERT
        cfg = tfm.bert_base()
        dcfg = text.TextDataConfig(dataset="synthetic_mlm", global_batch_size=b["global_batch"],
                                   seq_len=cfg.max_len, vocab_size=cfg.vocab_size,
                                   max_predictions=-1)
        stream = text.make_text_dataset(dcfg, shard=(0, 1))
        batches = []
        for i in range(b["steps"]):
            bt = dict(stream.batch(i))
            lens = rng.integers(b["pad"][0], b["pad"][1] + 1, b["global_batch"])
            bt["attention_mask"] = (np.arange(cfg.max_len)[None] < lens[:, None]).astype(np.int32)
            batches.append(bt)
        log(f"phase 14b: bert_pretrain bert_base B={b['global_batch']} S={cfg.max_len} bf16, "
            f"gathered MLM head (K={batches[0]['masked_positions'].shape[1]}), padded kv_mask "
            f"({b['pad'][0]}-{b['pad'][1]} keys), dropout {cfg.dropout}, at {b['mesh']}")
        opt = dict(name="adamw", learning_rate=1e-4, weight_decay=0.01)
        ranks, ref, ctl = tp_case(worker, torch, np, "bert", cfg, b["mesh"], batches, opt, 4,
                                  out, smi, more=more.get(4))
        res["more"].update({t: ranks for t in more.get(4, {}).get("tags", ())})
        init = {k: v.float().cpu().numpy() for k, v in tfm.init_params(
            cfg, seed=0, device=DEVICE, trainable=True).items()}
        res["14b"] = tp_gates(np, "bert", ranks, ref, ctl, init)
        res["14b"]["step_ms"] = [[float(x) for x in r["bert/step_ms"]] for r in ranks]
        del init, ref, ctl
        if not all(bool(r["bert/restored_equal"]) for r in ranks):
            raise SmokeFailure("14b: a rank's restore at the mesh differs from its saved state")
        model = tfm.build(cfg, tfm.init_params(cfg, seed=0, device=DEVICE, trainable=True),
                          DEVICE, trainable=True)
        state = tstep.init_train_state(model, topt.make_optimizer(topt.OptimizerConfig(**opt),
                                                                  model.parameters()))
        ck = ck_lib.Checkpointer(ck_lib.CheckpointConfig(directory=os.path.join(out, "ck_bert"),
                                                         async_save=False))
        try:
            ck.restore(state)
        finally:
            ck.close()
        import hashlib

        mine = {k: hashlib.sha256(v.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
                for k, v in tstep.state_leaves(state)}
        theirs = {k[len("bert/digest/"):]: str(v) for k, v in ranks[0].items()
                  if k.startswith("bert/digest/")}
        if mine != theirs or state.step != b["steps"]:
            diff = sorted(k for k in theirs if mine.get(k) != theirs[k])[:5]
            raise SmokeFailure(f"14b: the one-process restore at model=1 differs from the "
                               f"ranks' gathered state: {diff}")
        log(f"  14b: step dir of step {state.step} restored in one process at model=1: "
            f"{len(mine)} leaves bitwise the ranks' gathered ones; at the mesh: every rank "
            f"bitwise its saved shards")
        res["14b"]["restore"] = len(mine)
        del model, state, ranks
        torch.cuda.empty_cache()
    # 14c
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    for n in FLASH_NAMES:
        getattr(fa, n).launches_by_d.clear()
    out = run_workload("gpt_lm", T14_D256, device=DEVICE)
    res["14c"] = {n: getattr(fa, n).launches_by_d.get(256, 0) for n in FLASH_NAMES}
    res["14c_losses"] = [float(h["loss"]) for h in out.history]
    if not all(res["14c"].values()) or not np.isfinite(res["14c_losses"]).all():
        raise SmokeFailure(f"14c: head_dim 256 launches {res['14c']}, losses "
                           f"{res['14c_losses']}")
    log(f"  14c: gpt_lm at head_dim 256 (d_model 1024, 4 heads, 2 layers, B=4, S=1024): "
        f"losses {res['14c_losses']}, D=256 launches {res['14c']}")
    del out
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# phase 15: sequence parallelism
# ---------------------------------------------------------------------------

#: 15a: the three schedules at gpt_small's heads over seq=2 (two gloo ranks
#: on this card), causal with no mask and non-causal with a padded kv_mask
T15_ATTN = dict(B=2, H=12, S=2048, D=64, pad=(1536, 2048))
#: 15b: gpt_lm's long_context preset at gpt_small's full width (remat,
#: bf16, dropout 0) at seq=2, the ring and Ulysses; the preset's global
#: batch of 8 cut to 2 and its S=8192 to 4096 (K and V cross the host under
#: gloo; at 8192 the whole smoke ran 1032 s on a slow host's NVIDIA H100 80GB
#: HBM3 at 700 W, past its 1000 s aim) — the flash kernels' S=8192 shape is
#: phase 2c's (``FLASH_SP``)
T15_LC = dict(global_batch=2, steps=2, mesh={"seq": 2}, seq_len=4096)
#: flash launches of one sequence_parallel_attention call on a rank
#: (forward, dK/dV, dQ): the ring runs none, Ulysses and the non-causal
#: all-gather one forward and the two backward kernels, the causal
#: all-gather none (dense, as JAX's)
T15_LAUNCHES = {("ring", 1, 0): [0, 0, 0], ("ring", 0, 1): [0, 0, 0],
                ("ulysses", 1, 0): [1, 1, 1], ("ulysses", 0, 1): [1, 1, 1],
                ("allgather", 1, 0): [0, 0, 0], ("allgather", 0, 1): [1, 1, 1]}


#: 15a's dtypes: tag -> torch dtype name
T15_DTYPES = {"bf16": "bfloat16", "f32": "float32"}


def sp_attention_inputs(np) -> dict:
    """15a's global q, k, v, cotangent and padded kv_mask (numpy, f32)."""
    a = T15_ATTN
    rng = np.random.default_rng(150)
    arrays = {n: rng.standard_normal((a["B"], a["H"], a["S"], a["D"])).astype(np.float32)
              for n in ("q", "k", "v", "cot")}
    arrays["mask"] = padded_mask(np, rng, a["B"], a["S"], a["pad"])
    arrays["mask"][-1, : a["S"] // 2] = True  # the last row attends its first half
    return arrays


def sp_attention(torch, np, ranks, arrays) -> dict:
    """15a: ``sequence_parallel_attention`` of each schedule on two gloo
    ranks at seq=2 (``tests/torch_dp_worker.py``'s ``seq`` job, the
    permute emulated by an all-reduce under gloo on the card), bf16 and
    f32, against the same call in one process (the flash
    kernels for Ulysses and the non-causal all-gather, the dense f32 fold
    for the ring and the causal all-gather): out, dq, dk, dv as relative
    L2 (``TOL["sp/attn/*"]``) beside an out and a dq x 1.01 that must
    fail; each call's flash launches on each rank (``T15_LAUNCHES``)."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh
    from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
        sequence_parallel_attention)

    dtypes, runs = T15_DTYPES, [list(r) for r in T15_LAUNCHES]
    one = Mesh({n: 1 for n in AXIS_NAMES}, torch.device(DEVICE))
    res = {}
    for t, dname in dtypes.items():
        dtype = getattr(torch, dname)
        lim = {k: TOL[f"sp/attn/{k}/{dname}"] for k in ("fwd", "bwd")}
        for impl, causal, masked in runs:
            leaves = [torch.from_numpy(arrays[n]).to(DEVICE, dtype).requires_grad_()
                      for n in ("q", "k", "v")]
            mask = torch.from_numpy(arrays["mask"]).to(DEVICE) if masked else None
            o = sequence_parallel_attention(*leaves, one, impl=impl, causal=bool(causal),
                                            kv_mask=mask)
            (o * torch.from_numpy(arrays["cot"]).to(DEVICE, dtype)).sum().backward()
            want = {"out": o.detach(), **{f"d{n}": x.grad for n, x in zip("qkv", leaves)}}
            key = f"{t}/{impl}/{causal}{masked}"
            errs, ctl = {}, {}
            for r, rank in enumerate(ranks):
                for n, w in want.items():
                    got = torch.from_numpy(rank[f"{key}/{n}"]).to(DEVICE)
                    errs[n] = max(errs.get(n, 0.0), rel_l2(got, w))
                    if n in ("out", "dq"):
                        ctl[n] = rel_l2(got * 1.01, w)
                launches = rank[f"{key}/launches"].astype(int).tolist()
                if launches != T15_LAUNCHES[(impl, causal, masked)]:
                    raise SmokeFailure(f"15a {key} rank {r}: flash launches {launches}, want "
                                       f"{T15_LAUNCHES[(impl, causal, masked)]}")
            log(f"  15a {key}: relative L2 vs one process " + ", ".join(
                f"{n} {e:.2e}" for n, e in errs.items()) + f" (limits {lim}); controls x 1.01 "
                + ", ".join(f"{n} {e:.2e}" for n, e in ctl.items())
                + f"; flash launches a rank {T15_LAUNCHES[(impl, causal, masked)]}")
            if ctl["out"] <= lim["fwd"] or ctl["dq"] <= lim["bwd"]:
                raise SmokeFailure(f"15a {key}: a x 1.01 control passes its gate")
            bad = {n: e for n, e in errs.items() if e > lim["fwd" if n == "out" else "bwd"]}
            if bad:
                raise SmokeFailure(f"15a {key}: outside the limits: {bad}")
            res[key] = errs
            del leaves, o, want
    torch.cuda.empty_cache()
    return res


def sp_long_cases(np):
    """15b's configurations (the rank's and the one-process reference's
    of each schedule), batches and ``tp_steps`` cases."""
    import dataclasses

    from distributed_tensorflow_tpu_torch.workloads import gpt_lm

    g = T15_LC
    base = dataclasses.replace(gpt_lm.long_context(g["seq_len"]).model, dropout=0.0)
    cfgs = {"ring": (base, dataclasses.replace(base, seq_impl=None, attention_impl="dense")),
            "ulysses": (dataclasses.replace(base, seq_impl="ulysses"),
                        dataclasses.replace(base, seq_impl=None, attention_impl="flash"))}
    rng = np.random.default_rng(151)
    batches = [{"input_ids": rng.integers(0, base.vocab_size, (g["global_batch"],
                                                              base.max_len)).astype(np.int32)}
               for _ in range(g["steps"])]
    opt = dict(name="adamw", learning_rate=1e-4, weight_decay=0.1)
    cases = [dict(tag=t, seed=0, cfg=dataclasses.asdict(c), mesh=g["mesh"], optimizer=opt,
                  options={}, whole="params", chunk=base.xent_chunk, save=False)
             for t, (c, _) in cfgs.items()]
    return base, cfgs, batches, cases


def sp_long(torch, np, worker, ranks, smi) -> dict:
    """15b: ``gpt_lm``'s ``long_context`` at gpt_small's width (12 layers,
    d 768, 12 heads of 64, S=``T15_LC["seq_len"]``, remat, bf16, dropout 0,
    the chunked loss at 256, adamw) at seq=2 on two gloo ranks of this card,
    the ring and Ulysses (``tests/torch_dp_worker.py``'s ``seq`` job runs
    them as ``tp_steps`` cases after 15a's calls), ``T15_LC["steps"]`` steps
    from the weights of one seed, against one process at the same batch
    (the ring against ``attention_impl="dense"``, Ulysses against the flash
    kernels) with phase 14's gates (``TOL["sp/bf16/*"]``); each rank's step
    ms and peak memory; the ring launches no flash kernel, Ulysses every
    one."""
    import dataclasses

    from distributed_tensorflow_tpu_torch.models import transformer as tfm

    base, cfgs, batches, cases = sp_long_cases(np)
    init = {k: v.float().cpu().numpy() for k, v in tfm.init_params(
        base, seed=0, device=DEVICE, trainable=True).items()}
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    res = {}
    for case, (t, (_, ref_cfg)) in zip(cases, cfgs.items()):
        for r, rank in enumerate(ranks):
            steps = [round(float(x), 2) for x in rank[f"{t}/step_ms"]]
            log(f"  15b {t} rank {r}: step ms {steps}, peak "
                f"{float(rank.get(f'{t}/peak_gib', np.nan)):.3f} GiB (gloo, 2 ranks on one "
                f"card: not sequence-parallel throughput; {smi}); flash launches over the "
                f"steps " + ", ".join(f"{n} {int(rank[f'{t}/launches/{n}'])}"
                                      for n in FLASH_NAMES))
        one = dict(case, cfg=dataclasses.asdict(ref_cfg))
        ref = worker.tp_steps(one, None, batches, [], DEVICE)
        ref.pop("model")
        torch.cuda.empty_cache()
        ctl = worker.tp_steps(one, None, half, [], DEVICE)
        ctl.pop("model")
        torch.cuda.empty_cache()
        res[t] = tp_gates(np, t, ranks, ref, ctl, init, phase="15b", tol="sp/bf16")
        launches = [[int(rk[f"{t}/launches/{n}"]) for n in FLASH_NAMES] for rk in ranks]
        if any((sum(x) > 0) != (t == "ulysses") or (t == "ulysses" and min(x) <= 0)
               for x in launches):
            raise SmokeFailure(f"15b {t}: flash launches {launches} (the ring launches none, "
                               f"Ulysses every kernel)")
        res[t].update(step_ms=[[float(x) for x in rk[f"{t}/step_ms"]] for rk in ranks],
                      peak_gib=[float(rk.get(f"{t}/peak_gib", np.nan)) for rk in ranks],
                      ref_step_ms=[float(x) for x in ref["step_ms"]],
                      ref_peak_gib=float(ref.get("peak_gib", np.nan)), launches=launches[0])
        log(f"  15b {t}: one process ({ref_cfg.attention_impl}) step ms "
            f"{[round(float(x), 2) for x in ref['step_ms']]}, peak "
            f"{res[t]['ref_peak_gib']:.3f} GiB")
        del ref, ctl
    return res


def sp_setup(np) -> dict:
    """Phase 15's inputs: 15a's arrays and ``seq``-job calls, 15b's
    configurations, batches and ``tp`` cases (``shared_launches`` hands
    them to phase 14's launch of two ranks)."""
    arrays = sp_attention_inputs(np)
    base, _, batches, cases = sp_long_cases(np)
    runs = [list(r) for r in T15_LAUNCHES]
    return dict(arrays=arrays, base=base,
                inputs={f"{t}/{n}": v for t in T15_DTYPES for n, v in arrays.items()},
                attention=[dict(tag=t, mesh={"seq": 2}, dtype=d, runs=runs)
                           for t, d in T15_DTYPES.items()],
                cases=[(c, batches) for c in cases])


def shared_launches(pp, sp) -> dict:
    """What phase 14's launches of two and four gloo ranks run for phases
    15 and 16 (``phase_tp``'s ``more``): by world size, the ``cases`` run
    after phase 14's own (16a, 16b, then 15b's; 16c, 16d), 15a's
    ``attention`` calls on its ``arrays`` run before them, and the
    ``tags`` under which ``res["more"]`` keeps the ranks' results ("15a":
    the attention's)."""
    return {2: dict(cases=[*pp["more"][2], *sp["cases"]], arrays=sp["inputs"],
                    attention=sp["attention"],
                    tags=["15a", *(c["tag"] for c, _ in [*pp["more"][2], *sp["cases"]])]),
            4: dict(cases=pp["more"][4], tags=[c["tag"] for c, _ in pp["more"][4]])}


def phase_sp(torch, np, smi, setup, ranks) -> dict:
    """Phase 15: sequence parallelism — 15a's calls and 15b's steps run by
    phase 14a's two gloo ranks on this card (``tests/torch_dp_worker.py``'s
    ``seq`` job: 15a's calls before 14a's case, 15b's steps after it), then
    the one-process references and the gates (``sp_attention``,
    ``sp_long``)."""
    worker = load_dp_worker()
    t1 = time.perf_counter()
    a, g, base = T15_ATTN, T15_LC, setup["base"]
    log(f"phase 15a: sequence_parallel_attention at seq=2, two gloo ranks on this card (phase "
        f"14a's), B={a['B']} H={a['H']} S={a['S']} D={a['D']}, bf16 and f32; causal with no "
        f"mask, non-causal with a padded kv_mask ({a['pad'][0]}-{a['pad'][1]} keys)")
    log(f"phase 15b: gpt_lm long_context, gpt_small width, B={g['global_batch']} (the "
        f"preset's 8 cut to {g['global_batch']}) S={base.max_len} (the preset's 8192 cut to "
        f"{base.max_len}) bf16, remat, at {g['mesh']} on the same two ranks: the ring and "
        f"Ulysses, {g['steps']} steps each")
    ranks_s = max(float(r["attention/wall_s"]) for r in ranks) + sum(
        max(float(r[f"{c['tag']}/wall_s"]) for r in ranks) for c, _ in setup["cases"])
    res = {"ranks_s": ranks_s, "15a": sp_attention(torch, np, ranks, setup["arrays"])}
    t2 = time.perf_counter()
    res["15b"] = sp_long(torch, np, worker, ranks, smi)
    res.update(gates_15a_s=t2 - t1, gates_15b_s=time.perf_counter() - t2)
    res["wall_s"] = ranks_s + time.perf_counter() - t1
    log(f"  phase 15 wall {res['wall_s']:.1f} s: its calls and cases in phase 14a's ranks "
        f"{res['ranks_s']:.1f} (the slowest rank's), 15a's references and gates "
        f"{res['gates_15a_s']:.1f}, 15b's {res['gates_15b_s']:.1f}")
    return res


# ---------------------------------------------------------------------------
# phase 16: pipeline parallelism
# ---------------------------------------------------------------------------

#: 16a/16b: gpt_small at pipe=2 on two gloo ranks of this card, the global
#: batch of 8 in 4 microbatches, one and two virtual chunks a stage; 16c the
#: same at pipe=2 x model=2 on four ranks; 16d one bert_base step at data=2
#: x pipe=2 on the same four ranks (a global batch of 16 in 4 microbatches of
#: each rank's 8 rows, padded keys)
T16_GPT = dict(global_batch=8, steps=3, microbatches=4, chunk=256)
T16_BERT = dict(global_batch=16, steps=1, microbatches=4, pad=(384, 512))
#: case -> (model, mesh, virtual chunks)
T16_CASES = {"16a": ("gpt_fused", {"pipe": 2}, 1), "16b": ("gpt_fused", {"pipe": 2}, 2),
             "16c": ("gpt", {"pipe": 2, "model": 2}, 1),
             "16d": ("bert", {"pipe": 2, "data": 2}, 1)}
#: each rank's launches a step, by the rule the schedule follows (idle ticks
#: skipped: a rank runs its chunks R = M·V times a step, lpc = L/(S·V)
#: layers a chunk): the flash forward 2·R·lpc (each tick's recompute
#: under torch.utils.checkpoint), dK/dV and dQ R·lpc each; at model=1 with
#: fused_ln_matmul the LN+matmul forward 8·R·lpc (q, k, v and mlp_in, and
#: the recompute), dx and dw 4·R·lpc each. R·lpc = M·L/S = 4·12/2 = 24 in
#: every case (16d: the 4 microbatches of each data shard's rows)
T16_LAUNCHES = {
    "16a": {"flash_fwd": 48, "flash_bwd_dkv": 24, "flash_bwd_dq": 24, "ln_matmul": 192,
            "ln_matmul_bwd_dx": 96, "ln_matmul_bwd_dw": 96},
    "16b": {"flash_fwd": 48, "flash_bwd_dkv": 24, "flash_bwd_dq": 24, "ln_matmul": 192,
            "ln_matmul_bwd_dx": 96, "ln_matmul_bwd_dw": 96},
    "16c": {"flash_fwd": 48, "flash_bwd_dkv": 24, "flash_bwd_dq": 24, "ln_matmul": 0,
            "ln_matmul_bwd_dx": 0, "ln_matmul_bwd_dw": 0},
    "16d": {"flash_fwd": 48, "flash_bwd_dkv": 24, "flash_bwd_dq": 24, "ln_matmul": 0,
            "ln_matmul_bwd_dx": 0, "ln_matmul_bwd_dw": 0},
}
#: the kernels line's pipeline rows: the flash kernels at 16a's microbatch
#: (B=2 of S=1024, 12 heads, causal, bf16) and the LN+matmul pair at its
#: rows (M = 2·1024, d 768, n 3072)
T16_FLASH = dict(B=2, H=12, S=1024, D=64)
T16_LN = (2048, 768, 3072)
#: the other shapes phase 16 gives the kernels, checked against their plain
#: versions but not timed: flash at 16c's 6 local heads (causal) and at
#: 16d's BERT microbatch (B=2 of S=512, non-causal, padded keys); the
#: LN+matmul pair at q, k and v's n=768
T16_FLASH_CHECKS = {"16c": (dict(B=2, H=6, S=1024, D=64), True, False),
                    "16d": (dict(B=2, H=12, S=512, D=64), False, "padded")}
T16_LN_CHECKS = [(2048, 768, 768)]
T16_ENV = {"DTF_FUSED_BWD": "pallas"}


def pp_models():
    """Phase 16's configurations: gpt_small (bf16, flash, dropout 0) with
    and without the fused LN+matmul, and bert_base at dropout 0 (the
    pipeline draws its own dropout masks, which one process does not)."""
    import dataclasses

    from distributed_tensorflow_tpu_torch.models import transformer as tfm

    gpt = dataclasses.replace(tfm.gpt_small(), dropout=0.0, xent_chunk=T16_GPT["chunk"])
    return {"gpt_fused": dataclasses.replace(gpt, fused_ln_matmul=True), "gpt": gpt,
            "bert": dataclasses.replace(tfm.bert_base(), dropout=0.0)}


def pp_batches(np, cfgs) -> dict:
    from distributed_tensorflow_tpu_torch.data import text

    rng = np.random.default_rng(160)
    g, b = T16_GPT, T16_BERT
    gpt = [{"input_ids": rng.integers(0, cfgs["gpt"].vocab_size, (
        g["global_batch"], cfgs["gpt"].max_len)).astype(np.int32)} for _ in range(g["steps"])]
    bcfg = cfgs["bert"]
    stream = text.make_text_dataset(text.TextDataConfig(
        dataset="synthetic_mlm", global_batch_size=b["global_batch"], seq_len=bcfg.max_len,
        vocab_size=bcfg.vocab_size, max_predictions=-1), shard=(0, 1))
    bert = []
    for i in range(b["steps"]):
        bt = dict(stream.batch(i))
        lens = rng.integers(b["pad"][0], b["pad"][1] + 1, b["global_batch"])
        bt["attention_mask"] = (np.arange(bcfg.max_len)[None] < lens[:, None]).astype(np.int32)
        bert.append(bt)
    return {"gpt_fused": gpt, "gpt": gpt, "bert": bert}


def pp_case(tag, cfg, mesh, V, micro) -> dict:
    import dataclasses

    return dict(tag=tag, seed=0, cfg=dataclasses.asdict(cfg), mesh=mesh,
                optimizer=dict(name="adamw", learning_rate=1e-4, weight_decay=0.01),
                options={}, whole="params", mlm=not cfg.causal, chunk=cfg.xent_chunk,
                save=False, env=T16_ENV, pipeline=dict(virtual=V, microbatches=micro))


def pp_kernel_rows(torch, np, F) -> tuple[dict, dict]:
    """The kernels line's pipeline rows: the three flash kernels at
    ``T16_FLASH`` (``check_flash``'s gates and controls, ``time_flash``)
    and the LN+matmul forward, dx and dw at ``T16_LN`` (bf16, phase 2e's
    gates; timed beside their plain versions and the library's layer_norm
    + linear and products); the same gates, untimed, at
    ``T16_FLASH_CHECKS`` and ``T16_LN_CHECKS``. Their comparison launches
    are not counted. Returns (the rows, the untimed checks' max abs
    errors)."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import fused_ln_matmul as fln

    rng = np.random.default_rng(16)
    before = {n: getattr(fa, n).launches for n in FLASH_NAMES}
    before.update({n: k.launches for n, k in fln.KERNELS.items()})
    dn = "bfloat16"
    c = flash_case(torch, np, rng, torch.bfloat16, False, **T16_FLASH)
    errs = check_flash(torch, fa, c, True, "bfloat16 pipeline microbatch", dn)
    rows = time_flash(torch, np, F, fa, rng, c, True, dn, T16_FLASH, iters=20)
    out = {f"{n}_pipe": dict(rows[n], err=max(errs[n])) for n in FLASH_NAMES}
    del c
    checks = {}
    for t, (shape, causal, masked) in T16_FLASH_CHECKS.items():
        c = flash_case(torch, np, rng, torch.bfloat16, masked, pad_lengths=T16_BERT["pad"],
                       **shape)
        e = check_flash(torch, fa, c, causal, f"bfloat16 {t} microbatch {shape}", dn)
        checks[f"flash {t}"] = {n: max(e[n]) for n in FLASH_NAMES}
        del c
    for shape in T16_LN_CHECKS:
        checks[f"ln_matmul {shape}"] = pp_ln_check(torch, np, fln, rng, *shape)[1]
    log(f"    checked against the plain versions, not timed (max abs errors): {checks}")
    M, d, n = T16_LN
    c, errs = pp_ln_check(torch, np, fln, rng, M, d, n)
    nbytes = c["x"].numel() * 2 * 2 + c["dy"].numel() * 2
    sets = [c] + [ln_bwd_case(torch, np, rng, M, d, n, torch.bfloat16)
                  for _ in range(copies_for(nbytes) - 1)]
    for st in sets:
        st["stats"] = fln.ln_matmul_bwd_dx(st["x"], st["gamma"], st["w"], st["dy"])[4:]
        mu, rs = (t[:, None] for t in st["stats"])
        st["h"] = ((st["x"].float() - mu) * rs * st["gamma"] + st["beta"]).to(torch.bfloat16)
    kern = {"ln_matmul_train": [lambda s=s: fln.ln_matmul(s["x"], s["gamma"], s["beta"], s["w"],
                                                           s["bias"]) for s in sets],
            "ln_matmul_bwd_dx": [lambda s=s: fln.ln_matmul_bwd_dx(s["x"], s["gamma"], s["w"],
                                                                  s["dy"]) for s in sets],
            "ln_matmul_bwd_dw": [lambda s=s: fln.ln_matmul_bwd_dw(
                s["x"], s["gamma"], s["beta"], s["dy"], *s["stats"]) for s in sets]}
    plain = {"fwd": [lambda s=s: fln.ln_matmul_plain(s["x"], s["gamma"], s["beta"], s["w"],
                                                     s["bias"]) for s in sets],
             "bwd": [lambda s=s: fln.ln_matmul_bwd_plain(s["x"], s["gamma"], s["beta"], s["w"],
                                                         s["dy"]) for s in sets]}
    bf = torch.bfloat16
    lib = {"ln_matmul_train": [lambda s=s: F.linear(F.layer_norm(
               s["x"], (d,), s["gamma"].to(bf), s["beta"].to(bf), 1e-6), s["w"].t(),
               s["bias"].to(bf)) for s in sets],
           "ln_matmul_bwd_dx": [lambda s=s: torch.mm(s["dy"], s["w"].t()) for s in sets],
           "ln_matmul_bwd_dw": [lambda s=s: torch.mm(s["h"].t(), s["dy"]) for s in sets]}
    t_plain = {k: plain_time(torch, v) for k, v in plain.items()}
    for k in kern:
        tk, tl = cuda_ms(torch, kern[k], iters=20), cuda_ms(torch, lib[k], iters=20)
        bound = (ln_bound_ms(c, dn) if k == "ln_matmul_train"
                 else ln_bwd_bound_ms(c, k.split("_")[-1], dn))
        out[f"{k}_pipe"] = dict(ms=tk["device_ms"], library_ms=tl["device_ms"],
                                plain_ms=t_plain["fwd" if k == "ln_matmul_train" else "bwd"][
                                    "device_ms"], bound_ms=bound[0], bound_by=bound[1],
                                err=errs[k])
        r = out[f"{k}_pipe"]
        log(f"    {k} M={M} n={n}: kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
            f"library_ms={r['library_ms']:.5f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
    del sets, kern, plain, lib, c
    for name, k in fln.KERNELS.items():  # comparison launches do not count
        k.launches = before[name]
    for name in FLASH_NAMES:
        getattr(fa, name).launches = before[name]
    torch.cuda.empty_cache()
    return out, checks


def pp_ln_check(torch, np, fln, rng, M, d, n) -> tuple[dict, dict]:
    """The LN+matmul forward, dx and dw (bf16) at ``M x d -> n`` against
    their plain versions (phase 2e's gates). Returns (the case, each
    kernel's max abs error)."""
    dn = "bfloat16"
    c = ln_bwd_case(torch, np, rng, M, d, n, torch.bfloat16)
    y = fln.ln_matmul(c["x"], c["gamma"], c["beta"], c["w"], c["bias"])
    dx, dg, db, dbias, mean, rstd = fln.ln_matmul_bwd_dx(c["x"], c["gamma"], c["w"], c["dy"])
    dw = fln.ln_matmul_bwd_dw(c["x"], c["gamma"], c["beta"], c["dy"], mean, rstd)
    want_y = fln.ln_matmul_plain(c["x"], c["gamma"], c["beta"], c["w"], c["bias"])
    want = fln.ln_matmul_bwd_plain(c["x"], c["gamma"], c["beta"], c["w"], c["dy"])
    tag = f"{dn} M={M} d={d} n={n}"
    err_y = check_close(torch, f"ln_matmul/y {tag}", y, want_y, TOL[f"ln_matmul/{dn}"])
    err_dx = check_close(torch, f"ln_matmul_bwd_dx/dx {tag}", dx, want[0], TOL[f"ln_bwd/{dn}"])
    reds = {"dgamma": rel_l2(dg, want[1]), "dbeta": rel_l2(db, want[2]),
            "dbias": rel_l2(dbias, want[4]), "dw": rel_l2(dw, want[3])}
    if max(reds.values()) > TOL[f"ln_bwd/reduction/{dn}"]:
        raise SmokeFailure(f"16 ln_matmul backward {tag}: a sum is off: {reds}")
    return c, {"ln_matmul_train": err_y, "ln_matmul_bwd_dx": err_dx,
               "ln_matmul_bwd_dw": float((dw.float() - want[3].float()).abs().max())}


def pp_setup(np) -> dict:
    """Phase 16's configurations, batches and ``tp`` cases (by tag), and
    the (case, batches) that phase 14's launches of two and four ranks
    run for it (by world size; ``shared_launches``)."""
    cfgs = pp_models()
    batches = pp_batches(np, cfgs)
    g, b = T16_GPT, T16_BERT
    cases = {t: pp_case(t, cfgs[m], mesh, V, (g if m != "bert" else b)["microbatches"])
             for t, (m, mesh, V) in T16_CASES.items()}
    more = {w: [(cases[t], batches[T16_CASES[t][0]]) for t in tags]
            for w, tags in ((2, ("16a", "16b")), (4, ("16c", "16d")))}
    return dict(cfgs=cfgs, batches=batches, cases=cases, more=more)


def phase_pp(torch, np, F, smi, setup, ranks) -> dict:
    """Phase 16: pipeline parallelism — 16a and 16b (gpt_small, fused
    LN+matmul with the pallas backward, flash, pipe=2, V=1 and 2) run by
    phase 14a's two gloo ranks on this card, 16c (pipe=2 x model=2, flash)
    and 16d (bert_base, data=2 x pipe=2, padded, the gathered MLM head) by
    14b's four (``tests/torch_dp_worker.py``'s ``tp`` job; ``ranks``: tag
    -> the ranks' results), each held against the dense model's same steps
    in one process (phase 14's gates, ``TOL["tp/bf16/*"]``, with their
    controls), its launches against ``T16_LAUNCHES``, its step ms and peak
    GiB a rank printed; then the kernels line's pipeline rows
    (``pp_kernel_rows``)."""
    from distributed_tensorflow_tpu_torch.models import transformer as tfm

    worker = load_dp_worker()
    t1 = time.perf_counter()
    cfgs, batches, cases = setup["cfgs"], setup["batches"], setup["cases"]
    g, b = T16_GPT, T16_BERT
    log(f"phase 16: pipeline parallelism, gloo ranks on this card (the permute emulated by "
        f"an all-reduce; run by phase 14's launches): 16a/16b gpt_small B={g['global_batch']} "
        f"S=1024 bf16, fused LN+matmul (pallas backward), flash, pipe=2, "
        f"M={g['microbatches']}, V=1 / 2, {g['steps']} steps; 16c the same unfused at pipe=2 "
        f"x model=2; 16d bert_base B={b['global_batch']} S=512, padded ({b['pad'][0]}-"
        f"{b['pad'][1]} keys), gathered MLM head, at data=2 x pipe=2, {b['steps']} step")
    ranks_s = sum(max(float(r[f"{t}/wall_s"]) for r in ranks[t]) for t in T16_CASES)
    old = {k: os.environ.get(k) for k in T16_ENV}
    os.environ.update(T16_ENV)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    refs = {}
    try:
        for m in ("gpt_fused", "gpt", "bert"):
            case = dict(next(c for t, c in cases.items() if T16_CASES[t][0] == m))
            half = [{k: v[:len(v) // 2] for k, v in bt.items()} for bt in batches[m]]
            ref = worker.tp_steps(case, None, batches[m], [], DEVICE)
            ctl = worker.tp_steps(case, None, half, [], DEVICE)
            ref.pop("model")
            ctl.pop("model")
            refs[m] = (ref, ctl)
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    res = {}
    for t, (m, mesh, V) in T16_CASES.items():
        init = {k: v.float().cpu().numpy() for k, v in tfm.init_params(
            cfgs[m], seed=0, device=DEVICE, trainable=True).items()}
        ref, ctl = refs[m]
        res[t] = tp_gates(np, t, ranks[t], ref, ctl, init, phase="16")
        del init
        steps = len(batches[m])
        want = {n: c * steps for n, c in T16_LAUNCHES[t].items()}
        got = [{n: int(r[f"{t}/launches/{n}"]) for n in want} for r in ranks[t]]
        if any(per != want for per in got):
            raise SmokeFailure(f"{t}: launches {got}, T16_LAUNCHES over {steps} steps {want}")
        res[t].update(launches_per_step=T16_LAUNCHES[t],
                      step_ms=[[float(x) for x in r[f"{t}/step_ms"]] for r in ranks[t]],
                      peak_gib=[float(r.get(f"{t}/peak_gib", np.nan)) for r in ranks[t]],
                      ref_step_ms=[float(x) for x in ref["step_ms"]],
                      ref_peak_gib=float(ref.get("peak_gib", np.nan)))
        log(f"  {t} ({m}, {mesh}, V={V}): rank step ms {res[t]['step_ms']}, peak GiB "
            f"{[round(x, 3) for x in res[t]['peak_gib']]} (gloo, {len(ranks[t])} ranks on one "
            f"card: not pipeline throughput; {smi}); one process step ms "
            f"{[round(x, 2) for x in res[t]['ref_step_ms']]}, peak {res[t]['ref_peak_gib']:.3f} "
            f"GiB; launches a step a rank {T16_LAUNCHES[t]} (T16_LAUNCHES)")
    t2 = time.perf_counter()
    res["kernels"], res["checks"] = pp_kernel_rows(torch, np, F)
    res["launches"] = {f"{n}_pipe": int(ranks["16a"][0][f"16a/launches/{n}"])
                       for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    res["launches"].update({f"{k}_pipe": int(ranks["16a"][0][f"16a/launches/{n}"])
                            for k, n in (("ln_matmul_train", "ln_matmul"),
                                         ("ln_matmul_bwd_dx", "ln_matmul_bwd_dx"),
                                         ("ln_matmul_bwd_dw", "ln_matmul_bwd_dw"))})
    res.update(ranks_s=ranks_s, gates_s=t2 - t1, kernels_s=time.perf_counter() - t2)
    res["wall_s"] = ranks_s + time.perf_counter() - t1
    log(f"  phase 16 wall {res['wall_s']:.1f} s: its cases in phase 14's ranks "
        f"{res['ranks_s']:.1f} (the slowest rank's, summed over the cases), references and "
        f"gates {res['gates_s']:.1f}, kernel rows {res['kernels_s']:.1f}")
    return res


def timed(walls: dict, name: str, phase, *args):
    """``phase(*args)``, its wall seconds kept in ``walls[name]``."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        walls[name] = time.perf_counter() - t0


def main() -> int:
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script needs "
              "one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from distributed_tensorflow_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {REPO}: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    walls: dict[str, float] = {}
    try:
        smi = nvidia_smi_line()
        log(f"card: {smi}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        reports = _build.build_all()
        log(f"phase 1: built {sorted(reports)} in {time.perf_counter() - t0:.1f}s")
        for name, rep in reports.items():
            for line in rep.splitlines():
                if any(k in line for k in ("Function properties for", "registers", "spill",
                                           "error")):
                    log(f"  [{name}] {line.strip()}")
        from distributed_tensorflow_tpu_torch.ops.flash_attention import HEAD_DIMS

        check_spills(reports["flash_attention"], FLASH_KERNELS, HEAD_DIMS)
        walls["1"] = time.perf_counter() - t0
        kern = timed(walls, "2a-2b", phase_kernels, torch, np, F)
        kern.update(timed(walls, "2c", phase_flash, torch, np, F))
        ln_train = timed(walls, "2e", phase_ln_train, torch, np, F)
        kern.update({n: {"err": ln_train[n]["err"], "rows": [ln_train[n]["main"]]}
                     for n in ("ln_matmul_bwd_dx", "ln_matmul_bwd_dw")})
        kern["ln_matmul_train"] = {"err": ln_train["ln_matmul/train"]["err"],
                                   "rows": [ln_train["ln_matmul/train"]["main"]]}
        conv_bn = timed(walls, "2d", phase_conv_bn, torch, np)
        kern.update({n: {"err": r["err"], "rows": [r["main"]]} for n, r in conv_bn.items()})
        launches, counts, steps = timed(walls, "3-4", phase_serve, torch, np, smi)
        train = timed(walls, "5", phase_train, torch, np, smi)
        launches.update(train["flash_launches"])
        # the LN+matmul forward runs on two main paths: serving (the
        # row-tile kernel, "ln_matmul") and the fused training pass with the
        # pallas backward (the tiled pair, "ln_matmul_train"; dx and dw)
        launches.update({n: train["launches"][n] for n in ("ln_matmul_train",
                                                            "ln_matmul_bwd_dx",
                                                            "ln_matmul_bwd_dw")})
        resnet = timed(walls, "6", phase_resnet, torch, np, smi)
        launches.update(resnet["launches"])
        dp = timed(walls, "7", phase_dp, torch, np, smi)
        bert = timed(walls, "8", phase_bert, torch, np, smi)
        ckpt = timed(walls, "9", phase_ckpt, torch, np, smi)
        intake = timed(walls, "10", phase_intake, torch, np, smi,
                       resnet["passes"]["fused/pallas"]["step_ms"])
        wide = timed(walls, "11", phase_wide_deep, torch, np, smi)
        # the slice's path: the two small workloads, then the demos; the
        # head_dim-32 flash launches are the MLM and LM demos' (each demo
        # zeroes the counts before its training run and reads them after)
        small = timed(walls, "12", phase_small, torch, np, smi)
        launches.update({f"{n}_d32": c for n, c in small["flash_d32_launches"].items()})
        t13 = timed(walls, "13", phase_transformer, torch, np, smi)
        # phase 14's launches of two and four ranks run phases 15's and
        # 16's work too; that work is timed in their walls, not in 14's
        sp_in, pp_in = sp_setup(np), pp_setup(np)
        tp = timed(walls, "14", phase_tp, torch, np, smi, shared_launches(pp_in, sp_in))
        launches.update({f"{n}_d256": c for n, c in tp["14c"].items()})
        sp = timed(walls, "15", phase_sp, torch, np, smi, sp_in, tp["more"]["15a"])
        pp = timed(walls, "16", phase_pp, torch, np, F, smi, pp_in, tp["more"])
        for name, part in (("15", sp), ("16", pp)):
            walls["14"] -= part["ranks_s"]
            walls[name] += part["ranks_s"]
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    entries = []
    for name, src, replaces, row in (
        ("paged_attention", "distributed_tensorflow_tpu_torch/ops/csrc/paged_attention.cu",
         "distributed_tensorflow_tpu/ops/flash_attention.py:373",
         kern["paged_attention"]["rows"][0]),
        *((name, "distributed_tensorflow_tpu_torch/ops/csrc/ln_matmul.cu",
           "distributed_tensorflow_tpu/ops/fused_ln_matmul.py:53", row)
          for name, row in (("ln_matmul", next(r for r in kern["ln_matmul"]["rows"]
                                                if (r["M"], r["n"]) == (8, 3072))),
                            ("ln_matmul_train", kern["ln_matmul_train"]["rows"][0]))),
        *((name, "distributed_tensorflow_tpu_torch/ops/csrc/ln_matmul_bwd.cu",
           f"distributed_tensorflow_tpu/ops/fused_ln_matmul.py:{line}", kern[name]["rows"][0])
          for name, line in (("ln_matmul_bwd_dx", 87), ("ln_matmul_bwd_dw", 156))),
        *((name, "distributed_tensorflow_tpu_torch/ops/csrc/flash_attention.cu",
           f"distributed_tensorflow_tpu/ops/flash_attention.py:{line}", kern[name]["rows"][0])
          for name, line in (("flash_fwd", 75), ("flash_bwd_dkv", 205), ("flash_bwd_dq", 241),
                             ("flash_fwd_d32", 75), ("flash_bwd_dkv_d32", 205),
                             ("flash_bwd_dq_d32", 241), ("flash_fwd_d256", 75),
                             ("flash_bwd_dkv_d256", 205), ("flash_bwd_dq_d256", 241))),
        *((name, "distributed_tensorflow_tpu_torch/ops/csrc/fused_conv_bn.cu",
           f"distributed_tensorflow_tpu/ops/fused_conv_bn.py:{line}", kern[name]["rows"][0])
          for name, line in (("conv_bn_fwd", 60), ("conv_bn_bwd_dx", 121), ("conv_bn_bwd_dw", 201),
                             ("conv_bn_bwd_single", 266))),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": kern[name]["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # this slice's path: the pipelined gpt_small step's microbatch shapes,
    # the launches 16a's rank 0 made over its steps
    for name, src, line in (
            ("flash_fwd_pipe", "flash_attention.cu", "flash_attention.py:75"),
            ("flash_bwd_dkv_pipe", "flash_attention.cu", "flash_attention.py:205"),
            ("flash_bwd_dq_pipe", "flash_attention.cu", "flash_attention.py:241"),
            ("ln_matmul_train_pipe", "ln_matmul.cu", "fused_ln_matmul.py:53"),
            ("ln_matmul_bwd_dx_pipe", "ln_matmul_bwd.cu", "fused_ln_matmul.py:87"),
            ("ln_matmul_bwd_dw_pipe", "ln_matmul_bwd.cu", "fused_ln_matmul.py:156")):
        row = pp["kernels"][name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"distributed_tensorflow_tpu_torch/ops/csrc/{src}",
            "replaces": f"distributed_tensorflow_tpu/ops/{line}",
            "launches": pp["launches"][name], "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    log(f"card: {smi}")
    log(f"launches by pass (paged_attention, ln_matmul): {counts}; engine steps by pass: "
        f"{steps}; timed shapes: paged_attention decode B=8 S=1, ln_matmul M=8 n=3072, "
        f"ln_matmul_train M=8192 n=3072, "
        f"flash B=8 H=12 S=1024 D=64 causal bf16 (flash_bwd_dkv library_ms: SDPA's whole "
        f"backward, dq+dk+dv; flash_bwd_dq: null); the *_d32 rows: the head_dim-32 "
        f"instantiation at B=64 H=4 S=64 D=32 non-causal bf16 (the MLM demo's shape), their "
        f"launches the MLM and LM demos' training runs' (phase 12b)")
    log(f"gpt_lm training (B=8, S=1024): flash step {train['step_ms']:.2f} ms, "
        f"{train['tok_s']:.0f} tokens/s, MFU {100 * train['mfu']:.2f}%, dense step "
        f"{train['dense_step_ms']:.2f} ms; profiled step idle "
        f"{100 - 100 * train['profile']['busy_ms'] / train['profile']['wall_ms']:.1f}%; "
        f"batch 64: {train['batch64']}")
    log(f"gpt_lm fused_ln_matmul training (B=8, S=1024): " + "; ".join(
        f"{bwd} backward step {v['step_ms']:.2f} ms, {v['tok_s']:.0f} tokens/s, MFU "
        f"{100 * v['mfu']:.2f}%, peak {v['peak_gib']:.2f} GiB"
        for bwd, v in train["passes"].items())
        + f"; profiled fused+pallas step idle "
        f"{100 - 100 * train['fused_profile']['busy_ms'] / train['fused_profile']['wall_ms']:.1f}"
        f"%; "
        f"gates {train['compare']}; LN+matmul at M=8192 (bf16, kernel / bound / plain / "
        f"library ms): " + "; ".join(
            f"{k} n={r['n']} {r['ms']:.5f} / {r['bound_ms']:.5f} / {r['plain_ms']:.5f} / "
            f"{r['library_ms']:.5f} (device ms by kernel: {fmt_split(r['split'])})"
            for k in ("ln_matmul/train", "ln_matmul_bwd_dx", "ln_matmul_bwd_dw")
            for r in ln_train[k]["rows"])
        + "; dw plans (event ms): " + "; ".join(
            f"n={n} " + ", ".join(f"{k} {v:.5f}" for k, v in sw.items())
            for n, sw in ln_train["sweep"].items())
        + "; crossover n=3072 (row-tile vs tiled device ms): " + ", ".join(
            f"M={M} " + " vs ".join(f"{t:.5f}" for t in ts)
            for M, ts in kern["ln_matmul"]["crossover"].items())
        + "; kernels line: ln_matmul's row is serving's M=8 n=3072 and its launches serving's; "
        f"ln_matmul_train's row is M=8192 n={LN_BWD_MAIN_N} and its launches the fused+pallas "
        f"training pass's forward launches; the backward rows are n={LN_BWD_MAIN_N} "
        f"(library_ms: the product alone, dy@w^T and h^T@dy)")
    log(f"resnet50_imagenet training (B=256, 224x224, bf16): " + "; ".join(
        f"{k} step {v['step_ms']:.2f} ms, {v['img_s']:.1f} images/s, MFU {100 * v['mfu']:.2f}%, "
        f"peak {v['peak_gib']:.2f} GiB" for k, v in resnet["passes"].items())
        + f"; device idle of one profiled fused step with its batch preloaded (the timed "
        f"steps also gather and copy their batch on the host) "
        f"{100 - 100 * resnet['profile']['busy_ms'] / resnet['profile']['wall_ms']:.1f}%; "
        f"f32 step-1 gradients, fused+pallas vs standard: median "
        f"{resnet['compare']['f32']['median']:.3e}, worst {resnet['compare']['f32']['worst']:.3e}; "
        f"conv_bn timed shapes: {CONV_BN_MAIN} (library_ms: the product alone, x@w, g@w^T, "
        f"h^T@g, both for single); dw over the step's two-pass shapes (sum of launches x "
        f"kernel ms): {conv_bn['conv_bn_bwd_dw']['sweep']['step_ms']:.4f} ms; the forward over "
        f"the step's 36 launches: {conv_bn['conv_bn_fwd']['sweep']['step_ms']:.4f} ms")
    bench = dp["bench"]["row"]
    log(f"phase 7 ({dp['wall_s']:.1f} s): bench ResNet-50 fused+pallas batch "
        f"{bench['global_batch']} at world 1: {bench['value']} images/s per card, MFU "
        f"{bench['mfu']}, pipeline-fed {bench['pipeline_fed_images_per_sec_per_chip']} images/s, "
        f"pipeline_efficiency {bench['pipeline_efficiency']} ({bench['provenance']['device_kind']}"
        f", {bench['provenance']['power_limit']}); bench launches {dp['bench']['launches']}; "
        f"dp2 on one card (gloo) vs one process: {dp['dp']['passes']} (half-batch control BN "
        f"{dp['dp']['control_bn']:.3e}); fed path bitwise over {dp['dp']['fed_bitwise']} batches")
    log(f"bert_pretrain training (phase 8, {bert['wall_s']:.1f} s; bert_base, B={BERT_BATCH}, "
        f"S=512, K=77, bf16): " + "; ".join(
            f"{k} step {v['step_ms']:.2f} ms, {v['tok_s']:.0f} tokens/s, MFU "
            f"{100 * v['mfu']:.2f}%, peak {v['peak_gib']:.2f} GiB, eval loss "
            f"{v['eval_metrics']['loss']:.5f} accuracy {v['eval_metrics']['accuracy']:.5f}"
            for k, v in bert["passes"].items())
        + f"; flash launches {bert['launches']}; gates {bert['compare']}; f32 eval on the same "
        f"weights, flash and control vs dense, per batch: {bert['eval']}; flash kernels at "
        f"BERT's shape (B=32 H=12 S=512 D=64 non-causal bf16; kernel / bound / plain / SDPA "
        f"ms): " + "; ".join(
            f"{n} {case} {r['ms']:.5f} / {r['bound_ms']:.5f} ({r['bound_by']}) / "
            f"{r['plain_ms']:.5f} / "
            + (f"{r['library_ms']:.5f} ({r['sdpa_backend']})" if r["library_ms"] is not None
               else "null")
            for n in FLASH_NAMES for case, r in kern[n]["bert"].items()))
    log(f"checkpoint-restart (phase 9, {ckpt['wall_s']:.1f} s; {smi}): gpt_lm fused + pallas "
        f"killed in step {CKPT_KILL_AT}'s commit, preempted after step {CKPT_SIGTERM_AT}, "
        f"resumed: steps {ckpt['gate']['steps']} bitwise the straight run's; resnet50_imagenet "
        f"steps {ckpt['resnet']['steps']} bitwise; {ckpt['step_bytes']} bytes a gpt_lm step dir, "
        f"snapshot stall {ckpt['snapshot_ms']:.1f} ms, async commit {ckpt['commit_s']:.3f} s, "
        f"sync save {ckpt['sync_save_s']:.3f} s ({ckpt['write_gb_s']:.3f} GB/s to the host "
        f"disk), restore {ckpt['restore_s']:.3f} s")
    log(f"real-data intake (phase 10, {intake['wall_s']:.1f} s; {smi}; {os.cpu_count()} host "
        f"cores): resnet50_imagenet fused + pallas from records: (crop_flip), batch 256: step "
        f"{intake['step_ms']:.2f} ms (steps 2-{INTAKE_STEPS}), {intake['steady_ms']:.2f} ms = "
        f"{INTAKE_BATCH * 1e3 / intake['steady_ms']:.1f} images/s in the steady state; losses "
        f"{intake['losses']} bitwise the hand-fed steps', launches {intake['launches']}; host "
        f"records stream {intake['host_images_s']:.1f} images/s; loader native == Python over "
        f"{intake['compared']} batches")
    log(f"wide_deep (phase 11, {wide['wall_s']:.1f} s; {smi}): 11a model=1, {WD_FEATURES} "
        f"tables of {WD_VOCAB} x {WD_EMBED}, bf16, batch {WD_BATCH}: step "
        f"{wide['step_ms']:.3f} ms, {wide['ex_s']:.0f} examples/s, embed traffic "
        f"{wide['embed_gbps']:.2f} GB/s, peak {wide['peak_gib']:.3f} GiB (above "
        f"{wide['held_gib']:.3f} held before), profiled step idle "
        f"{100 - 100 * wide['profile']['busy_ms'] / wide['profile']['wall_ms']:.1f}%; eval "
        f"loss {wide['eval']['loss']:.5f} accuracy {wide['eval']['accuracy']:.5f} auc "
        f"{wide['eval']['auc']:.5f}; f32 card vs CPU {wide['f32']}; 11b model=2 on two ranks vs "
        f"model=1: loss {wide['dp']['loss']:.3e}, updates {wide['dp']['update']:.3e}, bitwise "
        f"{wide['dp']['bitwise']}")
    log(f"small workloads and demos (phase 12, {small['wall_s']:.1f} s; {smi}): " + "; ".join(
        f"{n} (batch {get_batch(n)}) step {small[n]['step_ms']:.3f} ms, "
        f"{small[n]['ex_s']:.0f} examples/s, profiled step idle "
        f"{100 - 100 * small[n]['profile']['busy_ms'] / small[n]['profile']['wall_ms']:.1f}%, "
        f"eval accuracy {small[n]['eval']['accuracy']:.5f}, f32 card vs CPU update "
        f"{small[n]['f32']['update']:.3e}" for n in SMALL_WORKLOADS)
        + f"; mnist_mlp by the JAX test's recipe: accuracy "
        f"{small['mlp_converge']['accuracy']:.5f}, top-5 "
        f"{small['mlp_converge']['top5_accuracy']:.5f}; demos: " + "; ".join(
            f"{n} " + ", ".join(f"{k} {v}" for k, v in d.items()
                                if k.startswith("eval_") or k in ("steps", "wall_s",
                                                                  "process_s"))
            for n, d in small["demos"].items())
        + "; flash kernels at head_dim 32 (B=64 H=4 S=64, bf16; kernel / bound / plain / SDPA "
        "ms): " + "; ".join(
            f"{n} {case} {r['ms']:.5f} / {r['bound_ms']:.5f} ({r['bound_by']}) / "
            f"{r['plain_ms']:.5f} / "
            + (f"{r['library_ms']:.5f} ({r['sdpa_backend']})" if r["library_ms"] is not None
               else "null")
            for n in FLASH_NAMES for case, r in kern[f"{n}_d32"]["timed"].items())
        + f"; head_dim-32 launches (the MLM + LM demos' training runs): "
        f"{small['flash_d32_launches']}")
    padded = kern["padded"]
    log(f"flash at padded head dims (phase 2c; {smi}; B={FLASH_D32['B']} H={FLASH_D32['H']} "
        f"S={FLASH_D32['S']}, bf16, zero-padded to D=32; kernel / bound at the caller's D / "
        f"plain / SDPA ms; the whole padded call's device ms in brackets): " + "; ".join(
            f"{case} {n} {r['ms']:.5f} [{r['call_ms']:.5f}] / {r['bound_ms']:.5f} "
            f"({r['bound_by']}) / {r['plain_ms']:.5f} / "
            + (f"{r['library_ms']:.5f} ({r['sdpa_backend']})" if r["library_ms"] is not None
               else "null")
            for case, rows in padded["timed"].items() for n, r in rows.items())
        + f"; max abs errors {padded['err']}")
    a, b = t13["13a"], t13["13b"]
    log(f"transformer training options (phase 13, {walls['13']:.1f} s; {smi}): 13a gpt_lm "
        f"B=8 S=1024 bf16 dropout 0.1: " + "; ".join(
            f"{k} step {v['step_ms']:.2f} ms, {v['tok_s']:.0f} tokens/s, MFU "
            f"{100 * v['mfu']:.2f}%, peak {v['peak_gib']:.3f} GiB, flash launches "
            f"{[v['launches'][n] for n in FLASH_NAMES]}" for k, v in a["passes"].items())
        + f"; remat bitwise the plain run (control diverges at step "
        f"{a['control_diverges_at']}); gates {a['compare']}; 13b blockwise vs dense "
        f"{b['compare']}, blockwise step {b['passes']['blockwise']['step_ms']:.2f} ms peak "
        f"{b['passes']['blockwise']['peak_gib']:.3f} GiB, dense step "
        f"{b['passes']['dense']['step_ms']:.2f} ms peak {b['passes']['dense']['peak_gib']:.3f} "
        f"GiB; 13c " + "; ".join(
            f"{n} losses {[round(x, 5) for x in v['losses']]} step {v['step_ms']:.2f} ms, f32 "
            f"card vs CPU {v['f32']}" for n, v in t13["13c"].items())
        + f"; 13d dp2 on one card {t13['13d']}; 13e {t13['13e']}; 13f bench_bert_torch: "
        + "; ".join(f"{k} {v['value']} tokens/s/card, step {v['step_ms']} ms, MFU {v['mfu']}, "
                    f"peak {v['peak_memory_gib']} GiB" for k, v in t13["13f"].items()))
    log(f"flash at head_dim 256 (phase 2c; {smi}; B={FLASH_D256['B']} H={FLASH_D256['H']} "
        f"S={FLASH_D256['S']}, bf16; kernel / bound / plain / SDPA ms): " + "; ".join(
            f"{n} {case} {r['ms']:.5f} / {r['bound_ms']:.5f} ({r['bound_by']}) / "
            f"{r['plain_ms']:.5f} / "
            + (f"{r['library_ms']:.5f} ({r['sdpa_backend']})" if r["library_ms"] is not None
               else "null")
            for n in FLASH_NAMES for case, r in kern[f"{n}_d256"]["timed"].items())
        + f"; D=192 padded to 256, causal: " + "; ".join(
            f"{n} {r['ms']:.5f} [{r['call_ms']:.5f}] / {r['bound_ms']:.5f} / {r['plain_ms']:.5f}"
            for case, rows in kern["padded192"]["timed"].items() for n, r in rows.items())
        + f"; max abs errors D=256 {[kern[n + '_d256']['err'] for n in FLASH_NAMES]}, D=192 "
        f"{kern['padded192']['err']}; D=256 launches (14c's run_workload) {tp['14c']}")
    log(f"tensor and fully-sharded data parallelism (phase 14, {walls['14']:.1f} s; {smi}): "
        f"14a gpt_lm gpt_small data=1 x model=2 (2 gloo ranks on one card) vs one process "
        f"{ {k: v for k, v in tp['14a'].items() if k != 'step_ms'} }, rank step ms "
        f"{tp['14a']['step_ms']}; 14b bert_pretrain bert_base fsdp=2 x model=2 (4 gloo ranks on "
        f"one card) vs one process {tp['14b']}; step ms are gloo-on-one-card numbers, not "
        f"tensor-parallel throughput")
    log(f"sequence parallelism (phase 15, {walls['15']:.1f} s; {smi}): 15a the three "
        f"schedules at seq=2 (2 gloo ranks on one card) vs one process, relative L2 {sp['15a']}; "
        f"15b gpt_lm long_context S=8192 B={T15_LC['global_batch']} at seq=2 vs one process: "
        f"{sp['15b']}; step ms are gloo-on-one-card numbers, not sequence-parallel throughput")
    log(f"flash at the sequence-parallel shapes and f32 D=256 (phase 2c; {smi}; kernel / bound "
        f"/ plain / SDPA ms): " + "; ".join(
            f"{name} {r['shape']} {'causal' if r['causal'] else 'non-causal'}"
            f"{' padded' if r['masked'] else ''}: " + ", ".join(
                f"{n} {x['ms']:.5f} / {x['bound_ms']:.5f} ({x['bound_by']}) / "
                f"{x['plain_ms']:.5f} / "
                + (f"{x['library_ms']:.5f} ({x['sdpa_backend']})" if x["library_ms"] is not None
                   else "null") for n, x in r["timed"].items())
            + f", max abs errors {r['err']}" for name, r in kern["sp"].items())
        + "; f32 D=256 causal: " + ", ".join(
            f"{n} {x['ms']:.5f} / {x['bound_ms']:.5f} ({x['bound_by']}) / {x['plain_ms']:.5f} / "
            + (f"{x['library_ms']:.5f} ({x['sdpa_backend']})" if x["library_ms"] is not None
               else "null") for n, x in kern["f32_d256"]["timed"]["causal"].items())
        + f", max abs errors {kern['f32_d256']['err']}")
    log(f"pipeline parallelism (phase 16, {walls['16']:.1f} s; {smi}): " + "; ".join(
        f"{t} {T16_CASES[t][0]} {T16_CASES[t][1]} V={T16_CASES[t][2]} vs one process "
        + str({k: v for k, v in pp[t].items() if k not in ('step_ms', 'peak_gib')})
        + f", rank step ms {pp[t]['step_ms']}, peak GiB {pp[t]['peak_gib']}"
        for t in T16_CASES)
        + "; step ms are gloo-on-one-card numbers, not pipeline throughput; the *_pipe rows "
        f"of the kernels line: flash at {T16_FLASH} causal bf16, LN+matmul at M={T16_LN[0]} "
        f"d={T16_LN[1]} n={T16_LN[2]} bf16, their launches 16a rank 0's over "
        f"{T16_GPT['steps']} steps; checked untimed at the other shapes (max abs errors): "
        f"{pp['checks']}")
    log(f"cuda_ms traces kept {PAD_RECORDS[0]} of the {PAD_RECORDS[1]} spin-kernel records "
        f"that opened them; {BLANK_TRACES[0]} blank traces retaken")
    log("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    log("the longest stretches between log lines (s, the line that opened each): " + "; ".join(
        f"{gap:.1f} after {line.strip()[:90]!r}" for gap, line in sorted(LOG_GAPS)[::-1][:12]))
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s (builds included)")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
