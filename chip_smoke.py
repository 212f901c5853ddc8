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
9. print the ``kernels`` JSON line (twelve entries: ``ln_matmul`` is the
   serving forward at M=8, ``ln_matmul_train`` the tiled forward at
   M=8192), then the ``ok`` line last.

TF32 is off for every f32 product compared here
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import contextlib
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
}

REPO = os.path.dirname(os.path.abspath(__file__))

#: where the tensors go (a rehearsal on the CPU may point this elsewhere)
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def log(msg: str = "") -> None:
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


def cuda_ms(torch, fns, iters: int = 50, warmup: int = 5, traces: int = 3,
            launches: dict | None = None) -> dict:
    """Time one call, cycling through ``fns`` (closures over independent
    input sets, together larger than L2, so each call finds its inputs
    cold as the serve path does). Returns ``device_ms``: the device time
    of every kernel the calls launched, per call, from ``torch.profiler``
    (CUPTI, ``traces`` traces of ``iters`` calls) — the kernel's own time,
    free of the Python wrapper's host overhead; ``by_name``: that device
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
    logged, and one of more than a tenth of a kernel's records fails the
    run."""
    call_ms = event_ms(torch, fns, iters, warmup)
    act = torch.profiler.ProfilerActivity
    most = {}  # kernel name -> (records, ms) of the trace with the most records of it
    for _ in range(traces):
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(PAD_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        PAD_RECORDS[1] += PAD_LAUNCHES
        for e in device_events(torch, prof):
            if "spin_kernel" in e.key:
                PAD_RECORDS[0] += e.count
            elif e.count > most.get(e.key, (0, 0.0))[0]:
                most[e.key] = (e.count, e.self_device_time_total / 1e3)
    launches = launches or {}
    for part in launches:
        if not any(part in k for k in most):
            raise SmokeFailure(f"torch.profiler recorded no launch of {part} in {traces} traces")
    by_name, short = {}, []
    for k, (n, ms) in most.items():
        each = next((c for part, c in launches.items() if part in k), -(-n // iters))
        by_name[k] = ms / n * each
        if n != each * iters:  # more than the caller's count is a shortfall of the count
            short.append((k[:60], n, each * iters))
    if short:
        log(f"    (records in the fullest of {traces} traces: "
            f"{'; '.join(f'{k} {n} of {want}' for k, n, want in short)})")
    bad = [k for k, n, want in short if 10 * abs(want - n) > want]
    if bad:
        raise SmokeFailure(f"torch.profiler lost more than a tenth of the records of {bad}")
    if sum(by_name.values()) <= 0:
        raise SmokeFailure(f"torch.profiler recorded no device time in {traces} traces")
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


def flash_case(torch, np, rng, dtype, masked, B=8, H=12, S=1024, D=64):
    """q/k/v/dout as the model makes them ([B,S,H,D] viewed as
    [B,H,S,D]); with ``masked`` a kv_mask of ~75% keys whose last batch
    row attends nothing; with ``masked="padded"`` the mask of a padded
    batch, each row's keys a valid prefix of a length drawn from
    ``BERT_PAD_LENGTHS``, the last row none."""
    mk = lambda: torch.from_numpy(  # noqa: E731
        rng.standard_normal((B, S, H, D), dtype=np.float32)).to(DEVICE, dtype).transpose(1, 2)
    c = dict(q=mk(), k=mk(), v=mk(), dout=mk(), mask=None)
    if masked == "padded":
        c["mask"] = torch.from_numpy(padded_mask(np, rng, B, S)).to(DEVICE)
    elif masked:
        m = rng.random((B, S)) > 0.25
        m[:, 0] = True
        m[-1] = False
        c["mask"] = torch.from_numpy(m).to(DEVICE)
    return c


def padded_mask(np, rng, B, S):
    """[B, S] bool: row b attends its first lens[b] keys, lens drawn from
    ``BERT_PAD_LENGTHS`` (clipped to S), the last row none."""
    lo, hi = (min(x, S) for x in BERT_PAD_LENGTHS)
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
    any) and, when ``causal``, the causal order allow it."""
    q = c["q"]
    B, H, S, D = q.shape
    tensor = q.numel() * q.element_size()
    lse = B * H * S * 4
    rows = torch.arange(S, device=q.device)
    keys = ((rows[None, :] <= rows[:, None]) if causal             # [S, S]
            else torch.ones(S, S, dtype=torch.bool, device=q.device))
    if c["mask"] is not None:
        pairs = int((keys[None] & c["mask"][:, None, :]).sum()) * H
    else:
        pairs = int(keys.sum()) * B * H
    mask_bytes = c["mask"].numel() if c["mask"] is not None else 0
    nbytes, products = {
        "fwd": (3 * tensor + mask_bytes + tensor + lse, 2),
        "dkv": (5 * tensor + lse + mask_bytes + 2 * tensor, 4),
        "dq": (5 * tensor + lse + mask_bytes + tensor, 3),
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
    names = " ".join(by_name).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                         ("efficient", "efficient")):
        if key in names:
            return backend
    return "math"


def time_flash(torch, np, F, fa, rng, c, causal, dn, shape) -> dict[str, dict]:
    """Each kernel, the plain versions and SDPA (forward; its whole
    backward through autograd) on cold copies of case ``c``'s inputs, three
    traces deep (``cuda_ms``), beside the bound of this case's attended
    pairs. SDPA takes ``is_causal`` or, with a kv_mask, the boolean
    ``attn_mask``; its backend is read from its kernels' names."""
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
    t_plain_fwd, t_plain_bwd = cuda_ms(torch, plain_fwd), cuda_ms(torch, plain_bwd)
    t_lib_fwd, t_lib_bwd = cuda_ms(torch, lib_fwd), cuda_ms(torch, lib_bwd)
    backend = sdpa_backend(t_lib_fwd["by_name"])
    rows = {}
    for n in kern:
        tk = cuda_ms(torch, kern[n])
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
    torch.cuda.empty_cache()
    for n in names:  # comparison launches do not count
        getattr(fa, n).launches = before[n]
    return results


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
            t_plain = {k: cuda_ms(torch, v, iters=10, warmup=2) for k, v in plain.items()}
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
        plain = {"fwd": cuda_ms(torch, [lambda: fcb.conv1x1_bn_act_plain(c["x"], c["w"], *aff)],
                                iters=10, warmup=2),
                 "bwd": cuda_ms(torch, [lambda: fcb.conv1x1_bn_bwd_plain(*bwd)], iters=10,
                                warmup=2)}
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
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
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


def phase_train(torch, np, card):
    log(f"phase 5: train gpt_lm (gpt_small, S=1024, bf16, random weights from seed 0, "
        f"SyntheticLM tokens, adamw at constant lr 3e-4, dropout 0.1 — a smoke setting) "
        f"through run_workload, flash kernels vs no kernel; on {card}")
    import dataclasses
    import tempfile

    from distributed_tensorflow_tpu_torch.data.text import SyntheticLM
    from distributed_tensorflow_tpu_torch.utils.config import apply_overrides
    from distributed_tensorflow_tpu_torch.workloads import gpt_lm

    # On the SyntheticLM stream every step brings 8k fresh next-token pairs
    # of a 50k-entry map, so 6 steps do not lower the loss (on an H100 it
    # stayed within +-0.01 of 10.97 at lr 3e-4; PERF.md). The smoke
    # therefore trains on a fixed corpus of SyntheticLM's first 8
    # sequences, written as a token file: the steps revisit its pairs, and
    # the loss falls if the backward is right.
    data_cfg = apply_overrides(gpt_lm.default_config(), TRAIN_OVERRIDES).data
    corpus = SyntheticLM(dataclasses.replace(data_cfg, global_batch_size=8)).batch(0)
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "corpus.npy")
    np.save(path, np.append(corpus["input_ids"].reshape(-1), 0).astype(np.int32))
    log(f"  corpus: SyntheticLM batch 0 ({corpus['input_ids'].shape} tokens) as tokens:{path}")
    data = [f"--data.dataset=tokens:{path}"]
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
    dispatch, host<->device copies of tokens and tables)."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        p = serve_pass(torch, np, cfg, params, prompts, "profiled fused_ln_matmul")
    events = [e for e in device_events(torch, prof) if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = 1e3 * p["wall_s"]
    log(f"  profiled pass (fused_ln_matmul, profiler on): wall {wall_ms:.1f} ms, device "
        f"busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% (idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f}%), {p['steps']} steps")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


def check_spills(report: str, kernels) -> None:
    """ptxas's report of one library: each instantiation of ``kernels``
    (matched by substring of its mangled name) with its registers and
    spills, logged; fails where one spills or none was reported."""
    lines = report.splitlines()
    found = {k: 0 for k in kernels}
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
        log(f"  ptxas {k}<{d.group(1) if d else '?'}>: {regs.group(1) if regs else '?'} "
            f"registers, spill stores/loads {spills}")
        if any(spills):
            raise SmokeFailure(f"ptxas: {m.group(1)} spills {spills} bytes")
    if not all(found.values()):
        raise SmokeFailure(f"ptxas reported no instantiation of {found}")


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
        check_spills(reports["flash_attention"], FLASH_KERNELS)
        kern = phase_kernels(torch, np, F)
        kern.update(phase_flash(torch, np, F))
        ln_train = phase_ln_train(torch, np, F)
        kern.update({n: {"err": ln_train[n]["err"], "rows": [ln_train[n]["main"]]}
                     for n in ("ln_matmul_bwd_dx", "ln_matmul_bwd_dw")})
        kern["ln_matmul_train"] = {"err": ln_train["ln_matmul/train"]["err"],
                                   "rows": [ln_train["ln_matmul/train"]["main"]]}
        conv_bn = phase_conv_bn(torch, np)
        kern.update({n: {"err": r["err"], "rows": [r["main"]]} for n, r in conv_bn.items()})
        launches, counts, steps = phase_serve(torch, np, smi)
        train = phase_train(torch, np, smi)
        launches.update(train["flash_launches"])
        # the LN+matmul forward runs on two main paths: serving (the
        # row-tile kernel, "ln_matmul") and the fused training pass with the
        # pallas backward (the tiled pair, "ln_matmul_train"; dx and dw)
        launches.update({n: train["launches"][n] for n in ("ln_matmul_train",
                                                            "ln_matmul_bwd_dx",
                                                            "ln_matmul_bwd_dw")})
        resnet = phase_resnet(torch, np, smi)
        launches.update(resnet["launches"])
        dp = phase_dp(torch, np, smi)
        bert = phase_bert(torch, np, smi)
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
          for name, line in (("flash_fwd", 75), ("flash_bwd_dkv", 205), ("flash_bwd_dq", 241))),
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
    log(f"card: {smi}")
    log(f"launches by pass (paged_attention, ln_matmul): {counts}; engine steps by pass: "
        f"{steps}; timed shapes: paged_attention decode B=8 S=1, ln_matmul M=8 n=3072, "
        f"ln_matmul_train M=8192 n=3072, "
        f"flash B=8 H=12 S=1024 D=64 causal bf16 (flash_bwd_dkv library_ms: SDPA's whole "
        f"backward, dq+dk+dv; flash_bwd_dq: null)")
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
    log(f"cuda_ms traces kept {PAD_RECORDS[0]} of the {PAD_RECORDS[1]} spin-kernel records "
        f"that opened them")
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s (builds included)")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
