#!/usr/bin/env python3
"""The ``fused_ln_matmul`` serve pass of ``chip_smoke.py`` (phase 3:
``gpt_small``, 8 requests, 4 slots, 32 new tokens each), and the host
time of one call of its two kernels' wrappers, on this checkout and on
another tree, in turns, on one CUDA card.

Run from the root of a checkout, with the other commit unpacked beside it
(a whole tree: its package and its ``chip_smoke.py``)::

    git archive <commit> | tar -x -C other
    python3 tools/serve_turns.py other

Each turn (other, this, this, other) is a process of its own, run in that
tree: it builds the tree's paged-attention and LN+matmul kernels; times
one wrapper call (``call_ms``, as ``chip_smoke.py``'s phase 2 reads it:
CUDA events around back-to-back calls, here 200 on one bf16 input set,
the least of 5 repeats) of paged attention at phase 2a's decode case and
of the LN+matmul forward at M=4 (the pass's decode), d=768, n=768 and
3072 — calls whose device time is a fraction of the wrapper's host time,
so the reading is the host's; warms the engine up with one pass, then
runs one timed pass (tok/s, TTFT p50, TPOT
p50 on the host clock, ending in a device sync) and one pass under
torch.profiler, whose device time it splits into the serving LN+matmul
kernel (names holding ``ln_matmul_kernel``: its launches, its ms a pass and
a step), paged attention (names holding ``paged_attention``: each kernel
by its full name with its records and ms, and their ms a pass and a step)
and the rest, beside the pass's device-busy share. A wrapper call
launches each ``__global__`` function of the tree's
``paged_attention.cu`` once (``paged_kernels``), so paged attention's
records must add up to the wrapper's calls in the profiled pass times
those kernels, both in the profiler's table and among the trace's device
records; the tool logs every shortfall and then exits non-zero. The pass is
host-bound (PERF.md §5), so tok/s and TPOT move with the host more than
with any kernel. The first and the last line name the card (``nvidia-smi``'s
name and power limit). Exits non-zero without a card or when a turn fails.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one turn, run with a tree's root as its working directory
CHILD = r"""
import dataclasses, json, os, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from distributed_tensorflow_tpu_torch.models import transformer as tfm
from distributed_tensorflow_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all(("paged_attention", "ln_matmul"))
from distributed_tensorflow_tpu_torch.ops.fused_ln_matmul import ln_matmul
from distributed_tensorflow_tpu_torch.ops.paged_attention import paged_flash_attention
rng = np.random.default_rng(0)
c = cs.paged_case(torch, np, rng, "decode", torch.bfloat16)
calls = {"paged_attention decode": lambda c=c: paged_flash_attention(
    c["q"], c["k_pool"], c["v_pool"], c["block_table"], q_pos=c["q_pos"])}
for n in (768, 3072):
    c = cs.ln_case(torch, np, rng, 4, 768, n, torch.bfloat16)
    calls[f"ln_matmul M=4 n={n}"] = lambda c=c: ln_matmul(
        c["x"], c["gamma"], c["beta"], c["w"], c["bias"])
call_ms = {k: min(cs.event_ms(torch, [f], iters=200, warmup=20) for _ in range(5))
           for k, f in calls.items()}
cfg = dataclasses.replace(tfm.gpt_small(), fused_ln_matmul=True)
params = tfm.init_params(cfg, seed=0, device="cuda")
prompts = cs.make_prompts(np, cfg.vocab_size)
cs.serve_pass(torch, np, cfg, params, prompts, "warm-up")
p = cs.serve_pass(torch, np, cfg, params, prompts, "timed")
act = torch.profiler.ProfilerActivity
calls0 = paged_flash_attention.launches
with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
    q = cs.serve_pass(torch, np, cfg, params, prompts, "profiled")
events = cs.device_events(torch, prof)
ln = [e for e in events if "ln_matmul_kernel" in e.key]
busy = sum(e.self_device_time_total for e in events) / 1e3
# each paged kernel by its full name: (records, device ms) in the profiler's
# table and, beside it, straight from the trace's device records
pa = {e.key: (e.count, e.self_device_time_total / 1e3)
      for e in events if "paged_attention" in e.key}
raw = {}
for k in prof.profiler.kineto_results.events():
    if k.device_type() == torch.autograd.DeviceType.CUDA and "paged_attention" in k.name():
        n, ms = raw.get(k.name(), (0, 0.0))
        raw[k.name()] = (n + 1, ms + (k.end_ns() - k.start_ns()) / 1e6)
print(json.dumps({"tok_s": p["tok_s"], "ttft_p50_ms": p["ttft_p50_ms"],
                  "tpot_p50_ms": p["tpot_p50_ms"], "steps": q["steps"],
                  "ln_launches": sum(e.count for e in ln),
                  "ln_ms": sum(e.self_device_time_total for e in ln) / 1e3,
                  "pa_calls": paged_flash_attention.launches - calls0, "pa": pa, "pa_raw": raw,
                  "busy_ms": busy, "wall_ms": 1e3 * q["wall_s"], "call_ms": call_ms}))
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    if len(sys.argv) != 2 or not os.path.exists(os.path.join(sys.argv[1], "chip_smoke.py")):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("serve_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    card = cs.nvidia_smi_line()
    log(f"card: {card}")
    trees = {"other": os.path.abspath(sys.argv[1]), "this": REPO}
    short = []
    for side in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=trees[side],
                             capture_output=True, text=True)
        if out.returncode:
            log(f"turn {side} failed:\n{out.stderr[-4000:]}")
            return 1
        r = json.loads(out.stdout.strip().splitlines()[-1])
        pa_ms = sum(ms for _, ms in r["pa"].values())
        log(f"serve {side}: {r['tok_s']:.1f} tok/s, TTFT p50 {r['ttft_p50_ms']:.2f} ms, TPOT p50 "
            f"{r['tpot_p50_ms']:.3f} ms; profiled pass: {r['steps']} steps, ln_matmul_kernel "
            f"{r['ln_launches']} launches, {r['ln_ms']:.4f} device ms "
            f"({r['ln_ms'] / r['steps']:.4f} a step, {1e3 * r['ln_ms'] / r['ln_launches']:.3f} us "
            f"a launch), paged attention {pa_ms:.4f} device ms ({pa_ms / r['steps']:.4f} a "
            f"step), device busy {r['busy_ms']:.1f} of {r['wall_ms']:.1f} ms "
            f"({100 - 100 * r['busy_ms'] / r['wall_ms']:.1f}% idle); wrapper call_ms: "
            + ", ".join(f"{k} {v:.5f}" for k, v in r["call_ms"].items()))
        kernels = paged_kernels(trees[side])
        want = r["pa_calls"] * len(kernels)
        log(f"  paged attention {side}: {r['pa_calls']} wrapper calls x {len(kernels)} kernels "
            f"a call ({', '.join(kernels)}) = {want} launches")
        for k, (n, ms) in sorted(r["pa"].items()):
            log(f"    {n} records, {ms:.4f} device ms ({ms / r['steps']:.4f} a step): {k}")
        for what, table in (("the profiler's table", r["pa"]), ("the trace", r["pa_raw"])):
            got = sum(n for n, _ in table.values())
            if got != want:
                short.append(f"{side}: {what} holds {got} paged attention records of {want}")
                log(f"  {short[-1]}; by name: {table}")
    log(f"card: {card}")
    if short:
        log("paged attention's records do not add up to its launches: " + "; ".join(short))
        return 1
    return 0


def paged_kernels(tree: str) -> list[str]:
    """The ``__global__`` functions of a tree's ``paged_attention.cu``: a
    wrapper call launches each once (the first design a split and a combine
    kernel, the redesign one)."""
    with open(os.path.join(tree, "distributed_tensorflow_tpu_torch", "ops", "csrc",
                           "paged_attention.cu")) as f:
        src = f.read()
    return sorted(set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)))


if __name__ == "__main__":
    sys.exit(main())
