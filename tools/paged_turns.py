#!/usr/bin/env python3
"""Paged attention (``paged_attention_kernel``) of this checkout against
another commit's, on one CUDA card, in turns — and what bounds this
checkout's kernel.

Run from the root of a checkout, with the other commit's kernel sources
unpacked beside it (any directory holding its ``paged_attention.cu`` and
the headers that file includes)::

    git archive <commit> distributed_tensorflow_tpu_torch/ops/csrc | tar -x -C other
    python3 tools/paged_turns.py other/distributed_tensorflow_tpu_torch/ops/csrc

It builds, one nvcc each, all started together: the other source
("parent", launched through its own C entries as its wrapper did: the
split count queried, the two f32 scratch tensors allocated), this
checkout's ("change", through the port's own build) and copies of this
checkout's source with substitutions (``VARIANTS``): ablations (no
in-launch merge — each warp stores its own partial —, the merge without
its sums, no K/V copies, no products, none of the three — the
launch, the dependent loads, the barriers and the stores alone —, P
rounded to bf16 for P V) and levers (S=1 on the tensor cores' 16-row
tiles, a ring of at most 2 stages, 4 warps — one a row group — at S >
32). An ablated copy computes
garbage and is timed only. Each substituted text must occur exactly once
in the source, or the tool refuses to run. Then, bf16, H=12, D=64, bs=16,
MB=64, on ``chip_smoke.paged_case``'s inputs at each of phase 2a's cases
(``chip_smoke.PAGED_KINDS``: decode B=8, prefill S=64, verify B=4 S=5,
the serve pass's decode B=4):

1. ptxas's registers and spills of every kernel instantiation;
2. out of "parent", "change" and the variants that compute it against
   the plain version: relative L2 error (an out x 1.01 beside it);
3. parent and change in turns (parent, change, change, parent), device ms
   by torch.profiler (``chip_smoke.cuda_ms``, enough input sets to exceed
   L2), with the share of ``chip_smoke.paged_bound_ms`` and SDPA on the
   gathered K/V beside each; then a timeline of one cold call of the
   change built with its ``PA_MARK`` points recording ``%globaltimer``
   (``TIMELINE``): the span, the spread of the CTAs' starts and each phase
   (``PHASES``) over the CTAs;
4. at each case, plans other than ``paged_plan``'s (ranks x chunk keys,
   ``PLAN_RANKS`` x ``PLAN_CHUNKS``) through the C entry, and each
   variant, in turns with the change (the change first and last).

The first and the last line name the card (``nvidia-smi``'s name and
power limit). Exits non-zero without a card or when the parent's or the
change's build fails; a variant that does not build is logged and left
out.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: where the no-merge ablation goes: the cluster wait before the pushes
_WAIT = 'asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");  // every rank has started\n'
#: the no-merge ablation: after the wait each warp stores its own
#: normalised partial and returns (the warps and ranks of a row race: garbage)
NO_MERGE = (_WAIT, _WAIT + """\
  if (warp_live && CORES) {
#pragma unroll
    for (int w = 1; w < 32; w <<= 1) lc += __shfl_xor_sync(0xffffffffu, lc, w);
#pragma unroll
    for (int u = 0; u < CU; ++u)
      if (2 * lane + 64 * u < D) {
        T* dst = out + bh * D + 2 * lane + 64 * u;
        dst[0] = tile::from_f32<T>(oc[u][0] / lc);
        dst[1] = tile::from_f32<T>(oc[u][1] / lc);
      }
  } else if (warp_live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      const float inv = 1.f / fmaxf(lr + __shfl_xor_sync(0xffffffffu, lr, 2), 1e-30f);
      if (s0 + r0 + 8 * r < S)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (8 * j < D) {
            T* dst = out + (bh * S + s0 + r0 + 8 * r) * D + 8 * j + 2 * t;
            dst[0] = tile::from_f32<T>(o[0][j][2 * r] * inv);
            dst[1] = tile::from_f32<T>(o[0][j][2 * r + 1] * inv);
          }
    }
  }
  return;
""")
#: (name, [(text in this checkout's paged_attention.cu, its replacement)])
VARIANTS = [
    ("without the in-launch merge", [NO_MERGE]),
    ("merge without the sums", [("constexpr bool PA_SUMS = true;",
                                 "constexpr bool PA_SUMS = false;")]),
    ("without the K/V copies", [("constexpr bool PA_KV_COPY = true;",
                                 "constexpr bool PA_KV_COPY = false;")]),
    ("without the products", [("constexpr bool PA_PRODUCTS = true;",
                               "constexpr bool PA_PRODUCTS = false;")]),
    ("the launch, chain and stores alone", [
        NO_MERGE,
        ("constexpr bool PA_KV_COPY = true;", "constexpr bool PA_KV_COPY = false;"),
        ("constexpr bool PA_PRODUCTS = true;", "constexpr bool PA_PRODUCTS = false;")]),
    ("P rounded to bf16", [("constexpr bool PA_P_SPLIT = true;",
                            "constexpr bool PA_P_SPLIT = false;")]),
    ("S=1 on tensor cores", [("constexpr bool PA_DECODE_MMA = false;",
                              "constexpr bool PA_DECODE_MMA = true;")]),
    ("at most 2 ring stages", [("constexpr int PA_STAGES = 3;", "constexpr int PA_STAGES = 2;")]),
    ("4 warps at S > 32", [("constexpr int PA_WIDE_THREADS = 256;",
                            "constexpr int PA_WIDE_THREADS = 128;")]),
]
#: the timeline variant: each CTA's thread 0 records %globaltimer at the
#: source's PA_MARK points into a device array that a C entry copies out
TIMELINE = ("timeline", [("#define PA_MARK(i)\n", """\
__device__ unsigned long long pa_marks[1 << 16][8];
__device__ __forceinline__ void pa_mark(int i) {
  if (threadIdx.x != 0) return;
  const unsigned cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (cta < (1u << 16)) pa_marks[cta][i] = t;
}
#define PA_MARK(i) pa_mark(i)
"""), ("const char* dtf_error_string(int err) {", """\
int paged_attention_marks(void* dst, int ctas) {
  return (int)cudaMemcpyFromSymbol(dst, pa_marks, (size_t)ctas * sizeof(pa_marks[0]));
}

const char* dtf_error_string(int err) {""")])
#: the phases between the marks: (name, from mark, to mark)
PHASES = (("chain", 0, 1), ("chunks", 1, 2), ("push", 2, 3), ("barrier", 3, 4),
          ("merge max", 4, 6), ("merge sums", 6, 7), ("merge store", 7, 5))
#: variants that compute out (checked against the plain version in step 2)
EXACT = ("S=1 on tensor cores", "at most 2 ring stages", "4 warps at S > 32")
#: step 4's plans: ranks and chunk keys
PLAN_RANKS = (1, 2, 4, 8)
PLAN_CHUNKS = (32, 64, 128)
#: the parent's entries: q, k_pool, v_pool, table, q_pos, out, part_acc,
#: part_ml; B, H, S, D, NB, bs, MB; scale, stream — and its split query
PARENT_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7 + (ctypes.c_float, ctypes.c_void_p)


def substitute(src: str, name: str, subs) -> str:
    """``src`` with each (old, new) of ``subs`` applied in turn; refuses a
    text that does not occur exactly once."""
    for old, new in subs:
        n = src.count(old)
        if n != 1:
            raise SystemExit(f"paged_turns: {name!r}: the source holds {old!r} {n} times, "
                             f"not once")
        src = src.replace(old, new)
    return src


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    if len(sys.argv) != 2 or not os.path.exists(os.path.join(sys.argv[1],
                                                             "paged_attention.cu")):
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("paged_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import attention as att
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    log(f"card: {card}")
    with open(os.path.join(_build.CSRC, "paged_attention.cu")) as f:
        src = f.read()
    sources = {"parent": os.path.join(os.path.abspath(sys.argv[1]), "paged_attention.cu")}
    work = os.path.join(_build.BUILD_DIR, "paged_turns")
    for name, subs in VARIANTS + [TIMELINE]:
        text = substitute(src, name, subs)
        d = os.path.join(work, re.sub(r"\W+", "_", name))
        os.makedirs(d, exist_ok=True)
        for h in os.listdir(_build.CSRC):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(_build.CSRC, h), d)
        with open(os.path.join(d, "paged_attention.cu"), "w") as f:
            f.write(text)
        sources[name] = os.path.join(d, "paged_attention.cu")
    t0 = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    jobs = {n: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", os.path.join(work, f"pa{i}.so"), cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (n, cu) in enumerate(sources.items())}
    libs = {"change": _build.load("paged_attention")}
    reports = {"change": _build.build_all(("paged_attention",))["paged_attention"]}
    sig = _build.SIGNATURES["paged_attention"]
    for i, (n, p) in enumerate(jobs.items()):
        reports[n], _ = p.communicate()
        if p.returncode:
            log(f"build of {n!r} failed:\n{reports[n][-4000:]}")
            if n == "parent":
                return 1
            continue
        lib = ctypes.CDLL(os.path.join(work, f"pa{i}.so"))
        for fn, argtypes in sig.items():
            getattr(lib, fn).argtypes = list(PARENT_ARGS if n == "parent" else argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        if n == "parent":
            lib.paged_attention_splits.argtypes = [ctypes.c_int] * 4
            lib.paged_attention_splits.restype = ctypes.c_int
        if n == TIMELINE[0]:
            lib.paged_attention_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.paged_attention_marks.restype = ctypes.c_int
        lib.dtf_error_string.argtypes = [ctypes.c_int]
        lib.dtf_error_string.restype = ctypes.c_char_p
        libs[n] = lib
    log(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")

    # 1. ptxas: registers and spills of each kernel instantiation
    for n, rep in reports.items():
        lines = rep.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Function properties for (\S*paged_attention\S*)", line)
            if m:
                info = " | ".join(x.strip() for x in lines[i + 1:i + 3])
                log(f"ptxas {n}: {m.group(1)}: {info}")

    sms = pa._sms(torch.device("cuda"))

    def shapes(c):
        B, H, S, D = c["q"].shape
        return B, H, S, D, c["k_pool"].shape[0], c["k_pool"].shape[2], c["block_table"].shape[1]

    def run(n, c, plan=None):
        """One call with library ``n`` on case ``c``: the change and its
        variants through the wrapper (``paged_plan``'s plan) or, given
        ``plan`` (ranks, chunk keys, chunks a rank), through the C entry;
        the parent through its own entries and scratch."""
        q = c["q"]
        B, H, S, D, NB, bs, MB = shapes(c)
        ptrs = (q.data_ptr(), c["k_pool"].data_ptr(), c["v_pool"].data_ptr(),
                c["block_table"].data_ptr(), c["q_pos"].data_ptr())
        if n == "parent":
            lib = libs[n]
            splits = lib.paged_attention_splits(D, bs, MB, q.element_size())
            out = torch.empty_like(q)
            acc = torch.empty(B * H * splits * S * D, dtype=torch.float32, device=q.device)
            ml = torch.empty(B * H * splits * S * 2, dtype=torch.float32, device=q.device)
            _build.launch(lib, "paged_attention_bf16", "parent", q.device, *ptrs,
                          out.data_ptr(), acc.data_ptr(), ml.data_ptr(), B, H, S, D, NB, bs,
                          MB, D ** -0.5)
            return out
        if plan is None:
            _build._libs["paged_attention"] = libs[n]
            return pa.paged_flash_attention(q, c["k_pool"], c["v_pool"], c["block_table"],
                                            q_pos=c["q_pos"])
        out = torch.empty_like(q)
        _build.launch(libs[n], "paged_attention_bf16", n, q.device, *ptrs, out.data_ptr(),
                      B, H, S, D, NB, bs, MB, *plan, D ** -0.5)
        return out

    def timeline(kind, sets, plan):
        """One cold call of the timeline variant: the span from the first
        CTA's start to the last CTA's end, the spread of the starts, and
        each phase between the marks (``PHASES``) over the CTAs, median and
        most, and in the CTA that ended last (us)."""
        for s in sets + sets[:1]:
            run(TIMELINE[0], s)
        torch.cuda.synchronize()
        ctas = plan.grid[0] * plan.grid[1] * plan.grid[2]
        marks = np.zeros((ctas, 8), np.uint64)
        _build.check(libs[TIMELINE[0]], libs[TIMELINE[0]].paged_attention_marks(
            marks.ctypes.data, ctas), "marks")
        m = (marks.astype(np.int64) - int(marks[:, 0].min())) / 1e3
        last = int(np.argmax(m[:, 5]))
        log(f"timeline {kind} ({ctas} CTAs): span {m[:, 5].max():.2f} us, starts spread "
            f"{m[:, 0].max():.2f} us; " + "; ".join(
                f"{p} median {np.median(m[:, b] - m[:, a]):.2f} most "
                f"{(m[:, b] - m[:, a]).max():.2f} last-CTA {m[last, b] - m[last, a]:.2f}"
                for p, a, b in PHASES)
            + f"; the last CTA started at {m[last, 0]:.2f} us")

    rng = np.random.default_rng(17)
    bf16 = torch.bfloat16

    def case_sets(kind):
        c = cs.paged_case(torch, np, rng, kind, bf16)
        nbytes = 2 * c["k_pool"].numel() * c["k_pool"].element_size()
        return [c] + [dict(c, k_pool=c["k_pool"].clone(), v_pool=c["v_pool"].clone())
                      for _ in range(cs.copies_for(nbytes) - 1)]

    # 2. out against the plain version
    for kind in cs.PAGED_KINDS:
        c = cs.paged_case(torch, np, rng, kind, bf16)
        want = pa.paged_attention_plain(c["q"], c["k_pool"], c["v_pool"], c["block_table"],
                                        q_pos=c["q_pos"])
        for n in ("parent", "change", *(v for v in EXACT if v in libs)):
            got = run(n, c)
            log(f"relative L2 {n} at {kind}: out {cs.rel_l2(got, want):.3e} "
                f"(out x 1.01 {cs.rel_l2(got.float() * 1.01, want):.3e})")
    _build._libs["paged_attention"] = libs["change"]

    # 3. parent against change, in turns, with SDPA on the gathered K/V
    turns = ("parent", "change", "change", "parent")
    for kind in cs.PAGED_KINDS:
        sets = case_sets(kind)
        ms = {side: [] for side in ("parent", "change")}
        calls = {side: [] for side in ("parent", "change")}
        for side in turns:
            t = cs.cuda_ms(torch, [lambda s=s, side=side: run(side, s) for s in sets])
            ms[side].append(t["device_ms"])
            calls[side].append(t["call_ms"])
        lib_in = []
        for s in sets:
            kg = att.paged_gather_kv(s["k_pool"], s["block_table"])
            vg = att.paged_gather_kv(s["v_pool"], s["block_table"])
            mask = (torch.arange(kg.shape[2], device=kg.device)[None, None, :]
                    <= s["q_pos"].long()[:, :, None])[:, None]
            lib_in.append((s["q"], kg, vg, mask))
        lib = cs.cuda_ms(torch, [lambda a=a: F.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3]) for a in lib_in])["device_ms"]
        del lib_in
        bound, by = cs.paged_bound_ms(sets[0], "bfloat16")
        B, H, S, D, NB, bs, MB = shapes(sets[0])
        plan = pa.paged_plan(B, H, S, MB, bs, D, 2, sms)
        for side, v in ms.items():
            mean = sum(v) / len(v)
            log(f"turns {kind} {side}: device ms {', '.join(f'{t:.5f}' for t in v)}, mean "
                f"{mean:.5f}; {100 * bound / mean:.1f}% of the {bound:.5f} ms bound ({by}); "
                f"event call_ms {', '.join(f'{t:.5f}' for t in calls[side])}")
        log(f"library {kind}: SDPA on gathered K/V device ms {lib:.5f}; plan {plan}")
        if TIMELINE[0] in libs:
            timeline(kind, sets, plan)

        # 4. other plans and the variants, in turns with the change
        entries = {"change": ("change", None)}
        for kc in PLAN_CHUNKS:
            chunks = -(-(MB * bs) // kc)
            for r in PLAN_RANKS:
                cpr = -(-chunks // min(r, chunks))
                ranks = -(-chunks // cpr)
                key = f"ranks {ranks} chunk {kc} cpr {cpr}"
                if (ranks, kc, cpr) != (plan.ranks, plan.chunk, plan.cpr):
                    entries.setdefault(key, ("change", (ranks, kc, cpr)))
        entries.update({name: (name, None) for name, _ in VARIANTS if name in libs})
        names = list(entries)[1:]
        order = ["change"] + names + names[::-1] + ["change"]
        got = {k: [] for k in entries}
        for k in order:
            n, p = entries[k]
            got[k].append(cs.cuda_ms(torch, [lambda st=st, n=n, p=p: run(n, st, p)
                                             for st in sets])["device_ms"])
        base = sum(got["change"]) / 2
        for k, v in got.items():
            mean = sum(v) / len(v)
            log(f"variant {kind} {k}: device ms {', '.join(f'{x:.5f}' for x in v)}, mean "
                f"{mean:.5f} ({100 * (mean - base) / base:+.1f}% against the change)")
        del sets
    log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
