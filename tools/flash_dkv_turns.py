#!/usr/bin/env python3
"""The flash attention kernels of this checkout against another commit's,
on one CUDA card, in turns — and where the bf16 forward's, dK/dV and dQ
kernels' time goes.

Run from the root of a checkout, with the other commit's kernel sources
unpacked beside it (any directory holding its ``flash_attention.cu`` and
the headers that file includes)::

    git archive <commit> distributed_tensorflow_tpu_torch/ops/csrc | tar -x -C other
    python3 tools/flash_dkv_turns.py other/distributed_tensorflow_tpu_torch/ops/csrc

It builds, one nvcc each, all started together: the other source ("parent"),
this checkout's ("change", through the port's own build) and copies of
this checkout's source with substitutions — for dK/dV its CTA shape (4 or
8 warps at both head dims), K and V fragments read by ldmatrix at every
use instead of held in registers, and four ablations (the exp2 and ds
arithmetic, the second pair of products, the ring's copies, the delta
pass); for the forward its CTA shape (64 rows x 4 warps, 128 x 4 with 32
rows a warp, 128 x 8), the depth of its K/V ring (2 or 3 stages), 128
keys a stage, and three ablations (the exp2 arithmetic, the P V product,
the ring's copies); for dQ its CTA shape at D=64 (64 rows x 4 warps with 64
keys a stage, 128 x 4 with 32 rows a warp and 32 keys, 128 x 8 with 64
keys), at D=128 64 keys a stage and 8 warps (128 rows) of 16 rows a
warp, and four ablations (the exp2 and ds arithmetic, the
dS K product, the ring's copies, the delta pass). An ablated copy computes
garbage and is timed only.
Each substituted text must occur exactly once in the source, or the tool
refuses to run. Then, at B=8 H=12 S=1024 D=64, causal, bf16
(``chip_smoke.flash_case``), and at D=128 with H=6 (the same width):

1. ptxas's registers and spills of every forward, dK/dV and dQ
   instantiation built;
2. dk, dv of "parent", "change" and the dK/dV layouts, out, lse of
   "parent", "change" and the forward layouts, and dq of "parent",
   "change" and the dQ shapes, against the plain version: relative L2
   error (out and dq also at D=128; lse as its largest absolute error),
   with and without a kv_mask, a dk, an out and a dq scaled by 1.01 beside
   them;
3. the forward, dK/dV and dQ with the parent's library and the change's,
   in turns (parent, change, change, parent), device ms by torch.profiler
   on inputs past L2 (``chip_smoke.cuda_ms``), with TFLOP/s and the share of
   ``chip_smoke.flash_bound_ms``, at D=64 and at D=128; SDPA's forward and
   its whole backward (dq, dk and dv in one autograd call) on the same
   inputs beside them (timed only);
4. each variant in turns with the change, CUDA events
   (``chip_smoke.event_ms``): dK/dV's at D=64 and its CTA shapes at D=128;
   the forward's at D=64 and its layouts at D=128; dQ's shapes and
   ablations at D=64 and its D=128 shapes at D=128.

The first and the last line name the card (``nvidia-smi``'s name and
power limit). Exits non-zero without a card or when a build fails.
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

_MMA2 = [("tile::mma_bf16(dva[j], pa[kk], bo[0], bo[1]);",
          "dva[j][0] += __uint_as_float(pa[kk][0] ^ bo[0]);"),
         ("tile::mma_bf16(dva[j + 1], pa[kk], bo[2], bo[3]);",
          "dva[j + 1][0] += __uint_as_float(pa[kk][1] ^ bo[2]);"),
         ("tile::mma_bf16(dka[j], da[kk], bq[0], bq[1]);",
          "dka[j][0] += __uint_as_float(da[kk][0] ^ bq[0]);"),
         ("tile::mma_bf16(dka[j + 1], da[kk], bq[2], bq[3]);",
          "dka[j + 1][0] += __uint_as_float(da[kk][1] ^ bq[2]);")]
_WARPS = "static constexpr int WARPS = D <= 64 ? 4 : 8;"
#: (name, [(text in this checkout's flash_attention.cu, its replacement)]):
#: the dK/dV kernel's layouts and ablations
LAYOUTS = [
    ("4 warps (64 keys) at both D", [(_WARPS, "static constexpr int WARPS = 4;")]),
    ("8 warps (128 keys) at both D", [(_WARPS, "static constexpr int WARPS = 8;")]),
    ("K, V by ldsm_x4 at every use", [("KV_REGS = D <= 64;", "KV_REGS = false;")]),
]
ABLATIONS = [
    ("without the exp2 and ds arithmetic",
     [("p[e] = ok ? exp2f(fmaf(st[j][e], sl2, -((e & 1) ? ls.y : ls.x))) : 0.f;",
       "p[e] = ok ? st[j][e] * sl2 : 0.f;")]),
    ("without the P^T dO and dS^T Q products", _MMA2),
    ("without the ring's copies (stale stages)",
     [("    load_tile_async(i + 2);\n", "    tile::cp_async_commit();\n")]),
    ("without the delta pass (stale delta)", [("    row_pass(i + 1);\n", "")]),
]
_FWD_WARPS = "static constexpr int WARPS = 4;                 // warps of a forward CTA"
_FWD_MI = "static constexpr int MI = D <= 64 ? 2 : 1;      // 16-row groups of a warp"
_FWD_STAGES = "static constexpr int STAGES = D == 128 ? 2 : 3;  // depth of the K, V ring"
_FWD_BN = "static constexpr int BN = D <= 128 ? 64 : 32;   // keys of a ring stage"
#: the forward kernel's layouts (timed at both head dims) and ablations
FWD_LAYOUTS = [
    ("fwd 64 rows x 4 warps at both D", [(_FWD_WARPS, "static constexpr int WARPS = 4;"),
                                         (_FWD_MI, "static constexpr int MI = 1;")]),
    ("fwd 128 rows x 4 warps (32 a warp) at both D",
     [(_FWD_WARPS, "static constexpr int WARPS = 4;"), (_FWD_MI, "static constexpr int MI = 2;")]),
    ("fwd 128 rows x 8 warps at both D", [(_FWD_WARPS, "static constexpr int WARPS = 8;"),
                                          (_FWD_MI, "static constexpr int MI = 1;")]),
    ("fwd 2 stages at both D", [(_FWD_STAGES, "static constexpr int STAGES = 2;")]),
    ("fwd 3 stages at both D", [(_FWD_STAGES, "static constexpr int STAGES = 3;")]),
    ("fwd 128 keys a stage", [(_FWD_BN, "static constexpr int BN = 128;")]),
]
FWD_ABLATIONS = [
    ("fwd without the exp2 arithmetic",
     [("p[e] = exp2f(fmaf(s[mi][j][e], sl2, -m[mi][e >> 1]));", "p[e] = s[mi][j][e] * sl2;")]),
    ("fwd without the P V product",
     [("tile::mma_bf16(o[mi][j], pa[mi][kk], vb[0], vb[1]);",
       "o[mi][j][0] += __uint_as_float(pa[mi][kk][0] ^ vb[0]);"),
      ("tile::mma_bf16(o[mi][j + 1], pa[mi][kk], vb[2], vb[3]);",
       "o[mi][j + 1][0] += __uint_as_float(pa[mi][kk][1] ^ vb[2]);")]),
    ("fwd without the ring's copies (stale stages)",
     [("    load_kv_async(i + S::STAGES - 1);\n", "    tile::cp_async_commit();\n")]),
]
_DQ_WARPS = "static constexpr int WARPS = 4;                 // warps of a dQ CTA"
_DQ_MI = "static constexpr int MI = D <= 64 ? 2 : 1;      // 16-row groups of a dQ warp"
_DQ_BN = "static constexpr int BN = 32;                   // keys of a dQ ring stage"
#: the dQ kernel's CTA shapes (timed at D=64), its shapes timed at D=128, and
#: its ablations
DQ_LAYOUTS = [
    ("dq 64 rows x 4 warps, 64 keys a stage",
     [(_DQ_WARPS, "static constexpr int WARPS = 4;"), (_DQ_MI, "static constexpr int MI = 1;"),
      (_DQ_BN, "static constexpr int BN = 64;")]),
    ("dq 128 rows x 4 warps (32 a warp), 32 keys a stage",
     [(_DQ_WARPS, "static constexpr int WARPS = 4;"), (_DQ_MI, "static constexpr int MI = 2;"),
      (_DQ_BN, "static constexpr int BN = 32;")]),
    ("dq 128 rows x 8 warps, 64 keys a stage",
     [(_DQ_WARPS, "static constexpr int WARPS = 8;"), (_DQ_MI, "static constexpr int MI = 1;"),
      (_DQ_BN, "static constexpr int BN = 64;")]),
]
DQ_LAYOUTS_128 = [
    ("dq 64 keys a stage", [(_DQ_BN, "static constexpr int BN = 64;")]),
    ("dq 8 warps (128 rows) at D=128", [(_DQ_WARPS, "static constexpr int WARPS = 8;")]),
]
DQ_ABLATIONS = [
    ("dq without the exp2 and ds arithmetic",
     [("float p = exp2f(fmaf(s[mi][j][e], sl2, -l2[mi][e >> 1]));",
       "float p = s[mi][j][e] * sl2;"),
      ("ds[e] = p * (dp[mi][j][e] - dl[mi][e >> 1]) * scale;", "ds[e] = p + dp[mi][j][e];")]),
    ("dq without the dS K product",
     [("tile::mma_bf16(dqa[mi][j], da[mi][kk], kb[0], kb[1]);",
       "dqa[mi][j][0] += __uint_as_float(da[mi][kk][0] ^ kb[0]);"),
      ("tile::mma_bf16(dqa[mi][j + 1], da[mi][kk], kb[2], kb[3]);",
       "dqa[mi][j + 1][0] += __uint_as_float(da[mi][kk][1] ^ kb[2]);")]),
    ("dq without the ring's copies (stale stages)",
     [("    copy_kv(i + S::STAGES - 1);\n", "    tile::cp_async_commit();\n")]),
    ("dq without the delta pass (stale delta)",
     [("  row_pass();\n",
       "  for (int mi = 0; mi < MI; ++mi)\n"
       "    dl[mi][0] = dl[mi][1] = l2[mi][0] = l2[mi][1] = ls;\n")]),
]
VARIANTS = (LAYOUTS + ABLATIONS + FWD_LAYOUTS + FWD_ABLATIONS + DQ_LAYOUTS + DQ_LAYOUTS_128
            + DQ_ABLATIONS)


def substitute(src: str, name: str, subs) -> str:
    """``src`` with each (old, new) of ``subs`` applied in turn; refuses a
    text that does not occur exactly once (a replacement of every
    occurrence would change lines shared by two kernels)."""
    for old, new in subs:
        n = src.count(old)
        if n != 1:
            raise SystemExit(f"flash_dkv_turns: {name!r}: the source holds {old!r} {n} times, "
                             f"not once")
        src = src.replace(old, new)
    return src

def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    if len(sys.argv) != 2 or not os.path.exists(os.path.join(sys.argv[1],
                                                             "flash_attention.cu")):
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_dkv_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    card = cs.nvidia_smi_line()
    log(f"card: {card}")
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        src = f.read()
    sources = {"parent": os.path.join(os.path.abspath(sys.argv[1]), "flash_attention.cu")}
    work = os.path.join(_build.BUILD_DIR, "turns")
    for name, subs in VARIANTS:
        text = substitute(src, name, subs)
        d = os.path.join(work, re.sub(r"\W+", "_", name))
        os.makedirs(d, exist_ok=True)
        for h in os.listdir(_build.CSRC):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(_build.CSRC, h), d)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(text)
        sources[name] = os.path.join(d, "flash_attention.cu")
    t0 = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    jobs = {n: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", os.path.join(work, f"{i}.so"), cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (n, cu) in enumerate(sources.items())}
    libs = {"change": _build.load("flash_attention")}
    reports = {"change": _build.build_all(("flash_attention",))["flash_attention"]}
    for i, (n, p) in enumerate(jobs.items()):
        reports[n], _ = p.communicate()
        if p.returncode:
            log(f"build of {n!r} failed:\n{reports[n][-4000:]}")
            return 1
        lib = ctypes.CDLL(os.path.join(work, f"{i}.so"))
        for fn, argtypes in _build.SIGNATURES["flash_attention"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.dtf_error_string.argtypes = [ctypes.c_int]
        lib.dtf_error_string.restype = ctypes.c_char_p
        libs[n] = lib
    log(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")

    # 1. ptxas: registers and spills of each forward, dK/dV and dQ instantiation
    for n, rep in reports.items():
        lines = rep.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Function properties for (\S*(flash_bwd_dkv|flash_fwd|flash_bwd_dq)\S*)",
                          line)
            if m:
                info = " | ".join(x.strip() for x in lines[i + 1:i + 3])
                kind = "f32" if "_f32_" in m.group(1) or "IfLi" in m.group(1) else "bf16"
                d = "128" if "Li128E" in m.group(1) else "64"
                log(f"ptxas {n}: {m.group(2)} {kind} D={d}: {info}")

    def use(n):
        _build._libs["flash_attention"] = libs[n]

    rng = np.random.default_rng(11)

    # 2. dk, dv and out, lse against the plain version
    for masked in (False, True):
        c = cs.flash_case(torch, np, rng, torch.bfloat16, masked)
        args = (c["q"], c["k"], c["v"], c["mask"])
        tag = "kv_mask" if masked else "no mask"
        use("change")
        out, lse = fa.flash_fwd(*args, causal=True)
        want = fa.flash_attention_bwd_plain(*args, out, lse, c["dout"], causal=True)
        for n in ["parent", "change"] + [name for name, _ in LAYOUTS]:
            use(n)
            dk, dv = fa.flash_bwd_dkv(*args, out, lse, c["dout"], causal=True)
            log(f"relative L2 {n} ({tag}): dk "
                f"{cs.rel_l2(dk, want[1]):.3e}, dv {cs.rel_l2(dv, want[2]):.3e}; dk x 1.01 "
                f"{cs.rel_l2(dk.float() * 1.01, want[1]):.3e}")
    for H, D, shapes in ((12, 64, DQ_LAYOUTS), (6, 128, DQ_LAYOUTS_128)):
        for masked in (False, True):
            c = cs.flash_case(torch, np, rng, torch.bfloat16, masked, H=H, D=D)
            args = (c["q"], c["k"], c["v"], c["mask"])
            use("change")
            out, lse = fa.flash_fwd(*args, causal=True)
            want = fa.flash_attention_bwd_plain(*args, out, lse, c["dout"], causal=True)[0]
            for n in ["parent", "change"] + [name for name, _ in shapes]:
                use(n)
                dq = fa.flash_bwd_dq(*args, out, lse, c["dout"], causal=True)
                log(f"relative L2 D={D} {n} ({'kv_mask' if masked else 'no mask'}): dq "
                    f"{cs.rel_l2(dq, want):.3e}; dq x 1.01 "
                    f"{cs.rel_l2(dq.float() * 1.01, want):.3e}")
            want_out, want_lse = fa.flash_attention_plain(*args, causal=True)
            for n in ["parent", "change"] + [name for name, _ in FWD_LAYOUTS]:
                use(n)
                out, lse = fa.flash_fwd(*args, causal=True)
                log(f"forward D={D} {n} ({'kv_mask' if masked else 'no mask'}): out relative L2 "
                    f"{cs.rel_l2(out, want_out):.3e} (out x 1.01 "
                    f"{cs.rel_l2(out.float() * 1.01, want_out):.3e}), lse max abs err "
                    f"{float((lse - want_lse).abs().max()):.3e}")

    def case_sets(**kw):
        c = cs.flash_case(torch, np, rng, torch.bfloat16, False, **kw)
        size = c["q"].numel() * c["q"].element_size()
        sets = [c] + [cs.flash_case(torch, np, rng, torch.bfloat16, False, **kw)
                      for _ in range(cs.copies_for(5 * size) - 1)]
        use("change")
        for st in sets:
            st["out"], st["lse"] = fa.flash_fwd(st["q"], st["k"], st["v"], None, causal=True)
        qkv = lambda st: (st["q"], st["k"], st["v"], None)  # noqa: E731
        bwd = lambda st: (*qkv(st), st["out"], st["lse"], st["dout"])  # noqa: E731
        fns = {"flash_fwd": [lambda st=st: fa.flash_fwd(*qkv(st), causal=True) for st in sets],
               "flash_bwd_dkv": [lambda st=st: fa.flash_bwd_dkv(*bwd(st), causal=True)
                                 for st in sets],
               "flash_bwd_dq": [lambda st=st: fa.flash_bwd_dq(*bwd(st), causal=True)
                                for st in sets]}
        sdpa = [lambda st=st: F.scaled_dot_product_attention(st["q"], st["k"], st["v"],
                                                             is_causal=True) for st in sets]
        graphs = []
        for st in sets:
            leaves = [t.detach().requires_grad_() for t in (st["q"], st["k"], st["v"])]
            graphs.append((F.scaled_dot_product_attention(*leaves, is_causal=True), leaves,
                           st["dout"]))
        sdpa_bwd = [lambda g=g: torch.autograd.grad(g[0], g[1], g[2], retain_graph=True)
                    for g in graphs]
        B, H, S, D = c["q"].shape
        # 2 D operations a pair and product
        return c, fns, sdpa, sdpa_bwd, S * (S + 1) // 2 * B * H * 2 * D

    # 3. parent against change, in turns, at D=64 (all three) and D=128
    products = {"flash_fwd": 2, "flash_bwd_dkv": 4, "flash_bwd_dq": 3}
    kinds = {"flash_fwd": "fwd", "flash_bwd_dkv": "dkv", "flash_bwd_dq": "dq"}
    turns = ("parent", "change", "change", "parent")
    fns_at = {}
    for label, kw in (("D=64", {}), ("D=128 H=6", {"H": 6, "D": 128})):
        names = list(products)
        c, fns, sdpa, sdpa_bwd, per_product = case_sets(**kw)
        fns_at[label] = fns
        ms = {(side, k): [] for side in turns for k in names}
        for side in turns:
            use(side)
            for k in names:
                ms[(side, k)].append(cs.cuda_ms(torch, fns[k], iters=20)["device_ms"])
        lib = cs.cuda_ms(torch, sdpa, iters=20)["device_ms"]
        lib_bwd = cs.cuda_ms(torch, sdpa_bwd, iters=20)["device_ms"]
        for k in names:
            bound = cs.flash_bound_ms(torch, c, kinds[k], "bfloat16")[0]
            for side in ("parent", "change"):
                v = ms[(side, k)]
                mean = sum(v) / len(v)
                log(f"turns {label} {k} {side}: device ms {', '.join(f'{x:.5f}' for x in v)}, "
                    f"mean {mean:.5f}; {products[k] * per_product / mean / 1e9:.1f} TFLOP/s; "
                    f"{100 * bound / mean:.1f}% of the {bound:.5f} ms bound")
        log(f"SDPA forward {label}: device ms {lib:.5f}, "
            f"{2 * per_product / lib / 1e9:.1f} TFLOP/s")
        pair = {side: sum(sum(ms[(side, k)]) / len(ms[(side, k)])
                          for k in ("flash_bwd_dkv", "flash_bwd_dq"))
                for side in ("parent", "change")}
        log(f"SDPA whole backward {label}: device ms {lib_bwd:.5f}; dK/dV + dQ parent "
            f"{pair['parent']:.5f} ({pair['parent'] / lib_bwd:.2f}x), change "
            f"{pair['change']:.5f} ({pair['change'] / lib_bwd:.2f}x)")

    # 4. the variants in turns with the change, CUDA events
    for label, fns, names in (
            ("dkv D=64", fns_at["D=64"]["flash_bwd_dkv"], [n for n, _ in LAYOUTS + ABLATIONS]),
            ("dkv D=128 H=6", fns_at["D=128 H=6"]["flash_bwd_dkv"], [n for n, _ in LAYOUTS[:2]]),
            ("fwd D=64", fns_at["D=64"]["flash_fwd"], [n for n, _ in FWD_LAYOUTS + FWD_ABLATIONS]),
            ("fwd D=128 H=6", fns_at["D=128 H=6"]["flash_fwd"], [n for n, _ in FWD_LAYOUTS]),
            ("dq D=64", fns_at["D=64"]["flash_bwd_dq"],
             [n for n, _ in DQ_LAYOUTS + DQ_ABLATIONS]),
            ("dq D=128 H=6", fns_at["D=128 H=6"]["flash_bwd_dq"],
             [n for n, _ in DQ_LAYOUTS_128])):
        order = ["change"] + names + names[::-1] + ["change"]
        ev = {n: [] for n in order}
        for n in order:
            use(n)
            ev[n].append(cs.event_ms(torch, fns, iters=40))
        base = sum(ev["change"]) / 2
        for n, v in ev.items():
            mean = sum(v) / len(v)
            log(f"variant {label} {n}: event ms {', '.join(f'{x:.5f}' for x in v)}, mean "
                f"{mean:.5f} ({100 * (mean - base) / base:+.1f}% against the change)")
    log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
