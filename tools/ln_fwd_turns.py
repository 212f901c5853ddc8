#!/usr/bin/env python3
"""The serving LN+matmul forward (``ln_matmul_kernel``, below
``LN_TILED_MIN_M`` rows) of this checkout against another commit's, on one
CUDA card, in turns — and what bounds this checkout's kernel.

Run from the root of a checkout, with the other commit's kernel sources
unpacked beside it (any directory holding its ``ln_matmul.cu`` and the
headers that file includes)::

    git archive <commit> distributed_tensorflow_tpu_torch/ops/csrc | tar -x -C other
    python3 tools/ln_fwd_turns.py other/distributed_tensorflow_tpu_torch/ops/csrc

It builds, one nvcc each, all started together: the other source
("parent", launched through its own C entry: the first serving design
takes no plan), this checkout's ("change", through the port's own build)
and copies of this checkout's source with substitutions — ablations (the
sum over the cluster's ranks, the LN pass with its cluster barrier, both,
the w slice's loads, all of these: what is left is the launch, the
barriers, the x and bias loads and the stores), w restaged in 32-deep
tiles one at a time, as the first design staged it, and 32-column tiles
(two warps a CTA). An ablated copy computes garbage and is timed only.
Each substituted text must occur exactly once in the source, or the tool
refuses to run.
Then, bf16, d=768, w the nn.Linear weight's view, on inputs drawn on the
card:

1. ptxas's registers and spills of every serving-kernel instantiation;
2. y of "parent", "change" and the variants that compute y against the
   plain version at M=8, n=3072: relative L2 error (and a y x 1.01 beside
   it);
3. parent and change in turns (parent, change, change, parent), device ms
   by torch.profiler (``chip_smoke.cuda_ms``), at each of phase 2b's
   serving shapes (``chip_smoke.LN_SERVE_M`` x n = 768, 3072; enough
   input sets to exceed L2), with the share of ``chip_smoke.ln_bound_ms``
   and ``layer_norm`` + ``linear`` beside each; then a serve step's
   LN+matmul at decode (3 launches at n=768 and 1 at n=3072 a layer);
4. at three shapes, each split of ``SPLITS`` (the change's kernel at
   another split than ``rows_plan``'s) and each variant in turns with the
   change (the change first and last), device ms.

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

_W_SLICE = "  rows_load_w<TIn>(Ws, L.ldw, w, sk, sn, d, n, k0, n0, L.dS, vec_w);\n"
_NO_W = (_W_SLICE, "  (void)vec_w;\n")
#: the first design's staging: w's slice in 32-deep tiles, each loaded and
#: waited for before its product
_RESTAGED = [(_W_SLICE, ""), ("  product(0, L.dS);\n", """\
  for (int ka = 0; ka < L.dS; ka += 32) {
    const int kb = min(ka + 32, L.dS);
    rows_load_w<TIn>(Ws + (n_contig ? ka * L.ldw : ka), L.ldw, w, sk, sn, d, n, k0 + ka, n0,
                     kb - ka, vec_w);
    tile::cp_async_commit();
    tile::cp_async_wait<0>();
    __syncthreads();
    product(ka, kb);
  }
""")]
#: variants that compute y (checked against the plain version in step 2)
EXACT = ("w restaged in 32-deep tiles", "32 columns")
#: (name, [(text in this checkout's ln_matmul.cu, its replacement)])
VARIANTS = [
    ("without the cluster sum", [("constexpr bool RW_CLUSTER_SUM = true;",
                                  "constexpr bool RW_CLUSTER_SUM = false;")]),
    ("without the LN pass", [("constexpr bool RW_LN_PASS = true;",
                              "constexpr bool RW_LN_PASS = false;")]),
    ("without both", [("constexpr bool RW_CLUSTER_SUM = true;",
                       "constexpr bool RW_CLUSTER_SUM = false;"),
                      ("constexpr bool RW_LN_PASS = true;",
                       "constexpr bool RW_LN_PASS = false;")]),
    ("w restaged in 32-deep tiles", _RESTAGED),
    ("32 columns", [("constexpr int RW_THREADS = 128;", "constexpr int RW_THREADS = 64;"),
                    ("constexpr int RW_COLS = 64;", "constexpr int RW_COLS = 32;")]),
    ("without the w slice", [_NO_W]),
    ("the launch, barriers and stores alone", [
        _NO_W, ("constexpr bool RW_CLUSTER_SUM = true;", "constexpr bool RW_CLUSTER_SUM = false;"),
        ("constexpr bool RW_LN_PASS = true;", "constexpr bool RW_LN_PASS = false;")]),
]
#: step 4's shapes (M, n) and the splits of d=768 timed at each
VARIANT_SHAPES = [(8, 3072), (8, 768), (64, 3072)]
SPLITS = (1, 2, 4, 8)
#: the parent's serving entry: x, gamma, beta, w, bias, y; M, d, n, sk, sn;
#: eps, stream
PARENT_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_void_p)


def substitute(src: str, name: str, subs) -> str:
    """``src`` with each (old, new) of ``subs`` applied in turn; refuses a
    text that does not occur exactly once."""
    for old, new in subs:
        n = src.count(old)
        if n != 1:
            raise SystemExit(f"ln_fwd_turns: {name!r}: the source holds {old!r} {n} times, "
                             f"not once")
        src = src.replace(old, new)
    return src


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    if len(sys.argv) != 2 or not os.path.exists(os.path.join(sys.argv[1], "ln_matmul.cu")):
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("ln_fwd_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_ln_matmul as fln

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    log(f"card: {card}")
    with open(os.path.join(_build.CSRC, "ln_matmul.cu")) as f:
        src = f.read()
    sources = {"parent": os.path.join(os.path.abspath(sys.argv[1]), "ln_matmul.cu")}
    work = os.path.join(_build.BUILD_DIR, "ln_turns")
    for name, subs in VARIANTS:
        text = substitute(src, name, subs)
        d = os.path.join(work, re.sub(r"\W+", "_", name))
        os.makedirs(d, exist_ok=True)
        for h in os.listdir(_build.CSRC):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(_build.CSRC, h), d)
        with open(os.path.join(d, "ln_matmul.cu"), "w") as f:
            f.write(text)
        sources[name] = os.path.join(d, "ln_matmul.cu")
    t0 = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    jobs = {n: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", os.path.join(work, f"ln{i}.so"), cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (n, cu) in enumerate(sources.items())}
    libs = {"change": _build.load("ln_matmul")}
    reports = {"change": _build.build_all(("ln_matmul",))["ln_matmul"]}
    sig = _build.SIGNATURES["ln_matmul"]
    for i, (n, p) in enumerate(jobs.items()):
        reports[n], _ = p.communicate()
        if p.returncode:
            log(f"build of {n!r} failed:\n{reports[n][-4000:]}")
            if n == "parent":
                return 1
            continue
        lib = ctypes.CDLL(os.path.join(work, f"ln{i}.so"))
        for fn, argtypes in sig.items():
            if n == "parent" and fn in ("ln_matmul_f32", "ln_matmul_bf16", "ln_matmul_bf16_f32"):
                argtypes = PARENT_ARGS
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.dtf_error_string.argtypes = [ctypes.c_int]
        lib.dtf_error_string.restype = ctypes.c_char_p
        libs[n] = lib
    log(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")

    # 1. ptxas: registers and spills of each serving-kernel instantiation
    for n, rep in reports.items():
        lines = rep.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Function properties for (\S*16ln_matmul_kernel\S*)", line)
            if m:
                info = " | ".join(x.strip() for x in lines[i + 1:i + 3])
                log(f"ptxas {n}: {m.group(1)}: {info}")

    sms = fln._sms(torch.device("cuda"))

    def fwd(n, c, split=None):
        """One serving forward with library ``n`` on case ``c``: the change
        and its variants through the wrapper (``rows_plan``'s split) or,
        given ``split``, through the C entry at that split; the parent
        through its own entry, which takes no plan."""
        x, g, b, w, bias = c["x"], c["gamma"], c["beta"], c["w"], c["bias"]
        if n != "parent" and split is None:
            _build._libs["ln_matmul"] = libs[n]
            return fln._launch_fwd_rows(x, g, b, w, bias, 1e-6, x.dtype)
        M, d = x.shape
        y = torch.empty(M, w.shape[1], dtype=x.dtype, device=x.device)
        _build.launch(libs[n], "ln_matmul_bf16", f"{n} ln_matmul", x.device, x.data_ptr(),
                      g.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
                      M, d, w.shape[1], *w.stride(), *(() if split is None else (split,)), 1e-6)
        return y

    rng = np.random.default_rng(16)
    bf16, d = torch.bfloat16, 768

    def case_sets(M, n):
        return [cs.ln_case(torch, np, rng, M, d, n, bf16)
                for _ in range(cs.copies_for(2 * (M * d + d * n + M * n)))]

    # 2. y against the plain version
    c = cs.ln_case(torch, np, rng, 8, d, 3072, bf16)
    want = fln.ln_matmul_plain(c["x"], c["gamma"], c["beta"], c["w"], c["bias"])
    for n in ("parent", "change", *(v for v in EXACT if v in libs)):
        y = fwd(n, c)
        log(f"relative L2 {n} at M=8 n=3072: y {cs.rel_l2(y, want):.3e} "
            f"(y x 1.01 {cs.rel_l2(y.float() * 1.01, want):.3e})")
    _build._libs["ln_matmul"] = libs["change"]

    # 3. parent against change, in turns, at phase 2b's serving shapes
    turns = ("parent", "change", "change", "parent")
    decode = dict.fromkeys(("parent", "change", "library"), 0.0)
    for n in (768, 3072):
        for M in cs.LN_SERVE_M:
            sets = case_sets(M, n)
            ms = {side: [] for side in ("parent", "change")}
            for side in turns:
                t = cs.cuda_ms(torch, [lambda s=s, side=side: fwd(side, s) for s in sets])
                ms[side].append(t["device_ms"])
            lib_in = [(s["x"], s["gamma"].to(bf16), s["beta"].to(bf16), s["w"].t(),
                       s["bias"].to(bf16)) for s in sets]
            lib = cs.cuda_ms(torch, [lambda a=a: F.linear(F.layer_norm(
                a[0], (d,), a[1], a[2], 1e-6), a[3], a[4]) for a in lib_in])["device_ms"]
            bound, by = cs.ln_bound_ms(sets[0], "bfloat16")
            plan = fln.rows_plan(M, d, n, sms)
            tag = f"M={M} n={n} (split {plan.split})"
            for side, v in ms.items():
                mean = sum(v) / len(v)
                if M == 4:  # the smoke's decode: 4 slots
                    decode[side] += (3 if n == 768 else 1) * mean
                log(f"turns {tag} {side}: device ms {', '.join(f'{t:.5f}' for t in v)}, mean "
                    f"{mean:.5f}; {100 * bound / mean:.1f}% of the {bound:.5f} ms bound ({by})")
            if M == 4:
                decode["library"] += (3 if n == 768 else 1) * lib
            log(f"library {tag}: layer_norm + linear device ms {lib:.5f}")
            del sets
    log("a serve step's LN+matmul at decode, M=4 (3 launches at n=768 + 1 at n=3072 a layer, "
        "12 layers; device ms): " + ", ".join(f"{k} {12 * v:.4f}" for k, v in decode.items()))

    # 4. plans and variants in turns with the change
    for M, n in VARIANT_SHAPES:
        sets = case_sets(M, n)
        entries = {"change": ("change", None)}
        for s in SPLITS:
            if (s - 1) * fln._slice(d, s) < d:
                entries[f"split {s}"] = ("change", s)
        entries.update({name: (name, None) for name, _ in VARIANTS if name in libs})
        names = list(entries)[1:]
        order = ["change"] + names + names[::-1] + ["change"]
        got = {k: [] for k in entries}
        for k in order:
            lib, split = entries[k]
            got[k].append(cs.cuda_ms(torch, [lambda st=st, lib=lib, split=split: fwd(lib, st, split)
                                             for st in sets])["device_ms"])
        base = sum(got["change"]) / 2
        for k, v in got.items():
            mean = sum(v) / len(v)
            log(f"variant M={M} n={n} {k}: device ms {', '.join(f'{x:.5f}' for x in v)}, mean "
                f"{mean:.5f} ({100 * (mean - base) / base:+.1f}% against the change)")
        del sets
    log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
