#!/usr/bin/env python3
"""The conv+BN forward kernel of this checkout against another commit's,
on one CUDA card, in turns — and what bounds this checkout's forward.

Run from the root of a checkout, with the other commit's kernel sources
unpacked beside it (any directory holding its ``fused_conv_bn.cu`` and the
headers that file includes)::

    git archive <commit> distributed_tensorflow_tpu_torch/ops/csrc | tar -x -C other
    python3 tools/conv_fwd_turns.py other/distributed_tensorflow_tpu_torch/ops/csrc

It builds, one nvcc each, all started together: the other source
("parent"), this checkout's ("change", through the port's own build) and
copies of this checkout's source with substitutions — its levers (w's
tile restaged with every tile instead of resident in shared memory when cin
fits one stage; y stored in two-column stores from the registers instead
of through a per-warp shared buffer; a ring of 2 or 3 stages), and three
ablations (the prologue pass and its barrier, the statistics, the y
stores from the shared buffer). An ablated copy computes garbage and is timed
only. Each substituted text must occur exactly once in the source, or the
tool refuses to run. A parent without ``conv_bn_fwd_tile`` is launched as
the first forward design was: its C entry without the tile width, G from
1056 resident CTAs over 64 x 64 tiles. Then, bf16, on inputs drawn on the card
(w the OIHW weight's view, the bn+relu prologue where the step has it):

1. ptxas's registers and spills of every forward instantiation built;
2. y and the statistics of "parent", "change" and each lever against the
   plain forward at the main shape (M=802816 64->256, prologue): relative
   L2 error;
3. the forward with the parent's library and the change's, in turns
   (parent, change, change, parent), device ms by torch.profiler
   (``chip_smoke.cuda_ms``, split into product and reduction), at each of
   the sixteen shapes of a ResNet-50 step's 36 forward launches at batch
   256 (``chip_smoke.CONV_BN_FWD_SWEEP``; enough input sets to exceed L2),
   with TFLOP/s, the share of ``chip_smoke.conv_bn_bound_ms`` and the
   launch-weighted step totals; ``x@w`` in ``torch.matmul`` beside each;
4. at the main shape, at stage 0's 256->64 and at stage 3's 512->2048
   (prologue), each width of ``fwd_plan`` and each variant in turns with
   the change, CUDA events (``chip_smoke.event_ms``).

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

_STAGES = "static constexpr int STAGES = sizeof(T) == 2 ? (FIT < 4 ? FIT : 4) : 2;"
#: (name, [(text in this checkout's fused_conv_bn.cu, its replacement)]):
#: the forward kernel's levers
LEVERS = [
    ("w restaged", [("static constexpr bool W_RESIDENT = true;",
                     "static constexpr bool W_RESIDENT = false;")]),
    ("y in two-column stores", [("static constexpr bool Y_VIA_SMEM = true;",
                                 "static constexpr bool Y_VIA_SMEM = false;")]),
    ("2 stages", [(_STAGES, "static constexpr int STAGES = 2;")]),
    ("3 stages", [(_STAGES, "static constexpr int STAGES = sizeof(T) == 2 ? "
                            "(FIT < 3 ? FIT : 3) : 2;")]),
]
ABLATIONS = [
    ("without the prologue pass",
     [("if (m0 + r < M) h_chunk(As + r * S::LDA + hcol, sc, sh, pro.relu);", "(void)r;"),
      ("      __syncthreads();  // h is whole\n", "")]),
    ("without the statistics",
     [("          if (stats) {\n            su[j][0] += v0, su[j][1] += v1;\n"
       "            sq[j][0] += v0 * v0, sq[j][1] += v1 * v1;\n          }\n", "")]),
    ("without the y stores",
     [("          if (row < M && col < cout)\n            *reinterpret_cast<uint4*>(y + ",
       "          if (false)\n            *reinterpret_cast<uint4*>(y + ")]),
]
VARIANTS = LEVERS + ABLATIONS
#: the shapes of step 4: (M, cin, cout, prologue)
VARIANT_SHAPES = [(802816, 64, 256, True), (802816, 256, 64, False), (12544, 512, 2048, True)]
#: the first forward design's grid: CTAs it aims to keep resident, and its
#: tile edge
FIRST_RESIDENT_CTAS, FIRST_TILE = 1056, 64


def substitute(src: str, name: str, subs) -> str:
    """``src`` with each (old, new) of ``subs`` applied in turn; refuses a
    text that does not occur exactly once (a replacement of every
    occurrence would change lines shared by two kernels)."""
    for old, new in subs:
        n = src.count(old)
        if n != 1:
            raise SystemExit(f"conv_fwd_turns: {name!r}: the source holds {old!r} {n} times, "
                             f"not once")
        src = src.replace(old, new)
    return src


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    if len(sys.argv) != 2 or not os.path.exists(os.path.join(sys.argv[1], "fused_conv_bn.cu")):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("conv_fwd_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    log(f"card: {card}")
    with open(os.path.join(_build.CSRC, "fused_conv_bn.cu")) as f:
        src = f.read()
    parent_cu = os.path.join(os.path.abspath(sys.argv[1]), "fused_conv_bn.cu")
    with open(parent_cu) as f:
        parent_tiled = "conv_bn_fwd_tile" in f.read()
    sources = {"parent": parent_cu}
    work = os.path.join(_build.BUILD_DIR, "turns")
    for name, subs in VARIANTS:
        text = substitute(src, name, subs)
        d = os.path.join(work, re.sub(r"\W+", "_", name))
        os.makedirs(d, exist_ok=True)
        for h in os.listdir(_build.CSRC):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(_build.CSRC, h), d)
        with open(os.path.join(d, "fused_conv_bn.cu"), "w") as f:
            f.write(text)
        sources[name] = os.path.join(d, "fused_conv_bn.cu")
    t0 = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    jobs = {n: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", os.path.join(work, f"fwd{i}.so"), cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (n, cu) in enumerate(sources.items())}
    libs = {"change": _build.load("fused_conv_bn")}
    reports = {"change": _build.build_all(("fused_conv_bn",))["fused_conv_bn"]}
    sig = dict(_build.SIGNATURES["fused_conv_bn"])
    for i, (n, p) in enumerate(jobs.items()):
        reports[n], _ = p.communicate()
        if p.returncode:
            log(f"build of {n!r} failed:\n{reports[n][-4000:]}")
            if n == "parent":
                return 1
            continue
        lib = ctypes.CDLL(os.path.join(work, f"fwd{i}.so"))
        for fn, argtypes in sig.items():
            if n == "parent" and not parent_tiled and fn.startswith("conv_bn_fwd"):
                if fn == "conv_bn_fwd_tile":
                    continue
                # the first design's entry: the same arguments without the tile width
                argtypes = argtypes[:14] + argtypes[15:]
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.dtf_error_string.argtypes = [ctypes.c_int]
        lib.dtf_error_string.restype = ctypes.c_char_p
        libs[n] = lib
    log(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")

    # 1. ptxas: registers and spills of each forward instantiation
    for n, rep in reports.items():
        lines = rep.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Function properties for (\S*conv_bn_fwd_kernel\S*)", line)
            if m:
                info = " | ".join(x.strip() for x in lines[i + 1:i + 3])
                log(f"ptxas {n}: {m.group(1)}: {info}")

    sms = fcb._sms(torch.device("cuda"))

    def fwd(n, c, width=None):
        """One forward call with library ``n`` on case ``c``: the change's
        (and every variant's) at ``fwd_plan`` (or at one ``width``), a
        parent without the tile entry at the first design's grid."""
        x, w, sc, sh = c["x"], c["w"], c["scale"], c["shift"]
        M, cin = x.shape
        cout = w.shape[1]
        _build._libs["fused_conv_bn"] = libs[n]
        if n != "parent" or parent_tiled:
            widths = (width,) if width else fcb.FWD_WIDTHS
            tile = tuple(libs[n].conv_bn_fwd_tile(i) for i in range(2))
            rows_m, per_sm = tile
            bn = fcb._width(cout, widths)
            G = max(1, min(-(-M // rows_m), per_sm * sms // -(-cout // bn)))
            return fcb._launch_fwd(x, w, sc, sh, True, True, {"tile": (rows_m, bn), "G": G})
        tiles = -(-cout // FIRST_TILE)
        G = max(1, min(-(-M // FIRST_TILE), -(-FIRST_RESIDENT_CTAS // tiles)))
        y = torch.empty(M, cout, dtype=x.dtype, device=x.device)
        ws = torch.empty(2 * G * cout, dtype=torch.float32, device=x.device)
        s, q = (torch.empty(cout, dtype=torch.float32, device=x.device) for _ in range(2))
        sk, sn = w.stride()
        rc = libs[n].conv_bn_fwd_bf16(
            x.data_ptr(), w.data_ptr(), sk, sn, sc.data_ptr() if sc is not None else None,
            sh.data_ptr() if sh is not None else None, y.data_ptr(), ws.data_ptr(),
            s.data_ptr(), q.data_ptr(), M, cin, cout, G, int(sc is not None), 1, 1,
            torch.cuda.current_stream().cuda_stream)
        _build.check(libs[n], rc, "parent conv_bn_fwd")
        return y, s, q

    gen = torch.Generator(device="cuda").manual_seed(12)

    def case(M, cin, cout, prologue):
        def f(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        return dict(x=f(M, cin).to(torch.bfloat16),
                    w=(f(cout, cin) / cin ** 0.5).to(torch.bfloat16).t(),
                    scale=1 + 0.2 * f(cin) if prologue else None,
                    shift=0.2 * f(cin) if prologue else None)

    def case_sets(M, cin, cout, prologue):
        first = case(M, cin, cout, prologue)
        size = first["x"].numel() * 2 + M * cout * 2
        return [first] + [case(M, cin, cout, prologue) for _ in range(cs.copies_for(size) - 1)]

    # 2. y and the statistics against the plain forward at the main shape
    main = cs.CONV_BN_MAIN["conv_bn_fwd"]
    c = case(*main)
    want = fcb.conv1x1_bn_act_plain(c["x"], c["w"], c["scale"], c["shift"])
    for n in ["parent", "change"] + [name for name, _ in LEVERS if name in libs]:
        y, s, q = fwd(n, c)
        log(f"relative L2 {n}: y {cs.rel_l2(y, want[0]):.3e} (y x 1.01 "
            f"{cs.rel_l2(y.float() * 1.01, want[0]):.3e}), sum {cs.rel_l2(s, want[1]):.3e}, "
            f"sumsq {cs.rel_l2(q, want[2]):.3e}")
    del c, want, y, s, q

    # 3. parent against change, in turns, at the step's sixteen shapes
    turns = ("parent", "change", "change", "parent")
    step = dict.fromkeys(("parent", "change"), 0.0)
    for M, cin, cout, prologue, launches in cs.CONV_BN_FWD_SWEEP:
        sets = case_sets(M, cin, cout, prologue)
        each = cs.conv_launches("conv_bn_fwd", prologue)
        ms = {side: [] for side in ("parent", "change")}
        split = {}
        for side in turns:
            t = cs.cuda_ms(torch, [lambda st=st, side=side: fwd(side, st) for st in sets],
                           iters=20, launches=each)
            ms[side].append(t["device_ms"])
            split[side] = cs.kernel_split(t["by_name"], cs.CONV_PARTS["conv_bn_fwd"], side)
        lib = cs.cuda_ms(torch, [lambda st=st: torch.matmul(st["x"], st["w"]) for st in sets],
                         iters=20)["device_ms"]
        bound, by = cs.conv_bn_bound_ms(sets[0], "fwd", "bfloat16")
        tag = f"M={M} {cin}->{cout} {'bn+relu' if prologue else 'no prologue'} x{launches}"
        for side, v in ms.items():
            mean = sum(v) / len(v)
            step[side] += launches * mean
            log(f"turns {tag} {side}: device ms {', '.join(f'{t:.5f}' for t in v)}, mean "
                f"{mean:.5f} (last: {cs.fmt_split(split[side])}); "
                f"{2 * M * cin * cout / mean / 1e9:.1f} TFLOP/s; "
                f"{100 * bound / mean:.1f}% of the {bound:.5f} ms bound ({by})")
        log(f"x@w {tag}: device ms {lib:.5f}")
        del sets
        torch.cuda.empty_cache()
    log(f"the step's 36 forward launches (sum of launches x mean device ms): parent "
        f"{step['parent']:.4f}, change {step['change']:.4f}")

    # 4. the widths and variants in turns with the change, CUDA events
    for M, cin, cout, prologue in VARIANT_SHAPES:
        sets = case_sets(M, cin, cout, prologue)
        label = f"M={M} {cin}->{cout}"
        entries = {"change": ("change", None)}
        entries.update({f"width {wd}": ("change", wd) for wd in fcb.FWD_WIDTHS})
        entries.update({name: (name, None) for name, _ in VARIANTS if name in libs})
        names = list(entries)[1:]
        order = ["change"] + names + names[::-1] + ["change"]
        ev = {n: [] for n in order}
        for n in order:
            lib, wd = entries[n]
            ev[n].append(cs.event_ms(torch, [lambda st=st, lib=lib, wd=wd: fwd(lib, st, wd)
                                             for st in sets], iters=40))
        base = sum(ev["change"]) / 2
        for n, v in ev.items():
            mean = sum(v) / len(v)
            log(f"variant {label} {n}: event ms {', '.join(f'{x:.5f}' for x in v)}, mean "
                f"{mean:.5f} ({100 * (mean - base) / base:+.1f}% against the change)")
        del sets
        torch.cuda.empty_cache()
    log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
