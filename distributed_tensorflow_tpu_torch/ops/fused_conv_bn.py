"""Fused 1x1-conv + BatchNorm — the hand-written CUDA kernels
(``csrc/fused_conv_bn.cu``: forward, dx, dw, single-pass backward), their
plain PyTorch versions and the ``torch.autograd.Function`` that wires them.

Counterpart of ``distributed_tensorflow_tpu/ops/fused_conv_bn.py``
(``_fwd_kernel``, ``_bwd_dx_kernel``, ``_bwd_dw_kernel``,
``_bwd_single_kernel`` behind ``jax.custom_vjp``). A 1x1 conv over NHWC
rows is a matmul ``[M, cin] @ [cin, cout]``; the forward fuses into it

- a **prologue**: the previous BatchNorm's affine ``x*scale + shift``
  (+ ReLU), so the raw previous conv output is read and the normalised
  tensor is never written;
- an **epilogue**: the column ``sum``/``sumsq`` of the output, the
  statistics of the next BatchNorm, so the output is never read back.

Numerics as there: f32 prologue, h rounded to x's dtype, f32
accumulation, statistics of the output as rounded to its dtype; in the
backward the stats outputs' cotangents fold into the output gradient
``g = dy + dsum + 2*y*dssq``, rounded to dy's dtype before both products,
the ReLU mask ``x*scale + shift > 0`` in f32.

The wrappers ``conv1x1_bn_fwd``, ``conv1x1_bn_bwd_dx``,
``conv1x1_bn_bwd_dw`` and ``conv1x1_bn_bwd_single`` launch their kernel
for CUDA tensors (built with nvcc on first use, at launch plans from the
shapes and the card's SM count: ``fwd_plan``, ``dx_chunks``, ``dw_plan``,
``single_chunks``) and raise on what it does not take; for CPU tensors —
and only for those — they compute the plain version. Each counts its
launches in ``.launches``. The kernels take
cin and cout multiples of 8 and x in the output dtype (f32 or bf16).

The backward follows ``_policy.resolve_bwd_impl``: ``"xla"`` is the plain
math with its two products in ``torch.mm``; ``"pallas"`` launches the
single-pass kernel where ``single_pass(cin, cout)`` holds, else the dx
kernel and then the dw kernel.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from ._policy import mm_exact, mm_library, resolve_bwd_impl
from .fused_ln_matmul import _sms

#: the channel granule of the single-pass rule
TILE = 64
#: the forward kernel's tile widths (columns of cout), the launch plan's choice
FWD_WIDTHS = (64, 128, 256)
#: the dw kernel's tile widths (columns of cout), the launch plan's choice
DW_WIDTHS = (128, 256)
#: f32 elements of the largest dw partial one single-pass CTA holds in
#: registers across its sweep (64 a thread of its 256)
SINGLE_PASS_DW_ELEMS = 16384


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def single_pass(cin: int, cout: int) -> bool:
    """The port's single-pass vs two-pass rule for ``bwd_impl="pallas"``:
    single-pass when one CTA's f32 ``[cin, cout]`` dw partial (each dim
    rounded up to 64) fits its registers, 64 a thread of 256, i.e.
    ``ceil64(cin) * ceil64(cout) <= 16384``. At ResNet-50's shapes that is
    every stage-0 1x1 conv (64→64, 64→256, 256→64: 7 a step) and none
    after (29 a step run the dx + dw pair).

    The rule says where the single-pass kernel can run; it is also where
    it is faster than the pair. On an NVIDIA H100 80GB HBM3 at 700 W (bf16,
    batch 256, device time; PERF.md §6) it takes 0.408 ms at M=802816
    64→256 with the bn+relu prologue against 1.198 ms for the dx + dw pair
    on the same inputs, 0.369 against 1.069 without the prologue, 0.440
    against 0.936 at 256→64 and 0.152 against 0.340 at 64→64: 2.7 ms for
    the step's 7 launches."""
    return _round_up(cin, TILE) * _round_up(cout, TILE) <= SINGLE_PASS_DW_ELEMS


def _width(cout: int, widths) -> int:
    """The tile width of ``widths`` that pads cout least, the wider on a tie
    (fewer columns of tiles re-read their rows)."""
    return min(widths, key=lambda w: (_round_up(cout, w), -w))


def fwd_plan(M: int, cin: int, cout: int, sms: int, tile: tuple[int, int]) -> dict:
    """The forward kernel's launch plan from the shapes and the card alone:
    ``{"tile": (rows of M, columns of cout), "G": chunks}``. ``tile`` is
    the kernel's ``(rows of M a tile, CTAs an SM)`` (``fwd_tile``).

    The width is the one of ``FWD_WIDTHS`` that pads cout least, the wider
    on a tie. The grid is (cout tiles, G), and CTA (n, c) takes the M tiles
    c, c+G, ...: G fills one wave of the card's CTA slots beside the cout
    tiles, with at least 1 chunk and at most one an M tile. cin does not
    change the plan: the contraction runs inside each CTA. So the
    statistics' partials are summed in the same order on every call."""
    rows_m, per_sm = tile
    bn = _width(cout, FWD_WIDTHS)
    G = min(-(-M // rows_m), per_sm * sms // -(-cout // bn))
    return {"tile": (rows_m, bn), "G": max(1, G)}


@functools.cache
def fwd_tile() -> tuple[int, int]:
    """The forward kernel's tile and residency as its source states them
    (``conv_bn_fwd_tile``): rows of M a tile, CTAs an SM."""
    lib = _build.load("fused_conv_bn")
    return tuple(lib.conv_bn_fwd_tile(i) for i in range(2))


def dx_chunks(M: int, cin: int, sms: int, tile: tuple[int, int, int]) -> int:
    """G of the dx kernel: its grid is (cin tiles, G), and CTA (n, c) takes
    the M tiles c, c+G, ... ``tile`` is the kernel's ``(rows of M, columns
    of cin, CTAs an SM)`` (``dx_tile``). As many chunks as one wave of the
    card's ``sms`` holds beside the cin tiles (at least 1, at most one an M
    tile): a function of the shapes and the card alone, so the
    dscale/dshift partials are summed in the same order on every call."""
    bm, bn, per_sm = tile
    return max(1, min(-(-M // bm), per_sm * sms // -(-cin // bn)))


@functools.cache
def dx_tile() -> tuple[int, int, int]:
    """The dx kernel's tile and residency as its source states them
    (``conv_bn_dx_tile``): rows of M, columns of cin, CTAs an SM."""
    lib = _build.load("fused_conv_bn")
    return tuple(lib.conv_bn_dx_tile(i) for i in range(3))


def single_chunks(M: int, sms: int, tile: tuple[int, int]) -> int:
    """G of the single-pass kernel: a grid of G persistent CTAs, CTA c
    taking the M tiles c, c+G, ... ``tile`` is the kernel's ``(rows of M,
    CTAs an SM)`` (``single_tile``). One wave of the card's ``sms`` (at
    least 1, at most one an M tile): a function of M and the card alone,
    so the dw, dscale and dshift partials are summed in the same order on
    every call."""
    bm, per_sm = tile
    return max(1, min(-(-M // bm), per_sm * sms))


def dw_plan(M: int, cin: int, cout: int, sms: int, tile: tuple[int, int, int]) -> dict:
    """The dw kernel's launch plan from the shapes and the card alone:
    ``{"tile": (rows of cin, columns of cout), "G": chunks}``. ``tile`` is
    the kernel's ``(rows of cin a tile, rows of M a block, CTAs an SM)``
    (``dw_tile``).

    The width is the one of ``DW_WIDTHS`` that pads cout least, the wider
    on a tie (fewer columns of tiles restage x).
    The grid is (tiles, G); chunk c takes a contiguous range of the M
    blocks and writes an f32 partial of dw. G fills one wave of the card's
    CTA slots beside the tiles, with at least 1 chunk and at most one a
    block, and no more chunks than keep the partials (``G * cin * cout``
    floats, written, then read by the reduction) within the bf16 bytes the
    product reads (x, dy, y). So the sums' order is fixed per card."""
    rows_cin, rows_m, per_sm = tile
    bn = _width(cout, DW_WIDTHS)
    tiles = -(-cin // rows_cin) * -(-cout // bn)
    G = min(-(-M // rows_m), per_sm * sms // tiles, 2 * M * (cin + 2 * cout) // (8 * cin * cout))
    return {"tile": (rows_cin, bn), "G": max(1, G)}


@functools.cache
def dw_tile() -> tuple[int, int, int]:
    """The dw kernel's tile and residency as its source states them
    (``conv_bn_dw_tile``): rows of cin a tile, rows of M a block, CTAs an
    SM."""
    lib = _build.load("fused_conv_bn")
    return tuple(lib.conv_bn_dw_tile(i) for i in range(3))


@functools.cache
def single_tile() -> tuple[int, int]:
    """The single-pass kernel's tile and residency as its source states
    them (``conv_bn_single_tile``): rows of M, CTAs an SM."""
    lib = _build.load("fused_conv_bn")
    return tuple(lib.conv_bn_single_tile(i) for i in range(2))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def conv1x1_bn_act_plain(x, w, scale=None, shift=None, *, relu: bool = True,
                         emit_stats: bool = True, out_dtype=None):
    """The forward kernel's math in plain PyTorch — the counterpart of
    ``conv1x1_bn_act_reference``: the product in f32 on the operands as
    rounded to x's dtype (exact products, f32 sums), the statistics of the
    rounded output. Returns ``y`` or ``(y, col_sum, col_sumsq)``."""
    out_dtype = out_dtype or x.dtype
    h = x.float()
    if scale is not None:
        h = h * scale.reshape(1, -1).float() + shift.reshape(1, -1).float()
        if relu:
            h = torch.relu(h)
    h = h.to(x.dtype)
    y = torch.matmul(h.float(), w.to(x.dtype).float()).to(out_dtype)
    if not emit_stats:
        return y
    st = y.float()
    return y, st.sum(0), (st * st).sum(0)


def _gq(y, dy, dsum, dssq, emit_stats):
    """The output gradient with the statistics' cotangents folded in
    (d/dy [sum, sumsq] = [1, 2y]), rounded to y's dtype."""
    g = dy.float()
    if emit_stats:
        g = g + dsum.reshape(1, -1).float() + 2.0 * y.float() * dssq.reshape(1, -1).float()
    return g.to(y.dtype)


def _hq(x, scale, shift, relu):
    """The product's left operand: prologue(x) rounded to x's dtype."""
    if scale is None:
        return x
    h = x.float() * scale.reshape(1, -1).float() + shift.reshape(1, -1).float()
    return (torch.relu(h) if relu else h).to(x.dtype)


def _bwd_math(x, y, dy, w, scale, shift, dsum, dssq, *, relu, emit_stats, mm):
    """``_xla_bwd`` of the JAX package with the two products in ``mm``:
    returns ``(dx, dw f32, dscale, dshift)``; dscale/dshift are None
    without the prologue."""
    gq = _gq(y, dy, dsum, dssq, emit_stats)
    dh = mm(gq, w.to(gq.dtype).t())
    dscale = dshift = None
    if scale is not None:
        x32 = x.float()
        if relu:
            xn = x32 * scale.reshape(1, -1).float() + shift.reshape(1, -1).float()
            dh = dh * (xn > 0.0).float()
        dscale, dshift = (dh * x32).sum(0), dh.sum(0)
        dh = dh * scale.reshape(1, -1).float()
    hq = _hq(x, scale, shift, relu)
    return dh.to(x.dtype), mm(hq.t(), gq.to(hq.dtype)), dscale, dshift


def conv1x1_bn_bwd_plain(x, y, dy, w, scale=None, shift=None, dsum=None, dssq=None, *,
                         relu: bool = True, emit_stats: bool = True):
    """The backward kernels' math in plain PyTorch — the JAX package's
    ``_xla_bwd`` with both products in f32 on the rounded operands:
    ``(dx, dw f32 [cin, cout], dscale, dshift)``, the last two None
    without the prologue."""
    return _bwd_math(x, y, dy, w, scale, shift, dsum, dssq, relu=relu,
                     emit_stats=emit_stats, mm=mm_exact)


def xla_bwd(x, y, dy, w, scale=None, shift=None, dsum=None, dssq=None, *, relu: bool = True,
            emit_stats: bool = True):
    """``bwd_impl="xla"``: the plain-math backward with its dgrad and wgrad
    products in ``torch.mm`` (no kernel of this module)."""
    return _bwd_math(x, y, dy, w, scale, shift, dsum, dssq, relu=relu,
                     emit_stats=emit_stats, mm=mm_library)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _rows(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous with a 16-byte aligned base")


def _check(what, x, w, scale, shift, cout, *rows):
    """Validate what the kernels take; returns (M, cin, sk, sn, suffix).
    ``w`` [cin, cout] (None for the dw kernel, which reads none);
    ``rows``: (name, tensor) of further [M, cout] tensors in x's dtype."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{what}: the kernels take f32 or bf16 x, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{what}: want x [M, cin], got {tuple(x.shape)}")
    M, cin = x.shape
    if M < 1 or cin % 8 or cout % 8:
        raise ValueError(f"{what}: the kernels take M >= 1 and cin, cout multiples of 8, "
                         f"got M={M} cin={cin} cout={cout}")
    _rows("x", x, x.dtype, (M, cin))
    for name, t in rows:
        _rows(name, t, x.dtype, (M, cout))
    sk = sn = 0
    if w is not None:
        if tuple(w.shape) != (cin, cout) or w.dtype != x.dtype:
            raise TypeError(f"{what}: w must be {x.dtype} [{cin}, {cout}], got {w.dtype} "
                            f"{tuple(w.shape)}")
        sk, sn = w.stride()
        vec = 16 // x.element_size()
        if not ((sk == 1 and sn % vec == 0) or (sn == 1 and sk % vec == 0)) \
                or w.data_ptr() % 16:
            raise ValueError(f"{what}: w [cin, cout] needs a unit stride in one dim, the other "
                             f"a multiple of {vec}, and a 16-byte aligned base; got strides "
                             f"{w.stride()}")
    if (scale is None) != (shift is None):
        raise ValueError(f"{what}: scale and shift come together")
    if scale is not None:
        _rows("scale", scale, torch.float32, (cin,))
        _rows("shift", shift, torch.float32, (cin,))
    for name, t in (("w", w), ("scale", scale), ("shift", shift)) + rows:
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")
    return M, cin, sk, sn, _SUFFIX[x.dtype]


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _stats_args(dsum, dssq, cout, emit_stats, device):
    if not emit_stats:
        return None, None
    out = []
    for name, t in (("dsum", dsum), ("dssq", dssq)):
        t = t.reshape(-1).float().contiguous()
        if tuple(t.shape) != (cout,) or t.device != device:
            raise ValueError(f"{name} must be [{cout}] on {device}, got {tuple(t.shape)} on "
                             f"{t.device}")
        out.append(t)
    return out


def _launch_fwd(x, w, scale, shift, relu, emit_stats, plan):
    """The forward product at ``plan`` (``fwd_plan``'s keys) and, with the
    statistics, the reductions of its partials, on validated CUDA tensors;
    returns ``(y, col_sum, col_sumsq)``, the sums None without them."""
    M, cin = x.shape
    cout = w.shape[1]
    sk, sn = w.stride()
    G, dev = plan["G"], x.device
    y = torch.empty(M, cout, dtype=x.dtype, device=dev)
    ws = torch.empty(2 * G * cout if emit_stats else 1, dtype=torch.float32, device=dev)
    s = torch.empty(cout, dtype=torch.float32, device=dev) if emit_stats else None
    ssq = torch.empty(cout, dtype=torch.float32, device=dev) if emit_stats else None
    lib = _build.load("fused_conv_bn")
    rc = getattr(lib, f"conv_bn_fwd_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), w.data_ptr(), sk, sn, _ptr(scale), _ptr(shift), y.data_ptr(),
        ws.data_ptr(), _ptr(s), _ptr(ssq), M, cin, cout, G, plan["tile"][1],
        int(scale is not None), int(bool(relu)), int(bool(emit_stats)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "conv1x1_bn_fwd")
    return y, s, ssq


def conv1x1_bn_fwd(x, w, scale=None, shift=None, *, relu: bool = True,
                   emit_stats: bool = True, out_dtype=None):
    """Forward: ``(y, col_sum, col_sumsq)`` (the sums None without
    ``emit_stats``). CUDA tensors: one launch of the tiled forward kernel
    at ``fwd_plan`` (and, with the statistics, the reductions of its
    partials); CPU tensors: ``conv1x1_bn_act_plain``."""
    if not _build.on_cuda(x, "conv1x1_bn_fwd"):
        out = conv1x1_bn_act_plain(x, w, scale, shift, relu=relu, emit_stats=emit_stats,
                                   out_dtype=out_dtype)
        return out if emit_stats else (out, None, None)
    if (out_dtype or x.dtype) != x.dtype:
        raise TypeError(f"conv1x1_bn_fwd kernel: out_dtype {out_dtype} must be x's dtype "
                        f"{x.dtype}")
    cout = w.shape[-1]
    M, cin, _, _, _ = _check("conv1x1_bn_fwd", x, w, scale, shift, cout)
    out = _launch_fwd(x, w, scale, shift, relu, emit_stats,
                      fwd_plan(M, cin, cout, _sms(x.device), fwd_tile()))
    conv1x1_bn_fwd.launches += 1
    return out


def conv1x1_bn_bwd_dx(x, y, dy, w, scale=None, shift=None, dsum=None, dssq=None, *,
                      relu: bool = True, emit_stats: bool = True):
    """Two-pass backward, part 1: ``(dx, dscale, dshift)`` (the last two
    None without the prologue). CUDA tensors: one launch of the tiled dx
    kernel (and, with the prologue, the reduction of its ``dx_chunks``
    partials); CPU tensors: the plain backward's."""
    if not _build.on_cuda(x, "conv1x1_bn_bwd_dx"):
        dx, _, dscale, dshift = conv1x1_bn_bwd_plain(
            x, y, dy, w, scale, shift, dsum, dssq, relu=relu, emit_stats=emit_stats)
        return dx, dscale, dshift
    cout = w.shape[-1]
    M, cin, sk, sn, sfx = _check("conv1x1_bn_bwd_dx", x, w, scale, shift, cout, ("y", y),
                                 ("dy", dy))
    dev = x.device
    dsum, dssq = _stats_args(dsum, dssq, cout, emit_stats, dev)
    prologue = scale is not None
    G = dx_chunks(M, cin, _sms(dev), dx_tile())
    dx = torch.empty(M, cin, dtype=x.dtype, device=dev)
    ws = torch.empty(2 * G * cin if prologue else 1, dtype=torch.float32, device=dev)
    dscale = torch.empty(cin, dtype=torch.float32, device=dev) if prologue else None
    dshift = torch.empty(cin, dtype=torch.float32, device=dev) if prologue else None
    lib = _build.load("fused_conv_bn")
    rc = getattr(lib, f"conv_bn_bwd_dx_{sfx}")(
        x.data_ptr(), y.data_ptr(), dy.data_ptr(), w.data_ptr(), sk, sn, _ptr(scale),
        _ptr(shift), _ptr(dsum), _ptr(dssq), dx.data_ptr(), ws.data_ptr(), _ptr(dscale),
        _ptr(dshift), M, cin, cout, G, int(prologue), int(bool(relu)), int(bool(emit_stats)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "conv1x1_bn_bwd_dx")
    conv1x1_bn_bwd_dx.launches += 1
    return dx, dscale, dshift


def _launch_dw(x, y, dy, scale, shift, dsum, dssq, relu, emit_stats, plan):
    """The dw product at ``plan`` (``dw_plan``'s keys) and its reduction on
    validated CUDA tensors; returns dw f32 [cin, cout]."""
    M, cin = x.shape
    cout = dy.shape[1]
    G, dev = plan["G"], x.device
    ws = torch.empty(G * cin * cout, dtype=torch.float32, device=dev)
    dw = torch.empty(cin, cout, dtype=torch.float32, device=dev)
    lib = _build.load("fused_conv_bn")
    rc = getattr(lib, f"conv_bn_bwd_dw_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), y.data_ptr(), dy.data_ptr(), _ptr(scale), _ptr(shift), _ptr(dsum),
        _ptr(dssq), ws.data_ptr(), dw.data_ptr(), M, cin, cout, G, plan["tile"][1],
        int(scale is not None), int(bool(relu)), int(bool(emit_stats)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "conv1x1_bn_bwd_dw")
    return dw


def conv1x1_bn_bwd_dw(x, y, dy, scale=None, shift=None, dsum=None, dssq=None, *,
                      relu: bool = True, emit_stats: bool = True):
    """Two-pass backward, part 2: ``dw = prologue(x)^T @ g`` in f32
    ``[cin, cout]``. CUDA tensors: one launch of the tiled dw kernel at
    ``dw_plan`` (and the reduction of its partials); CPU tensors: the
    plain backward's."""
    if not _build.on_cuda(x, "conv1x1_bn_bwd_dw"):
        return mm_exact(_hq(x, scale, shift, relu).t(), _gq(y, dy, dsum, dssq, emit_stats))
    cout = dy.shape[-1]
    M, cin, _, _, _ = _check("conv1x1_bn_bwd_dw", x, None, scale, shift, cout, ("y", y),
                             ("dy", dy))
    dev = x.device
    dsum, dssq = _stats_args(dsum, dssq, cout, emit_stats, dev)
    dw = _launch_dw(x, y, dy, scale, shift, dsum, dssq, relu, emit_stats,
                    dw_plan(M, cin, cout, _sms(dev), dw_tile()))
    conv1x1_bn_bwd_dw.launches += 1
    return dw


def conv1x1_bn_bwd_single(x, y, dy, w, scale=None, shift=None, dsum=None, dssq=None, *,
                          relu: bool = True, emit_stats: bool = True):
    """Single-pass backward: ``(dx, dw f32, dscale, dshift)`` in one sweep
    over x, y and dy. CUDA tensors: one launch of the single-pass kernel
    over ``single_chunks`` persistent CTAs (and the reductions of their
    partials; raises where ``single_pass(cin, cout)`` does not hold); CPU
    tensors: the plain backward."""
    if not _build.on_cuda(x, "conv1x1_bn_bwd_single"):
        return conv1x1_bn_bwd_plain(x, y, dy, w, scale, shift, dsum, dssq, relu=relu,
                                    emit_stats=emit_stats)
    cout = w.shape[-1]
    M, cin, sk, sn, sfx = _check("conv1x1_bn_bwd_single", x, w, scale, shift, cout,
                                 ("y", y), ("dy", dy))
    if not single_pass(cin, cout):
        raise ValueError(f"conv1x1_bn_bwd_single: cin={cin} x cout={cout} exceeds the "
                         f"single-pass budget; use conv1x1_bn_bwd_dx + conv1x1_bn_bwd_dw")
    dev = x.device
    dsum, dssq = _stats_args(dsum, dssq, cout, emit_stats, dev)
    prologue = scale is not None
    G = single_chunks(M, _sms(dev), single_tile())
    dx = torch.empty(M, cin, dtype=x.dtype, device=dev)
    ws = torch.empty(G * cin * cout + 2 * G * cin, dtype=torch.float32, device=dev)
    dw = torch.empty(cin, cout, dtype=torch.float32, device=dev)
    dscale = torch.empty(cin, dtype=torch.float32, device=dev) if prologue else None
    dshift = torch.empty(cin, dtype=torch.float32, device=dev) if prologue else None
    lib = _build.load("fused_conv_bn")
    rc = getattr(lib, f"conv_bn_bwd_single_{sfx}")(
        x.data_ptr(), y.data_ptr(), dy.data_ptr(), w.data_ptr(), sk, sn, _ptr(scale),
        _ptr(shift), _ptr(dsum), _ptr(dssq), dx.data_ptr(), ws.data_ptr(), dw.data_ptr(),
        _ptr(dscale), _ptr(dshift), M, cin, cout, G, int(prologue), int(bool(relu)),
        int(bool(emit_stats)), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "conv1x1_bn_bwd_single")
    conv1x1_bn_bwd_single.launches += 1
    return dx, dw, dscale, dshift


conv1x1_bn_fwd.launches = conv1x1_bn_bwd_dx.launches = 0
conv1x1_bn_bwd_dw.launches = conv1x1_bn_bwd_single.launches = 0

#: the four kernel wrappers, by the name chip_smoke.py and PERF.md use
KERNELS = {"conv_bn_fwd": conv1x1_bn_fwd, "conv_bn_bwd_dx": conv1x1_bn_bwd_dx,
           "conv_bn_bwd_dw": conv1x1_bn_bwd_dw, "conv_bn_bwd_single": conv1x1_bn_bwd_single}


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------


class Conv1x1BN(torch.autograd.Function):
    """The custom VJP of the JAX op: the forward saves ``(x, y, w, scale,
    shift)``; the backward folds the statistics' cotangents into the
    output gradient and runs the ``bwd_impl`` backward. Gradients: dx in
    x's dtype, dw in w's dtype, dscale/dshift f32 (None without the
    prologue)."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, relu, emit_stats, out_dtype, bwd_impl):
        y, s, ssq = conv1x1_bn_fwd(x, w, scale, shift, relu=relu, emit_stats=emit_stats,
                                   out_dtype=out_dtype)
        ctx.save_for_backward(x, y, w, scale, shift)
        ctx.relu, ctx.emit_stats, ctx.bwd_impl = relu, emit_stats, bwd_impl
        return (y, s, ssq) if emit_stats else y

    @staticmethod
    def backward(ctx, dy, *stat_cts):
        x, y, w, scale, shift = ctx.saved_tensors
        emit_stats = ctx.emit_stats
        dsum, dssq = stat_cts if emit_stats else (None, None)
        dy = dy.to(y.dtype).contiguous()
        kw = dict(relu=ctx.relu, emit_stats=emit_stats)
        args = (x, y, dy, w, scale, shift, dsum, dssq)
        if ctx.bwd_impl == "xla":
            dx, dw, dscale, dshift = xla_bwd(*args, **kw)
        elif single_pass(x.shape[1], w.shape[1]):
            dx, dw, dscale, dshift = conv1x1_bn_bwd_single(*args, **kw)
        else:
            dx, dscale, dshift = conv1x1_bn_bwd_dx(*args, **kw)
            dw = conv1x1_bn_bwd_dw(x, y, dy, scale, shift, dsum, dssq, **kw)
        return dx, dw.to(w.dtype), dscale, dshift, None, None, None, None


def conv1x1_bn_act(x, w, scale=None, shift=None, *, relu: bool = True,
                   emit_stats: bool = True, out_dtype=None, bwd_impl: str | None = None):
    """Fused ``[M, cin] @ [cin, cout]`` with an optional BatchNorm-apply
    prologue and a statistics epilogue — the JAX op's contract.

    x: [M, cin] (bf16/f32), the raw previous conv output; w: [cin, cout]
    (a view with a unit stride in either dim); scale/shift: per-cin f32
    (``bn_scale_shift``), ``None`` disables the prologue (``relu`` is
    then ignored); ``emit_stats`` also returns ``(col_sum, col_sumsq)``
    [cout] f32 of the output (feed ``moments_from_sums``); ``bwd_impl``
    per ``_policy.resolve_bwd_impl``. Returns ``y`` or ``(y, col_sum,
    col_sumsq)``."""
    if scale is not None:
        scale = scale.reshape(-1).float().contiguous()
        shift = shift.reshape(-1).float().contiguous()
    return Conv1x1BN.apply(x, w, scale, shift, bool(relu), bool(emit_stats),
                           out_dtype or x.dtype, resolve_bwd_impl(bwd_impl))


# ---------------------------------------------------------------------------
# [C]-sized helpers
# ---------------------------------------------------------------------------


def moments_from_sums(col_sum, col_sumsq, count):
    """Column sums -> (mean, biased variance), f32."""
    mean = col_sum / count
    var = torch.clamp(col_sumsq / count - mean * mean, min=0.0)
    return mean, var


def bn_scale_shift(mean, var, gamma, beta, eps):
    """Fold BN(mean, var, gamma, beta) into a per-channel affine
    ``x*scale + shift``."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale
