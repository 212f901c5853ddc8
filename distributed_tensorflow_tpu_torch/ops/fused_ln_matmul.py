"""Fused LayerNorm + matmul (+bias) — the hand-written CUDA kernels
(``csrc/ln_matmul.cu``: the forward; ``csrc/ln_matmul_bwd.cu``: the dx and
dw backward; both on ``csrc/tile_mma.cuh``), their plain PyTorch versions
and the ``torch.autograd.Function`` that wires them.

Counterpart of ``distributed_tensorflow_tpu/ops/fused_ln_matmul.py``
(``_fwd_kernel``, ``_bwd_dx_kernel``, ``_bwd_dw_kernel`` behind
``jax.custom_vjp``): every pre-LN block applies LayerNorm and feeds the
result straight into a Dense matmul (q/k/v, mlp_in); the forward kernel
normalises each row tile in shared memory, so the normalised tensor never
reaches device memory, and the backward recomputes it. Numerics as in that
file: f32 row statistics (eps inside the rsqrt; the mean, then the mean of
squared deviations), the normalised rows cast to x's dtype, f32
accumulation, f32 bias, cast to ``out_dtype``. In the backward (JAX's
``_xla_bwd``): dy cast to ``out_dtype``; ``dh = dy @ w^T`` in f32; dx from
the coupled, row-local LayerNorm backward, cast to x's dtype; dgamma =
sum dh*xhat, dbeta = sum dh, dbias = sum dy in f32; ``dw = h^T @ dy`` in
f32 with h = xhat*gamma + beta cast to x's dtype, then cast to w's dtype.

The kernel wrappers ``ln_matmul`` (forward), ``ln_matmul_bwd_dx`` and
``ln_matmul_bwd_dw`` launch their kernels for CUDA tensors (built with
nvcc on first use) and raise on what they do not take; for CPU tensors —
and only for those — they compute the plain version. Each counts the calls
that launch in ``.launches``, several kernels behind one call counted as
one: the forward at ``M >= LN_TILED_MIN_M`` (``fwd_plan``: the rows'
statistics, then a tiled product; ``ln_matmul.tiled_launches`` counts
these calls alone), dx (the product dh = dy @ w^T into an f32 workspace,
the row-local LayerNorm pass and the partial sums' reduction), dw (the
tiled product split over M into partials, then their reduction;
``dw_plan``). The backward kernels and the tiled forward take x, w and dy
in one dtype (f32 or bf16), d and n multiples of 8.

``ln_matmul`` routes through ``LnMatmul`` whenever autograd records the
call; its backward follows ``_policy.resolve_bwd_impl``: ``"xla"`` is the
plain math with its two products in ``torch.mm``; ``"pallas"`` launches the
dx kernels and then the dw kernel.
"""

from __future__ import annotations

import torch

from . import _build
from ._policy import mm_exact, mm_library, resolve_bwd_impl

#: shared memory a CTA may use (227 KB on Hopper); the serving forward's
#: needs 16 normalised rows of width d (padded to 128) plus one 128x64 w
#: tile and the f32 epilogue tile
_SMEM_LIMIT = 232448


def ln_matmul_plain(x, gamma, beta, w, bias=None, *, eps: float = 1e-6,
                    out_dtype=None):
    """``LayerNorm(x; gamma, beta) @ w + bias`` in plain PyTorch — the
    counterpart of ``ln_matmul_reference``. x [M, d]; gamma/beta [d];
    w [d, n]; bias [n] or None. The product runs in f32 on the operands
    as rounded to x's dtype (exact products, f32 sums)."""
    out_dtype = out_dtype or x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    h = (x32 - mu) * torch.rsqrt(var + eps) * gamma.float().reshape(1, -1)
    h = (h + beta.float().reshape(1, -1)).to(x.dtype)
    y = torch.matmul(h.float(), w.to(x.dtype).float())
    if bias is not None:
        y = y + bias.float().reshape(1, -1)
    return y.to(out_dtype)


#: the dx product's output tile, (rows of dy, columns of d), and the rows
#: of one tile of the dx row pass (``csrc/ln_matmul_bwd.cu``: DH_BM, DH_BN,
#: RW_BM)
DH_TILE = (128, 128)
DX_ROW_TILE = 16
#: row-pass CTAs the dx plan aims to keep resident on one SM
DX_ROW_CTAS_PER_SM = 2
#: the output tile of the dw and training-forward products (``csrc/``
#: ``ln_matmul.cu`` Fw, ``ln_matmul_bwd.cu`` Dw: 8 warps of 64 x 64 on
#: ``tile_mma.cuh``; 128 x 256 timed faster than 128 x 128 at gpt_small's
#: shapes on an H100, PERF.md), and the CTAs an SM holds of either (their
#: 3-stage rings take 155-167 KB of shared memory)
TILE_ROWS, TILE_COLS = 128, 256
TILE_CTAS_PER_SM = 1
#: dw: rows of x and dy in one bf16 stage (f32 stages hold 32), the
#: granule of the split over M, and the most partial copies of dw
DW_STAGE_ROWS = 64
DW_MAX_G = 8
#: the forward takes the tiled path (row statistics, then a 2-D tiled
#: product) from this many rows up, and the row-tile kernel below it:
#: every serving call (decode slots, one prefill chunk, a verify step). On
#: an H100 at d=768, n=3072 the tiled pair is slower at M=128 (0.041 vs
#: 0.023 ms) and faster at M=256 (0.041 vs 0.043; PERF.md)
LN_TILED_MIN_M = 256

_SMS: dict = {}


def _sms(dev) -> int:
    """The device's SM count, read once per device. The dx row pass takes
    at most ``DX_ROW_CTAS_PER_SM`` CTAs per SM (``dx_plan``) and the dw
    split over M fills whole waves of CTA slots (``dw_plan``); the partial
    sums' order depends on the card and the shapes alone, so a step stays
    bitwise repeatable on one card."""
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def _dx_math(x, gamma, w, dy, eps, mm):
    """The dx kernel's function: ``(dx, dgamma, dbeta, dbias, mean, rstd)``;
    the f32 row statistics as the kernels take them: mean, then rsqrt of
    the mean of squared deviations plus eps."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    inv = torch.rsqrt(((x32 - mu) ** 2).mean(-1, keepdim=True) + eps)
    xhat = (x32 - mu) * inv
    dh = mm(dy, w.t())
    dxhat = dh * gamma.float().reshape(1, -1)
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = ((dxhat - m1 - xhat * m2) * inv).to(x.dtype)
    return (dx, (dh * xhat).sum(0), dh.sum(0), dy.float().sum(0), mu.reshape(-1),
            inv.reshape(-1))


def _dw_math(x, gamma, beta, dy, mean, rstd, mm):
    """The dw kernel's function: ``h^T @ dy`` summed in f32, with h =
    (xhat*gamma + beta) rounded to x's dtype, xhat from the rows' f32
    ``mean, rstd`` [M]."""
    h = ((x.float() - mean.reshape(-1, 1)) * rstd.reshape(-1, 1)
         * gamma.float().reshape(1, -1) + beta.float().reshape(1, -1)).to(x.dtype)
    return mm(h.t(), dy)


def _bwd(x, gamma, beta, w, dy, eps, mm):
    dx, dg, db, dbias, mean, rstd = _dx_math(x, gamma, w, dy, eps, mm)
    return dx, dg, db, _dw_math(x, gamma, beta, dy, mean, rstd, mm).to(w.dtype), dbias


def ln_matmul_bwd_plain(x, gamma, beta, w, dy, *, eps: float = 1e-6):
    """The backward kernels' math in plain PyTorch — JAX's ``_xla_bwd``
    with both products in f32 on the rounded operands (exact products, f32
    sums): ``(dx, dgamma, dbeta, dw, dbias)``; dx in x's dtype, dw in w's,
    the rest f32. ``dy`` is the output gradient in the forward's output
    dtype."""
    return _bwd(x, gamma, beta, w, dy, eps, mm_exact)


def xla_bwd(x, gamma, beta, w, dy, *, eps: float = 1e-6):
    """``bwd_impl="xla"``: the plain-math backward with its dgrad and wgrad
    products in ``torch.mm`` (no kernel of this module)."""
    return _bwd(x, gamma, beta, w, dy, eps, mm_library)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_ENTRY = {
    (torch.float32, torch.float32): "ln_matmul_f32",
    (torch.bfloat16, torch.bfloat16): "ln_matmul_bf16",
    (torch.bfloat16, torch.float32): "ln_matmul_bf16_f32",
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def fwd_plan(M: int) -> str:
    """The forward kernel for M rows: below ``LN_TILED_MIN_M`` the row-tile
    ``ln_matmul_kernel``; from there up ``ln_matmul_tiled_kernel`` (after
    ``ln_stats_kernel`` has written the rows' mean and rstd)."""
    return "ln_matmul_kernel" if M < LN_TILED_MIN_M else "ln_matmul_tiled_kernel"


def _fwd(x, gamma, beta, w, bias, eps, out_dtype):
    """The forward kernels' launch (CPU tensors: the plain version)."""
    if not _build.on_cuda(x, "ln_matmul"):
        return ln_matmul_plain(x, gamma, beta, w, bias, eps=eps, out_dtype=out_dtype)
    if (x.dtype, out_dtype) not in _ENTRY:
        raise TypeError(f"ln_matmul kernel takes (x, out) dtypes "
                        f"{sorted(_ENTRY, key=str)}, got ({x.dtype}, {out_dtype})")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"want x [M, d] and w [d, n], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    M, d = x.shape
    n = w.shape[1]
    if bias is None:
        bias = torch.zeros(n, dtype=torch.float32, device=x.device)
    if w.dtype != x.dtype:
        raise TypeError(f"w dtype {w.dtype} != x dtype {x.dtype}")
    for name, t, shape in (("gamma", gamma, (d,)), ("beta", beta, (d,)),
                           ("bias", bias, (n,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be f32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta), ("w", w),
                    ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if name != "w" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    sk, sn = w.stride()
    if sk != 1 and sn != 1:
        raise ValueError(f"w [d, n] needs a unit stride in one dim, got "
                         f"strides {w.stride()}")
    if fwd_plan(M) == "ln_matmul_tiled_kernel":
        return _launch_fwd_tiled(x, gamma, beta, w, bias, eps, out_dtype)
    return _launch_fwd_rows(x, gamma, beta, w, bias, eps, out_dtype)


def _launch_fwd_rows(x, gamma, beta, w, bias, eps, out_dtype):
    """the row-tile forward on validated CUDA tensors (``bias`` given)."""
    M, d = x.shape
    n = w.shape[1]
    smem = x.element_size() * (16 * (-(-d // 128) * 128 + 8) + 128 * 72) + 4 * 16 * 64
    if smem > _SMEM_LIMIT:
        raise ValueError(f"d={d} needs {smem} bytes of shared memory per CTA "
                         f"(limit {_SMEM_LIMIT})")
    y = torch.empty(M, n, dtype=out_dtype, device=x.device)
    lib = _build.load("ln_matmul")
    sk, sn = w.stride()
    rc = getattr(lib, _ENTRY[(x.dtype, out_dtype)])(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        bias.data_ptr(), y.data_ptr(), M, d, n, sk, sn, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "ln_matmul")
    ln_matmul.launches += 1
    return y


def _launch_fwd_tiled(x, gamma, beta, w, bias, eps, out_dtype):
    """The tiled forward (``fwd_plan``'s kernel pair) on validated CUDA
    tensors (``bias`` given); raises on what it does not take, as the
    backward does."""
    M, d = x.shape
    n = w.shape[1]
    if d % 8 or n % 8:
        raise ValueError(f"ln_matmul: from M={LN_TILED_MIN_M} rows the tiled kernels take d, "
                         f"n multiples of 8, got M={M} d={d} n={n}")
    _rows("ln_matmul", "x", x, x.dtype, (M, d))
    _w_layout("ln_matmul", w)
    sk, sn = w.stride()
    stats = torch.empty(2 * M, dtype=torch.float32, device=x.device)
    y = torch.empty(M, n, dtype=out_dtype, device=x.device)
    lib = _build.load("ln_matmul")
    rc = getattr(lib, _ENTRY[(x.dtype, out_dtype)].replace("ln_matmul", "ln_matmul_tiled"))(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), bias.data_ptr(),
        y.data_ptr(), stats.data_ptr(), M, d, n, sk, sn, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "ln_matmul")
    ln_matmul.launches += 1
    ln_matmul.tiled_launches += 1
    return y


def dx_plan(M: int, d: int, n: int, sms: int) -> dict:
    """The dx wrapper's launch plan, from the shapes and the SM count alone.

    ``dh_grid``: the product's (row tiles, column tiles) of ``DH_TILE``
    over dh [M, d]; ``rows_grid``: G, the row pass's CTAs (at most
    ``DX_ROW_CTAS_PER_SM`` per SM; CTA c takes the row tiles c, c+G, ...).
    The f32 workspace holds dh (M*d), the row pass's dgamma/dbeta
    partials (G*2d) and dbias's partials, one per row tile of the product
    (row tiles * n): ``ws`` elements in all."""
    bm, bn = DH_TILE
    mtiles = -(-M // bm)
    G = max(1, min(-(-M // DX_ROW_TILE), DX_ROW_CTAS_PER_SM * sms))
    sizes = {"dh": M * d, "rows_partials": G * 2 * d, "bias_partials": mtiles * n}
    return {"dh_grid": (mtiles, -(-d // bn)), "rows_grid": G, **sizes,
            "ws": sum(sizes.values())}


def dw_plan(M: int, d: int, n: int, sms: int) -> dict:
    """The dw wrapper's launch plan, from the shapes and the SM count alone.

    The product's output ``tile`` is (``TILE_ROWS`` columns of d,
    ``TILE_COLS`` of n). The rows are dealt to ``G`` chunks, one CTA per
    (tile, chunk), each writing an f32 partial copy of dw. G fills whole
    waves of the card's CTA slots: the least ceil(G * tiles / slots) / G
    (the waves each chunk's share of the rows costs) over G up to
    ``DW_MAX_G`` and one chunk per ``DW_STAGE_ROWS`` rows, the smaller G on
    a tie."""
    tiles = -(-d // TILE_ROWS) * -(-n // TILE_COLS)
    slots = TILE_CTAS_PER_SM * sms
    cands = range(1, max(1, min(DW_MAX_G, -(-M // DW_STAGE_ROWS))) + 1)
    G = min(cands, key=lambda g: (-(-g * tiles // slots) / g, g))
    return {"tile": (TILE_ROWS, TILE_COLS), "G": G}


def _rows(what, name, t, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} must be {dtype} {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be contiguous with a 16-byte aligned base")


def _w_layout(what, w) -> None:
    """w [d, n] as the tiled kernels stage it: a unit stride in one dim,
    the other a multiple of the 16-byte vector, a 16-byte aligned base."""
    sk, sn = w.stride()
    vec = 16 // w.element_size()
    if not ((sk == 1 and sn % vec == 0) or (sn == 1 and sk % vec == 0)) or w.data_ptr() % 16:
        raise ValueError(f"{what}: w [d, n] needs a unit stride in one dim, the other a "
                         f"multiple of {vec}, and a 16-byte aligned base; got strides "
                         f"{w.stride()}")


def _check_bwd(what, x, dy, w, gamma, beta):
    """Validate what the backward kernels take; returns (M, d, n, suffix)."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{what}: the kernels take f32 or bf16 x, got {x.dtype}")
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"{what}: want x [M, d] and dy [M, n], got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")
    M, d = x.shape
    n = dy.shape[1]
    if M < 1 or d % 8 or n % 8:
        raise ValueError(f"{what}: the kernels take M >= 1 and d, n multiples of 8, got "
                         f"M={M} d={d} n={n}")
    if dy.dtype != x.dtype:
        raise TypeError(f"{what}: the kernels take x, w and dy in one dtype, got x "
                        f"{x.dtype}, dy {dy.dtype}")
    _rows(what, "x", x, x.dtype, (M, d))
    _rows(what, "dy", dy, x.dtype, (M, n))
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t is not None:
            _rows(what, name, t, torch.float32, (d,))
    if w is not None:
        if tuple(w.shape) != (d, n) or w.dtype != x.dtype:
            raise TypeError(f"{what}: w must be {x.dtype} [{d}, {n}], got {w.dtype} "
                            f"{tuple(w.shape)}")
        _w_layout(what, w)
    for name, t in (("dy", dy), ("w", w), ("gamma", gamma), ("beta", beta)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")
    return M, d, n, _SUFFIX[x.dtype]


def ln_matmul_bwd_dx(x, gamma, w, dy, *, eps: float = 1e-6):
    """Backward, part 1: ``(dx, dgamma, dbeta, dbias, mean, rstd)``; mean
    and rstd are the rows' statistics [M] f32, the dw kernel's input. CUDA
    tensors: the product dh = dy @ w^T into an f32 workspace, the row pass
    and the partial sums' reductions (``dx_plan``), counted as one launch;
    CPU tensors: the plain backward's."""
    if not _build.on_cuda(x, "ln_matmul_bwd_dx"):
        return _dx_math(x, gamma, w, dy, eps, mm_exact)
    M, d, n, sfx = _check_bwd("ln_matmul_bwd_dx", x, dy, w, gamma, None)
    dev = x.device
    plan = dx_plan(M, d, n, _sms(dev))
    dx = torch.empty(M, d, dtype=x.dtype, device=dev)
    stats = torch.empty(2, M, dtype=torch.float32, device=dev)
    ws = torch.empty(plan["ws"], dtype=torch.float32, device=dev)
    out = torch.empty(2 * d + n, dtype=torch.float32, device=dev)
    sk, sn = w.stride()
    lib = _build.load("ln_matmul_bwd")
    rc = getattr(lib, f"ln_bwd_dx_{sfx}")(
        x.data_ptr(), gamma.data_ptr(), w.data_ptr(), sk, sn, dy.data_ptr(), dx.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), ws.data_ptr(), out.data_ptr(), M, d, n,
        plan["rows_grid"], float(eps), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "ln_matmul_bwd_dx")
    ln_matmul_bwd_dx.launches += 1
    return dx, out[:d], out[d:2 * d], out[2 * d:], stats[0], stats[1]


def _launch_dw(x, gamma, beta, dy, mean, rstd, G):
    """The dw product (split over M into G chunks) and its reduction on
    validated CUDA tensors."""
    M, d = x.shape
    n = dy.shape[1]
    ws = torch.empty(G * d * n, dtype=torch.float32, device=x.device)
    dw = torch.empty(d, n, dtype=x.dtype, device=x.device)
    lib = _build.load("ln_matmul_bwd")
    rc = getattr(lib, f"ln_bwd_dw_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), dy.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), ws.data_ptr(), dw.data_ptr(), M, d, n, G,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "ln_matmul_bwd_dw")
    return dw


def ln_matmul_bwd_dw(x, gamma, beta, dy, mean, rstd):
    """Backward, part 2: ``dw = h^T @ dy`` [d, n], summed in f32 and cast
    to x's dtype (the kernels' one dtype, w's), with h = (x - mean) * rstd
    * gamma + beta from the rows' ``mean, rstd`` that ``ln_matmul_bwd_dx``
    returns (the statistics JAX's kernel recomputes from x: the same
    function). CUDA tensors: the tiled product split over M into f32
    partials and their reduction (``dw_plan``), counted as one launch; CPU
    tensors: the plain backward's."""
    if not _build.on_cuda(x, "ln_matmul_bwd_dw"):
        return _dw_math(x, gamma, beta, dy, mean, rstd, mm_exact).to(x.dtype)
    M, d, n, _ = _check_bwd("ln_matmul_bwd_dw", x, dy, None, gamma, beta)
    dev = x.device
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or tuple(t.shape) != (M,) or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"ln_matmul_bwd_dw: {name} must be contiguous f32 [{M}] on {dev}")
    dw = _launch_dw(x, gamma, beta, dy, mean, rstd, dw_plan(M, d, n, _sms(dev))["G"])
    ln_matmul_bwd_dw.launches += 1
    return dw


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------


class LnMatmul(torch.autograd.Function):
    """The custom VJP of the JAX op: the forward kernel saves ``(x, gamma,
    beta, w)``; the backward casts dy to the output dtype and runs the
    ``bwd_impl`` backward. Gradients: dx in x's dtype, dw in w's dtype (a
    view such as ``linear.weight.t()`` gets it in its own shape), dgamma,
    dbeta and dbias f32."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, eps, out_dtype, bwd_impl):
        ctx.save_for_backward(x, gamma, beta, w)
        ctx.eps, ctx.out_dtype, ctx.bwd_impl = eps, out_dtype, bwd_impl
        ctx.has_bias = bias is not None
        return _fwd(x, gamma, beta, w, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w = ctx.saved_tensors
        dy = dy.to(ctx.out_dtype).contiguous()
        if ctx.bwd_impl == "xla":
            dx, dg, db, dw, dbias = xla_bwd(x, gamma, beta, w, dy, eps=ctx.eps)
        else:
            dx, dg, db, dbias, mean, rstd = ln_matmul_bwd_dx(x, gamma, w, dy, eps=ctx.eps)
            dw = ln_matmul_bwd_dw(x, gamma, beta, dy, mean, rstd).to(w.dtype)
        return dx, dg, db, dw, dbias if ctx.has_bias else None, None, None, None


def ln_matmul(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w: torch.Tensor, bias: torch.Tensor | None = None, *,
              eps: float = 1e-6, out_dtype=None, bwd_impl: str | None = None) -> torch.Tensor:
    """``LayerNorm(x; gamma, beta) @ w + bias`` in one kernel.

    x: [M, d] f32 or bf16; gamma/beta: [d] f32; w: [d, n] in x's dtype,
    either contiguous or the transposed view ``linear.weight.t()`` of an
    ``nn.Linear`` weight [n, d]; bias: [n] f32 or None. Returns [M, n] in
    ``out_dtype`` (default x.dtype; bf16 input may also give f32). When
    autograd records the call it runs through ``LnMatmul``, whose backward
    is ``bwd_impl``'s (``_policy.resolve_bwd_impl``); ``ln_matmul.launches``
    counts forward kernel launches (``fwd_plan``: the row-tile kernel
    below ``LN_TILED_MIN_M`` rows, the tiled pair from there up, which
    ``ln_matmul.tiled_launches`` counts alone; the tiled pair raises
    unless d and n are multiples of 8)."""
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, gamma, beta, w, bias)):
        return LnMatmul.apply(x, gamma, beta, w, bias, float(eps), out_dtype,
                              resolve_bwd_impl(bwd_impl))
    return _fwd(x, gamma, beta, w, bias, eps, out_dtype)


ln_matmul.launches = ln_matmul_bwd_dx.launches = ln_matmul_bwd_dw.launches = 0
ln_matmul.tiled_launches = 0

#: the three kernel wrappers, by the name chip_smoke.py and PERF.md use
KERNELS = {"ln_matmul": ln_matmul, "ln_matmul_bwd_dx": ln_matmul_bwd_dx,
           "ln_matmul_bwd_dw": ln_matmul_bwd_dw}
