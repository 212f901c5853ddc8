"""FlashAttention for training — the hand-written CUDA kernels
(``csrc/flash_attention.cu``: forward, dK/dV, dQ), their plain PyTorch
versions and the ``torch.autograd.Function`` that wires them.

Counterpart of ``flash_attention`` in ``distributed_tensorflow_tpu/ops/
flash_attention.py`` (``_fwd_kernel``, ``_bwd_dkv_kernel``,
``_bwd_dq_kernel`` behind ``jax.custom_vjp``). Contract as there: q
[B,H,Sq,D], k/v [B,H,Sk,D], ``kv_mask`` [B,Sk] bool (True attends),
causal aligned by ``q_offset = Sk - Sq``, output in q's dtype; the
forward also gives the row log-sum-exp in f32, ``[B,H,Sq]`` (the TPU's
8-lane stat padding is dropped). A row that attends nothing comes out 0
with LSE ``NEG_INF`` and gets zero gradients. Differences from the TPU
kernel, deliberate: any Sq/Sk works (the kernel masks the ragged edge,
so no 128-multiple padding), the tile shape is the kernel's own launch
config (no block-size knob), and dQ is a kernel of its own with the q
tile resident, so no float atomics and a deterministic backward.

The wrappers ``flash_fwd``, ``flash_bwd_dkv`` and ``flash_bwd_dq`` launch
their kernel for CUDA tensors (built with nvcc on first use) and raise
on what it does not take; for CPU tensors — and only for those — they
compute the plain version. Each counts its launches in ``.launches``,
by the head dim it launched at in ``.launches_by_d``, and by the head
dim its caller asked for in ``.launches_by_asked_d``.

The kernels are instantiated at ``HEAD_DIMS``; ``flash_attention`` takes
any head dim up to 256: one that is not instantiated (8 and 16, the JAX
package's tools' shapes; 192) is zero-padded to the next one
(``padded_head_dim``) with the softmax scale of the original, and the
output sliced back. That is exact: the pad columns add 0 to QKᵀ, come out
0 in O, dQ, dK and dV, and add nothing to the backward's rowsum(dO∘O).
The CPU's plain path pads alike. A head dim above 256 is refused (ROADMAP
Queue C; no public configuration reaches it). The f32 kernels (checks,
not speed) take the same head dims: 64-row tiles up to 128, 32-row
tiles at 256, where four 64-row f32 tiles would exceed shared memory.
Inputs are read through their strides with the head dimension
contiguous (the model's ``[B,S,H,D] -> [B,H,S,D]`` views need no copy);
a tensor whose last dimension is strided is made contiguous first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .attention import NEG_INF

#: head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 128, 256)
#: the ones the f32 kernels take (at 256 on 32-row tiles)
F32_HEAD_DIMS = HEAD_DIMS


def padded_head_dim(D: int) -> int:
    """The instantiated head dim a call at ``D`` launches at: ``D`` itself
    when instantiated, else the next one up (``flash_attention`` pads
    with zeros); above ``max(HEAD_DIMS)`` raises."""
    if D in HEAD_DIMS:
        return D
    up = [h for h in HEAD_DIMS if h > D]
    if D < 1 or not up:
        raise ValueError(f"head_dim {D}: the flash kernels take head dims up to "
                         f"{max(HEAD_DIMS)} (instantiated at {HEAD_DIMS}, others "
                         f"zero-padded); larger ones are open in ROADMAP Queue C, and no "
                         f"public configuration reaches them (attention_impl='dense' or "
                         f"'blockwise' takes any head_dim)")
    return up[0]


def _scale(q: torch.Tensor, sm_scale: float | None) -> float:
    return float(sm_scale) if sm_scale is not None else q.shape[-1] ** -0.5


def _valid(kv_mask, causal: bool, B: int, Sq: int, Sk: int, device) -> torch.Tensor | None:
    """[B,1,Sq,Sk] (or broadcastable) attend mask, None when all attend."""
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.bool).reshape(B, 1, 1, Sk)
    if causal:
        qi = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
        tri = (torch.arange(Sk, device=device)[None, :] <= qi)[None, None]
        mask = tri if mask is None else mask & tri
    return mask


def flash_attention_plain(q, k, v, kv_mask=None, *, causal: bool = False,
                          sm_scale: float | None = None):
    """The forward kernel's math in plain PyTorch: f32 logits and
    softmax with an explicit zero under the mask, the probabilities
    rounded to q's dtype for the value product (a no-op in f32; the
    kernel feeds its tensor cores that way), f32 sums. Returns ``(out
    [B,H,Sq,D] in q.dtype, lse [B,H,Sq] f32)``; a row that attends
    nothing gives 0 and ``NEG_INF``."""
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q, sm_scale)
    mask = _valid(kv_mask, causal, B, Sq, Sk, q.device)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    lsum = p.sum(-1, keepdim=True)
    out = torch.matmul(p.to(q.dtype).float(), v.float()) / lsum.clamp_min(1e-30)
    lse = torch.where(lsum > 0, m + torch.log(lsum.clamp_min(1e-30)), NEG_INF)
    return out.to(q.dtype), lse[..., 0]


def flash_attention_bwd_plain(q, k, v, kv_mask, out, lse, dout, *, causal: bool = False,
                              sm_scale: float | None = None):
    """The backward kernels' math in plain PyTorch: p recomputed from the
    LSE (0 under the mask), delta = rowsum(dO * O) in f32,
    ds = p * (dp - delta) * scale, p and ds rounded to q's dtype before
    their products (a no-op in f32). Returns ``(dq, dk, dv)`` in the
    inputs' dtypes."""
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    scale = _scale(q, sm_scale)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(logits - lse.float()[..., None])
    mask = _valid(kv_mask, causal, B, Sq, Sk, q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta) * scale
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _strided(name: str, t: torch.Tensor) -> tuple[torch.Tensor, list]:
    """``t`` as the kernel reads it: (pointer, stride_b, stride_h,
    stride_s) with a contiguous head dim and 16-byte rows."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    vec = 16 // t.element_size()
    sb, sh, ss, _ = t.stride()
    if t.data_ptr() % 16 or sb % vec or sh % vec or ss % vec:
        raise ValueError(
            f"{name}: the flash kernels load rows 16 bytes at a time; the pointer and "
            f"the b/h/s strides {t.stride()[:3]} must be 16-byte multiples")
    return t, [t.data_ptr(), sb, sh, ss]


def _check(q, k, v, kv_mask, *extra):
    if q.dtype not in _SUFFIX:
        raise TypeError(f"flash attention kernels take f32 or bf16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)) + extra:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,H,Sq,D] and k/v [B,H,Sk,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the flash kernels are built for {HEAD_DIMS}; "
                         f"flash_attention zero-pads a smaller one to the next of them, "
                         f"and larger ones are open in ROADMAP Queue C")
    for name, t in (("q", q), ("k", k), ("v", v)) + extra:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, k.shape[2]) or kv_mask.device != q.device:
            raise ValueError(f"kv_mask must be [B={B}, Sk={k.shape[2]}] on {q.device}, got "
                             f"{tuple(kv_mask.shape)} on {kv_mask.device}")
        kv_mask = kv_mask.to(torch.bool).contiguous()
    return kv_mask


def _count(wrapper, D: int, asked: int | None) -> None:
    """One launch of ``wrapper``'s kernel at head dim ``D``, for a caller
    at head dim ``asked`` (``D`` when None)."""
    wrapper.launches += 1
    wrapper.launches_by_d[D] = wrapper.launches_by_d.get(D, 0) + 1
    asked = D if asked is None else asked
    wrapper.launches_by_asked_d[asked] = wrapper.launches_by_asked_d.get(asked, 0) + 1


def _common_tail(q, k, causal, scale):
    B, H, Sq, D = q.shape
    return [B, H, Sq, k.shape[2], D, int(bool(causal)), float(scale)]


def flash_fwd(q, k, v, kv_mask=None, *, causal: bool = False, sm_scale: float | None = None,
              head_dim: int | None = None):
    """Forward: ``(out, lse)``. CUDA tensors: one launch of the forward
    kernel on the current stream; CPU tensors: ``flash_attention_plain``.
    ``head_dim``: the caller's, when q/k/v were zero-padded (counted in
    ``launches_by_asked_d``)."""
    if not _build.on_cuda(q, "flash_fwd"):
        return flash_attention_plain(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale)
    kv_mask = _check(q, k, v, kv_mask)
    (q, qa), (k, ka), (v, va) = (_strided(n, t) for n, t in (("q", q), ("k", k), ("v", v)))
    B, H, Sq, D = q.shape
    out = torch.empty(B, H, Sq, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    _build.launch(_build.load("flash_attention"), f"flash_fwd_{_SUFFIX[q.dtype]}", "flash_fwd",
                  q.device, *qa, *ka, *va, kv_mask.data_ptr() if kv_mask is not None else None,
                  out.data_ptr(), lse.data_ptr(), *_common_tail(q, k, causal, _scale(q, sm_scale)))
    _count(flash_fwd, q.shape[-1], head_dim)
    return out, lse


def _bwd_args(q, k, v, kv_mask, out, lse, dout):
    kv_mask = _check(q, k, v, kv_mask, ("out", out), ("dout", dout))
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"out/dout must be {tuple(q.shape)}, got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"lse must be f32 {tuple(q.shape[:3])}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    lse = lse.contiguous()
    tensors = [_strided(n, t) for n, t in
               (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout))]
    args = [a for _, t_args in tensors for a in t_args]
    args += [kv_mask.data_ptr() if kv_mask is not None else None, lse.data_ptr()]
    keep = [t for t, _ in tensors] + [lse, kv_mask]  # alive across the launch
    return args, keep


def flash_bwd_dkv(q, k, v, kv_mask, out, lse, dout, *, causal: bool = False,
                  sm_scale: float | None = None, head_dim: int | None = None):
    """dK, dV with the kv tile resident. CUDA tensors: one launch;
    CPU tensors: the plain backward's dk, dv."""
    if not _build.on_cuda(q, "flash_bwd_dkv"):
        _, dk, dv = flash_attention_bwd_plain(q, k, v, kv_mask, out, lse, dout,
                                              causal=causal, sm_scale=sm_scale)
        return dk, dv
    args, _alive = _bwd_args(q, k, v, kv_mask, out, lse, dout)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _build.launch(_build.load("flash_attention"), f"flash_bwd_dkv_{_SUFFIX[q.dtype]}",
                  "flash_bwd_dkv", q.device, *args, dk.data_ptr(), dv.data_ptr(),
                  *_common_tail(q, k, causal, _scale(q, sm_scale)))
    _count(flash_bwd_dkv, q.shape[-1], head_dim)
    return dk, dv


def flash_bwd_dq(q, k, v, kv_mask, out, lse, dout, *, causal: bool = False,
                 sm_scale: float | None = None, head_dim: int | None = None):
    """dQ with the q tile resident. CUDA tensors: one launch; CPU
    tensors: the plain backward's dq."""
    if not _build.on_cuda(q, "flash_bwd_dq"):
        return flash_attention_bwd_plain(q, k, v, kv_mask, out, lse, dout,
                                         causal=causal, sm_scale=sm_scale)[0]
    args, _alive = _bwd_args(q, k, v, kv_mask, out, lse, dout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _build.launch(_build.load("flash_attention"), f"flash_bwd_dq_{_SUFFIX[q.dtype]}",
                  "flash_bwd_dq", q.device, *args, dq.data_ptr(),
                  *_common_tail(q, k, causal, _scale(q, sm_scale)))
    _count(flash_bwd_dq, q.shape[-1], head_dim)
    return dq


flash_fwd.launches = flash_bwd_dkv.launches = flash_bwd_dq.launches = 0
for _w in (flash_fwd, flash_bwd_dkv, flash_bwd_dq):
    _w.launches_by_d, _w.launches_by_asked_d = {}, {}
del _w


class FlashAttention(torch.autograd.Function):
    """The custom VJP of the JAX version: the forward saves ``(q, k, v,
    kv_mask, out, lse)``; the backward launches dK/dV, then dQ. On CPU
    tensors the backward is the plain version, computed once."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, sm_scale, head_dim=None):
        out, lse = flash_fwd(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale,
                             head_dim=head_dim)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.sm_scale, ctx.head_dim = causal, sm_scale, head_dim
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, kv_mask, out, lse, dout, **kw)
        else:
            dk, dv = flash_bwd_dkv(q, k, v, kv_mask, out, lse, dout, **kw,
                                   head_dim=ctx.head_dim)
            dq = flash_bwd_dq(q, k, v, kv_mask, out, lse, dout, **kw, head_dim=ctx.head_dim)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, kv_mask=None,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Differentiable FlashAttention (see module docstring): q [B,H,Sq,D],
    k/v [B,H,Sk,D], kv_mask [B,Sk] bool or None; returns [B,H,Sq,D] in
    q's dtype. A head dim the kernels are not instantiated at is
    zero-padded to ``padded_head_dim(D)`` and the output sliced back."""
    scale = _scale(q, sm_scale)
    D = q.shape[-1]
    Dp = padded_head_dim(D)
    if Dp == D:
        return FlashAttention.apply(q, k, v, kv_mask, causal, scale)
    q, k, v = (F.pad(t, (0, Dp - D)) for t in (q, k, v))
    return FlashAttention.apply(q, k, v, kv_mask, causal, scale, D)[..., :D]

