"""Fused LayerNorm + matmul (+bias), forward only — the hand-written
CUDA kernel (``csrc/ln_matmul.cu``) and its plain PyTorch version.

Counterpart of the forward of ``distributed_tensorflow_tpu/ops/
fused_ln_matmul.py``: every pre-LN block applies LayerNorm and feeds the
result straight into a Dense matmul (q/k/v, mlp_in); the kernel
normalises each row tile in shared memory, so the normalised tensor
never reaches device memory. Numerics as in that file: f32 row
statistics (eps inside the rsqrt), the normalised rows cast to x's
dtype, f32 accumulation, f32 bias, cast to ``out_dtype``. Forward only:
the backward kernels are ROADMAP Queue B rows 6-7, so on a CUDA tensor
that requires grad (with grad mode on) the wrapper raises instead of
returning a result autograd cannot differentiate.

``ln_matmul`` launches the kernel for CUDA tensors (building it with
nvcc on first use) and raises on what the kernel does not take; for CPU
tensors — and only for those — it computes ``ln_matmul_plain``.
``ln_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build

#: shared memory a CTA may use (227 KB on Hopper): 16 normalised rows of
#: width d (padded to 128) plus one 128x64 w tile and the f32 epilogue tile
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


_ENTRY = {
    (torch.float32, torch.float32): "ln_matmul_f32",
    (torch.bfloat16, torch.bfloat16): "ln_matmul_bf16",
    (torch.bfloat16, torch.float32): "ln_matmul_bf16_f32",
}


def ln_matmul(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w: torch.Tensor, bias: torch.Tensor | None = None, *,
              eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """``LayerNorm(x; gamma, beta) @ w + bias`` in one kernel.

    x: [M, d] f32 or bf16; gamma/beta: [d] f32; w: [d, n] in x's dtype,
    either contiguous or the transposed view ``linear.weight.t()`` of an
    ``nn.Linear`` weight [n, d]; bias: [n] f32 or None. Returns [M, n] in
    ``out_dtype`` (default x.dtype; bf16 input may also give f32)."""
    if x.device.type == "cpu":
        return ln_matmul_plain(x, gamma, beta, w, bias, eps=eps,
                               out_dtype=out_dtype)
    _build.refuse_grad("ln_matmul", (x, gamma, beta, w, bias),
                       "its backward kernels are ROADMAP Queue B rows 6-7 "
                       "(slice 3: fused_ln_matmul training)")
    if x.device.type != "cuda":
        raise ValueError(f"ln_matmul runs on cuda or cpu, got {x.device}")
    out_dtype = out_dtype or x.dtype
    entry = _ENTRY.get((x.dtype, out_dtype))
    if entry is None:
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
    smem = x.element_size() * (16 * (-(-d // 128) * 128 + 8) + 128 * 72) + 4 * 16 * 64
    if smem > _SMEM_LIMIT:
        raise ValueError(f"d={d} needs {smem} bytes of shared memory per CTA "
                         f"(limit {_SMEM_LIMIT})")
    y = torch.empty(M, n, dtype=out_dtype, device=x.device)
    lib = _build.load("ln_matmul")
    rc = getattr(lib, entry)(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        bias.data_ptr(), y.data_ptr(), M, d, n, sk, sn, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "ln_matmul")
    ln_matmul.launches += 1
    return y


ln_matmul.launches = 0
