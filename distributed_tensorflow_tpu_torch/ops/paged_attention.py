"""Paged attention straight off the KV block pool — the hand-written CUDA
kernel (``csrc/paged_attention.cu``) and its plain PyTorch version.

Counterpart of ``distributed_tensorflow_tpu/ops/flash_attention.py``
``paged_flash_attention`` / ``_paged_fwd_kernel``: queries ``q``
[B,H,S,D] at absolute positions ``q_pos`` [B,S] attend the pool
``k_pool``/``v_pool`` [NB,H,bs,D] through ``block_table`` [B,MB]
(int32); key position ``p`` of row ``b`` is
``pool[block_table[b, p // bs], :, p % bs]`` and attends iff
``p <= q_pos``. Sentinel ids (>= NB) clamp to NB-1. A row that attends
nothing (``q_pos = -1``) comes out exactly 0. Forward only: decode never
differentiates, and on a CUDA tensor that requires grad (with grad mode
on) the wrapper raises rather than return a result with no gradient.

``paged_flash_attention`` launches the kernel for CUDA tensors (building
it with nvcc on first use) and raises on what the kernel does not take;
for CPU tensors — and only for those — it computes the plain version.
``paged_flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build

NEG_INF = -1e30

#: the kernel's 128 threads split D into quads of output columns
MAX_HEAD_DIM = 128


def paged_attention_plain(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """The kernel's math in plain PyTorch, all in f32: masked logits,
    ``p = exp(logit - max)`` with an explicit zero under the mask, and
    ``(p @ V) / max(sum p, 1e-30)`` — so fully masked rows give 0, as the
    kernel's online softmax does (the ``gather``/``fused`` dispatch paths
    instead spread such a row uniformly, like ``jax.nn.softmax``)."""
    NB, H, bs, D = k_pool.shape
    B, MB = block_table.shape
    S = q.shape[2]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    ids = block_table.long().clamp(0, NB - 1).reshape(-1)
    # [B*MB, H, bs, D] -> [B, H, MB*bs, D] logical view
    kg = k_pool[ids].reshape(B, MB, H, bs, D).transpose(1, 2).reshape(
        B, H, MB * bs, D).float()
    vg = v_pool[ids].reshape(B, MB, H, bs, D).transpose(1, 2).reshape(
        B, H, MB * bs, D).float()
    logits = torch.matmul(q.float(), kg.transpose(-1, -2)) * scale
    kpos = torch.arange(MB * bs, device=q.device)
    mask = (kpos[None, None, :] <= q_pos.long()[:, :, None])[:, None]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    out = torch.matmul(p, vg) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


def _check(q, k_pool, v_pool, block_table, q_pos):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged attention kernel takes f32 or bf16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"q/k_pool/v_pool dtypes differ: {q.dtype}, {k_pool.dtype}, "
            f"{v_pool.dtype}")
    if block_table.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("block_table and q_pos must be int32")
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"want q [B,H,S,D] and pools [NB,H,bs,D], got {tuple(q.shape)}, "
            f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, H, S, D = q.shape
    bs = k_pool.shape[2]
    if k_pool.shape[1] != H or k_pool.shape[3] != D:
        raise ValueError(
            f"pool heads/head_dim {tuple(k_pool.shape)} do not match q "
            f"{tuple(q.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [B={B}, MB], got "
                         f"{tuple(block_table.shape)}")
    if tuple(q_pos.shape) != (B, S):
        raise ValueError(f"q_pos must be [B={B}, S={S}], got {tuple(q_pos.shape)}")
    if D > MAX_HEAD_DIM or D % 4 or 128 % (D // 4):
        raise ValueError(f"head_dim {D}: the paged attention kernel takes a "
                         f"power of two from 8 to {MAX_HEAD_DIM}")
    if bs > 128 or bs * D * q.element_size() > 16384:
        raise ValueError(f"block_size {bs} x head_dim {D} x {q.element_size()} bytes: "
                         f"a block must fit one split (128 keys, 16 KB per tensor)")
    if (D * q.element_size()) % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the kernel loads K/V rows 16 bytes at a time: "
                         "head_dim * itemsize must be a multiple of 16 and the "
                         "pools 16-byte aligned")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("q_pos", q_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_flash_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Attention read in place from the block pool (see module
    docstring). CUDA tensors: one launch of the hand-written kernel, on
    the current stream; CPU tensors: ``paged_attention_plain``."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_table,
                                     q_pos=q_pos, sm_scale=sm_scale)
    _build.refuse_grad("paged_flash_attention", (q, k_pool, v_pool),
                       "paged attention is the forward-only decode kernel")
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu, got {q.device}")
    _check(q, k_pool, v_pool, block_table, q_pos)
    B, H, S, D = q.shape
    NB, _, bs, _ = k_pool.shape
    MB = block_table.shape[1]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    lib = _build.load("paged_attention")
    splits = lib.paged_attention_splits(D, bs, MB, q.element_size())
    out = torch.empty_like(q)
    # per-split partial results the kernel's second pass merges
    part_acc = torch.empty(B * H * splits * S * D, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(B * H * splits * S * 2, dtype=torch.float32, device=q.device)
    entry = "paged_attention_bf16" if q.dtype == torch.bfloat16 else "paged_attention_f32"
    _build.launch(lib, entry, "paged_attention", q.device, q.data_ptr(), k_pool.data_ptr(),
                  v_pool.data_ptr(), block_table.data_ptr(), q_pos.data_ptr(),
                  out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
                  B, H, S, D, NB, bs, MB, float(scale))
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0
