"""Attention: the dense reference and the training dispatch
(``attention``), and over the paged KV pool the K/V scatter, the gather
view, masked cached attention and the ``paged_attention`` dispatch.

Counterpart of ``distributed_tensorflow_tpu/ops/attention.py``
(``attention_reference`` and the paged half), with its layouts:
attention tensors ``[B,H,S,D]``, the per-layer pool ``[NB,H,bs,D]``,
block tables int32 ``[B,MB]``. One difference is deliberate: JAX scatters with ``mode="drop"`` so padded
rows and idle slots write nothing, while an out-of-range index on a
CUDA tensor is a device-side assert. The port's per-layer pool therefore
carries ONE extra trailing block (``[NB+1,H,bs,D]``, see
``serve.kv_cache.PagedKVCache``) that every such write is routed to on
the device, with no host sync; attention only ever reads ``pool[:NB]``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free

PAGED_IMPLS = ("auto", "gather", "fused", "cuda")
IMPLS = ("auto", "dense", "flash")


def _scale(q: torch.Tensor, sm_scale: float | None) -> float:
    return sm_scale if sm_scale is not None else q.shape[-1] ** -0.5


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain softmax(QKᵀ)V: q [B,H,Sq,D], k/v [B,H,Sk,D], kv_mask [B,Sk]
    bool (True = attend), causal aligned by ``Sk - Sq``. f32 logits and
    softmax, probabilities cast to v's dtype for the value product;
    returns [B,H,Sq,D] in q's dtype. As in the JAX version, a row that
    attends nothing is a uniform softmax over ``NEG_INF`` logits (the
    mean of v), not zeros as in the flash kernel."""
    Sq, Sk = q.shape[2], k.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q, sm_scale)
    if kv_mask is not None:
        logits = torch.where(kv_mask.to(torch.bool)[:, None, None, :], logits, NEG_INF)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    impl: str = "auto",
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Training attention (the model's uncached path), selected by ``impl``:

    - ``"dense"`` — ``attention_reference`` (autograd through plain ops);
    - ``"flash"`` — the hand-written kernels
      (``ops.flash_attention.flash_attention``: forward, dK/dV, dQ); on
      CPU tensors their plain versions;
    - ``"auto"`` — ``"flash"`` for a CUDA tensor, ``"dense"`` on the CPU
      (the JAX model's "flash on the accelerator" rule).

    ``"blockwise"`` is not ported yet (ROADMAP Queue A item 2.5)."""
    if impl == "auto":
        impl = "flash" if q.is_cuda else "dense"
    if impl == "flash":
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, kv_mask=kv_mask, sm_scale=sm_scale)
    if impl == "dense":
        return attention_reference(q, k, v, causal=causal, kv_mask=kv_mask,
                                   sm_scale=sm_scale)
    raise ValueError(f"attention impl must be one of {IMPLS} (blockwise is not ported "
                     f"yet: ROADMAP Queue A item 2.5), got {impl!r}")


def paged_append_kv(
    pool: torch.Tensor,
    new: torch.Tensor,
    block_table: torch.Tensor,
    pos: torch.Tensor,
) -> torch.Tensor:
    """Scatter ``new`` [B,H,S,D] into the block pool IN PLACE and return
    it. ``pool`` is ``[NB+1, H, bs, D]``: NB physical blocks plus the
    trailing drop block. Token ``(b, s)`` at absolute position
    ``p = pos[b, s]`` lands in physical block ``block_table[b, p // bs]``
    at offset ``p % bs``.

    The padding contract of the JAX version holds: a position past the
    table (``p // bs >= MB``, the chunk-padding / idle-slot sentinel) or
    a table entry outside ``[0, NB)`` (the unallocated sentinel) writes
    into the drop block instead of a live one — decided on the device,
    so the call never waits for the host."""
    NB = pool.shape[0] - 1
    B, H, S, D = new.shape
    bs = pool.shape[2]
    MB = block_table.shape[1]
    pos = pos.long()
    blk = torch.div(pos, bs, rounding_mode="floor")  # [B,S] logical block
    off = pos - blk * bs                              # in [0, bs)
    bids = torch.gather(block_table.long(), 1, blk.clamp(0, MB - 1))
    live = (blk < MB) & (bids >= 0) & (bids < NB)
    bids = torch.where(live, bids, NB)
    flat = new.transpose(1, 2).reshape(B * S, H, D).to(pool.dtype)
    pool[bids.reshape(-1), :, off.reshape(-1)] = flat
    return pool


def paged_gather_kv(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """The contiguous logical K (or V) view ``[B, H, MB*bs, D]`` of the
    pool ``[NB, H, bs, D]`` through ``block_table`` [B, MB]. Sentinel
    entries (>= NB) clamp to the last block and read garbage that the
    ``j <= q_pos`` mask excludes."""
    NB, H, bs, D = pool.shape
    B, MB = block_table.shape
    g = pool[block_table.long().clamp(0, NB - 1).reshape(-1)]
    return g.reshape(B, MB, H, bs, D).transpose(1, 2).reshape(B, H, MB * bs, D)


def cached_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Masked full attention over a KV view: ``q`` [B,H,S,D] at absolute
    positions ``q_pos`` [B,S], ``k``/``v`` [B,H,M,D]; key ``j`` attends
    iff ``j <= q_pos``. f32 logits and softmax, probabilities cast to
    v's dtype for the value product, as in the JAX version."""
    M = k.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q, sm_scale)
    mask = torch.arange(M, device=q.device)[None, None, :] <= q_pos.long()[:, :, None]
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(q.dtype)


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    sm_scale: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention over the paged pool ``[NB,H,bs,D]``, selected by ``impl``:

    - ``"gather"`` — ``paged_gather_kv`` then ``cached_attention``: the
      exact-parity path, materialising the logical view of K and V.
    - ``"fused"`` — one pool gather per buffer consumed in block layout
      ``[B,MB,H,bs,D]`` by the attention products directly.
    - ``"cuda"`` — the hand-written kernel
      (``ops.paged_attention.paged_flash_attention``), reading blocks in
      place; on CPU tensors it computes that kernel's plain version.
    - ``"auto"`` — ``"cuda"`` for a CUDA tensor, ``"fused"`` on the CPU.
    """
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "fused"
    if impl == "gather":
        return cached_attention(
            q, paged_gather_kv(k_pool, block_table),
            paged_gather_kv(v_pool, block_table),
            q_pos=q_pos, sm_scale=sm_scale)
    if impl == "cuda":
        from .paged_attention import paged_flash_attention

        return paged_flash_attention(q, k_pool, v_pool, block_table,
                                     q_pos=q_pos, sm_scale=sm_scale)
    if impl != "fused":
        raise ValueError(
            f"paged attention impl must be one of {PAGED_IMPLS}, got {impl!r}")
    NB, H, bs, D = k_pool.shape
    B, MB = block_table.shape
    S = q.shape[2]
    ids = block_table.long().clamp(0, NB - 1).reshape(-1)
    kg = k_pool[ids].reshape(B, MB, H, bs, D)
    vg = v_pool[ids].reshape(B, MB, H, bs, D)
    logits = torch.einsum("bhsd,bmhkd->bhsmk", q.float(), kg.float()) * _scale(q, sm_scale)
    kpos = torch.arange(MB * bs, device=q.device).reshape(MB, bs)
    mask = kpos[None, None, None] <= q_pos.long()[:, None, :, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits.reshape(B, H, S, MB * bs), dim=-1).reshape(logits.shape)
    out = torch.einsum("bhsmk,bmhkd->bhsd", probs.to(vg.dtype), vg)
    return out.to(q.dtype)
