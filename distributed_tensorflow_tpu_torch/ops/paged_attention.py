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
it with nvcc on first use) at ``paged_plan``'s plan and raises on what the
kernel does not take; for CPU tensors — and only for those — it computes
the plain version. ``paged_flash_attention.launches`` counts kernel
launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build

NEG_INF = -1e30

#: head dims the kernel takes (its mma tiles: 16 columns at least, D = 8
#: zero-padded to 16)
HEAD_DIMS = (8, 16, 32, 64, 128)

#: keys of one chunk: a rank's unit of K/V in its shared-memory ring
PAGED_CHUNK = 64
#: CTAs per SM the plan keeps the grid within, one wave of them (a second
#: waits for the first), or as many as fit the SM's shared memory if fewer:
#: 3 of 4 warps (S <= 32: ~45-60 KB at D=64 bf16, up to 128 registers a
#: thread on the mma path, ~60 on the S = 1 CUDA-core path), 2 of 8 (S >
#: 32: 128 registers a thread fill half the SM's)
PAGED_CTAS_PER_SM = 3
PAGED_WIDE_CTAS_PER_SM = 2
_PA = _build.constants("paged_attention")
#: the kernel's shapes, stated once in its source: warps a CTA (S <= 32,
#: longer), keys a warp step, ring stages at most, the largest cluster,
#: table ids a CTA holds
_WARPS, _WIDE_WARPS = _PA["PA_THREADS"] // 32, _PA["PA_WIDE_THREADS"] // 32
_KS, _STAGES = _PA["PA_KS"], _PA["PA_STAGES"]
_MAX_RANKS, _IDS = _PA["PA_MAX_RANKS"], _PA["PA_IDS"]
#: shared memory a CTA may take, and an SM's, of which each resident CTA
#: leaves 1 KB to the system (bytes; H100)
_SMEM_LIMIT = 232448
_SM_SMEM = 233472


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
    if block_table.dim() != 2 or block_table.shape[0] != B or block_table.shape[1] < 1:
        raise ValueError(f"block_table must be [B={B}, MB >= 1], got "
                         f"{tuple(block_table.shape)}")
    if tuple(q_pos.shape) != (B, S):
        raise ValueError(f"q_pos must be [B={B}, S={S}], got {tuple(q_pos.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the paged attention kernel takes a "
                         f"power of two from 8 to {HEAD_DIMS[-1]}")
    if bs > 128 or bs * D * q.element_size() > 16384:
        raise ValueError(f"block_size {bs} x head_dim {D} x {q.element_size()} bytes: "
                         f"the kernel takes blocks of up to 128 keys and 16 KB per tensor")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("the kernel copies q and K/V rows 16 bytes at a time: "
                         "q and the pools must be 16-byte aligned")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("q_pos", q_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class PagedPlan(NamedTuple):
    """``paged_plan``'s launch: a cluster of ``ranks`` CTAs per (b, h) and
    row tile, rank r taking the chunks ``[r * cpr, (r + 1) * cpr)`` of
    ``chunk`` keys each; ``rows``: query rows of a tile; ``grid``: (ranks
    x row tiles, H, B)."""
    ranks: int
    chunk: int
    cpr: int
    rows: int
    grid: tuple[int, int, int]


@functools.lru_cache(maxsize=None)
def paged_plan(B: int, H: int, S: int, MB: int, bs: int, D: int, esz: int,
               sms: int) -> PagedPlan:
    """The kernel's launch plan from the shapes and the SM count alone (so
    the merge's order of sums is fixed per card model; a pure function,
    memoised).

    A tile holds up to 64 query rows (16 a row group; at S <= 16 one group
    of 4 warps sharing the keys, at S <= 32 two groups of 2, longer four
    groups of 2 of a CTA's 8 warps), so for S <= 64 one cluster per (b, h)
    reads each K/V block once. The row's ``MB * bs`` keys fall into chunks
    of ``PAGED_CHUNK`` keys (halved down to 16 while a CTA would not fit
    shared memory: f32 at D=128). The plan takes the most ranks (up to 8,
    never more than the chunks) whose grid stays within one wave —
    ``PAGED_CTAS_PER_SM`` CTAs an SM (``PAGED_WIDE_CTAS_PER_SM`` at S > 32),
    or as many as fit the SM's shared memory, whichever is fewer — else 1;
    each rank takes the fewest chunks that cover them all, and ranks that
    would be left empty are dropped."""
    rows = 16 if S <= 16 else 32 if S <= 32 else 64
    tiles = max(1, -(-S // rows))
    clusters = max(1, B * H * tiles)
    cap = PAGED_CTAS_PER_SM if S <= 32 else PAGED_WIDE_CTAS_PER_SM
    kc = PAGED_CHUNK
    while True:
        chunks = -(-(MB * bs) // kc)
        fallback = None
        for want in range(min(_MAX_RANKS, chunks), 0, -1):
            cpr = -(-chunks // want)
            ranks = -(-chunks // cpr)
            plan = PagedPlan(ranks, kc, cpr, rows, (ranks * tiles, H, B))
            smem = paged_smem(plan, S, D, esz)
            if smem > _SMEM_LIMIT:
                continue
            fallback = plan
            if clusters * ranks <= min(cap, _SM_SMEM // (smem + 1024)) * sms:
                return plan
        if fallback is not None:
            return fallback
        if kc == _KS:
            raise ValueError(f"paged attention: D={D} needs {smem} bytes of shared memory "
                             f"per CTA at {plan} (limit {_SMEM_LIMIT})")
        kc //= 2


def paged_smem(plan: PagedPlan, S: int, D: int, esz: int) -> int:
    """Shared memory of one CTA at ``plan`` (bytes; the kernel's
    ``layout``): q's rows and the K/V ring (a stage a chunk of the rank's
    share, at most ``_STAGES``; rows of max(D, 16) padded by 16 bytes),
    f32's per-warp P tiles, the merge's f32 partials of the output
    chunks the rank owns from every (rank, warp) slot and their (m, l), the
    tile's positions and warp maxima, the table ids of a pass."""
    r16 = lambda a: -(-a // 16) * 16  # noqa: E731
    warps = _WARPS if S <= 32 else _WIDE_WARPS
    wk = 4 if S <= 16 else 2 if S <= 32 else warps // 4  # warps sharing a group's keys
    rl = min(S, plan.rows)
    ld = max(D, 16) + 16 // esz
    nown = -(-(rl * (D // 8)) // plan.ranks)
    stages = min(plan.cpr, _STAGES)
    return (esz * ld * (plan.rows + stages * 2 * plan.chunk)
            + (warps * 16 * (_KS + 4) * 4 if esz == 4 else 0)
            + plan.ranks * wk * nown * 32 + r16(plan.ranks * wk * rl * 8)
            + r16((plan.rows + warps) * 4) + _IDS * 4)


_SMS: dict = {}


def _sms(dev) -> int:
    """The device's SM count, read once per device."""
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


_ENTRY = {torch.float32: "paged_attention_f32", torch.bfloat16: "paged_attention_bf16"}


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
    docstring). CUDA tensors: one launch of the hand-written kernel at
    ``paged_plan``'s plan, on the current stream; CPU tensors:
    ``paged_attention_plain``."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_table,
                                     q_pos=q_pos, sm_scale=sm_scale)
    _build.refuse_grad("paged_flash_attention", (q, k_pool, v_pool),
                       "paged attention is the forward-only decode kernel")
    _build.on_cuda(q, "paged attention")  # raises on any device but cuda
    _check(q, k_pool, v_pool, block_table, q_pos)
    B, H, S, D = q.shape
    NB, _, bs, _ = k_pool.shape
    MB = block_table.shape[1]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    plan = paged_plan(B, H, S, MB, bs, D, q.element_size(), _sms(q.device))
    out = torch.empty_like(q)
    _build.launch(_build.load("paged_attention"), _ENTRY[q.dtype], "paged_attention",
                  q.device, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  block_table.data_ptr(), q_pos.data_ptr(), out.data_ptr(), B, H, S, D, NB,
                  bs, MB, plan.ranks, plan.chunk, plan.cpr, float(scale))
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0
