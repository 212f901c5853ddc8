"""Sequence parallelism: ring attention, Ulysses and all-gather K/V — the
port's counterpart of ``distributed_tensorflow_tpu/parallel/ring_attention.py``.

Three interchangeable schedules of attention over a sequence split on the
``seq`` mesh axis; ``sequence_parallel_attention`` is the dispatcher the
transformer calls (``model.seq_impl``):

- **ring**: the K/V chunks rotate around the ``seq`` ring
  (``collectives.ring_permute``) while each rank folds every visiting
  chunk into its queries' online-softmax state (``_inner_attention``:
  dense f32 with global-coordinate masks; the JAX schedule has no Pallas
  kernel here either). Each fold is recomputed in the backward
  (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``); the permute's
  backward is the reverse permute, so the gradient ring falls out of
  autograd. Causal: a strictly-future chunk's fold is skipped while its
  permute still runs.
- **ulysses**: ``all_to_all`` re-splits seq→heads, the local heads attend
  over the whole sequence (the flash kernels, ``ops/flash_attention.py``,
  on the card; ``attention_reference`` otherwise), then heads→seq. The
  rank's heads (``H`` here is this rank's ``model`` share) must divide by
  the ``seq`` size.
- **allgather**: K, V and the mask all-gathered over ``seq``; the local
  queries attend to the whole sequence (non-causal through the flash
  kernels at Sq = S/seq, Sk = S; causal dense, its queries at the traced
  offset ``idx·S_local``, as JAX's).

**The island.** JAX runs each schedule inside ``shard_map``: outside it the
activations are not split over ``seq``. The port's caller therefore hands
in what the JAX model holds outside the island on this rank — its
``(data, fsdp)`` batch rows, its ``model`` heads and the *whole* sequence
— and gets the whole sequence's output back. The rank keeps its
contiguous query chunk ``[idx·S_local, (idx+1)·S_local)``
(``collectives.scatter_to_axis``), runs the schedule and all-gathers the
output over ``seq`` (``collectives.gather_from_axis``). The two are a
conjugate pair: the entry's backward all-gathers the chunks' gradients and
the exit's keeps this rank's chunk of the (replicated) cotangent, so every
``seq`` rank ends a step with the same, whole gradient of every parameter.
The train step therefore reduces gradients over ``(data, fsdp)`` alone;
a sum over ``seq`` on top would multiply them by its size.
"""

from __future__ import annotations

from typing import Literal

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import NEG_INF, attention_reference
from . import collectives as col
from .mesh import MODEL, SEQ, Mesh

Impl = Literal["ring", "ulysses", "allgather"]
IMPLS = ("ring", "ulysses", "allgather")


def _inner_attention(q, k, v, *, causal: bool, kv_mask, q_offset: int, kv_offset: int):
    """Dense attention of local tiles with global-coordinate masks: q
    [B,H,Sq,D] from global position ``q_offset``, k/v [B,H,Sk,D] from
    ``kv_offset``, ``kv_mask`` [B,Sk] bool or None. Returns ``(out, m,
    l)`` in f32: the unnormalised accumulator and the row statistics, for
    the caller to merge."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    mask = None
    if kv_mask is not None:
        mask = kv_mask[:, None, None, :]
    if causal:
        qpos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = kv_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        tri = (kpos <= qpos)[None, None]
        mask = tri if mask is None else mask & tri
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    return torch.matmul(p, v.float()), m, p.sum(-1)


class _KeepInGraph(torch.autograd.Function):
    """The identity on ``x``, whose backward gives each of ``others`` a
    zero gradient: a skipped fold's K/V chunk stays in the graph, so the
    backward of the permute that brought it runs on this rank too (the
    transpose of JAX's ``cond``; every rank of the ring must take part)."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.others))


def _ring(q, k, v, kv_mask, mesh: Mesh, *, causal: bool, n: int, s_local: int):
    """The ring schedule on this rank's chunks (JAX ``_ring_body``)."""
    idx = col.axis_index(SEQ, mesh)
    q_offset = idx * s_local
    B, H, Sq, D = q.shape
    # the mask rides the ring as bytes (every backend sums them)
    mask = (torch.ones(B, k.shape[2], dtype=torch.uint8, device=q.device) if kv_mask is None
            else kv_mask.to(torch.uint8))

    def fold(acc, m_run, l_run, k_t, v_t, mask_t, src):
        out, m, l = _inner_attention(q, k_t, v_t, causal=causal, kv_mask=mask_t.bool(),
                                     q_offset=q_offset, kv_offset=src * s_local)
        m_new = torch.maximum(m_run, m)
        c_old, c_cur = torch.exp(m_run - m_new), torch.exp(m - m_new)
        return (acc * c_old[..., None] + out * c_cur[..., None], m_new,
                l_run * c_old + l * c_cur)

    def maybe_fold(state, k_t, v_t, mask_t, src):
        if causal and src > idx:  # a strictly-future chunk: every key masked
            return (_KeepInGraph.apply(state[0], k_t, v_t), *state[1:])
        return checkpoint(fold, *state, k_t, v_t, mask_t, src, use_reentrant=False,
                          preserve_rng_state=False)

    state = (q.new_zeros((B, H, Sq, D), dtype=torch.float32),
             q.new_full((B, H, Sq), NEG_INF, dtype=torch.float32),
             q.new_zeros((B, H, Sq), dtype=torch.float32))
    k_t, v_t, mask_t = k, v, mask
    # n - 1 folds, each followed by a rotation; the last visiting chunk is
    # folded after the loop (a rotation after it would move data for nothing)
    for t in range(n - 1):
        state = maybe_fold(state, k_t, v_t, mask_t, (idx - t) % n)
        k_t, v_t, mask_t = (col.ring_permute(x, SEQ, mesh) for x in (k_t, v_t, mask_t))
    acc, _, l_sum = maybe_fold(state, k_t, v_t, mask_t, (idx + 1) % n)
    return (acc / l_sum.clamp_min(1e-30)[..., None]).to(q.dtype)


def _local_attention(q, k, v, kv_mask, *, causal: bool, use_flash: bool):
    if use_flash:
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, kv_mask=kv_mask)
    return attention_reference(q, k, v, causal=causal, kv_mask=kv_mask)


def _gather_mask(kv_mask, mesh: Mesh):
    """The whole sequence's [B,S] mask from the ranks' chunks."""
    if kv_mask is None:
        return None
    return col.all_gather(kv_mask.to(torch.uint8), SEQ, mesh, tiled_axis=1).bool()


def _ulysses(q, k, v, kv_mask, mesh: Mesh, *, causal: bool, use_flash: bool):
    """seq→heads all-to-all, attention of the local heads over the whole
    sequence, heads→seq (JAX ``_ulysses_body``)."""
    qg, kg, vg = (col.all_to_all(x, SEQ, mesh, split_axis=1, concat_axis=2)
                  for x in (q, k, v))
    out = _local_attention(qg, kg, vg, _gather_mask(kv_mask, mesh), causal=causal,
                           use_flash=use_flash)
    return col.all_to_all(out, SEQ, mesh, split_axis=2, concat_axis=1)


def _allgather(q, k, v, kv_mask, mesh: Mesh, *, causal: bool, s_local: int,
               use_flash: bool):
    """K, V and the mask all-gathered; the local queries attend to the
    whole sequence (JAX ``_allgather_body``)."""
    kg, vg = (col.all_gather(x, SEQ, mesh, tiled_axis=2) for x in (k, v))
    maskg = _gather_mask(kv_mask, mesh)
    if use_flash and not causal:
        return _local_attention(q, kg, vg, maskg, causal=False, use_flash=True)
    # causal stays dense, as in JAX: the flash kernels align a causal query
    # block at Sk - Sq, and this chunk starts at idx * S_local
    out, _, l_sum = _inner_attention(q, kg, vg, causal=causal, kv_mask=maskg,
                                     q_offset=col.axis_index(SEQ, mesh) * s_local,
                                     kv_offset=0)
    return (out / l_sum.clamp_min(1e-30)[..., None]).to(q.dtype)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                mesh: Mesh, *, impl: Impl = "ring", causal: bool = False,
                                kv_mask: torch.Tensor | None = None,
                                use_flash: bool | None = None) -> torch.Tensor:
    """Attention over the sequence split on ``mesh``'s ``seq`` axis (module
    docstring): q, k, v [B,H,S,D] — this rank's batch rows and ``model``
    heads, the whole sequence — and ``kv_mask`` [B,S] bool or None.
    Returns [B,H,S,D] in q's dtype, equal to unsplit attention. Raises
    where S does not divide by the ``seq`` size, or (``ulysses``) the
    rank's H heads do not. ``use_flash`` (the Ulysses and non-causal
    all-gather attention through the flash kernels) defaults to whether q
    is on the card, JAX's "on the TPU backend". With ``seq`` at 1 it is
    one local attention (the schedule over a ring of one)."""
    if impl not in IMPLS:
        raise ValueError(f"seq_impl must be one of {IMPLS}, got {impl!r}")
    n = mesh.shape[SEQ]
    B, H, S, D = q.shape
    if S % n:
        raise ValueError(f"seq len {S} not divisible by seq axis {n}")
    if impl == "ulysses" and H % n:
        # H is this rank's share of the heads (split over model already);
        # the all-to-all splits it again over seq
        raise ValueError(f"ulysses needs local heads ({H * mesh.shape[MODEL]}//"
                         f"{mesh.shape[MODEL]}) divisible by seq shards ({n})")
    if use_flash is None:
        use_flash = q.is_cuda
    s_local = S // n
    q, k, v = (col.scatter_to_axis(x, 2, SEQ, mesh) for x in (q, k, v))
    mask = None if kv_mask is None else col.scatter_to_axis(kv_mask.to(torch.bool), 1, SEQ,
                                                            mesh)
    if impl == "ring":
        out = _ring(q, k, v, mask, mesh, causal=causal, n=n, s_local=s_local)
    elif impl == "ulysses":
        out = _ulysses(q, k, v, mask, mesh, causal=causal, use_flash=use_flash)
    else:
        out = _allgather(q, k, v, mask, mesh, causal=causal, s_local=s_local,
                         use_flash=use_flash)
    return col.gather_from_axis(out, 2, SEQ, mesh)
