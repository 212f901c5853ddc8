"""The paged step functions of the serving engine.

Counterpart of the paged half of ``distributed_tensorflow_tpu/serve/
decode.py``: one prefill chunk of one request, one decode step of every
slot, one speculative verify step of every slot, and the copy-on-write
block copy. Each runs the model eagerly (there is no jit to compile per
shape, so no ``jit_*`` wrappers) and updates the pool IN PLACE — where
the JAX engine donates the pool to each jitted step and rebinds the
returned one, here ``cache`` is returned only so both engines read
``logits, self.cache = fn(...)``.
"""

from __future__ import annotations

import torch

from ..models.transformer import Transformer
from .kv_cache import PagedKVCache


@torch.no_grad()
def paged_prefill_chunk(
    model: Transformer,
    cache: PagedKVCache,
    table_row: torch.Tensor,
    tokens: torch.Tensor,
    start: int,
    length: int,
) -> tuple[torch.Tensor, PagedKVCache]:
    """One fixed-size prefill chunk of ONE request: ``tokens`` [C] int32
    (zero-padded past ``length``) at absolute positions
    ``start .. start+length-1``, scattered through ``table_row`` [MB].
    Padded rows get the past-the-table sentinel position, so their K/V
    writes go to the drop block. Returns the next-token logits at the
    chunk's last REAL position and the (updated) pool."""
    C = tokens.shape[0]
    sentinel = table_row.shape[0] * cache.block_size
    idx = torch.arange(C, dtype=torch.int32, device=tokens.device)
    pos = torch.where(idx < length, start + idx, sentinel).to(torch.int32)
    logits, cache = model(tokens[None], kv_cache=cache, decode_pos=pos[None],
                          block_table=table_row[None])
    return logits[0, length - 1], cache


@torch.no_grad()
def paged_decode_step(
    model: Transformer,
    cache: PagedKVCache,
    block_tables: torch.Tensor,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step for all slots. ``lengths`` [num_slots] is each
    slot's write position; idle and mid-prefill slots carry the
    past-the-table sentinel, so their garbage token writes nothing live
    (a mid-prefill slot's frontier may sit in a COW-shared block)."""
    logits, cache = model(tokens[:, None], kv_cache=cache,
                          decode_pos=lengths[:, None], block_table=block_tables)
    return logits[:, 0], cache


@torch.no_grad()
def paged_verify_step(
    model: Transformer,
    cache: PagedKVCache,
    block_tables: torch.Tensor,
    tokens: torch.Tensor,
    positions: torch.Tensor,
) -> tuple[torch.Tensor, PagedKVCache]:
    """Speculative verify over EVERY slot at once: ``tokens``
    [num_slots, K+1] (newest sampled token then K drafts) at
    ``positions`` [num_slots, K+1]. Row ``i`` of a slot's logits
    conditions causally on everything at or before ``positions[slot,
    i]``. Idle slots and unused draft rows carry the sentinel. Returns
    logits [num_slots, K+1, vocab]."""
    return model(tokens, kv_cache=cache, decode_pos=positions,
                 block_table=block_tables)


@torch.no_grad()
def copy_block(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy-on-write resolution: duplicate physical block ``src`` into
    ``dst`` across every layer and both buffers, in place on the device."""
    cache.k_buf[:, dst] = cache.k_buf[:, src]
    cache.v_buf[:, dst] = cache.v_buf[:, src]
    return cache


def prefill_bucket(length: int, *, minimum: int = 8) -> int:
    """Pad a prompt length to the next power of two (>= ``minimum``)."""
    b = minimum
    while b < length:
        b *= 2
    return b
