"""Paged KV cache — the resident state of the decode engine.

Counterpart of the paged half of ``distributed_tensorflow_tpu/serve/
kv_cache.py``: a fixed pool of KV blocks on the device
(``PagedKVCache``) plus host-side free/used accounting with
copy-on-write refcounts and a shared-prefix cache (``BlockAllocator``,
copied as it is — plain Python, so the port makes the same block
decisions as the JAX engine on the same request sequence). The dense
slot cache (``paged=False``) and the sharding specs come with later
slices.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.transformer import TransformerConfig, torch_dtype
from ..utils.device import resolve_device


@dataclasses.dataclass
class PagedKVCache:
    """``k_buf``/``v_buf``: [num_layers, num_blocks + 1, num_heads,
    block_size, head_dim].

    The public pool is ``k``/``v`` = ``k_buf[:, :num_blocks]``, the JAX
    layout [L, NB, H, bs, D]. The one extra trailing block per layer is
    the DROP block: JAX drops out-of-range scatter writes (padded prefill
    rows, idle and mid-prefill slots write through a past-the-table
    sentinel), whereas an out-of-range index on a CUDA tensor is a
    device-side assert — so ``ops.paged_append_kv`` routes every such
    write into the drop block, on the device, and nothing ever reads it.

    The pool is updated IN PLACE by every prefill, decode and verify
    step (the JAX engine donates it to each jitted step instead); which
    blocks belong to which request is the host-owned block table."""

    k_buf: torch.Tensor
    v_buf: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.k_buf.shape[1] - 1

    @property
    def block_size(self) -> int:
        return self.k_buf.shape[3]

    @property
    def k(self) -> torch.Tensor:
        return self.k_buf[:, : self.num_blocks]

    @property
    def v(self) -> torch.Tensor:
        return self.v_buf[:, : self.num_blocks]


def init_paged_cache(
    cfg: TransformerConfig,
    num_blocks: int,
    block_size: int,
    dtype: str | torch.dtype | None = None,
    device="cuda",
) -> PagedKVCache:
    """Zero-filled block pool for ``cfg`` on ``device`` (plus the drop
    block; the card by default — raises without one unless
    ``device="cpu"``). Capacity is ``num_blocks * block_size`` tokens
    shared by every resident request."""
    device = resolve_device(device)
    if num_blocks < 1:
        raise ValueError("num_blocks must be >= 1")
    if block_size < 1:
        raise ValueError("block_size must be >= 1")
    if dtype is None:
        dtype = cfg.dtype
    dt = dtype if isinstance(dtype, torch.dtype) else torch_dtype(dtype)
    shape = (cfg.num_layers, num_blocks + 1, cfg.num_heads, block_size,
             cfg.head_dim)
    return PagedKVCache(k_buf=torch.zeros(shape, dtype=dt, device=device),
                        v_buf=torch.zeros(shape, dtype=dt, device=device))


class NoFreeBlocks(RuntimeError):
    """The pool is exhausted and nothing is evictable — the engine's
    cue to preempt a resident request (backpressure, not corruption)."""


class BlockAllocator:
    """Host-side free/used accounting for the block pool — plain
    Python, jax-free, so every invariant (used + free == pool size,
    refcounts hit zero, no leaked blocks) is testable with no device.

    Three kinds of ownership, all through one refcount array:

    - a resident request holds one ref on every block in its table;
    - the **prefix cache** holds one ref on each registered full block
      (``register_prefix``), so a popular system-prompt prefix survives
      the request that wrote it; entries are LRU-evicted when ``alloc``
      finds the free list empty (``evictions`` counts them);
    - **partially filled tail blocks** are registered weakly (no ref,
      validated by a per-block generation counter), so an identical
      prompt can map the same tail block — the copy-on-write case: the
      first APPEND into a block with refcount > 1 must copy it
      (``ensure `` via the engine's COW path), because the writer and
      the sharers diverge at that position.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # pop() hands out 0, 1, 2, ... — deterministic block placement
        self._free = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks
        #: bumped on every alloc — stale weak (partial) registrations
        #: carry the generation they were made under and are pruned lazily
        self._gen = [0] * num_blocks
        #: full-block prefix cache: token prefix (length k*block_size,
        #: as a tuple) → physical block id of block k-1. Insertion order
        #: doubles as LRU (move_to_end on hit).
        self._prefix: dict[tuple[int, ...], int] = {}
        #: weak partial-tail registrations: full-block prefix → list of
        #: (tail_content, block_id, generation)
        self._partial: dict[tuple[int, ...],
                            list[tuple[tuple[int, ...], int, int]]] = {}
        #: prefix-cache blocks evicted under pressure (feeds the
        #: kv_block_evictions_total counter)
        self.evictions = 0
        #: copy-on-write block copies performed (engine bumps this when
        #: it resolves a shared-block write)
        self.cow_copies = 0

    # -- accounting --------------------------------------------------------

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    def evictable(self) -> int:
        """Prefix-cache blocks held ONLY by the cache (refcount 1) —
        freeable on demand, so admission may count them as capacity."""
        return sum(1 for bid in self._prefix.values()
                   if self._ref[bid] == 1)

    # -- alloc / free ------------------------------------------------------

    def alloc(self) -> int:
        """Hand out a free block (refcount 1). When the free list is
        empty, evict least-recently-used prefix-cache entries whose
        block nothing else holds; raises ``NoFreeBlocks`` when even
        that finds nothing."""
        if not self._free:
            self._evict_cached()
        if not self._free:
            raise NoFreeBlocks(
                f"all {self.num_blocks} KV blocks are referenced and no "
                f"prefix-cache entry is evictable"
            )
        bid = self._free.pop()
        self._ref[bid] = 1
        self._gen[bid] += 1
        return bid

    def incref(self, bid: int) -> None:
        if self._ref[bid] < 1:
            raise ValueError(f"incref on free block {bid}")
        self._ref[bid] += 1

    def decref(self, bid: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        if self._ref[bid] < 1:
            raise ValueError(f"decref on free block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
            return True
        return False

    def release_tail(self, blocks: list[int], keep: int) -> None:
        """Speculation rollback: drop ownership of every block past the
        first ``keep`` — a refcount/length edit, never a data copy. Pops
        ``blocks`` in place so the caller's per-slot block list stays
        the single source of truth; decref's double-free tripwire still
        guards each drop (a rejected suffix must not free a block the
        prefix cache or another slot co-owns more times than this slot
        held it)."""
        if keep < 0:
            raise ValueError(f"keep must be >= 0, got {keep}")
        while len(blocks) > keep:
            self.decref(blocks.pop())

    def _evict_cached(self) -> None:
        """LRU-evict prefix-cache entries whose block only the cache
        holds, until one block is actually freed."""
        for key in list(self._prefix):
            bid = self._prefix[key]
            if self._ref[bid] == 1:
                del self._prefix[key]
                self.evictions += 1
                if self.decref(bid):
                    return

    # -- prefix reuse ------------------------------------------------------

    def match_prefix(
        self, tokens: tuple[int, ...] | list[int]
    ) -> tuple[list[int], int]:
        """Longest reusable prefix of ``tokens``: full cached blocks
        first, then optionally one weakly-registered partial tail
        block. Returns ``(block_ids, matched_tokens)`` with one ref
        taken on every returned block (the caller now co-owns them)."""
        tokens = tuple(int(t) for t in tokens)
        bs = self.block_size
        blocks: list[int] = []
        matched = 0
        while matched + bs <= len(tokens):
            key = tokens[: matched + bs]
            bid = self._prefix.get(key)
            if bid is None:
                break
            self._prefix[key] = self._prefix.pop(key)  # LRU touch
            self.incref(bid)
            blocks.append(bid)
            matched += bs
        # partial tail: a registered block whose content agrees with the
        # remaining tokens on their common prefix
        tail = tokens[matched:]
        if tail:
            hit = self._lookup_partial(tokens[:matched], tail)
            if hit is not None:
                bid, common = hit
                self.incref(bid)
                blocks.append(bid)
                matched += common
        return blocks, matched

    def peek_match(self, tokens: tuple[int, ...] | list[int]) -> int:
        """``match_prefix`` without taking refs — how many FULL blocks
        admission could reuse (the gate's conservative estimate)."""
        tokens = tuple(int(t) for t in tokens)
        bs, n = self.block_size, 0
        while (n + 1) * bs <= len(tokens) \
                and tokens[: (n + 1) * bs] in self._prefix:
            n += 1
        return n

    def _lookup_partial(
        self, full_prefix: tuple[int, ...], tail: tuple[int, ...]
    ) -> tuple[int, int] | None:
        cands = self._partial.get(full_prefix)
        if not cands:
            return None
        live = []
        for content, bid, gen in cands:
            if self._ref[bid] < 1 or self._gen[bid] != gen:
                continue  # block was freed/reallocated: stale entry
            live.append((content, bid, gen))
        if len(live) != len(cands):
            if live:
                self._partial[full_prefix] = live
            else:
                del self._partial[full_prefix]
        best: tuple[int, int] | None = None
        for content, bid, _gen in live:
            common = 0
            for a, b in zip(content, tail):
                if a != b:
                    break
                common += 1
            if common > 0 and (best is None or common > best[1]):
                best = (bid, common)
        return best

    def register_prefix(
        self, tokens: tuple[int, ...] | list[int], blocks: list[int]
    ) -> None:
        """Publish a prefilled prompt's blocks for reuse: each FULL
        block enters the prefix cache (one cache ref, survives the
        request), a partially filled tail block is registered weakly
        (valid only while the block lives). Re-registering content that
        is already cached is a no-op — no double refs."""
        tokens = tuple(int(t) for t in tokens)
        bs = self.block_size
        n_full = len(tokens) // bs
        for j in range(min(n_full, len(blocks))):
            key = tokens[: (j + 1) * bs]
            if key in self._prefix:
                continue
            bid = blocks[j]
            self.incref(bid)
            self._prefix[key] = bid
        tail = tokens[n_full * bs:]
        if tail and len(blocks) > n_full:
            bid = blocks[n_full]
            key = tokens[: n_full * bs]
            entry = (tail, bid, self._gen[bid])
            cands = self._partial.setdefault(key, [])
            if entry not in cands:
                cands.append(entry)
            # weak entries are pruned lazily on lookup, which never
            # happens for prompts no one repeats — sweep when the map
            # outgrows the pool so host memory stays bounded
            if sum(len(c) for c in self._partial.values()) \
                    > max(64, 2 * self.num_blocks):
                self._prune_partials()

    def _prune_partials(self) -> None:
        """Drop every stale weak entry (block freed or reallocated)."""
        for key in list(self._partial):
            live = [(c, bid, gen) for c, bid, gen in self._partial[key]
                    if self._ref[bid] >= 1 and self._gen[bid] == gen]
            if live:
                self._partial[key] = live
            else:
                del self._partial[key]

    def note_write(self, bid: int, offset: int) -> None:
        """The sole owner is about to write block ``bid`` in place from
        ``offset`` on: weak partial entries claiming content AT or past
        that offset would describe overwritten K/V — drop them. (An
        append past an entry's registered fill leaves it valid; a COW
        writer gets a fresh block and never invalidates the original.)
        The engine calls this for every block a prefill chunk or decode
        write touches, so the weak registry can never serve stale
        content even if the engine's COW ordering ever changes. Cost:
        nothing when the registry is empty (reuse off, or no partial
        prompts), else one scan of a map the register-time sweep keeps
        bounded at ``max(64, 2 * num_blocks)`` entries."""
        if not self._partial:
            return
        for key in list(self._partial):
            kept = [(c, b, g) for c, b, g in self._partial[key]
                    if not (b == bid and len(c) > offset)]
            if kept:
                self._partial[key] = kept
            else:
                del self._partial[key]

    def release_cached(self, bid: int) -> bool:
        """Drop every prefix-cache ref on ``bid`` (full-block entries;
        weak partial entries hold no ref and die by generation).
        Returns True when an entry was removed. The engine's last
        resort when a copy-on-write target cannot be allocated: if the
        only other holder of a block is the cache itself, un-caching it
        makes the writer sole owner, who then writes in place — no copy
        needed."""
        removed = False
        for key in [k for k, b in self._prefix.items() if b == bid]:
            del self._prefix[key]
            self.evictions += 1
            self.decref(bid)
            removed = True
        return removed

    def flush_prefix_cache(self) -> int:
        """Drop every cached prefix ref (shutdown / leak audits):
        afterwards only resident requests hold blocks. Returns the
        number of blocks freed outright."""
        freed = 0
        for bid in self._prefix.values():
            freed += bool(self.decref(bid))
        self._prefix.clear()
        self._partial.clear()
        return freed
