"""ServeEngine — the user-facing submit/step/stream loop, paged.

Counterpart of ``distributed_tensorflow_tpu/serve/engine.py`` (paged
path): the step functions of ``decode.py`` over one resident block pool,
driven by the continuous-batching scheduler, with ``sampling.py``
choosing tokens. One engine ``step()``:

1. **Admit.** Every queued request the scheduler can place into a free
   slot — gated on free KV blocks — is admitted, mapping whatever
   prefix the block cache already holds (copy-on-write sharing).
2. **Prefill.** At most ONE fixed-size chunk per mid-prefill slot per
   step, so a long prompt never starves the resident decoders for more
   than one chunk. The final chunk samples the request's first token.
3. **Decode.** One step advances every decode-ready slot by one token
   (or, with ``spec_k > 0``, verifies ``spec_k`` n-gram drafts per slot
   in one step). Idle and mid-prefill slots compute garbage that is
   never delivered and write through a past-the-table sentinel, so it
   lands in the pool's drop block.
4. **Deliver + evict.** Sampled tokens are appended via the scheduler,
   which evicts finished requests so their slots and blocks are
   re-admissible on the next step.

The host state (queue, tables, refcounts, write indices) is the JAX
engine's, decision for decision: the same request sequence gives the
same block ids, COW copies and preemptions. The device runs on
``device`` ("cuda" by default; an entry point never falls back to the
CPU on its own — pass ``device="cpu"`` for that, as the tests do).
The dense ``paged=False`` cache, sharding and request tracing come with
later slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..models import transformer as tfm
from ..obs import flightrec as flightrec_lib
from ..obs.registry import Registry
from ..utils.device import resolve_device
from . import decode as decode_lib
from . import sampling
from .kv_cache import BlockAllocator, NoFreeBlocks, PagedKVCache, init_paged_cache
from .scheduler import FINISH_REASONS, Request, Scheduler


@dataclasses.dataclass
class StepStats:
    """What one engine step did."""

    admitted: int = 0
    decoded_slots: int = 0
    occupancy: float = 0.0
    #: prefill chunks run this step
    prefill_chunks: int = 0
    #: (uid, token) pairs in delivery order — a uid can appear twice in
    #: one step (its prefill token AND its first decode token)
    tokens: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    finished: list[int] = dataclasses.field(default_factory=list)
    #: host wall-clock split of this step: prefill phase, decode phase,
    #: and the whole call. Each phase ends reading sampled tokens back
    #: from the device, so these are compute latencies, not dispatch.
    wall_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0


class ServeEngine:
    """KV-cached continuous-batching inference over a causal Transformer,
    paged.

    >>> eng = ServeEngine.with_random_params(cfg, num_slots=4)
    >>> for tok in eng.stream([5, 17, 3]):
    ...     print(tok)

    ``params`` is a state dict of ``models.transformer.Transformer(cfg)``
    (or a ``Transformer``); tensors already on ``device`` in the right
    dtype are used as they are, so several engines can share one set of
    weights."""

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        params,
        *,
        device="cuda",
        num_slots: int = 4,
        max_len: int | None = None,
        max_queue: int | None = None,
        cache_dtype=None,
        block_size: int = 16,
        num_blocks: int | None = None,
        prefill_chunk: int = 32,
        prefix_reuse: bool = True,
        spec_k: int = 0,
        spec_ngram: int = 4,
        paged_impl: str | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        registry: Registry | None = None,
        clock: Callable[[], float] = time.perf_counter,
        flightrec=None,
    ):
        self.device = resolve_device(device)
        if not cfg.causal:
            raise ValueError("ServeEngine requires a causal (decoder) model")
        if paged_impl is not None:
            # per-engine override of the paged-attention dispatch
            cfg = dataclasses.replace(cfg, paged_attention_impl=paged_impl)
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {spec_ngram}")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.cfg = cfg
        self.model = tfm.build(cfg, params, self.device)
        M = cfg.max_len if max_len is None else max_len
        if M > cfg.max_len:
            raise ValueError(
                f"max_len={M} exceeds the model context window "
                f"(cfg.max_len={cfg.max_len})"
            )
        self.prefix_reuse = prefix_reuse
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        #: logical blocks per request = the per-request token budget
        self._mb = -(-M // block_size)
        if num_blocks is None:
            num_blocks = num_slots * self._mb
        if num_blocks < self._mb:
            raise ValueError(
                f"num_blocks={num_blocks} < ceil(max_len/block_size)="
                f"{self._mb}: one request could exhaust the pool with "
                f"no one left to preempt"
            )
        self.cache: PagedKVCache = init_paged_cache(
            cfg, num_blocks, block_size, dtype=cache_dtype, device=self.device)
        self.alloc = BlockAllocator(num_blocks, block_size)
        #: slot → physical block ids in logical order (host truth); the
        #: device-side table mirrors it, sentinel-padded
        self._blocks: list[list[int]] = [[] for _ in range(num_slots)]
        self._table = np.full((num_slots, self._mb), num_blocks, np.int32)
        #: past-the-table write position — routes a slot's K/V write to
        #: the drop block (idle / mid-prefill). Uses the FULL table
        #: width, so it lies past every trimmed table too.
        self._oob = self._mb * block_size
        #: slot → next prefill position (chunked prefill in flight)
        self._pending: dict[int, int] = {}
        #: slot → all tokens known at admission (the re-prefill source
        #: after a preemption)
        self._ptoks: dict[int, tuple[int, ...]] = {}
        self._evictions_seen = 0
        #: blocks promised to requests approved earlier in the same
        #: admit cycle (reset each step)
        self._gate_reserved = 0
        self.clock = clock
        self.flightrec = (flightrec if flightrec is not None
                          else flightrec_lib.default_recorder())
        self.sched = Scheduler(
            num_slots, M, clock=clock, max_queue=max_queue,
            flightrec=self.flightrec, admission_gate=self._admission_gate,
        )
        self.temperature = temperature
        self.top_k = top_k
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # per-slot host state: cache write index and most recent token
        self._written = np.zeros(num_slots, np.int32)
        self._last = np.zeros(num_slots, np.int32)
        # the step functions, bound to this engine's model (attributes,
        # as in the JAX engine, so a harness can wrap them)
        self._prefill_chunk_fn = lambda *a: decode_lib.paged_prefill_chunk(
            self.model, *a)
        self._decode = lambda *a: decode_lib.paged_decode_step(self.model, *a)
        self._copy_block = decode_lib.copy_block
        if spec_k > 0:
            self._verify = lambda *a: decode_lib.paged_verify_step(self.model, *a)
            #: host-side accept-rule randomness (temperature spec)
            self._spec_gen = np.random.default_rng(seed)
        # telemetry: the JAX engine's metric names, one registry per
        # engine by default; handles resolved once here
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        self._m_queue_wait = r.histogram(
            "serve_queue_wait_seconds", "submit → slot admission")
        self._m_ttft = r.histogram(
            "serve_ttft_seconds", "submit → first token delivered")
        self._m_tpot = r.histogram(
            "serve_tpot_seconds",
            "mean per-output-token decode latency of a finished request")
        self._m_step = r.histogram(
            "serve_step_seconds", "one engine step (admit+prefill+decode)")
        self._m_prefill = r.histogram(
            "serve_prefill_seconds", "prefill phase of an engine step")
        self._m_decode = r.histogram(
            "serve_decode_seconds", "fused decode phase of an engine step")
        self._m_occupancy = r.gauge(
            "serve_occupancy", "active slots / num_slots at last decode")
        self._m_admitted = r.counter(
            "serve_admitted_total", "requests admitted into a slot")
        self._m_tokens = r.counter(
            "serve_tokens_total", "tokens delivered (prefill + decode)")
        self._m_finished = {
            reason: r.counter(
                "serve_finished_total", "finished requests by eviction reason",
                reason=reason)
            for reason in FINISH_REASONS
        }
        self._m_blocks_used = r.gauge(
            "kv_blocks_in_use", "physical KV blocks with refcount > 0")
        self._m_blocks_free = r.gauge(
            "kv_blocks_free", "physical KV blocks on the free list")
        self._m_block_evic = r.counter(
            "kv_block_evictions_total",
            "prefix-cache blocks evicted under pool pressure")
        self._m_reuse = r.counter(
            "prefix_reuse_hits_total",
            "physical blocks mapped from the shared-prefix cache at "
            "admission instead of being prefilled")
        self._m_chunks = r.counter(
            "prefill_chunks_total", "prefill chunks run (chunked prefill)")
        self._m_spec_prop = r.counter(
            "spec_tokens_proposed_total",
            "draft tokens proposed to the speculative verify step")
        self._m_spec_acc = r.counter(
            "spec_tokens_accepted_total",
            "draft tokens the speculative verify step accepted")
        self._m_spec_rate = r.gauge(
            "spec_acceptance_rate",
            "accepted / proposed draft tokens over the engine lifetime")
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._sync_block_metrics()

    @classmethod
    def with_random_params(
        cls, cfg: tfm.TransformerConfig, *, seed: int = 0, device="cuda", **kw
    ) -> "ServeEngine":
        """Random-weight engine for demos and smoke runs: normal(0.02)
        weights drawn from a ``torch.Generator`` seeded with ``seed``
        (``models.transformer.init_params``)."""
        dev = resolve_device(device)
        return cls(cfg, tfm.init_params(cfg, seed, dev), device=dev,
                   seed=seed, **kw)

    # -- public API --------------------------------------------------------

    def submit(
        self,
        prompt: Iterable[int],
        max_new_tokens: int = 32,
        eos_id: int | None = None,
        deadline_s: float | None = None,
        priority: int = 0,
    ) -> int:
        """Enqueue a request (raises ``scheduler.QueueFull`` under
        backpressure, ``scheduler.SchedulerClosed`` after drain). Higher
        ``priority`` residents are preempted LAST on block exhaustion."""
        return self.sched.submit(prompt, max_new_tokens, eos_id,
                                 deadline_s=deadline_s, priority=priority)

    def cancel(self, uid: int) -> bool:
        """Cancel a queued or in-flight request (``FINISH_CANCELLED``);
        returns False if the uid is unknown or already finished."""
        req = self.sched.cancel(uid)
        if req is None:
            return False
        self._observe_finish(req, None)
        self._reconcile_slots()
        self._sync_block_metrics()
        return True

    def step(self) -> StepStats:
        """Enforce deadlines, admit newly placed requests, run at most
        ONE prefill chunk per mid-prefill slot, then advance every
        decode-ready slot. Returns per-step stats and records them into
        ``self.registry``."""
        stats = StepStats()
        t0 = self.clock()
        expired = self.sched.expire()
        for req in expired:
            self._observe_finish(req, stats)
        if expired:
            self._reconcile_slots()
        self._gate_reserved = 0  # fresh admit cycle
        placed = self.sched.admit()
        for slot, req in placed:
            stats.admitted += 1
            self._m_admitted.inc()
            if req.preemptions == 0:
                self._m_queue_wait.observe(req.t_admit - req.t_submit)
            self._begin_paged(slot, req)
        stats.occupancy = (
            len(self.sched.active_slots()) / self.sched.num_slots
        )
        # one chunk per pending slot per step — the interleave bound
        for slot in sorted(self._pending):
            if slot in self._pending:  # preemption may drop peers
                self._paged_prefill_step(slot, stats)
        t1 = self.clock()
        active = [s for s in self.sched.active_slots() if s not in self._pending]
        if active:
            self._do_decode(active, stats)
        t2 = self.clock()
        stats.prefill_s = t1 - t0
        stats.decode_s = t2 - t1
        stats.wall_s = t2 - t0
        self._m_step.observe(stats.wall_s)
        if stats.admitted or stats.prefill_chunks:
            self._m_prefill.observe(stats.prefill_s)
        if stats.decoded_slots:
            self._m_decode.observe(stats.decode_s)
        if stats.occupancy:
            self._m_occupancy.set(stats.occupancy)
        self._sync_block_metrics()
        return stats

    def stream(
        self,
        prompt: Iterable[int],
        max_new_tokens: int = 32,
        eos_id: int | None = None,
        deadline_s: float | None = None,
    ) -> Iterator[int]:
        """Submit one request and yield its tokens as they are decoded
        (other queued requests keep making progress in the same steps)."""
        uid = self.submit(prompt, max_new_tokens, eos_id,
                          deadline_s=deadline_s)
        req = self._find(uid)
        delivered = 0
        while True:
            self.step()
            while delivered < len(req.generated):
                yield req.generated[delivered]
                delivered += 1
            if req.done:
                self.sched.finished.pop(uid, None)  # delivered in full
                return

    def run(self) -> dict[int, Request]:
        """Drain queue + slots to completion; returns (and forgets)
        uid → Request."""
        while self.sched.has_work:
            self.step()
        return self.sched.drain_finished()

    def drain(self) -> dict[int, Request]:
        """Graceful shutdown: stop admission, cancel everything still
        queued, decode the residents to completion, flush the prefix
        cache (so a clean drain leaves every block free) and leave
        telemetry flushed. Returns (and forgets) uid → Request."""
        for req in self.sched.close():
            self._observe_finish(req, None)
        while any(r is not None for r in self.sched.slots) \
                or self.sched.queue:
            self.step()
        self._reconcile_slots()
        self.alloc.flush_prefix_cache()
        self._sync_block_metrics()
        self._m_occupancy.set(0.0)
        done = self.sched.drain_finished()
        self.flightrec.emit("serve_drain", finished=len(done))
        return done

    # -- internals ---------------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _reconcile_slots(self) -> None:
        """Every slot the scheduler freed out of band (timeout, cancel,
        close) gives its blocks back and parks its write index at 0."""
        for i, req in enumerate(self.sched.slots):
            if req is None:
                if self._blocks[i] or i in self._pending:
                    self._release_slot(i)
                self._written[i] = 0

    def _sync_block_metrics(self) -> None:
        self._m_blocks_used.set(float(self.alloc.blocks_in_use))
        self._m_blocks_free.set(float(self.alloc.blocks_free))
        d = self.alloc.evictions - self._evictions_seen
        if d:
            self._m_block_evic.inc(d)
            self._evictions_seen = self.alloc.evictions

    def _mb_bucket(self, hi_blocks: int) -> int:
        """Table width (in blocks) to hand the step: the smallest power
        of two covering the widest live slot, capped at the full table —
        attention reads only as many blocks as are mapped."""
        mbu = 1
        while mbu < hi_blocks:
            mbu *= 2
        return min(mbu, self._mb)

    def _admission_gate(self, req: Request) -> bool:
        """Admission is gated on KV capacity (see the JAX engine): blocks
        for every position the request writes through its first decode
        token, minus what the prefix cache supplies; evictable cache
        blocks count as capacity; ``_gate_reserved`` covers requests
        approved earlier in the same admit cycle."""
        T = len(req.prompt) + len(req.generated)
        need = -(-min(T + 1, self.sched.max_len) // self.block_size)
        m = self.alloc.peek_match(req.prompt) if self.prefix_reuse else 0
        free, ev = self.alloc.blocks_free, self.alloc.evictable()
        reserved = self._gate_reserved
        with_reuse = free + max(ev - m, 0) - reserved >= max(need - m, 1)
        without_reuse = free + ev - reserved >= max(need, 1)
        if with_reuse or without_reuse:
            self._gate_reserved += max(need - (m if with_reuse else 0), 1)
            return True
        return False

    def _release_slot(self, slot: int) -> None:
        """Give every block in ``slot``'s table back and reset the slot
        to the idle sentinel state."""
        for bid in self._blocks[slot]:
            self.alloc.decref(bid)
        self._blocks[slot] = []
        self._table[slot, :] = self.cache.num_blocks
        self._written[slot] = 0
        self._pending.pop(slot, None)
        self._ptoks.pop(slot, None)

    def _youngest_resident(self, exclude: int) -> int | None:
        """Preemption victim: the LOWEST-priority resident, youngest
        (highest uid) among equals."""
        best = None
        for i, req in enumerate(self.sched.slots):
            if req is None or i == exclude:
                continue
            if best is None:
                best = i
                continue
            cur = self.sched.slots[best]
            if (req.priority, -req.uid) < (cur.priority, -cur.uid):
                best = i
        return best

    def _paged_alloc(self, slot: int) -> int:
        """Allocate one block for ``slot``; on exhaustion, preempt the
        youngest OTHER resident back to the queue head and retry."""
        while True:
            try:
                return self.alloc.alloc()
            except NoFreeBlocks:
                victim = self._youngest_resident(exclude=slot)
                if victim is None:
                    raise
                self.sched.preempt(victim)
                self._release_slot(victim)

    def _ensure_blocks(self, slot: int, start: int, end: int) -> None:
        """Make positions ``[start, end)`` of ``slot`` writable: append
        fresh blocks past the table's frontier, and copy-on-write any
        block about to be written whose refcount is > 1."""
        bs = self.block_size
        blocks = self._blocks[slot]
        for b in range(start // bs, (end - 1) // bs + 1):
            if b < len(blocks):
                bid = blocks[b]
                if self.alloc.refcount(bid) > 1:
                    try:
                        new = self._paged_alloc(slot)
                    except NoFreeBlocks:
                        # no copy target and no one preemptible: the other
                        # holder must be the prefix cache — un-cache the
                        # block and write in place as sole owner
                        self.alloc.release_cached(bid)
                        if self.alloc.refcount(bid) != 1:
                            raise
                    else:
                        self.cache = self._copy_block(self.cache, bid, new)
                        self.alloc.decref(bid)
                        self.alloc.cow_copies += 1
                        blocks[b] = new
                        self._table[slot, b] = new
            else:
                new = self._paged_alloc(slot)
                blocks.append(new)
                self._table[slot, b] = new
            self.alloc.note_write(blocks[b], max(start - b * bs, 0))

    def _begin_paged(self, slot: int, req: Request) -> None:
        """Admission bookkeeping: map what the prefix cache already
        holds (never the last known position — its logits must be
        recomputed) and queue the rest for chunked prefill."""
        toks = tuple(req.prompt) + tuple(req.generated)
        blocks: list[int] = []
        matched = 0
        if self.prefix_reuse:
            blocks, matched = self.alloc.match_prefix(toks)
            matched = min(matched, len(toks) - 1)
            if blocks:
                self._m_reuse.inc(len(blocks))
        self._blocks[slot] = blocks
        self._table[slot, :] = self.cache.num_blocks
        self._table[slot, :len(blocks)] = blocks
        self._written[slot] = matched
        self._pending[slot] = matched
        self._ptoks[slot] = toks

    def _paged_prefill_step(self, slot: int, stats: StepStats) -> None:
        """Run ONE prefill chunk for ``slot``; on the final chunk, sample
        the first token, publish the prompt's blocks for prefix reuse,
        and hand the slot to the decode phase."""
        req = self.sched.slots[slot]
        toks = self._ptoks[slot]
        T = len(toks)
        start = self._pending[slot]
        end = min(start + self.prefill_chunk, T)
        self._ensure_blocks(slot, start, end)
        buf = np.zeros(self.prefill_chunk, np.int32)
        buf[: end - start] = toks[start:end]
        mbu = self._mb_bucket(len(self._blocks[slot]))
        logits, self.cache = self._prefill_chunk_fn(
            self.cache, self._to_device(self._table[slot, :mbu]),
            self._to_device(buf), start, end - start,
        )
        stats.prefill_chunks += 1
        self._m_chunks.inc()
        self.flightrec.emit("serve_prefill_chunk", uid=req.uid, slot=slot,
                            start=start, n=end - start)
        self._written[slot] = end
        if end < T:
            self._pending[slot] = end
            return
        del self._pending[slot]
        if self.prefix_reuse:
            P = len(req.prompt)
            n_prompt_blocks = -(-P // self.block_size)
            self.alloc.register_prefix(
                req.prompt, self._blocks[slot][:n_prompt_blocks]
            )
        tok = int(sampling.sample(logits, self._next_gen(),
                                  temperature=self.temperature, top_k=self.top_k))
        self._last[slot] = tok
        self._deliver(slot, tok, stats)

    def _observe_finish(self, req: Request, stats: StepStats | None) -> None:
        """The ONE terminal observation per finished request, whatever
        ended it: one TTFT and one TPOT observation each, so their counts
        equal Σ serve_finished_total."""
        if stats is not None:
            stats.finished.append(req.uid)
        self._m_finished[req.finish_reason].inc()
        if req.t_first_token is None:
            self._m_ttft.observe(req.t_finish - req.t_submit)
            self._m_tpot.observe(0.0)
        else:
            g = len(req.generated)
            self._m_tpot.observe(
                (req.t_finish - req.t_first_token) / max(g - 1, 1)
            )

    def _find(self, uid: int) -> Request:
        req = self.sched.finished.get(uid)
        if req is not None:
            return req
        for r in self.sched.slots:
            if r is not None and r.uid == uid:
                return r
        for r in self.sched.queue:
            if r.uid == uid:
                return r
        raise KeyError(f"unknown request uid {uid}")

    def _next_gen(self) -> torch.Generator | None:
        return self._gen if self.temperature > 0.0 else None

    def _deliver(self, slot: int, token: int, stats: StepStats) -> None:
        req = self.sched.slots[slot]
        stats.tokens.append((req.uid, token))
        self._m_tokens.inc()
        finished = self.sched.append_token(slot, token)
        if len(req.generated) == 1:
            self._m_ttft.observe(req.t_first_token - req.t_submit)
        if finished is not None:
            self._release_slot(slot)  # blocks home before slot reuse
            self._observe_finish(finished, stats)

    def _draft(self, slot: int, k: int) -> list[int]:
        """N-gram prompt-lookup drafter: the ``k`` tokens that followed
        the most recent earlier occurrence of the longest recurring
        suffix (n = spec_ngram down to 1); short continuations repeat
        their last token; no recurrence proposes the last token."""
        req = self.sched.slots[slot]
        ctx = list(req.prompt) + list(req.generated)
        for n in range(min(self.spec_ngram, len(ctx) - 1), 0, -1):
            pat = ctx[-n:]
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i: i + n] == pat:
                    cont = ctx[i + n: i + n + k]
                    while len(cont) < k:
                        cont.append(cont[-1])
                    return cont
        return [ctx[-1]] * k

    def _do_verify_decode(self, active: list[int], stats: StepStats) -> None:
        """Speculative decode step: draft ``spec_k`` tokens per slot,
        verify every slot's drafts in ONE step, emit each slot's accepted
        prefix plus its correction/bonus token, and roll rejected
        suffixes back through the block table (a refcount edit, never a
        device copy)."""
        bs = self.block_size
        cap = self._oob  # positions a slot's table can address
        drafts: dict[int, list[int]] = {}
        for slot in active:
            if self.sched.slots[slot] is None:
                continue  # a peer's _ensure_blocks preempted it
            w = int(self._written[slot])
            ks = max(min(self.spec_k, cap - 1 - w), 0)
            drafts[slot] = self._draft(slot, ks) if ks else []
            self._ensure_blocks(slot, w, w + len(drafts[slot]) + 1)
        active = [s for s in active if self.sched.slots[s] is not None]
        if not active:
            return
        stats.decoded_slots = len(active)
        S = self.spec_k + 1
        toks = np.zeros((self.sched.num_slots, S), np.int32)
        pos = np.full((self.sched.num_slots, S), self._oob, np.int32)
        for slot in active:
            d = drafts[slot]
            w = int(self._written[slot])
            toks[slot, 0] = self._last[slot]
            toks[slot, 1: 1 + len(d)] = d
            pos[slot, : 1 + len(d)] = np.arange(w, w + 1 + len(d))
        mbu = self._mb_bucket(max(len(self._blocks[s]) for s in active))
        logits, self.cache = self._verify(
            self.cache, self._to_device(self._table[:, :mbu]),
            self._to_device(toks), self._to_device(pos),
        )
        logits = logits.float().cpu().numpy()
        for slot in active:
            d = drafts[slot]
            w = int(self._written[slot])
            rows = logits[slot, : len(d) + 1]
            if self.temperature <= 0.0:
                emitted, accepted = sampling.spec_verify_greedy(rows, d)
            else:
                emitted, accepted = sampling.spec_verify_sample(
                    rows, d, self._spec_gen,
                    temperature=self.temperature, top_k=self.top_k,
                )
            # K/V past w+accepted is rejected-draft garbage: retreat the
            # write index over it and give wholly-garbage tail blocks back
            self._written[slot] = w + accepted + 1
            keep = -(-int(self._written[slot]) // bs)
            if len(self._blocks[slot]) > keep:
                self.alloc.release_tail(self._blocks[slot], keep)
                self._table[slot, keep:] = self.cache.num_blocks
            self._spec_proposed += len(d)
            self._spec_accepted += accepted
            if d:
                self._m_spec_prop.inc(len(d))
            if accepted:
                self._m_spec_acc.inc(accepted)
            req = self.sched.slots[slot]
            req.spec_accepted += accepted
            self.flightrec.emit("serve_spec_step", uid=req.uid, slot=slot,
                                proposed=len(d), accepted=accepted)
            self._last[slot] = emitted[-1]
            for tok in emitted:
                self._deliver(slot, tok, stats)
                if self.sched.slots[slot] is None:
                    break  # finished mid-burst; trailing tokens discarded
        if self._spec_proposed:
            self._m_spec_rate.set(self._spec_accepted / self._spec_proposed)

    def _do_decode(self, active: list[int], stats: StepStats) -> None:
        if self.spec_k > 0:
            self._do_verify_decode(active, stats)
            return
        # make each decoding slot's write position privately owned (fresh
        # block at a boundary, COW off a shared block); allocation
        # pressure may preempt the youngest residents, so re-filter
        for slot in active:
            if self.sched.slots[slot] is not None:
                w = int(self._written[slot])
                self._ensure_blocks(slot, w, w + 1)
        active = [s for s in active if self.sched.slots[s] is not None]
        if not active:
            return
        stats.decoded_slots = len(active)
        # non-decoding slots write through the past-the-table sentinel
        lens = np.full(self.sched.num_slots, self._oob, np.int32)
        for slot in active:
            lens[slot] = self._written[slot]
        mbu = self._mb_bucket(max(len(self._blocks[s]) for s in active))
        logits, self.cache = self._decode(
            self.cache, self._to_device(self._table[:, :mbu]),
            self._to_device(self._last), self._to_device(lens),
        )
        toks = sampling.sample(logits, self._next_gen(),
                               temperature=self.temperature,
                               top_k=self.top_k).cpu().numpy()
        for slot in active:
            self._written[slot] += 1  # the decode wrote k/v at the old index
            tok = int(toks[slot])
            self._last[slot] = tok
            self._deliver(slot, tok, stats)
