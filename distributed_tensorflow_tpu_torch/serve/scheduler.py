"""Continuous-batching scheduler — deterministic, jax-free, CPU-testable.

A copy of ``distributed_tensorflow_tpu/serve/scheduler.py``: the port imports
nothing of the JAX package (importing any module there runs that
package's ``__init__``, which imports jax), so it keeps its own.

Policy (the MLPerf lesson applied to serving: batching discipline, not
FLOPs, decides utilization — PAPERS.md):

- **FIFO admission.** Requests queue in submission order; the moment a
  decode slot frees, the head of the queue is admitted into it. No
  reordering, no priorities — fairness is positional.
- **Fixed decode-batch slots.** The decode batch is ``num_slots`` wide,
  always. The scheduler's job is to keep occupancy at 1.0 whenever the
  queue is non-empty (asserted by tools/bench_serve.py).
- **Evict on EOS / max-new / max-len.** A request leaves its slot the
  step it finishes: its own ``eos_id``, its ``max_new_tokens`` budget,
  or the slot's ``max_len`` cache budget (prompt + written tokens). The
  freed slot is re-admissible in the SAME engine step — prefill/decode
  interleaving with no idle step.

Admission control (docs/resilience.md — the failure modes an unbounded
FIFO hides until overload):

- **Bounded queue.** ``max_queue`` caps waiting requests; ``submit``
  raises ``QueueFull`` instead of growing without bound. Rejection is
  explicit backpressure the client can act on (retry, shed, reroute);
  silent queue growth just converts overload into timeout for everyone.
- **Deadlines.** A request may carry ``deadline_s``; once its absolute
  deadline passes it is evicted with ``FINISH_TIMEOUT`` — from the
  queue (never admitted, no wasted prefill) or from its slot (checked
  every engine step via ``expire()``).
- **Cancellation.** ``cancel(uid)`` evicts a queued or resident request
  with ``FINISH_CANCELLED``; idempotent, no-op on finished/unknown uids.
- **Drain.** ``close()`` stops admission (submit raises
  ``SchedulerClosed``) and cancels everything still queued; resident
  requests keep decoding until done — the graceful-shutdown half the
  engine exposes as ``ServeEngine.drain()``.

All state is plain Python (deque + list), so every invariant — no slot
leaks, FIFO order, eviction conditions — is testable with no model and
no device (tests/test_serve.py::test_scheduler_invariants).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Iterable

from ..obs import flightrec as flightrec_lib

#: why a request finished
FINISH_EOS = "eos"
FINISH_MAX_NEW = "max_new_tokens"
FINISH_MAX_LEN = "max_len"
FINISH_TIMEOUT = "timeout"
FINISH_CANCELLED = "cancelled"

#: every reason a Request.finish_reason can hold — the serve_finished
#: counter label set (obs wiring in engine.py keys off this tuple)
FINISH_REASONS = (
    FINISH_EOS, FINISH_MAX_NEW, FINISH_MAX_LEN,
    FINISH_TIMEOUT, FINISH_CANCELLED,
)


class QueueFull(RuntimeError):
    """Bounded-queue backpressure: the waiting line is at ``max_queue``.
    The client should retry later or shed the request."""


class SchedulerClosed(RuntimeError):
    """submit() after close()/drain(): the scheduler no longer admits."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    eos_id: int | None = None
    #: relative latency budget; ``t_deadline`` (absolute, scheduler
    #: clock) is stamped at submit and enforced by ``expire()``
    deadline_s: float | None = None
    t_deadline: float | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    finish_reason: str | None = None
    #: times this request was preempted back to the queue head (paged
    #: block exhaustion — engine re-prefills prompt+generated on
    #: re-admission); ``t_admit`` keeps its FIRST admission stamp
    preemptions: int = 0
    #: SLO tier: block-exhaustion preemption victimizes the LOWEST
    #: priority resident first (ties: youngest), so a low-priority batch
    #: lane absorbs cache pressure before interactive traffic. 0 =
    #: default; all-equal priorities reproduce pure youngest-first.
    priority: int = 0
    # lifecycle timestamps (scheduler clock), the raw material for the
    # serve latency metrics (docs/observability.md): queue wait =
    # t_admit - t_submit, TTFT = t_first_token - t_submit, per-token
    # decode latency = (t_finish - t_first_token) / (generated - 1).
    t_submit: float | None = None
    t_admit: float | None = None
    t_first_token: float | None = None
    t_finish: float | None = None
    #: router trace id (serve fleet): set when the request entered
    #: through a Router, None for direct engine submissions. Carried so
    #: the replica-side request ledger (obs/reqtrace.py) records this
    #: process's admission/prefill/preemption spans under the SAME id
    #: the router traces — the key the cross-process merge joins on.
    rid: int | None = None
    #: draft tokens the verify step accepted over this request's
    #: lifetime (speculative decoding only; stays 0 otherwise).
    #: ``spec_accepted / (generated - 1)`` approximates the per-request
    #: acceptance rate — the fleet-wide rate is the engine gauge.
    spec_accepted: int = 0

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


class Scheduler:
    """FIFO continuous batching over ``num_slots`` decode slots, each
    with a ``max_len``-token KV budget (prompt + generated)."""

    def __init__(self, num_slots: int, max_len: int,
                 clock: Callable[[], float] = time.perf_counter,
                 max_queue: int | None = None, flightrec=None,
                 admission_gate: Callable[[Request], bool] | None = None,
                 reqtrace=None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        self.num_slots = num_slots
        self.max_len = max_len
        self.max_queue = max_queue
        #: extra admission predicate beyond "a slot is free" — the paged
        #: engine installs a free-BLOCKS check here, so admission is
        #: gated on actual KV capacity, not slot count. Head-of-line
        #: blocking is deliberate: skipping past a starved head would
        #: break FIFO fairness.
        self.admission_gate = admission_gate
        self.clock = clock  # injectable for deterministic latency tests
        #: flight recorder for admit/evict/close lifecycle events
        #: (obs/flightrec.py — stdlib-only, so this stays jax-free)
        self.flightrec = (flightrec if flightrec is not None
                          else flightrec_lib.default_recorder())
        #: per-request span ledger (obs/reqtrace.py), None = untraced.
        #: Only rid-carrying requests (router traffic) emit spans.
        self.reqtrace = reqtrace
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * num_slots
        self._next_uid = 0
        self._closed = False
        #: uid → Request, completion order. Retained until the caller
        #: collects results (ServeEngine.run / stream); long-lived
        #: servers must drain_finished() or history accumulates forever.
        self.finished: dict[int, Request] = {}

    # -- admission ---------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(
        self,
        prompt: Iterable[int],
        max_new_tokens: int = 32,
        eos_id: int | None = None,
        deadline_s: float | None = None,
        priority: int = 0,
        rid: int | None = None,
    ) -> int:
        """Enqueue a request; returns its uid. Raises ``QueueFull`` when
        ``max_queue`` requests are already waiting (backpressure) and
        ``SchedulerClosed`` after ``close()``."""
        if self._closed:
            raise SchedulerClosed("scheduler is draining; admission stopped")
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the per-slot cache "
                f"budget max_len={self.max_len}"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")
        # capacity LAST: a malformed request must get its permanent
        # ValueError, not a retryable QueueFull the client would loop on
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise QueueFull(
                f"{len(self.queue)} requests waiting (max_queue="
                f"{self.max_queue}); retry later"
            )
        now = self.clock()
        req = Request(self._next_uid, prompt, max_new_tokens, eos_id,
                      deadline_s=deadline_s, priority=int(priority),
                      t_submit=now, rid=rid)
        if deadline_s is not None:
            req.t_deadline = now + deadline_s
        self._next_uid += 1
        self.queue.append(req)
        return req.uid

    def admit(self) -> list[tuple[int, Request]]:
        """Move queued requests into free slots, FIFO; returns the newly
        placed (slot, request) pairs — the engine prefills exactly
        these."""
        placed = []
        for slot in range(self.num_slots):
            if not self.queue:
                break
            if self.slots[slot] is None:
                if self.admission_gate is not None \
                        and not self.admission_gate(self.queue[0]):
                    break  # head-of-line blocked on capacity, stay FIFO
                req = self.queue.popleft()
                if req.t_admit is None:  # keep the FIRST admission stamp
                    req.t_admit = self.clock()
                self.slots[slot] = req
                placed.append((slot, req))
                self.flightrec.emit("serve_admit", uid=req.uid, slot=slot)
                if self.reqtrace is not None and req.rid is not None:
                    # admission ends the block-wait: the request enters
                    # its (chunked) prefill phase in this slot
                    self.reqtrace.transition(
                        req.rid, "prefill_chunks", uid=req.uid, slot=slot,
                        preemptions=req.preemptions)
        return placed

    # -- eviction beyond token-driven finish -------------------------------

    def _finish(self, req: Request, reason: str, now: float | None = None) -> None:
        """The single eviction bottleneck — every finished request, token-
        driven or not, passes through here exactly once (one flight-
        recorder ``serve_evict`` per request, reason attached)."""
        req.finish_reason = reason
        req.t_finish = self.clock() if now is None else now
        self.finished[req.uid] = req
        self.flightrec.emit("serve_evict", uid=req.uid, reason=reason)
        if self.reqtrace is not None and req.rid is not None:
            self.reqtrace.finish(req.rid, reason)

    def cancel(self, uid: int) -> Request | None:
        """Evict ``uid`` with ``FINISH_CANCELLED`` wherever it lives —
        still queued (removed without ever taking a slot) or resident
        (slot freed immediately; its next decode token is never
        delivered). Returns the evicted Request, or None if the uid is
        unknown or already finished (idempotent)."""
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[i]
                self._finish(req, FINISH_CANCELLED)
                return req
        for slot, req in enumerate(self.slots):
            if req is not None and req.uid == uid:
                self.slots[slot] = None
                self._finish(req, FINISH_CANCELLED)
                return req
        return None

    def preempt(self, slot: int) -> Request:
        """Evict the request in ``slot`` back to the FRONT of the queue
        (it keeps its uid, prompt, and generated tokens — on
        re-admission the engine re-prefills everything it already knows
        and decoding continues where it left off). This is the paged
        engine's block-exhaustion pressure valve: the request is NOT
        finished, so no terminal accounting fires."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"preempt on empty slot {slot}")
        self.slots[slot] = None
        req.preemptions += 1
        self.queue.appendleft(req)
        self.flightrec.emit("serve_preempt", uid=req.uid, slot=slot)
        if self.reqtrace is not None and req.rid is not None:
            self.reqtrace.transition(req.rid, "preempted", uid=req.uid,
                                     slot=slot)
        return req

    def expire(self) -> list[Request]:
        """Evict every request whose absolute deadline has passed, with
        ``FINISH_TIMEOUT``: queued requests are never admitted (no
        wasted prefill), resident requests free their slot. The engine
        calls this once per step, so a resident deadline is enforced to
        one decode-step granularity."""
        now = self.clock()
        evicted: list[Request] = []
        if any(r.t_deadline is not None and now >= r.t_deadline
               for r in self.queue):
            kept: deque[Request] = deque()
            for req in self.queue:  # one partition pass, not O(n) removes
                if req.t_deadline is not None and now >= req.t_deadline:
                    self._finish(req, FINISH_TIMEOUT, now)
                    evicted.append(req)
                else:
                    kept.append(req)
            self.queue = kept
        for slot, req in enumerate(self.slots):
            if req is not None and req.t_deadline is not None \
                    and now >= req.t_deadline:
                self.slots[slot] = None
                self._finish(req, FINISH_TIMEOUT, now)
                evicted.append(req)
        return evicted

    def close(self) -> list[Request]:
        """Stop admission and cancel everything still queued (they would
        never run); resident requests are left to finish decoding.
        Returns the cancelled requests; idempotent."""
        first_close = not self._closed
        self._closed = True
        evicted: list[Request] = []
        while self.queue:
            req = self.queue.popleft()
            self._finish(req, FINISH_CANCELLED)
            evicted.append(req)
        if first_close:
            self.flightrec.emit("serve_close", cancelled=len(evicted))
        return evicted

    # -- decode-loop bookkeeping -------------------------------------------

    def active_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    @property
    def occupancy(self) -> float:
        return len(self.active_slots()) / self.num_slots

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(
            r is not None for r in self.slots
        )

    def append_token(self, slot: int, token: int) -> Request | None:
        """Record a sampled token for the request in ``slot``; evict and
        return the request if this token finishes it, else None.

        Cache accounting: after ``g`` generated tokens, continuing
        requires writing token ``g`` at cache position ``P + g - 1``, so
        the slot is out of budget once ``P + g > max_len`` — the request
        keeps that final token (it was sampled from in-budget state) and
        frees the slot before an out-of-bounds write can happen."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"append_token on empty slot {slot}")
        req.generated.append(int(token))
        g, P = len(req.generated), len(req.prompt)
        if g == 1:
            req.t_first_token = self.clock()
        if req.eos_id is not None and int(token) == req.eos_id:
            req.finish_reason = FINISH_EOS
        elif g >= req.max_new_tokens:
            req.finish_reason = FINISH_MAX_NEW
        elif P + g > self.max_len:
            req.finish_reason = FINISH_MAX_LEN
        if req.done:
            self.slots[slot] = None
            self._finish(req, req.finish_reason)
            return req
        return None

    def drain_finished(self) -> dict[int, Request]:
        """Hand over (and forget) all completed requests — the memory
        bound for a long-lived engine: call after delivering results."""
        done, self.finished = self.finished, {}
        return done
