"""Retry with backoff for transient-failure seams — a copy of
``distributed_tensorflow_tpu/resilience/retry.py`` over the port's own
``obs`` (the JAX package cannot be imported without jax).

One ``RetryPolicy`` describes the whole budget — attempt count,
exponential backoff with seeded deterministic jitter, per-attempt
timeout, total deadline — and ``retry_call`` executes a callable under
it, counting into the two counters every site shares:

    retry_attempts_total{site}   re-attempts after a retryable failure
    retry_exhausted_total{site}  budgets exhausted (the give-up events)

plus the flight-recorder events ``retry_attempt`` / ``retry_exhausted``
and a ``wasted_seconds_total{cause=retry_backoff}`` entry for every
backoff slept. The jitter is a function of ``(seed, retry_index)``, so
the delays equal the JAX package's for the same policy and a faulted run
repeats exactly. Consumers: ``train/checkpoint.py`` (sites ``ckpt_*``),
``data/pipeline.RetryingIterator`` (site ``data``), and
``resilience/supervisor.py``'s restart backoff. Nothing here imports
torch or ``train/``.
"""

from __future__ import annotations

import dataclasses
import logging
import queue as queue_lib
import random
import threading
import time
from typing import Any, Callable

from ..obs import flightrec as flightrec_lib
from ..obs import goodput
from ..obs.flightrec import FlightRecorder
from ..obs.registry import Registry, default_registry

logger = logging.getLogger(__name__)

#: counter names (documented in docs/observability.md)
ATTEMPTS_TOTAL = "retry_attempts_total"
EXHAUSTED_TOTAL = "retry_exhausted_total"


class RetryExhausted(RuntimeError):
    """The retry budget (attempts or total deadline) ran out. Carries the
    ``site`` and attempt count; the last underlying failure is chained as
    ``__cause__`` so classification (resilience/supervisor.py) can see
    through to what actually failed."""

    def __init__(self, site: str, attempts: int, reason: str,
                 last: BaseException):
        super().__init__(
            f"retry budget exhausted at site {site!r} after {attempts} "
            f"failed attempt(s) ({reason}); last: {last!r}"
        )
        self.site = site
        self.attempts = attempts
        self.reason = reason


class AttemptTimeout(OSError):
    """A single attempt exceeded ``RetryPolicy.attempt_timeout_s``.
    Subclasses OSError so the default policy retries it."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Declarative retry budget. Immutable, so one policy instance can be
    shared across sites and threads; all mutable accounting lives in
    ``retry_call``'s frame."""

    #: total calls allowed (first try included); the Nth failure exhausts
    max_attempts: int = 3
    #: backoff before retry k is base_s * multiplier**k, capped
    base_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 30.0
    #: fraction of each backoff randomized away: delay ∈ [d·(1−jitter), d].
    #: Jitter is derived from (seed, retry_index) — deterministic.
    jitter: float = 0.5
    seed: int = 0
    #: wall budget across ALL attempts and backoffs; None = unbounded
    deadline_s: float | None = None
    #: per-attempt wall cap, enforced on a worker thread (the timed-out
    #: attempt's thread is abandoned, daemon); None = no cap
    attempt_timeout_s: float | None = None
    #: exception classes considered transient. IOError is an OSError
    #: alias, so the default covers the whole injected-IO fault family.
    retry_on: tuple[type[BaseException], ...] = (OSError,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff durations must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1 (backoff escalates)")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def backoff_s(self, retry_index: int) -> float:
        """Delay before the ``retry_index``-th retry (0-based). Pure
        function of (policy, retry_index) — same seed, same schedule."""
        d = min(self.base_s * self.multiplier ** retry_index,
                self.max_backoff_s)
        if self.jitter and d > 0:
            # str seeds hash via sha512 in random.seed(version=2):
            # stable across processes, unlike PYTHONHASHSEED-dependent hash()
            u = random.Random(f"{self.seed}:{retry_index}").random()
            d *= 1.0 - self.jitter * u
        return d


def _call_with_timeout(fn: Callable[[], Any], timeout_s: float,
                       site: str) -> Any:
    """Run ``fn`` on a daemon thread, bounded by ``timeout_s``. On
    timeout the thread is abandoned (it cannot be killed) and
    AttemptTimeout raised — acceptable for idempotent IO attempts, which
    is what the checkpoint/data seams are."""
    out: queue_lib.Queue = queue_lib.Queue(maxsize=1)

    def run():
        try:
            out.put((True, fn()))
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            out.put((False, e))

    t = threading.Thread(target=run, daemon=True, name=f"retry-{site}")
    t.start()
    try:
        ok, val = out.get(timeout=timeout_s)
    except queue_lib.Empty:
        raise AttemptTimeout(
            f"{site}: attempt exceeded {timeout_s}s (worker abandoned)"
        ) from None
    if ok:
        return val
    raise val


def retry_call(
    fn: Callable[[], Any],
    *,
    policy: RetryPolicy = RetryPolicy(),
    site: str,
    registry: Registry | None = None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Callable[[int, BaseException], None] | None = None,
    flightrec: FlightRecorder | None = None,
) -> Any:
    """Call ``fn`` under ``policy``; return its value or raise
    RetryExhausted (chaining the last failure).

    ``on_retry(failures, exc)`` runs after the backoff sleep and before
    the re-attempt — the seam RetryingIterator uses to re-seek its
    stream. Non-retryable exceptions (not in ``policy.retry_on``)
    propagate untouched and never touch the counters.
    """
    reg = registry if registry is not None else default_registry()
    rec = flightrec if flightrec is not None else flightrec_lib.default_recorder()
    attempts_c = reg.counter(
        ATTEMPTS_TOTAL, "re-attempts after a retryable failure", site=site)
    exhausted_c = reg.counter(
        EXHAUSTED_TOTAL, "retry budgets exhausted", site=site)
    t0 = clock()
    failures = 0
    pending: BaseException | None = None  # failure awaiting its on_retry
    while True:
        try:
            # the hook runs INSIDE the protected attempt: a re-seek that
            # hits the same outage counts against the budget and ends in
            # RetryExhausted like any other failure, instead of escaping
            # retry_call raw
            if pending is not None and on_retry is not None:
                on_retry(failures, pending)
            pending = None
            if policy.attempt_timeout_s is not None:
                return _call_with_timeout(fn, policy.attempt_timeout_s, site)
            return fn()
        except policy.retry_on as e:
            failures += 1
            if failures >= policy.max_attempts:
                exhausted_c.inc()
                rec.emit("retry_exhausted", site=site, failures=failures,
                         reason="attempt budget")
                raise RetryExhausted(site, failures, "attempt budget", e) from e
            delay = policy.backoff_s(failures - 1)
            if (policy.deadline_s is not None
                    and (clock() - t0) + delay > policy.deadline_s):
                exhausted_c.inc()
                rec.emit("retry_exhausted", site=site, failures=failures,
                         reason="total deadline")
                raise RetryExhausted(site, failures, "total deadline", e) from e
            attempts_c.inc()
            rec.emit("retry_attempt", site=site, failures=failures)
            logger.warning(
                "retry[%s]: attempt %d/%d failed (%s); backing off %.3fs",
                site, failures, policy.max_attempts, e, delay,
            )
            t_sleep = clock()
            sleep(delay)
            # goodput books ELAPSED time around the (injectable) sleep,
            # not the nominal delay: a no-op test sleep wastes nothing
            slept = clock() - t_sleep
            if slept > 0:
                goodput.note_wasted(goodput.WASTE_RETRY_BACKOFF, slept,
                                    registry=reg)
            pending = e
