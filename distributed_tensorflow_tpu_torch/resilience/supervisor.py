"""In-process training supervision: restart from the last valid
checkpoint — the port's counterpart of ``distributed_tensorflow_tpu/
resilience/supervisor.py`` (the reference's ``_RecoverableSession``).
``Supervisor`` wraps ``Trainer.fit``, classifies what ended an attempt,
and relaunches from the newest checkpoint that passes its integrity
checks, under a restart budget with escalating, seeded-jitter backoff.

Failure classes (``classify_failure``):

- ``transient``: IO-class errors (OSError, a ``RetryExhausted`` over IO
  failures): the state on disk is fine -> restart and resume.
- ``poisoned``: FloatingPointError (NaNGuard, a refused save): roll back
  to the last valid checkpoint and retry.
- ``stalled``: a stall judgment (the Watchdog and the fleet's liveness,
  ROADMAP Queue A items 2.6 and 6, raise it; nothing in the port does
  yet).
- ``fatal``: everything else, re-raised at once.
- ``preemption``: not an exception: ``fit`` returned with
  ``trainer.preempted`` set (SIGTERM -> agreed save).

The supervisor never touches a checkpoint itself: the ``build`` callable
makes each attempt — a fresh ``Checkpointer`` (a fresh signal watcher),
``init_or_restore(..., fallback=True)``, a fresh ``Trainer``, the stream
at the restored step — and the supervisor closes that attempt's
checkpointer when the attempt ends.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal as signal_lib
import threading
import time
from typing import Any, Callable, Iterable, Sequence

from ..obs import flightrec as flightrec_lib
from ..obs import goodput
from ..obs.flightrec import FlightRecorder
from ..obs.registry import Registry, default_registry
from .retry import RetryExhausted, RetryPolicy

logger = logging.getLogger(__name__)

#: failure classes (classify_failure) and the preemption restart cause
TRANSIENT = "transient"
POISONED = "poisoned"
STALLED = "stalled"
FATAL = "fatal"
PREEMPTION = "preemption"

#: counter name (documented in docs/observability.md)
RESTARTS_TOTAL = "supervisor_restarts_total"


def classify_failure(exc: BaseException) -> str:
    """Map an exception out of ``Trainer.fit`` to a failure class."""
    from ..train.callbacks import StalledError

    if isinstance(exc, StalledError):
        return STALLED
    if isinstance(exc, RetryExhausted):
        # see through to what the retries were absorbing
        under = exc.__cause__
        if isinstance(under, FloatingPointError):
            return POISONED
        return TRANSIENT
    if isinstance(exc, FloatingPointError):
        return POISONED
    if isinstance(exc, OSError):  # IOError/TimeoutError are aliases/subclasses
        return TRANSIENT
    return FATAL


class SupervisorExhausted(RuntimeError):
    """The restart budget ran out. ``cause`` is the classified failure
    class of the last attempt; the last exception (if the attempt raised
    rather than exiting via preemption) is chained as ``__cause__``."""

    def __init__(self, cause: str, restarts: int, last: BaseException | None):
        super().__init__(
            f"supervisor restart budget exhausted after {restarts} "
            f"restart(s); last failure class {cause!r}"
            + (f": {last!r}" if last is not None else "")
        )
        self.cause = cause
        self.restarts = restarts


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    #: restarts allowed (attempts = max_restarts + 1)
    max_restarts: int = 3
    #: failure classes that earn a restart; anything else re-raises
    restart_on: tuple[str, ...] = (TRANSIENT, POISONED, PREEMPTION, STALLED)
    #: escalating backoff between attempts — reuses RetryPolicy's
    #: seeded-jitter schedule (max_attempts is ignored here; the restart
    #: budget is max_restarts above)
    backoff: RetryPolicy = RetryPolicy(
        base_s=0.2, multiplier=2.0, max_backoff_s=60.0)

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        unknown = set(self.restart_on) - {TRANSIENT, POISONED, PREEMPTION,
                                          STALLED}
        if unknown:
            raise ValueError(f"unknown restart_on classes: {sorted(unknown)}")


class Supervisor:
    """Run ``build → fit`` until the target step is reached, restarting
    restartable failures from the latest valid checkpoint.

    ``build(restart_index)`` returns ``(trainer, data, checkpointer)``
    for one attempt; ``checkpointer`` may be None, otherwise the
    supervisor closes it when the attempt ends (success or failure) so
    signal handlers and async savers never leak across attempts.

    ``on_restart`` hooks run as ``hook(restart_index, cause)`` after the
    backoff sleep and before the next ``build`` — the production seam
    for cache cleanup or operator paging, and the seam
    ``FaultPlan.restart_hook`` uses to model corruption discovered at
    restart time. Hooks execute inside the next attempt's classified
    try: a hook that raises transiently earns a restart like any other
    failure, and the hooks re-run on that next attempt — keep them
    idempotent. ``sleep`` is injectable so chaos tests run the full
    escalation in microseconds; when NOT injected, backoff waits are an
    interruptible ``Event.wait`` that ``interrupt()`` — or a SIGTERM —
    wakes immediately, so a preemption is processed at once instead of
    after up to a full backoff interval (the signal is re-delivered to
    the pre-backoff handler once the wait returns).
    """

    def __init__(
        self,
        build: Callable[[int], tuple[Any, Iterable, Any]],
        num_steps: int,
        cfg: SupervisorConfig = SupervisorConfig(),
        registry: Registry | None = None,
        on_restart: Sequence[Callable[[int, str], None]] = (),
        sleep: Callable[[float], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
        flightrec: FlightRecorder | None = None,
        postmortem_dir: str | None = None,
    ):
        self.build = build
        self.num_steps = num_steps
        self.cfg = cfg
        self.registry = registry if registry is not None else default_registry()
        self.on_restart = tuple(on_restart)
        self.sleep = sleep
        self.clock = clock
        self._wake = threading.Event()
        self.flightrec = (flightrec if flightrec is not None
                          else flightrec_lib.default_recorder())
        #: where the exhaustion postmortem lands; defaults to the first
        #: attempt checkpointer's directory (the run dir) when not given
        self.postmortem_dir = postmortem_dir
        #: restarts performed by the last run() (observability for tests)
        self.restarts = 0

    def interrupt(self) -> None:
        """Wake the in-progress (or next) backoff wait immediately. The
        wakeup is consumed by that one wait — never lost when it races
        the sleep, but not sticky either: later restarts keep their
        escalating backoff instead of degenerating into a zero-delay
        restart storm."""
        self._wake.set()

    def _backoff_wait(self, delay: float) -> None:
        """Sleep out one restart backoff. With an injected ``sleep`` the
        caller owns the semantics (tests). Otherwise wait on the wake
        event AND catch SIGTERM for the duration: during backoff no
        attempt checkpointer is alive, so no PreemptionWatcher handler
        is installed — without this, a preemption either kills the
        process mid-backoff (default handler) or waits out the full
        delay. The caught signal is re-delivered to the restored
        handler after the wait, so its real semantics still apply —
        just immediately."""
        if self.sleep is not None:
            self.sleep(delay)
            return
        pending: list[int] = []

        def handler(signum, frame):
            pending.append(signum)
            self._wake.set()

        main = threading.current_thread() is threading.main_thread()
        prev = signal_lib.signal(signal_lib.SIGTERM, handler) if main else None
        try:
            if self._wake.wait(delay):
                self._wake.clear()  # one-shot: later backoffs still wait
        finally:
            if main:
                signal_lib.signal(signal_lib.SIGTERM, prev)
        if pending:
            logger.warning(
                "supervisor: SIGTERM during restart backoff — woke early, "
                "re-delivering to the previous handler")
            os.kill(os.getpid(), pending[0])

    def run(self):
        """Supervised ``Trainer.fit``; returns the final TrainState.

        Raises SupervisorExhausted when the restart budget runs out, or
        re-raises the attempt's exception for non-restartable classes.
        A deliberate early stop (``trainer.request_stop`` without
        preemption, or data exhaustion) is respected and returned as-is.
        """
        restarts = 0
        last_exc: BaseException | None = None
        #: (restart_index, cause) the on_restart hooks still owe a run for
        pending_hook: tuple[int, str] | None = None
        while True:
            self.restarts = restarts
            cause: str | None = None
            trainer = ckpt = None
            self.flightrec.emit("sup_attempt", attempt=restarts)
            try:
                try:
                    # hooks and build are INSIDE the classified attempt:
                    # a transient failure at the restart boundary (a
                    # hook's disk work, a restore-time IO blip) earns
                    # another restart, not a raw escape. Hooks re-run on
                    # the next attempt if one raised — keep them
                    # idempotent. A builder that dies after creating its
                    # checkpointer must close it itself — the supervisor
                    # never saw it.
                    t_boundary = self.clock()
                    if pending_hook is not None:
                        for hook in self.on_restart:
                            hook(*pending_hook)
                        pending_hook = None
                    trainer, data, ckpt = self.build(restarts)
                    # goodput: hook + build time (restore, re-init) is
                    # wall-clock the job did not train — startup counts
                    # as warmup, restart boundaries as recovery
                    goodput.note_wasted(
                        goodput.WASTE_COMPILE_WARMUP if restarts == 0
                        else goodput.WASTE_RESTART_RECOVERY,
                        self.clock() - t_boundary, registry=self.registry,
                    )
                    if self.postmortem_dir is None:
                        self.postmortem_dir = getattr(
                            getattr(ckpt, "cfg", None), "directory", None)
                    state = trainer.fit(data, num_steps=self.num_steps)
                except BaseException as e:
                    cause = classify_failure(e)
                    last_exc = e
                    self.flightrec.emit(
                        "sup_failure", attempt=restarts, cause=cause,
                        error=repr(e)[:200],
                    )
                    logger.error(
                        "supervised attempt %d failed [%s]: %r",
                        restarts, cause, e,
                    )
                    if cause not in self.cfg.restart_on:
                        raise
                else:
                    done = int(state.step) >= self.num_steps
                    if done or not getattr(trainer, "preempted", False):
                        return state
                    cause, last_exc = PREEMPTION, None
                    if cause not in self.cfg.restart_on:
                        return state
            finally:
                if ckpt is not None:
                    # close() joins the async background writer (bounded)
                    # and re-raises its stored error after a clean
                    # shutdown — a failed attempt's exception must not be
                    # masked by it, so it is logged here (the success
                    # path already surfaced it via Checkpointer.wait in
                    # CheckpointCallback.on_train_end)
                    try:
                        ckpt.close()
                    except Exception:
                        logger.exception(
                            "closing checkpointer (async writer join) "
                            "after attempt %d failed", restarts,
                        )
            if restarts >= self.cfg.max_restarts:
                self.flightrec.emit("sup_exhausted", cause=cause,
                                    restarts=restarts)
                self._dump_postmortem(f"supervisor_exhausted:{cause}")
                raise SupervisorExhausted(cause, restarts, last_exc) from last_exc
            delay = self.cfg.backoff.backoff_s(restarts)
            restarts += 1
            self.registry.counter(
                RESTARTS_TOTAL, "supervised restarts by failure class",
                cause=cause,
            ).inc()
            self.flightrec.emit("sup_restart", restart=restarts, cause=cause,
                                backoff_s=round(delay, 6))
            logger.warning(
                "supervisor: restart %d/%d (cause=%s) after %.2fs backoff",
                restarts, self.cfg.max_restarts, cause, delay,
            )
            t_sleep = self.clock()
            self._backoff_wait(delay)
            # ELAPSED, not nominal: an injected no-op sleep wastes nothing
            slept = self.clock() - t_sleep
            if slept > 0:
                goodput.note_wasted(goodput.WASTE_RESTART_RECOVERY, slept,
                                    registry=self.registry)
            pending_hook = (restarts, cause)

    def _dump_postmortem(self, reason: str) -> None:
        flightrec_lib.dump_postmortem(self.flightrec, self.postmortem_dir,
                                      reason=reason)
