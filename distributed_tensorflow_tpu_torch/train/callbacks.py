"""Host-loop callbacks — the subset of ``distributed_tensorflow_tpu/train/
callbacks.py`` the ported loop uses: ``Callback``, ``StopAtStep``,
``MetricsLogger``, ``NaNGuard`` and ``CheckpointCallback``. Metrics are
device scalars and reading one waits for the step, so the callbacks that
read values do it on a cadence (``every_n``). The summary writer,
telemetry, watchdog, profiler, heartbeat and elastic callbacks come later
(ROADMAP Queue A items 2.6 and 6)."""

from __future__ import annotations

import logging
import time
from typing import Any

from ..obs import goodput
from ..obs.registry import Registry
from ..parallel.cluster import is_chief
from .step import step_nonfinite

logger = logging.getLogger(__name__)


class Callback:
    def on_train_start(self, trainer) -> None: ...
    def on_step_end(self, trainer, step: int, metrics: dict[str, Any]) -> None: ...
    def on_train_end(self, trainer) -> None: ...


class StopAtStep(Callback):
    """Stop once ``last_step`` is reached."""

    def __init__(self, last_step: int):
        self.last_step = last_step

    def on_step_end(self, trainer, step, metrics):
        if step >= self.last_step:
            trainer.request_stop(f"reached last_step={self.last_step}")


class MetricsLogger(Callback):
    """Steps/sec, examples/sec, MFU and the metric dict, every N steps.
    Every process fetches (keeping the processes in step); only the chief
    logs.

    ``model_flops_per_step`` is FORWARD FLOPs per step; ``obs.goodput.
    train_mfu`` applies the ×3. Rates are taken between two fetches, so
    the first interval (kernel builds, library handles) is not in them:
    it is booked as ``compile_warmup`` waste in the goodput ledger, every
    later interval as productive."""

    def __init__(self, every_n: int = 100, batch_size: int | None = None,
                 model_flops_per_step: float | None = None,
                 history: bool = False, clock=time.perf_counter,
                 registry: Registry | None = None):
        self.every_n = every_n
        self.batch_size = batch_size
        self.model_flops = model_flops_per_step
        self.clock = clock
        self.registry = registry
        self._t0: float | None = None
        self._t_start: float | None = None
        self._step0 = 0
        self.history: list[dict] | None = [] if history else None
        self.last: dict[str, float] = {}
        self.last_step: int | None = None

    def on_train_start(self, trainer):
        self._t0, self._t_start = None, self.clock()
        self.last, self.last_step = {}, None

    def note_pause(self, seconds: float) -> None:
        """Wall time spent off the train path between two steps (a
        mid-train eval): the rate baseline moves forward by it, so
        steps/s, examples/s and MFU do not absorb it."""
        if self._t0 is not None:
            self._t0 += max(float(seconds), 0.0)

    def on_step_end(self, trainer, step, metrics):
        if step % self.every_n != 0:
            return
        fetched = {k: float(v) for k, v in metrics.items()}
        now = self.clock()
        if self._t0 is not None:
            dt = now - self._t0
            goodput.note_productive(dt, self.registry)
            steps_per_sec = (step - self._step0) / max(dt, 1e-9)
            fetched["steps_per_sec"] = steps_per_sec
            if self.batch_size:
                fetched["examples_per_sec"] = steps_per_sec * self.batch_size
            if self.model_flops:
                fetched["mfu"] = goodput.train_mfu(self.model_flops, steps_per_sec,
                                                   registry=self.registry)
        elif self._t_start is not None:
            goodput.note_wasted(goodput.WASTE_COMPILE_WARMUP, now - self._t_start,
                                self.registry)
        self._t0, self._step0 = now, step
        self.last, self.last_step = fetched, step
        if self.history is not None:
            self.history.append({"step": step, **fetched})
        if is_chief():
            logger.info("step %d: %s", step,
                        " ".join(f"{k}={v:.6g}" for k, v in sorted(fetched.items())))


class NaNGuard(Callback):
    """Stop (or raise) when the step reports a non-finite loss/gradient:
    the per-step ``nonfinite`` flag when the step carries it, else the
    ``grads_finite``/``loss`` signals every ``every_n`` steps."""

    def __init__(self, every_n: int = 10, fail_fast: bool = True):
        self.every_n = every_n
        self.fail_fast = fail_fast

    def on_step_end(self, trainer, step, metrics):
        if "nonfinite" in metrics:
            if step_nonfinite(metrics):
                self._bad(trainer, step)
            return
        if step % self.every_n != 0:
            return
        bad = False
        if "grads_finite" in metrics:
            bad |= float(metrics["grads_finite"]) == 0.0
        if "loss" in metrics:
            loss = float(metrics["loss"])
            bad |= loss != loss or loss in (float("inf"), float("-inf"))
        if bad:
            self._bad(trainer, step)

    def _bad(self, trainer, step: int) -> None:
        msg = f"non-finite loss/gradients at step {step}"
        if self.fail_fast:
            raise FloatingPointError(msg)
        trainer.request_stop(msg)


class CheckpointCallback(Callback):
    """The CheckpointSaverHook: cadence and retention are the manager's
    (``train/checkpoint.Checkpointer``); it also saves when training ends
    cleanly, and on an agreed preemption (``maybe_save`` raises
    ``PreemptionSaved`` for the loop)."""

    def __init__(self, manager):
        self.manager = manager

    def on_step_end(self, trainer, step, metrics):
        self.manager.maybe_save(step, trainer.state)

    def on_train_end(self, trainer):
        if trainer.failed:
            # the state may be poisoned or torn: never the latest
            # checkpoint. The writer is still drained, and its own error
            # logged, not raised over the failure that ended the run.
            logger.warning("skipping final checkpoint: training failed")
            try:
                self.manager.wait()
            except Exception:
                logger.exception("async checkpoint writer also failed during the aborted run")
            return
        # the final save commits on this thread; wait() then drains a
        # cadence commit still in flight and re-raises its stored error
        self.manager.save(int(trainer.state.step), trainer.state, force=True, trigger="final")
        self.manager.wait()
