"""Host-loop callbacks — the port's ``distributed_tensorflow_tpu/train/
callbacks.py``: ``Callback``, ``StopAtStep``, ``MetricsLogger``,
``SummaryWriter``, ``TelemetryCallback``, ``NaNGuard``, ``Watchdog`` (and
``StalledError``), ``Profiler`` and ``CheckpointCallback``. Metrics are
device scalars and reading one waits for the step, so the callbacks that
read values do it on a cadence (``every_n``). The heartbeat, elastic and
fleet-snapshot callbacks need the fleet control plane (ROADMAP Queue A
item 6).

``SummaryWriter`` writes TensorBoard's event files itself (the card's
machine has no tensorboard package): each record is the little-endian
u64 length, the masked CRC32C of those 8 bytes, an ``Event`` protobuf
(``wall_time``, ``step``, and ``summary.value{tag, simple_value}``, after
a leading ``file_version`` event) and the masked CRC32C of the data."""

from __future__ import annotations

import logging
import os
import signal as signal_lib
import socket
import struct
import threading
import time
from typing import Any

from ..obs import flightrec as flightrec_lib
from ..obs import goodput
from ..obs.registry import Registry, default_registry
from ..parallel import cluster
from ..parallel.cluster import is_chief
from .step import step_nonfinite

logger = logging.getLogger(__name__)


class Callback:
    def on_train_start(self, trainer) -> None: ...
    def on_step_end(self, trainer, step: int, metrics: dict[str, Any]) -> None: ...
    def on_train_end(self, trainer) -> None: ...


class StalledError(RuntimeError):
    """A train step exceeded the ``Watchdog``'s wall budget with
    ``abort_on_stall`` set, raised in the training thread so the hung
    attempt dies as a classified failure (``resilience.supervisor.
    classify_failure`` -> ``stalled``, which the ``Supervisor`` restarts).
    Constructible with no arguments: the asynchronous raise instantiates
    the class bare."""

    def __init__(self, message: str = "train step exceeded the watchdog wall budget"):
        super().__init__(message)


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


def _fresh_scalars(metrics_logger: "MetricsLogger | None", step: int,
                   metrics: dict[str, Any]) -> dict[str, float]:
    """Scalars for ``step``: the paired logger's fetched dict only if it
    fetched at this very step (an older ``last`` under this step would
    shift every curve), else a fetch of ``metrics`` (the same cadence'd
    wait the logger pays)."""
    if metrics_logger is not None and metrics_logger.last_step == step:
        return dict(metrics_logger.last)
    return {k: float(v) for k, v in metrics.items()}


# -- TensorBoard event files ------------------------------------------------

def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotated right 15 bits plus 0xa282ead8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    return _varint(number << 3 | wire) + payload


def _bytes_field(number: int, data: bytes) -> bytes:
    return _field(number, 2, _varint(len(data)) + data)


def event_bytes(wall_time: float, step: int = 0, *, file_version: str | None = None,
                scalars: dict[str, float] | None = None) -> bytes:
    """One ``tensorflow.Event`` protobuf: ``wall_time`` (1, double),
    ``step`` (2, int64), ``file_version`` (3) or ``summary`` (5) holding a
    ``Summary.Value`` (1) of ``tag`` (1) and ``simple_value`` (2, float)
    per scalar."""
    out = _field(1, 1, struct.pack("<d", wall_time)) + _field(2, 0, _varint(int(step)))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode()) + _field(2, 5, struct.pack("<f", v)))
            for tag, v in scalars.items())
        out += _bytes_field(5, summary)
    return out


def record_bytes(data: bytes) -> bytes:
    """``data`` framed as a TFRecord: length, its masked CRC, data, the
    data's masked CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def read_records(path: str) -> list[bytes]:
    """The data of every TFRecord in ``path``, each frame's two CRCs
    checked (raises ``ValueError`` on a bad one or a torn frame)."""
    out = []
    with open(path, "rb") as f:
        buf = f.read()
    i = 0
    while i < len(buf):
        if i + 12 > len(buf):
            raise ValueError(f"{path}: torn record header at byte {i}")
        length = buf[i:i + 8]
        (n,) = struct.unpack("<Q", length)
        if struct.unpack("<I", buf[i + 8:i + 12])[0] != masked_crc32c(length):
            raise ValueError(f"{path}: bad length CRC at byte {i}")
        data = buf[i + 12:i + 12 + n]
        if len(data) != n or i + 16 + n > len(buf):
            raise ValueError(f"{path}: torn record at byte {i}")
        if struct.unpack("<I", buf[i + 12 + n:i + 16 + n])[0] != masked_crc32c(data):
            raise ValueError(f"{path}: bad data CRC at byte {i}")
        out.append(data)
        i += 16 + n
    return out


class EventFileWriter:
    """An ``events.out.tfevents.*`` file in ``logdir``: the
    ``brain.Event:2`` version event, then one event per ``add_scalar``."""

    def __init__(self, logdir: str, clock=time.time):
        os.makedirs(logdir, exist_ok=True)
        self.clock = clock
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(clock()):010d}.{socket.gethostname()}."
                    f"{os.getpid()}")
        self._f = open(self.path, "wb")
        self._write(event_bytes(clock(), file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._f.write(record_bytes(event))

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self._write(event_bytes(self.clock(), global_step, scalars={tag: float(value)}))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class SummaryWriter(Callback):
    """The SummarySaverHook: TensorBoard scalar event files
    (``EventFileWriter``, module docstring), one ``train/<name>`` scalar a
    metric every ``every_n`` steps. Chief only. Throughput and MFU come
    from the paired ``MetricsLogger`` when it fetched at this step."""

    def __init__(self, logdir: str, every_n: int = 100,
                 metrics_logger: "MetricsLogger | None" = None):
        self.logdir = logdir
        self.every_n = every_n
        self.metrics_logger = metrics_logger
        self._writer: EventFileWriter | None = None

    def on_train_start(self, trainer):
        if is_chief():
            self._writer = EventFileWriter(self.logdir)

    def on_step_end(self, trainer, step, metrics):
        if self._writer is None or step % self.every_n != 0:
            return
        for k, v in _fresh_scalars(self.metrics_logger, step, metrics).items():
            self._writer.add_scalar(f"train/{k}", v, global_step=step)
        self._writer.flush()

    def on_train_end(self, trainer):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class TelemetryCallback(Callback):
    """The train loop into an ``obs.Registry`` (the JAX package's metric
    names and cadences). Every step: the host-clock step latency into the
    ``train_step_seconds`` histogram, a ``train_steps_total`` tick and the
    ``train_global_step`` gauge (host arithmetic only). Every ``every_n``
    steps: a ``train_<name>`` gauge per metric (the paired logger's fetch
    when it fetched at this step) and, with ``track_goodput``, ``mfu``.
    With ``track_goodput`` the same clock feeds the goodput ledger: train
    start to the first completed step as ``compile_warmup`` waste, every
    later interval as productive seconds."""

    def __init__(self, registry: Registry | None = None, every_n: int = 100,
                 metrics_logger: "MetricsLogger | None" = None,
                 clock=time.perf_counter, track_goodput: bool = True):
        self.registry = registry if registry is not None else default_registry()
        self.every_n = every_n
        self.metrics_logger = metrics_logger
        self.clock = clock
        self.track_goodput = track_goodput
        self._t_prev: float | None = None
        self._t_start: float | None = None
        self._step_prev = 0
        self._m_step = self.registry.histogram(
            "train_step_seconds", "host wall-clock between step dispatches")
        self._m_steps = self.registry.counter("train_steps_total", "train steps completed")
        self._m_gstep = self.registry.gauge("train_global_step",
                                            "latest completed global step")

    @staticmethod
    def _gauge_name(key: str) -> str:
        sane = "".join(c if c.isalnum() or c == "_" else "_" for c in key)
        return f"train_{sane}"

    def on_train_start(self, trainer):
        self._t_prev = None
        self._t_start = self.clock() if self.track_goodput else None

    def note_pause(self, seconds: float) -> None:
        """Wall time off the train path (a mid-train eval): the inter-step
        baseline (or, inside the warm-up window, its start) moves forward
        by it, so it is neither a step's latency nor booked in the
        goodput ledger."""
        pause = max(float(seconds), 0.0)
        if self._t_prev is not None:
            self._t_prev += pause
        elif self._t_start is not None:
            self._t_start += pause

    def on_step_end(self, trainer, step, metrics):
        now = self.clock()
        if self._t_prev is not None:
            n = max(step - self._step_prev, 1)
            self._m_step.observe((now - self._t_prev) / n)
            if self.track_goodput:
                goodput.note_productive(now - self._t_prev, registry=self.registry)
        elif self.track_goodput and self._t_start is not None:
            goodput.note_wasted(goodput.WASTE_COMPILE_WARMUP, now - self._t_start,
                                registry=self.registry)
        self._t_prev, self._step_prev = now, step
        self._m_steps.inc()
        self._m_gstep.set(step)
        if step % self.every_n != 0:
            return
        scalars = _fresh_scalars(self.metrics_logger, step, metrics)
        for k, v in scalars.items():
            self.registry.gauge(self._gauge_name(k), "train metric (cadence-sampled)").set(v)
        if self.track_goodput and "mfu" in scalars:
            self.registry.gauge(goodput.MFU, "model FLOPs utilization of the train step"
                                ).set(scalars["mfu"])


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


def _async_raise(ident: int, exc_type: type[BaseException]) -> None:
    """Raise ``exc_type`` in thread ``ident`` at its next bytecode
    (``PyThreadState_SetAsyncExc``)."""
    import ctypes

    n = ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(ident),
                                                   ctypes.py_object(exc_type))
    if n != 1:
        logger.error("async %s delivery to thread %d failed (SetAsyncExc hit %d threads)",
                     exc_type.__name__, ident, n)


def _async_cancel(ident: int) -> None:
    """Revoke an undelivered asynchronous exception of thread ``ident``."""
    import ctypes

    ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(ident), None)


#: ``abort_on_stall`` delivery to a loop on the main thread: a process
#: signal, whose handler raises ``StalledError`` there (it wakes blocking
#: C sleeps, where an asynchronous exception can be lost). Installed once
#: on first arm and left installed: with no abort pending it ignores the
#: signal, so a late one never terminates the process.
_STALL_SIGNAL = signal_lib.SIGUSR1
#: ids of watchdogs with an abort pending (set operations hold the GIL;
#: the handler takes no lock)
_pending_aborts: set[int] = set()
_stall_handler_installed = False


def _stall_signal_handler(signum, frame):
    if _pending_aborts:
        _pending_aborts.clear()
        raise StalledError()
    logger.warning("stall-abort signal received with no abort pending; ignored")


def _install_stall_handler() -> None:
    """Main thread only (``signal.signal``); idempotent."""
    global _stall_handler_installed
    if not _stall_handler_installed:
        signal_lib.signal(_STALL_SIGNAL, _stall_signal_handler)
        _stall_handler_installed = True


class Watchdog(Callback):
    """Hung-step detector: when no ``on_step_end`` arrives within
    ``budget_s`` wall seconds (a daemon thread polls every ``poll_s`` on
    the injectable ``clock``), the ``train_watchdog_stalled`` gauge goes to
    1, ``train_watchdog_stalls_total`` counts the stall once, the flight
    recorder gets a ``watchdog_stall`` event and an error is logged; the
    next completed step clears the gauge. With ``abort_on_stall`` the
    stall also raises ``StalledError`` in the loop's thread — by
    ``SIGUSR1`` when the loop runs on the main thread, else by
    ``PyThreadState_SetAsyncExc`` — so the attempt dies as a ``stalled``
    failure the ``Supervisor`` rolls back; a step that completes before
    the abort is delivered revokes it. A thread wedged in a C call that
    ignores EINTR (a device wait, a stuck collective) aborts only when the
    call returns."""

    def __init__(self, budget_s: float = 300.0, registry: Registry | None = None,
                 poll_s: float | None = None, clock=time.monotonic, flightrec=None,
                 abort_on_stall: bool = False):
        if budget_s <= 0:
            raise ValueError("budget_s must be positive")
        self.budget_s = budget_s
        self.flightrec = flightrec if flightrec is not None else flightrec_lib.default_recorder()
        self.registry = registry if registry is not None else default_registry()
        self.poll_s = poll_s if poll_s is not None else max(min(budget_s / 4, 1.0), 0.005)
        self.clock = clock
        self.abort_on_stall = abort_on_stall
        self._beat: float | None = None
        self._loop_ident: int | None = None  # the thread to abort
        self._abort_issued = False           # issued, not consumed
        self._signal_abort = False           # delivered by signal (main thread)
        self._lock = threading.Lock()        # orders beats against the stall flags
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._m_stalled = self.registry.gauge(
            "train_watchdog_stalled",
            "1 while no train step has completed within the watchdog budget")
        self._m_stalls = self.registry.counter(
            "train_watchdog_stalls_total",
            "times a train step exceeded the watchdog wall budget")

    def on_train_start(self, trainer):
        self._signal_abort = (self.abort_on_stall
                              and threading.current_thread() is threading.main_thread())
        if self._signal_abort:
            _install_stall_handler()
        with self._lock:
            self._beat = self.clock()
            self._loop_ident = threading.get_ident()
            self._m_stalled.set(0.0)
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch, daemon=True, name="train-watchdog")
        self._thread.start()

    def note_pause(self, seconds: float) -> None:
        """A sanctioned pause (a mid-train eval) ended: the budget restarts
        from now."""
        with self._lock:
            if self._beat is not None:
                self._beat = self.clock()

    def on_step_end(self, trainer, step, metrics):
        with self._lock:
            if self._m_stalled.value:
                logger.warning("watchdog: step %d completed, stall cleared", step)
                self._m_stalled.set(0.0)
            self._beat = self.clock()
            cancel = self._take_abort_unlocked()
        if cancel is not None:
            # the flagged step completed after all: revoke the pending abort
            _pending_aborts.discard(id(self))
            if not self._signal_abort:
                _async_cancel(cancel)
            logger.warning("watchdog: step %d completed before the abort delivered; revoked",
                           step)

    def on_train_end(self, trainer):
        with self._lock:
            cancel = self._take_abort_unlocked()
        if cancel is not None:
            _pending_aborts.discard(id(self))
            if not self._signal_abort:
                _async_cancel(cancel)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _take_abort_unlocked(self) -> int | None:
        if not self._abort_issued:
            return None
        self._abort_issued = False
        return self._loop_ident

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:  # check and flag in one section with on_step_end
                if self._beat is None:
                    continue
                overdue = self.clock() - self._beat
                if overdue <= self.budget_s or self._m_stalled.value:
                    continue
                self._m_stalled.set(1.0)  # edge-triggered: one count a stall
                self._m_stalls.inc()
                abort_ident = self._loop_ident if self.abort_on_stall else None
                if abort_ident is not None:
                    self._abort_issued = True
                    if self._signal_abort:
                        _pending_aborts.add(id(self))
                        os.kill(os.getpid(), _STALL_SIGNAL)
                    else:
                        _async_raise(abort_ident, StalledError)
            self.flightrec.emit("watchdog_stall", overdue_s=round(overdue, 3),
                                budget_s=self.budget_s, abort=bool(abort_ident))
            logger.error("watchdog: no step completed for %.1fs (budget %.1fs) — host loop "
                         "or a collective is hung", overdue, self.budget_s)


class Profiler(Callback):
    """The ProfilerHook: a ``torch.profiler`` trace (CPU, and the card's
    kernels when CUDA is available) from the end of step ``start_step`` to
    the end of step ``start_step + num_steps``, written as a Chrome trace
    into ``logdir`` (``trace_rank<r>_steps<a>-<b>.json``; ``.path``)."""

    def __init__(self, logdir: str, start_step: int = 10, num_steps: int = 5):
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.path: str | None = None
        self._prof = None

    def on_step_end(self, trainer, step, metrics):
        import torch

        if step == self.start_step and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif step >= self.stop_step and self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._finish()

    def _finish(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(
            self.logdir,
            f"trace_rank{cluster.process_index()}_steps{self.start_step}-{self.stop_step}.json")
        prof.export_chrome_trace(self.path)
        if is_chief():
            logger.info("profile written to %s", self.path)

    def on_train_end(self, trainer):
        if self._prof is not None:
            self._finish()


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
