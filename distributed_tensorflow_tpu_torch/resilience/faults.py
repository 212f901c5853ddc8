"""Deterministic fault injection — the run-level and disk subset of
``distributed_tensorflow_tpu/resilience/faults.py``. Every fault goes in
through a seam the production code already has (the callback list, the
wrapping data iterator, the checkpoint writer's ``save_hooks``, the
supervisor's ``on_restart``, the directory on disk), so a faulted run
executes the code paths a real failure would:

- ``Sigterm(step)``: the process SIGTERMs itself after step N:
  PreemptionWatcher -> agreed save -> ``PreemptionSaved`` clean stop.
- ``DataError(batch)``: the data iterator raises ``IOError`` fetching
  batch M: Trainer emergency checkpoint -> re-raise.
- ``NaNBatch(batch)``: one batch poisoned with NaN: NaNGuard aborts and
  ``validate_before_save`` refuses the poisoned state.
- ``TransientIOError(batch, times)``: the iterator raises ``times`` times
  in total, then succeeds: ``data/pipeline.RetryingIterator`` absorbs it.
- ``CorruptCheckpoint(restart)``: truncates the newest checkpoint at the
  Nth supervisor restart (``FaultPlan.restart_hook``): fallback restore
  must quarantine it.
- ``AsyncCommitKill(step)``: SIGKILL from inside the background writer,
  shards written, manifest and publish not (``FaultPlan.save_hook``): the
  torn write stays in ``.pending/``.
- ``SlowWriter(step, delay_s)``: stalls the background writer before a
  commit (same seam).
- ``FaultClock``: a manually advanced clock for the ``clock=`` seams.

``truncate_shard`` / ``corrupt_shard`` damage a saved step on disk. The
fleet-side faults (``PodOutage``, ``ControlPlanePartition``,
``SlowControlPlane``, ``ClockStall``, ``Hang``) come with the fleet
(ROADMAP Queue A item 6). Faults fire at exact step or batch indices,
``FaultPlan.seeded`` draws them from a seed, and the fired state lives on
the plan, so a fault fires at most once per plan across the supervisor's
rebuilt callbacks and re-wrapped streams.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import signal as signal_lib

import numpy as np

from ..obs import flightrec as flightrec_lib
from ..train.callbacks import Callback

logger = logging.getLogger(__name__)


def _record_fault(fault: str, **attrs) -> None:
    """Every injected fault lands in the process flight recorder the
    instant it fires."""
    flightrec_lib.default_recorder().emit("fault_fired", fault=fault, **attrs)


# ---------------------------------------------------------------------------
# Clock
# ---------------------------------------------------------------------------


class FaultClock:
    """Manually-advanced clock, drop-in for the ``clock=`` seams
    (Scheduler/ServeEngine/Watchdog/MetricsLogger). Starts at ``start``
    and only moves when told to — latency and deadline logic becomes
    exactly reproducible."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("clocks only go forward")
        self.t += float(dt)
        return self.t


# ---------------------------------------------------------------------------
# Fault vocabulary
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sigterm:
    """Send SIGTERM to our own process after train step ``step``
    completes (FaultCallback seam)."""

    step: int


@dataclasses.dataclass(frozen=True)
class DataError:
    """Raise ``IOError`` from the data iterator on its ``batch``-th
    ``next()`` call, 1-based — batch i feeds train step i
    (FaultyIterator seam)."""

    batch: int
    message: str = "injected data fault"


@dataclasses.dataclass(frozen=True)
class NaNBatch:
    """Poison the ``batch``-th batch (1-based): the first element of
    ``key``'s array (or of the first float array found) becomes NaN, so
    the step computes non-finite loss/grads — the seam for driving
    NaNGuard and validate_before_save (FaultyIterator seam).

    ``recur=True`` models persistently bad data at a fixed index: the
    fault keys on the exact index (``count == batch``), never enters the
    plan's fired set, and re-poisons every fetch of that index."""

    batch: int
    key: str | None = None
    recur: bool = False


@dataclasses.dataclass(frozen=True)
class TransientIOError:
    """Raise ``IOError`` from the data iterator fetching the ``batch``-th
    batch (1-based), ``times`` times IN TOTAL across every iterator
    wrapping this plan, then succeed — the remaining-fires count is
    plan-shared state, so a re-seeking retry wrapper sees the fault decay
    exactly ``times`` fires regardless of how often it rebuilds the
    stream. A huge ``times`` models a permanent IO failure (drives retry
    exhaustion); no source batch is ever consumed by a faulted fetch
    (FaultyIterator seam)."""

    batch: int
    times: int = 1
    message: str = "injected transient IO fault"


@dataclasses.dataclass(frozen=True)
class CorruptCheckpoint:
    """Truncate ``nbytes`` from the largest shard of the NEWEST saved
    checkpoint when supervisor restart number ``restart`` begins (1 = the
    first restart; ``FaultPlan.restart_hook`` seam). Models corruption
    discovered at restore time — the case fallback restore must
    quarantine and degrade past, not brick on."""

    restart: int = 1
    nbytes: int = 1


@dataclasses.dataclass(frozen=True)
class AsyncCommitKill:
    """SIGKILL our own process from the background async-save writer at
    step >= ``step``, between the shard writes and the manifest
    publish — the widest torn-write window the snapshot-then-commit
    layout has (``FaultPlan.save_hook`` seam). The kill is immediate and
    unhandleable; the staged ``.pending/<step>`` dir must never become
    restorable."""

    step: int


@dataclasses.dataclass(frozen=True)
class SlowWriter:
    """Sleep ``delay_s`` inside the background async-save writer before
    step >= ``step``'s shard writes begin (``FaultPlan.save_hook``
    seam) — a slow/stuck writer thread as seen by wait()'s bounded
    join, the heartbeat save-phase window, and retention."""

    step: int
    delay_s: float = 1.0


Fault = (Sigterm | DataError | NaNBatch | TransientIOError | CorruptCheckpoint
         | AsyncCommitKill | SlowWriter)


# ---------------------------------------------------------------------------
# Plan + injection seams
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of faults. One plan drives three seams:
    ``plan.callback()`` goes into the Trainer's callback list (step
    faults), ``plan.wrap(iterator)`` wraps the batch source (data
    faults), ``plan.restart_hook(dir)`` goes into the Supervisor's
    ``on_restart`` list (restart-boundary disk faults).

    Each fault fires at most once PER PLAN: the fired set (and the
    remaining-fires count of TransientIOError) is shared mutable state on
    the plan, excluded from equality — so re-wrapping the stream or
    rebuilding the callback list (retry re-seeks, supervisor restarts)
    never re-fires a fault that already happened."""

    faults: tuple[Fault, ...] = ()
    #: indices of faults that already fired — plan-level, not per-seam
    _fired: set = dataclasses.field(
        default_factory=set, init=False, compare=False, repr=False)
    #: fault index → remaining fires, for TransientIOError decay
    _transient_left: dict = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False)

    @classmethod
    def seeded(cls, seed: int, num_steps: int,
               kinds: tuple[str, ...] = ("sigterm",)) -> "FaultPlan":
        """Deterministic random plan: each requested kind fires once at
        a seed-derived step in [2, num_steps-1] — never step 1 (nothing
        saved yet) and never the final step (nothing left to recover).
        Same (seed, num_steps, kinds) → identical plan, the JAX
        package's for the same arguments. The fleet-side kinds raise
        (ROADMAP Queue A item 6)."""
        if num_steps < 3:
            raise ValueError("need num_steps >= 3 to place a mid-run fault")
        rng = random.Random(seed)
        faults: list[Fault] = []
        for kind in kinds:
            at = rng.randint(2, num_steps - 1)
            if kind == "sigterm":
                faults.append(Sigterm(at))
            elif kind == "data_error":
                faults.append(DataError(at))
            elif kind == "nan_batch":
                faults.append(NaNBatch(at))
            elif kind == "transient_io":
                faults.append(TransientIOError(at, times=rng.randint(1, 2)))
            elif kind == "ckpt_corrupt":
                # fires at the first restart boundary; `at` drawn anyway
                # so every kind consumes rng state uniformly
                faults.append(CorruptCheckpoint(restart=1))
            elif kind == "async_commit_kill":
                faults.append(AsyncCommitKill(at))
            elif kind == "slow_writer":
                faults.append(SlowWriter(at, delay_s=rng.uniform(0.5, 5.0)))
            elif kind in ("clock_stall", "pod_outage", "control_plane_partition",
                          "slow_control_plane"):
                raise NotImplementedError(f"fault kind {kind!r} is not ported yet (ROADMAP "
                                          f"Queue A item 6, the fleet)")
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
        return cls(tuple(faults))

    def callback(self) -> "FaultCallback":
        return FaultCallback(self)

    def wrap(self, iterator, start: int = 0) -> "FaultyIterator":
        """``start``: batches already consumed upstream (a resumed run's
        restored step), so batch-indexed faults stay aligned with GLOBAL
        step numbering across restarts and re-seeks."""
        return FaultyIterator(iterator, self, start=start)

    def restart_hook(self, directory: str):
        """A ``Supervisor(on_restart=…)`` hook firing this plan's
        CorruptCheckpoint faults against the newest step dir under
        ``directory`` (no-op until a checkpoint exists)."""

        def hook(restart_index: int, cause: str) -> None:
            for i, fault in enumerate(self.faults):
                if (not isinstance(fault, CorruptCheckpoint)
                        or i in self._fired
                        or restart_index < fault.restart):
                    continue
                step = _newest_step_on_disk(directory)
                if step is None:
                    continue  # nothing saved yet; try again next restart
                self._fired.add(i)
                path = truncate_shard(directory, step, nbytes=fault.nbytes)
                _record_fault("ckpt_corrupt", step=step,
                              restart=restart_index)
                logger.warning(
                    "fault: truncated %d byte(s) of newest checkpoint "
                    "(step %d) at restart %d: %s",
                    fault.nbytes, step, restart_index, path,
                )

        return hook

    def save_hook(self, flush=None, sleep=None):
        """A ``Checkpointer.save_hooks`` entry firing this plan's
        background-writer faults through the production async-commit
        seam. ``stage`` is the writer's position: ``async_begin`` (the
        SlowWriter stall point, before any shard write) and
        ``shards_done`` (the AsyncCommitKill window — shards durable,
        manifest NOT yet published).

        ``flush``: called after a kill fault is recorded and before
        SIGKILL lands, so the flight-recorder ring reaches disk — the
        postmortem's only record of a death this abrupt. ``sleep``:
        injectable stall for tests (default: real ``time.sleep``)."""

        def hook(stage: str, step: int) -> None:
            for i, fault in enumerate(self.faults):
                if i in self._fired:
                    continue
                if (isinstance(fault, SlowWriter)
                        and stage == "async_begin" and step >= fault.step):
                    self._fired.add(i)
                    _record_fault("slow_writer", step=step,
                                  delay_s=fault.delay_s)
                    logger.warning(
                        "fault: stalling the async checkpoint writer "
                        "%.2fs at step %d", fault.delay_s, step)
                    if sleep is not None:
                        sleep(fault.delay_s)
                    else:
                        import time as time_lib

                        time_lib.sleep(fault.delay_s)
                elif (isinstance(fault, AsyncCommitKill)
                        and stage == "shards_done" and step >= fault.step):
                    self._fired.add(i)
                    _record_fault("async_commit_kill", step=step)
                    logger.warning(
                        "fault: SIGKILL inside the async commit window "
                        "at step %d (shards written, manifest not "
                        "published)", step)
                    if flush is not None:
                        flush()
                    os.kill(os.getpid(), signal_lib.SIGKILL)

        return hook


def _newest_step_on_disk(directory: str) -> int | None:
    """Largest numeric step dir under ``directory`` (filesystem truth —
    no manager involved, matching how disk faults see the world)."""
    d = os.path.abspath(os.path.expanduser(directory))
    if not os.path.isdir(d):
        return None
    steps = [int(n) for n in os.listdir(d)
             if n.isdigit() and os.path.isdir(os.path.join(d, n))]
    return max(steps) if steps else None


class FaultCallback(Callback):
    """Fires the plan's step-indexed faults from ``on_step_end`` — the seam
    every production hook uses, so a SIGTERM lands where a maintenance
    event would: between steps, with the PreemptionWatcher installed."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def on_step_end(self, trainer, step, metrics):
        fired = self.plan._fired  # plan-shared: at most once per PLAN
        for i, fault in enumerate(self.plan.faults):
            if i not in fired and isinstance(fault, Sigterm) and step >= fault.step:
                fired.add(i)
                _record_fault("sigterm", step=step)
                os.kill(os.getpid(), signal_lib.SIGTERM)


class FaultyIterator:
    """Wraps a batch iterator and injects the plan's batch-indexed
    faults. Batch numbering is 1-based and counts ``next()`` calls from
    ``start``, so with the standard loop batch i feeds train step i —
    pass ``start=restored_step`` on resume to keep global alignment.

    Fired-state is plan-shared: a one-shot fault (DataError/NaNBatch)
    fires once per PLAN even across re-wraps, and TransientIOError's
    remaining-fires count decays across re-seeks — a faulted fetch never
    consumes a source batch, so recovery sees the data it missed."""

    def __init__(self, iterator, plan: FaultPlan, start: int = 0):
        self._it = iter(iterator)
        self.plan = plan
        self.count = start

    def __iter__(self) -> "FaultyIterator":
        return self

    def __next__(self):
        self.count += 1
        fired = self.plan._fired
        left = self.plan._transient_left
        for i, fault in enumerate(self.plan.faults):
            if isinstance(fault, DataError):
                if i not in fired and self.count >= fault.batch:
                    fired.add(i)
                    _record_fault("data_error", step=self.count)
                    raise IOError(f"{fault.message} (batch {self.count})")
            elif isinstance(fault, TransientIOError):
                if self.count >= fault.batch:
                    remaining = left.setdefault(i, fault.times)
                    if remaining > 0:
                        left[i] = remaining - 1
                        _record_fault("transient_io", step=self.count,
                                      fires_left=remaining - 1)
                        raise IOError(
                            f"{fault.message} (batch {self.count}, "
                            f"{remaining - 1} fire(s) left)"
                        )
        batch = next(self._it)
        for i, fault in enumerate(self.plan.faults):
            if not isinstance(fault, NaNBatch):
                continue
            if fault.recur:
                # persistent bad index: fires on EVERY fetch of exactly
                # this index, across re-wraps and incarnations
                if self.count == fault.batch:
                    _record_fault("nan_batch", step=self.count, recur=True)
                    batch = _poison_batch(batch, fault.key)
            elif i not in fired and self.count >= fault.batch:
                fired.add(i)
                _record_fault("nan_batch", step=self.count)
                batch = _poison_batch(batch, fault.key)
        return batch


def _poison_batch(batch, key: str | None):
    """Copy ``batch`` with one NaN planted in the chosen (or first)
    float array — enough to make the whole step's grads non-finite
    through the loss reduction."""
    if not isinstance(batch, dict):
        raise TypeError(f"NaNBatch expects a dict batch, got {type(batch)}")
    out = dict(batch)
    keys = [key] if key is not None else [
        k for k, v in batch.items()
        if np.issubdtype(np.asarray(v).dtype, np.floating)
    ]
    if not keys:
        raise ValueError("NaNBatch: no float array in batch to poison")
    k = keys[0]
    arr = np.array(batch[k], dtype=np.asarray(batch[k]).dtype, copy=True)
    arr.reshape(-1)[0] = np.nan
    out[k] = arr
    return out


# ---------------------------------------------------------------------------
# Disk faults: checkpoint shard corruption
# ---------------------------------------------------------------------------


def _manifest_files(d: str) -> list[dict]:
    """Files listed in the step dir's MANIFEST.dtf (largest first), or a
    raw directory walk when no manifest exists."""
    path = os.path.join(d, "MANIFEST.dtf")
    if os.path.exists(path):
        from ..runtime import io as io_lib

        files = json.loads(io_lib.read_payload(path))["files"]
    else:
        files = []
        for root, _, names in os.walk(d):
            for n in sorted(names):
                if n == "MANIFEST.dtf":
                    continue
                p = os.path.join(root, n)
                files.append({
                    "path": os.path.relpath(p, d),
                    "bytes": os.path.getsize(p),
                })
    files = [f for f in files if f["bytes"] > 0]
    if not files:
        raise FileNotFoundError(f"no corruptible files under {d}")
    return sorted(files, key=lambda f: -f["bytes"])


def truncate_shard(directory: str, step: int, nbytes: int = 1,
                   index: int = 0) -> str:
    """Truncate ``nbytes`` from the ``index``-th largest file of the
    step's checkpoint dir (the partial-write / torn-copy fault).
    Returns the mutilated path; ``verify_manifest`` must now raise."""
    from ..train.checkpoint import step_dir

    d = step_dir(directory, step)
    entry = _manifest_files(d)[index]
    path = os.path.join(d, entry["path"])
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(size - nbytes, 0))
    return path


def corrupt_shard(directory: str, step: int, offset: int = 0,
                  index: int = 0) -> str:
    """Flip one byte of the ``index``-th largest file at ``offset`` (the
    bit-rot fault — size-preserving, so only content checks like the
    manifest CRC on MANIFEST.dtf itself, or orbax's own digests, can
    catch it). Returns the mutilated path."""
    from ..train.checkpoint import step_dir

    d = step_dir(directory, step)
    entry = _manifest_files(d)[index]
    path = os.path.join(d, entry["path"])
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        if not b:
            raise ValueError(f"offset {offset} past end of {path}")
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))
    return path
