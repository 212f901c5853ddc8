"""Checkpoint and resume — the port's counterpart of ``distributed_tensorflow_tpu/
train/checkpoint.py``: save on a cadence with an async snapshot-then-commit,
retention, a save on SIGTERM agreed across processes, restore of the newest
step (or, with ``fallback=True``, of the newest step that verifies, the
corrupt ones quarantined), and ``init_or_restore``.

**Layout** (the JAX package's native layout, so its fault helpers and its
own checks read a port directory): one digit directory a step; in it one
``shard-%05d.dtf`` a leaf of ``train/step.state_leaves`` (an ``.npy``
payload through ``runtime/io.py``'s checksummed atomic IO) and
``MANIFEST.dtf`` written LAST, ``{"step", "files": [{"path", "bytes"}]}``
plus the port's ``"leaves": [{"name", "dtype", "shape"}]``. A step is
staged under ``.pending/<step>`` and published with one ``os.rename``, so
death at any instant leaves a whole step or none: ``.pending`` is not a
digit name and no step listing sees it. A bf16 leaf is stored as its bits
(``uint16``) with ``"bfloat16"`` in its manifest entry, never widened.

**Saves.** With ``async_save`` a cadence save copies the state to host
memory at the step boundary (one pinned buffer, each leaf behind its
``.npy`` header so a shard is written straight from it; synchronised:
PyTorch updates parameters and moments in place, so the snapshot must be
complete before the next step starts) and one background thread commits
it; every other trigger (preemption, emergency, final) commits on the
calling thread. Both write the same layout (the JAX package's sync saves
go through orbax, a deliberate difference), the shards by ``IO_THREADS``
threads at once (the native IO releases the interpreter lock), and both
hand the buffer back to a pool the next snapshot reuses. A background
commit that fails is stored and re-raised from the next ``save`` /
``wait`` / ``latest_step`` / ``close``. ``validate_before_save`` refuses
a state whose parameters, buffers or optimizer state hold a NaN or Inf.
A restore reads the shards with the same threads.

**Processes.** The state is replicated over ``data`` (the reference's
chief Saver): only process 0 writes, every process restores, and a
barrier follows each synchronous commit. A state sharded over ``model``
or ``fsdp`` is gathered whole to every rank first (``step.whole_leaves``,
collective), so the chief writes the layout one process writes and a
step dir restores at any mesh, as the JAX package's orbax checkpoints
do; on restore each rank keeps its shard of every leaf. A pipelined
state (``pipe`` above 1) is saved in the dense model's layout too, every
stage's layers (and their ``model`` shards) gathered to the chief
(``step.whole_leaves``): it restores in one process and at any other
(S, V). The JAX package's orbax writes the stacked ``[S, (V,) layers,
...]`` layout there instead (ROADMAP Queue C). The chief walks the steps and
picks the one to restore; the others take its choice. The SIGTERM flag is
agreed by an all-reduce MAX over the process group every
``preemption_check_every`` steps (gloo on the CPU, NCCL on the card).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import io as _bytes_io
import json
import logging
import os
import queue
import shutil
import signal
import threading
import time
from typing import Any

import numpy as np
import torch

from ..obs import flightrec as flightrec_lib
from ..obs import goodput as goodput_lib
from ..parallel import cluster
from ..resilience.retry import RetryExhausted, RetryPolicy, retry_call
from ..runtime import io as io_lib
from ..utils import config as config_lib
from . import step as step_lib

logger = logging.getLogger(__name__)

#: staging subdir of a commit — NOT a digit name, so every step listing is
#: blind to a write in flight
PENDING_DIRNAME = ".pending"
CORRUPT_DIRNAME = ".corrupt"
MANIFEST = "MANIFEST.dtf"

#: histogram of background commit latency (enqueue -> published step dir)
CKPT_ASYNC_COMMIT_SECONDS = "ckpt_async_commit_seconds"
#: histogram of the step-boundary stall of an async save (the host copy)
CKPT_SNAPSHOT_SECONDS = "ckpt_snapshot_seconds"
#: threads that write (and read) one step's shards at once
IO_THREADS = min(8, os.cpu_count() or 1)


def step_dir(directory: str, step: int) -> str:
    """The directory of one checkpoint step — the one definition of the
    layout, shared with ``resilience/faults.py``."""
    return os.path.join(os.path.abspath(os.path.expanduser(directory)), str(step))


def _shard_name(index: int) -> str:
    return f"shard-{index:05d}.dtf"


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str = ""
    save_interval_steps: int = 1000
    max_to_keep: int = 3
    async_save: bool = True
    save_on_preemption: bool = True
    # refuse to write a state whose parameters, buffers or optimizer state
    # hold a NaN/Inf (poisoned moments with finite parameters would pass a
    # parameter-only check and poison the parameters one step after restore)
    validate_before_save: bool = True
    # write MANIFEST.dtf into each step dir and verify it before restore
    write_manifest: bool = True
    # the multi-process SIGTERM agreement runs every N steps (an
    # all-reduce; a signalled process waits at most N steps for the save)
    preemption_check_every: int = 8


class PreemptionWatcher:
    """A SIGTERM flag (the reference's TerminationConfig /
    PreemptionCheckpointHandler): the handler only sets it; ``close()``
    puts back the handlers it replaced."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._event = threading.Event()
        self._prev = {}
        if threading.current_thread() is threading.main_thread():
            for sig in signals:
                self._prev[sig] = signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        logger.warning("preemption signal %s received", signum)
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def close(self) -> None:
        """Reinstall the handlers captured at construction, for signals
        still pointing at this watcher (a newer watcher's handler is left
        in place, and ours kept for a later close); idempotent."""
        if threading.current_thread() is not threading.main_thread():
            return
        for sig, prev in list(self._prev.items()):
            if signal.getsignal(sig) == self._handler:
                signal.signal(sig, prev)
                del self._prev[sig]


def _npy_header(shape, dtype: np.dtype) -> bytes:
    """The ``.npy`` header ``np.save`` writes for an array of ``shape`` and
    ``dtype`` (format 1.0; its length a multiple of 64)."""
    f = _bytes_io.BytesIO()
    np.lib.format.write_array_header_1_0(f, {"descr": np.lib.format.dtype_to_descr(dtype),
                                             "fortran_order": False, "shape": tuple(shape)})
    return f.getvalue()


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a leaf is stored as: bf16 as its bits (uint16)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _align(n: int) -> int:
    return -(-n // 64) * 64


class _Snapshot:
    """A completed host copy of the state's leaves in one uint8 buffer:
    each leaf's ``.npy`` payload (header, then its bytes) at a 64-byte
    aligned offset, so each shard is written straight from the buffer."""

    def __init__(self, buffer: torch.Tensor, entries: list[tuple[str, str, tuple, int, int]]):
        self.buffer = buffer  # pinned when the state is on the card
        self.entries = entries  # (name, dtype name, shape, start, end)
        self.host = buffer.numpy()

    def payload(self, i: int) -> np.ndarray:
        _, _, _, start, end = self.entries[i]
        return self.host[start:end]


def _snapshot(leaves: list[tuple[str, torch.Tensor]], take_buffer) -> _Snapshot:
    """Copy ``leaves`` into a buffer from ``take_buffer(nbytes, pinned)``:
    card tensors by non-blocking copies into pinned memory and one
    synchronise, host tensors by plain copies."""
    layout, total = [], 0
    for name, t in leaves:
        header = _npy_header(t.shape, _np_dtype(t.dtype))
        size = len(header) + t.numel() * t.element_size()
        layout.append((name, t, header, total, total + size))
        total = _align(total + size)
    devices = {t.device for _, t in leaves if t.device.type == "cuda"}
    buffer = take_buffer(total, bool(devices))
    entries = []
    for name, t, header, start, end in layout:
        buffer[start:start + len(header)].copy_(torch.frombuffer(bytearray(header),
                                                                 dtype=torch.uint8))
        src = t.detach().view(torch.int16) if t.dtype == torch.bfloat16 else t.detach()
        dst = buffer[start + len(header):end].view(src.dtype).view(src.shape)
        dst.copy_(src, non_blocking=src.device.type == "cuda")
        entries.append((name, str(t.dtype).removeprefix("torch."), tuple(t.shape), start, end))
    for dev in devices:
        torch.cuda.synchronize(dev)
    return _Snapshot(buffer, entries)


def _load_npy(buf: np.ndarray) -> np.ndarray:
    """The array of an ``.npy`` payload held in ``buf`` (uint8), a view."""
    f = _bytes_io.BytesIO(buf[:4096].tobytes())
    version = np.lib.format.read_magic(f)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read(f)
    if fortran:
        raise OSError("a Fortran-ordered shard")
    return buf[f.tell():].view(dtype).reshape(shape)


def _error_text(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


class Checkpointer:
    """Save / restore / retention / preemption for one run directory; also
    usable alone for an eval-side restore (``evaluate_from_checkpoint``)."""

    def __init__(self, cfg: CheckpointConfig, io_retry: RetryPolicy | None = None,
                 registry=None, flightrec=None):
        """``io_retry``: the transient-IO budget of the save, restore and
        verify seams (sites ``ckpt_save`` / ``ckpt_restore`` /
        ``ckpt_verify``), a 3-attempt exponential policy by default. The
        state is replicated over the run's mesh; the agreement and the
        barriers use the default process group (the JAX package's
        ``mesh`` argument has no use here)."""
        if not cfg.directory:
            raise ValueError("CheckpointConfig.directory is required")
        self.cfg = cfg
        self.io_retry = io_retry if io_retry is not None else RetryPolicy()
        self.registry = registry
        self.flightrec = (flightrec if flightrec is not None
                          else flightrec_lib.default_recorder())
        self.base = os.path.abspath(os.path.expanduser(cfg.directory))
        self.chief = cluster.is_chief()
        if self.chief:
            os.makedirs(self.base, exist_ok=True)
            # a previous incarnation's unpublished writes: never restorable
            shutil.rmtree(os.path.join(self.base, PENDING_DIRNAME), ignore_errors=True)
        cluster.sync_hosts("ckpt_init")
        #: steps saved or queued by this run, and those on disk at start:
        #: the same on every process, so the save decisions agree
        self._known: set[int] = set(self._committed_steps())
        self.watcher = PreemptionWatcher() if cfg.save_on_preemption else None
        #: fault-injection seam: ``hook(stage, step)`` called by the
        #: background writer at ``async_begin`` (before the shard writes)
        #: and ``shards_done`` (after them, BEFORE the manifest and publish)
        self.save_hooks: list = []
        self._async_q: queue.Queue = queue.Queue()
        self._async_thread: threading.Thread | None = None
        self._async_cv = threading.Condition()
        self._async_steps: set[int] = set()
        self._async_error: BaseException | None = None
        self._retention_lock = threading.Lock()
        #: host buffers of finished commits, reused by the next snapshots
        self._pool: list[torch.Tensor] = []
        self._pool_lock = threading.Lock()

    def _take_buffer(self, nbytes: int, pinned: bool) -> torch.Tensor:
        with self._pool_lock:
            for i, b in enumerate(self._pool):
                if b.numel() >= nbytes and b.is_pinned() == pinned:
                    return self._pool.pop(i)
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)

    def _give_buffer(self, snapshot: _Snapshot) -> None:
        with self._pool_lock:
            self._pool.append(snapshot.buffer)

    def _registry(self):
        return self.registry if self.registry is not None else goodput_lib.default_registry()

    # -- save -------------------------------------------------------------
    def maybe_save(self, step: int, state: step_lib.TrainState) -> bool:
        """Cadence save; on an agreed preemption a forced save, then
        ``PreemptionSaved`` for the loop to stop cleanly."""
        if self.watcher is not None and self._any_host_preempted(step):
            saved = self.save(step, state, force=True, trigger="preemption")
            self.wait()
            latest = max(self._known) if self._known else None
            if not saved and (latest is None or latest < step):
                raise FloatingPointError(
                    f"preempted at step {step} with a non-finite state; checkpoint refused "
                    f"(latest on disk: {latest})")
            raise PreemptionSaved(step)
        return self.save(step, state)

    def _any_host_preempted(self, step: int) -> bool:
        """The local SIGTERM flag OR-ed over the processes (an all-reduce
        MAX of one int every ``preemption_check_every`` steps): every
        process must enter the save together."""
        local = self.watcher.preempted
        if cluster.process_count() == 1:
            return local
        if step % max(self.cfg.preemption_check_every, 1) != 0:
            return False
        import torch.distributed as dist

        from ..utils.multihost import _comm_device

        flag = torch.tensor([int(local)], dtype=torch.int32, device=_comm_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    @staticmethod
    def _state_finite(leaves) -> bool:
        """One device reduce over every float leaf (whole): parameters,
        buffers and the optimizer state. Identical on every process."""
        by_device: dict[torch.device, list[torch.Tensor]] = {}
        for _, t in leaves:
            if t.is_floating_point():
                by_device.setdefault(t.device, []).append(torch.isfinite(t).all())
        return all(bool(torch.stack(flags).all()) for flags in by_device.values())

    def save(self, step: int, state: step_lib.TrainState, force: bool = False,
             trigger: str = "cadence") -> bool:
        """``trigger`` (cadence / preemption / final / emergency) labels the
        event and picks the path: with ``async_save`` a cadence save is
        snapshotted here and committed by the background writer; every
        other trigger commits on this thread. Returns whether a save was
        made (or queued); every process returns the same."""
        native_async = self.cfg.async_save and trigger == "cadence"
        if native_async:
            self._raise_async_error()
        if step in self._known:
            return False  # already saved (a cadence save, then the final one)
        if not force:
            last = max(self._known) if self._known else None
            if last is not None and (last >= step
                                     or step % max(self.cfg.save_interval_steps, 1) != 0):
                return False
        leaves = step_lib.whole_leaves(state)
        if self.cfg.validate_before_save and not self._state_finite(leaves):
            logger.error("refusing to checkpoint at step %d: non-finite state", step)
            return False
        self._known.add(step)
        if native_async:
            return self._save_async(step, leaves, trigger)
        if self.chief:
            snap = _snapshot(leaves, self._take_buffer)
            try:
                retry_call(lambda: self._commit(step, snap, trigger, time.perf_counter(),
                                                hooks=False),
                           policy=self.io_retry, site="ckpt_save", registry=self.registry,
                           flightrec=self.flightrec)
            finally:
                self._give_buffer(snap)
        if trigger != "emergency":  # an emergency save's peers may be anywhere
            cluster.sync_hosts(f"ckpt_save_{step}")
        return True

    def _save_async(self, step: int, leaves, trigger: str) -> bool:
        """The host copy on this thread (the only part that stalls
        training, booked as ``async_checkpoint`` waste), then the commit
        handed to the background writer. Only the chief copies and
        writes."""
        if not self.chief:
            return True
        t0 = time.perf_counter()
        snap = _snapshot(leaves, self._take_buffer)
        with self._async_cv:
            self._async_steps.add(step)
        self._ensure_writer()
        self.flightrec.emit("ckpt_async_begin", step=step, trigger=trigger)
        self._async_q.put((step, snap, trigger, time.perf_counter()))
        stall = time.perf_counter() - t0
        goodput_lib.note_wasted(goodput_lib.WASTE_ASYNC_CKPT, stall, registry=self.registry)
        self._registry().histogram(
            CKPT_SNAPSHOT_SECONDS, "step-boundary stall of an async save (host copy)"
        ).observe(stall)
        logger.info("async checkpoint snapshot at step %d (%.3fs host)", step, stall)
        return True

    def _ensure_writer(self) -> None:
        if self._async_thread is None or not self._async_thread.is_alive():
            self._async_thread = threading.Thread(target=self._writer_loop, daemon=True,
                                                  name="ckpt-async-writer")
            self._async_thread.start()

    def _writer_loop(self) -> None:
        """One FIFO writer: commits land in save order, so retention after
        each commit never evicts a step a later write still needs."""
        while True:
            item = self._async_q.get()
            if item is None:
                return
            step, snap, trigger, t_enq = item
            try:
                retry_call(lambda: self._commit(step, snap, trigger, t_enq, hooks=True),
                           policy=self.io_retry, site="ckpt_save", registry=self.registry,
                           flightrec=self.flightrec)
            except BaseException as e:  # noqa: BLE001 — stored, re-raised by save()/wait()
                with self._async_cv:
                    if self._async_error is None:
                        self._async_error = e
                logger.exception("background checkpoint commit for step %d failed; it "
                                 "surfaces at the next save()/wait()", step)
                shutil.rmtree(self._pending_dir(step), ignore_errors=True)
            finally:
                self._give_buffer(snap)
                with self._async_cv:
                    self._async_steps.discard(step)
                    self._async_cv.notify_all()

    def _pending_dir(self, step: int) -> str:
        return os.path.join(self.base, PENDING_DIRNAME, str(step))

    def _commit(self, step: int, snap: _Snapshot, trigger: str, t_enq: float,
                hooks: bool) -> None:
        """Stage one shard a leaf under ``.pending/<step>`` (``IO_THREADS``
        at once), the manifest LAST, then publish the step with one
        rename."""
        pending, final = self._pending_dir(step), step_dir(self.base, step)
        shutil.rmtree(pending, ignore_errors=True)  # a clean retry slate
        os.makedirs(pending)
        if hooks:
            self._run_save_hooks("async_begin", step)

        def write(i):
            path = os.path.join(pending, _shard_name(i))
            io_lib.write_payload(path, snap.payload(i))
            return os.path.getsize(path)

        with concurrent.futures.ThreadPoolExecutor(IO_THREADS) as pool:
            sizes = list(pool.map(write, range(len(snap.entries))))
        files = [{"path": _shard_name(i), "bytes": n} for i, n in enumerate(sizes)]
        table = [{"name": name, "dtype": dtype, "shape": list(shape)}
                 for name, dtype, shape, _, _ in snap.entries]
        if hooks:
            self._run_save_hooks("shards_done", step)
        if self.cfg.write_manifest:
            payload = json.dumps({"step": step, "files": files, "leaves": table}).encode()
            io_lib.write_payload(os.path.join(pending, MANIFEST), payload)
        os.rename(pending, final)  # the commit point
        dt = time.perf_counter() - t_enq
        self.flightrec.emit("ckpt_save", step=step, trigger=trigger)
        if hooks:
            self.flightrec.emit("ckpt_async_commit", step=step, seconds=round(dt, 6))
            self._registry().histogram(
                CKPT_ASYNC_COMMIT_SECONDS,
                "background async-save commit latency (enqueue -> published step dir)",
            ).observe(dt)
        logger.info("checkpoint committed at step %d (%s, %.3fs)", step, trigger, dt)
        self._apply_retention()

    def _run_save_hooks(self, stage: str, step: int) -> None:
        for hook in list(self.save_hooks):
            hook(stage, step)

    def _committed_steps(self) -> list[int]:
        """Published steps, from the filesystem: the digit dirs are the
        commit points."""
        try:
            names = os.listdir(self.base)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit() and os.path.isdir(os.path.join(self.base, n)))

    def _apply_retention(self) -> None:
        """Keep the newest ``max_to_keep`` published steps (digit dirs
        only: a write in flight is under ``.pending``)."""
        if not self.cfg.max_to_keep or self.cfg.max_to_keep <= 0:
            return
        with self._retention_lock:
            steps = self._committed_steps()
            evict = steps[:-self.cfg.max_to_keep] if len(steps) > self.cfg.max_to_keep else []
            for s in evict:
                shutil.rmtree(step_dir(self.base, s), ignore_errors=True)
            if evict:
                logger.info("retention evicted checkpoint steps %s (max_to_keep=%d)", evict,
                            self.cfg.max_to_keep)

    def _raise_async_error(self) -> None:
        with self._async_cv:
            err, self._async_error = self._async_error, None
        if err is not None:
            raise err

    def wait(self, join_s: float = 60.0) -> None:
        """Drain the background commits (a bounded join; a straggler is
        logged by step and left for a later wait/close), then re-raise a
        stored background failure."""
        if self._async_thread is not None:
            deadline = time.monotonic() + join_s
            with self._async_cv:
                while self._async_steps:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        logger.error("async checkpoint writer still busy with steps %s after "
                                     "%.1fs; those checkpoints are not yet durable",
                                     sorted(self._async_steps), join_s)
                        break
                    self._async_cv.wait(left)
        self._raise_async_error()

    def save_config(self, cfg_obj: Any) -> None:
        """The run config beside the checkpoints (chief only, tmp + fsync
        + rename)."""
        if self.chief:
            path = os.path.join(self.base, "config.json")
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                f.write(config_lib.to_json(cfg_obj))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)

    # -- restore ----------------------------------------------------------
    def latest_step(self) -> int | None:
        """The newest published step (a stored background failure
        re-raises first)."""
        self._raise_async_error()
        steps = self._committed_steps()
        return steps[-1] if steps else None

    def verify_manifest(self, step: int) -> bool | None:
        """CRC-verify MANIFEST.dtf and check every listed file exists with
        its recorded size: None without a manifest, True when intact;
        raises OSError naming the shard otherwise."""
        d = step_dir(self.base, step)
        path = os.path.join(d, MANIFEST)
        if not os.path.exists(path):
            return None
        manifest = json.loads(io_lib.read_payload(path))
        for entry in manifest["files"]:
            p = os.path.join(d, entry["path"])
            if not os.path.exists(p):
                raise OSError(f"checkpoint step {step}: missing shard {entry['path']} "
                              f"(manifest expects {entry['bytes']} bytes at {p})")
            size = os.path.getsize(p)
            if size != entry["bytes"]:
                raise OSError(f"checkpoint step {step}: shard {entry['path']} is {size} bytes, "
                              f"manifest says {entry['bytes']} ({entry['bytes'] - size:+d} "
                              f"byte delta at {p})")
        return True

    def restore(self, state: step_lib.TrainState, step: int | None = None,
                fallback: bool = False) -> step_lib.TrainState | None:
        """Restore ``step`` (the newest by default) into ``state`` in place
        — onto the devices its tensors live on — and return it; None when
        there is no checkpoint. ``fallback=True`` walks the steps newest
        first (never past ``step``), quarantining each that fails its
        manifest or its read into ``.corrupt/<step>``, and restores the
        newest that verifies. The chief chooses; the other processes
        restore its choice and drop the steps it quarantined from the
        steps they know, so every process makes the same save decisions
        after a fallback."""
        chosen, leaves, error = None, None, None
        known = set(self._known)
        if self.chief:
            try:
                chosen, leaves = self._choose(state, step, fallback)
            except Exception as e:  # noqa: BLE001 — re-raised below, named on every process
                error = e
        from ..utils.multihost import broadcast_from_chief

        agreed = broadcast_from_chief((chosen, None if error is None else _error_text(error),
                                       sorted(known - self._known)))
        if error is not None:
            raise error
        chosen, message, quarantined = agreed
        self._known.difference_update(quarantined)
        if message is not None:
            raise OSError(f"checkpoint restore failed on the chief: {message}")
        if chosen is None:
            return None
        if leaves is None:
            leaves = self._read_step(chosen, state)
        step_lib.load_state_leaves(state, leaves)
        self.flightrec.emit("ckpt_restore", step=chosen, fallback=fallback)
        if self.chief:
            logger.info("restored checkpoint at step %d", chosen)
        return state

    def _choose(self, state, step, fallback):
        """(step, host leaves) of the step to restore (chief only)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        if not fallback:
            if self.cfg.write_manifest:
                self.verify_manifest(step)
            return step, self._read_step(step, state)
        for s in sorted(self._committed_steps(), reverse=True):
            if s > step:
                continue
            if self.cfg.write_manifest:
                try:
                    # retried: quarantine is destructive, so a transient blip
                    # in the check must not condemn a good step
                    retry_call(lambda: self.verify_manifest(s), policy=self.io_retry,
                               site="ckpt_verify", registry=self.registry,
                               flightrec=self.flightrec)
                except RetryExhausted as e:
                    self._quarantine(s, "integrity check", e.__cause__ or e)
                    continue
            try:
                return s, self._read_step(s, state)
            except (OSError, RetryExhausted) as e:
                self._quarantine(s, "restore", e)
        return None, None

    def _quarantine(self, step: int, what: str, exc: BaseException) -> None:
        logger.error("checkpoint step %d failed %s (%s); quarantining and falling back to an "
                     "older step", step, what, exc)
        self._known.discard(step)
        try:
            self.quarantine_step(step, reason=str(exc))
        except OSError:
            logger.exception("quarantining step %d failed; skipping it without quarantine",
                             step)

    def _read_step(self, step: int, state: step_lib.TrainState) -> dict[str, torch.Tensor]:
        """Every leaf of ``step`` as a host tensor, checked against the
        target state's names, shapes and dtypes (a mismatch raises OSError,
        so the fallback walk quarantines the step)."""
        d = step_dir(self.base, step)
        if not os.path.exists(os.path.join(d, _shard_name(0))):
            raise OSError(f"checkpoint step {step} at {d} has no {_shard_name(0)}: not a "
                          f"checkpoint in the port's layout (an orbax-only step of the JAX "
                          f"package is not restorable here)")
        return retry_call(lambda: self._read_leaves(d, step, state), policy=self.io_retry,
                          site="ckpt_restore", registry=self.registry,
                          flightrec=self.flightrec)

    def _read_leaves(self, d: str, step: int, state) -> dict[str, torch.Tensor]:
        def load(i):
            return _load_npy(io_lib.read_array(os.path.join(d, _shard_name(i))))

        count = int(load(step_lib.HEADER_LEAVES.index("optimizer/count")))
        names = step_lib.leaf_names(state, count)
        table = None
        if os.path.exists(os.path.join(d, MANIFEST)):
            table = json.loads(io_lib.read_payload(os.path.join(d, MANIFEST))).get("leaves")
        if table is not None and [e["name"] for e in table] != names:
            raise OSError(f"checkpoint step {step}: its leaves do not match the state's "
                          f"({len(table)} saved, {len(names)} wanted)")
        targets = {k: (step_lib.whole_shape(state, k, v.shape), v.dtype)
                   for k, v in step_lib.state_leaves(state)}
        params = dict(enumerate(state.optimizer.params))
        with concurrent.futures.ThreadPoolExecutor(IO_THREADS) as pool:
            arrays = list(pool.map(load, range(len(names))))
        out = {}
        for i, (name, arr) in enumerate(zip(names, arrays)):
            # a pipeline stage's template of another stage's leaf (leaf_names)
            k = step_lib.leaf_template(state, name)
            if k in targets:
                shape, dtype = targets[k]
            elif name.endswith("/step"):  # an optimizer leaf the state has no tensor of yet
                shape, dtype = (), torch.float32
            else:
                p = params[int(k.split("/")[1])]
                shape, dtype = step_lib.opt_leaf_shape(state, k), p.dtype
            if dtype == torch.bfloat16 and arr.dtype == np.uint16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise OSError(f"checkpoint step {step}: shard {_shard_name(i)} ({name}) is "
                              f"{arr.dtype}{list(arr.shape)}, the state wants "
                              f"{dtype}{list(shape)}")
            out[name] = t
        return out

    def quarantine_step(self, step: int, reason: str = "") -> str:
        """Move a failed step dir to ``.corrupt/<step>`` (suffixed on a
        collision) with a QUARANTINE note; returns the new path."""
        self.flightrec.emit("ckpt_quarantine", step=step, note=str(reason)[:160])
        src = step_dir(self.base, step)
        base = os.path.join(self.base, CORRUPT_DIRNAME)
        os.makedirs(base, exist_ok=True)
        dst = os.path.join(base, str(step))
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(base, f"{step}-{n}")
        os.rename(src, dst)
        try:  # the rename is the quarantine; the note is best-effort context
            with open(os.path.join(dst, "QUARANTINE"), "w") as f:
                f.write(reason + "\n")
        except OSError:
            logger.exception("writing the QUARANTINE note under %s failed", dst)
        logger.warning("quarantined checkpoint step %d -> %s", step, dst)
        return dst

    def close(self) -> None:
        """Drain the background commits, stop the writer and put back the
        signal handlers; a stored background failure still raises, after
        the shutdown."""
        try:
            self.wait()
        finally:
            if self._async_thread is not None and self._async_thread.is_alive():
                self._async_q.put(None)
                self._async_thread.join(timeout=5.0)
            if self.watcher is not None:
                self.watcher.close()
            with self._pool_lock:
                self._pool.clear()


class PreemptionSaved(RuntimeError):
    """Raised after a successful preemption save; the loop stops cleanly
    so the scheduler (or a ``Supervisor``) can restart and resume."""

    def __init__(self, step: int):
        super().__init__(f"preempted; checkpoint saved at step {step}")
        self.step = step


def init_or_restore(checkpointer: Checkpointer, state: step_lib.TrainState,
                    fallback: bool = False, step: int | None = None
                    ) -> tuple[step_lib.TrainState, bool]:
    """The one call a train script makes: ``state`` is the freshly built
    one (the port builds its model eagerly, where the JAX function builds
    it from ``init_fn``); it is overwritten in place from the newest
    checkpoint when there is one. Returns ``(state, restored)``.
    ``fallback=True``: corrupt steps quarantined, the newest valid one wins
    (what supervised restarts use); ``step`` caps the restore, ``step=0``
    forces the fresh state."""
    restored = None if step == 0 else checkpointer.restore(state, step=step, fallback=fallback)
    return state, restored is not None
