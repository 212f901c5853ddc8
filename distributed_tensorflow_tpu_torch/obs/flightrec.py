"""Flight recorder — a bounded ring buffer of structured run events.

A copy of ``distributed_tensorflow_tpu/obs/flightrec.py``: the port imports
nothing of the JAX package (importing any module there runs that
package's ``__init__``, which imports jax), so it keeps its own.

The reference's MonitoredTrainingSession assumed an operator could
answer "what was the job doing when it died?" from scattered logs; the
metrics registry (obs/registry.py) answers "how much" but not "in what
order". This module is the causal record: every layer that already has
a seam — the train loop, the checkpoint manager, the retry executor,
the Supervisor, the fault harness, the serve scheduler — emits a small
structured event (monotonic timestamp, kind, step, attrs) into one
process-wide ring. The ring is bounded (old events are dropped, counted)
so a week-long run costs the same memory as a smoke test, and
lock-protected so the watchdog poll thread, async manifest stampers, and
the train loop can emit concurrently.

On any abnormal exit — emergency checkpoint, ``SupervisorExhausted``,
an unhandled ``fit`` exception — the owning layer dumps the ring as a
JSONL postmortem into the run directory; ``tools/postmortem.py`` renders
it as a human-readable causal timeline ("fault fired → emergency
checkpoint → restart → fallback restore"), and ``validate_dump`` is the
schema gate shared by ``tools/obs_check.py`` and CI.

The event vocabulary is CLOSED (``EVENT_KINDS``): ``emit`` rejects
unknown kinds, so a new emitter must extend the vocabulary here — which
is exactly what keeps the postmortem renderer, the dump validator, and
the docs event table in sync.

Nothing here imports jax — plain stdlib, usable from the scheduler's
pure-host tests and from tools that never touch a device.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, Mapping, Sequence

__all__ = [
    "EVENT_KINDS",
    "SCHEMA",
    "FlightRecorder",
    "default_recorder",
    "dump_postmortem",
    "validate_dump",
    "contains_in_order",
]

logger = logging.getLogger(__name__)

#: dump header schema tag — bump when the record layout changes
SCHEMA = "dtf-flightrec-1"

#: the closed event vocabulary (docs/observability.md has the table)
EVENT_KINDS = (
    # train loop (train/loop.py) + host callbacks (train/callbacks.py)
    "train_start",          # fit() entered                 {step}
    "step_start",           # step dispatch begins          {step}
    "step_end",             # step + callbacks done         {step}
    "train_stop",           # fit() returned                {step, reason}
    "train_exception",      # unhandled step exception      {step, error, etype}
    "emergency_checkpoint", # best-effort crash save        {step, saved}
    "watchdog_stall",       # no step within the budget     {overdue_s, budget_s}
    # distributed eval (train/evaluation.py)
    "eval_start",           # sharded eval pass begins      {step, shards}
    "eval_end",             # sharded eval pass done        {step, batches}
    # checkpoint lifecycle (train/checkpoint.py)
    "ckpt_save",            # checkpoint written            {step, trigger}
    "ckpt_async_begin",     # async snapshot enqueued       {step, trigger}
    "ckpt_async_commit",    # background commit published   {step, seconds}
    "ckpt_restore",         # state restored                {step, fallback}
    "ckpt_quarantine",      # corrupt step condemned        {step, note}
    # retry/backoff (resilience/retry.py)
    "retry_attempt",        # re-attempt after a failure    {site, failures}
    "retry_exhausted",      # budget ran out                {site, failures, reason}
    # supervision (resilience/supervisor.py)
    "sup_attempt",          # supervised attempt begins     {attempt}
    "sup_failure",          # attempt died, classified      {attempt, cause, error}
    "sup_restart",          # restart granted               {restart, cause, backoff_s}
    "sup_exhausted",        # restart budget ran out        {cause, restarts}
    # fault injection (resilience/faults.py)
    "fault_fired",          # a planned fault fired         {fault, step, ...}
    # numeric-anomaly defense (resilience/anomaly.py)
    "anomaly_skip",         # nonfinite step no-op'd in-graph, batch dropped
    #                                                       {step, index, cause}
    "anomaly_spike",        # loss spiked vs EWMA baseline  {step, index, loss, ewma}
    "anomaly_blame",        # batch index blamed+quarantined {step, index, cause}
    # fleet control plane (resilience/fleet.py)
    "fleet_start",          # fleet run begins              {workers, incarnation}
    "fleet_launch",         # worker subprocess launched    {worker, incarnation, pid}
    "fleet_worker_dead",    # liveness/exit failure         {worker, cause, detail}
    "fleet_gang_stop",      # gang torn down                {cause, survivors, killed}
    "fleet_restart",        # new gang live after restart   {restart, cause, incarnation}
    "fleet_hold",           # resize hold plan written      {version, hold, resize}
    "fleet_shrink",         # elastic shrink released       {worker, world, barrier, cause, version}
    "fleet_rejoin",         # replacement rejoined the gang {worker, world, barrier, version}
    "fleet_exhausted",      # fleet restart budget ran out  {cause, restarts}
    "fleet_done",           # every worker finished         {incarnation}
    # elastic worker client (resilience/fleet.ElasticWorker) — the
    # worker-side half of the resize handshake, the clock anchors the
    # merged cross-worker timeline aligns on (obs/fleetview.py)
    "elastic_hold",         # worker paused at a resize barrier {step, version}
    "elastic_release",      # worker applied a steady plan  {version, world, barrier, rank}
    # peer-to-peer joiner catch-up (resilience/fleet.py): a rejoining
    # worker asks a live survivor for its newest valid step over the
    # file control plane instead of replaying from its own older ckpt
    "catchup_offer",        # survivor exported a verified step {step, peer, worker}
    "catchup_restore",      # joiner imported a peer's step {step, peer, seconds}
    "catchup_fallback",     # no usable offer within budget {worker, budget_s}
    # hierarchical fault domains (resilience/podfleet.py): the global
    # coordinator + per-pod supervisors' pod-level record — every event
    # a pod supervisor emits (including the fleet_* kinds above) also
    # carries a ``pod`` attr, so one timeline spans coordinator → pod
    # supervisors → workers
    "pod_outage",           # a pod's gang failed as a unit {pod, cause}
    "pod_restart",          # pod relaunched at its own quorum ceiling
    #                                       {pod, restart, cause, ceiling}
    "pod_rejoin",           # restarted pod's gang confirmed live {pod, restart}
    "pod_fence",            # pod control plane stale but processes alive:
    #                         fenced, no restart, no stale-plan action {pod}
    "pod_unfence",          # fenced pod's control plane came back {pod, fenced_s}
    "pod_hold",             # cross-pod hold plan written   {version, hold}
    "pod_release",          # cross-pod barrier released    {version, world, barrier}
    # fleet telemetry snapshots (obs/fleetview.py)
    "fleetsnap_export",     # worker exported a snapshot    {seq, worker}
    "fleetsnap_merge",      # fleet folded a new snapshot   {worker, seq, pid, incarnation}
    # serving (serve/scheduler.py, serve/engine.py)
    "serve_admit",          # request placed into a slot    {uid, slot}
    "serve_evict",          # request left (any reason)     {uid, reason}
    "serve_drain",          # engine graceful shutdown      {finished}
    "serve_close",          # scheduler admission stopped   {cancelled}
    "serve_preempt",        # resident evicted to queue head on block
    #                         exhaustion (paged cache)      {uid, slot}
    "serve_prefill_chunk",  # one chunk of a chunked prefill
    #                                               {uid, slot, start, n}
    "serve_spec_step",      # one speculative verify step for one slot
    #                                   {uid, slot, proposed, accepted}
    # serve fleet (serve/router.py, serve/fleet.py, serve/replica.py) —
    # serve_route is BOTH halves of the dispatch handshake: the router
    # emits it when it places a request on a replica, and the replica
    # re-emits it (same rid) when it ingests the dispatch — the clock
    # anchor the merged timeline aligns serve replicas on (fleetview)
    "serve_route",          # request dispatched / ingested {rid, lane, replica, hit}
    "serve_requeue",        # in-flight requeued at lane head after its
    #                         replica died                  {rid, lane, replica, delivered}
    "serve_replica_dead",   # serve replica liveness/exit failure
    #                                       {replica, cause, incarnation, pid}
    # free-form operator note
    "note",
)

_KNOWN = frozenset(EVENT_KINDS)
#: record keys an attr may not shadow
_RESERVED = frozenset(("t", "kind", "step", "schema"))


class FlightRecorder:
    """Lock-protected ring of events, newest-``capacity`` retained.

    ``emit`` is the single write path: it stamps the monotonic clock
    *inside* the lock, so event order in the ring is timestamp order
    even under concurrent emitters — the property the postmortem
    validator checks as "monotonic timestamps".
    """

    def __init__(self, capacity: int = 2048,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.clock = clock
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._dropped = 0

    # -- write -------------------------------------------------------------

    def emit(self, kind: str, step: int | None = None, **attrs: Any) -> None:
        """Record one event. ``kind`` must be in ``EVENT_KINDS``; attrs
        are free-form JSON-able fields (non-JSON values are repr'd at
        dump time, never at emit time — the hot path does no encoding)."""
        if kind not in _KNOWN:
            raise ValueError(
                f"unknown flight-recorder event kind {kind!r} "
                f"(extend EVENT_KINDS to add one)"
            )
        bad = _RESERVED.intersection(attrs)
        if bad:
            raise ValueError(f"attrs shadow reserved keys: {sorted(bad)}")
        rec: dict = {"kind": kind}
        if step is not None:
            rec["step"] = int(step)
        rec.update(attrs)
        with self._lock:
            # clock INSIDE the lock: ring order == time order
            rec["t"] = float(self.clock())
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(rec)

    # -- read --------------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound since the last clear()."""
        with self._lock:
            return self._dropped

    def events(self) -> list[dict]:
        """Snapshot copy, oldest first."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    # -- dump --------------------------------------------------------------

    def dump(self, path: str, reason: str = "",
             extra: Mapping[str, Any] | None = None) -> str:
        """Write the ring as a JSONL postmortem: one header line
        (schema, reason, counts) then one line per event, oldest first.
        ``extra`` adds identity fields to the header (the fleet-merge
        path stamps ``worker``/``incarnation`` so obs/fleetview.py can
        pair a dump with its control-plane anchors); core header keys
        win on collision. Returns ``path``. Never raises on
        unserializable attrs — they are repr'd."""
        with self._lock:
            events = [dict(e) for e in self._ring]
            dropped = self._dropped
        header = dict(extra or {})
        header.update({
            "schema": SCHEMA,
            "reason": reason,
            "dumped_t": float(self.clock()),
            "events": len(events),
            "dropped": dropped,
            "capacity": self.capacity,
            "pid": os.getpid(),
        })
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(header, sort_keys=True, default=repr) + "\n")
            for e in events:
                f.write(json.dumps(e, sort_keys=True, default=repr) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # a torn dump must not look complete
        return path

    def dump_unique(self, directory: str, reason: str = "",
                    basename: str = "postmortem") -> str:
        """Dump into ``directory`` as ``postmortem.jsonl``, suffixing
        ``-1``, ``-2``, … instead of overwriting an earlier postmortem
        (a supervised run can die more than once)."""
        d = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{basename}.jsonl")
        n = 0
        while os.path.exists(path):
            n += 1
            path = os.path.join(d, f"{basename}-{n}.jsonl")
        return self.dump(path, reason=reason)


def dump_postmortem(recorder: FlightRecorder, directory: str | None,
                    reason: str = "") -> str | None:
    """Best-effort ``dump_unique`` for abnormal-exit paths (Supervisor
    exhaustion, FleetSupervisor exhaustion, …): the whole point of the
    recorder is this moment, so a dump failure is logged — it must
    never mask the exception the caller is about to raise. Returns the
    dump path, or None when there is no directory or the dump failed."""
    if not directory:
        return None
    try:
        path = recorder.dump_unique(directory, reason=reason)
    except Exception:
        logger.exception("flight-recorder postmortem dump failed")
        return None
    logger.warning("flight-recorder postmortem dumped to %s", path)
    return path


# ---------------------------------------------------------------------------
# Dump validation + ordering queries (shared by tools/postmortem.py,
# tools/obs_check.py, and the chaos tests)
# ---------------------------------------------------------------------------


def validate_dump(path: str) -> list[str]:
    """Schema-check a postmortem dump; returns failures (empty == pass).

    Checks: header schema tag, event count agreement, required keys
    (``t`` number, ``kind`` in the known vocabulary, ``step`` an int
    when present), and non-decreasing timestamps.
    """
    failures: list[str] = []
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        return [f"unreadable dump: {e}"]
    if not lines:
        return ["empty dump (no header line)"]
    try:
        header = json.loads(lines[0])
    except ValueError as e:
        return [f"header is not JSON: {e}"]
    if header.get("schema") != SCHEMA:
        failures.append(
            f"header schema {header.get('schema')!r} != {SCHEMA!r}")
    n_events = len(lines) - 1
    if header.get("events") != n_events:
        failures.append(
            f"header says {header.get('events')} events, dump has {n_events}")
    prev_t = None
    for i, line in enumerate(lines[1:], 2):
        try:
            rec = json.loads(line)
        except ValueError as e:
            failures.append(f"line {i}: not JSON ({e})")
            continue
        t = rec.get("t")
        if not isinstance(t, (int, float)) or isinstance(t, bool):
            failures.append(f"line {i}: missing/non-numeric 't': {rec!r}")
        elif prev_t is not None and t < prev_t:
            failures.append(
                f"line {i}: timestamp {t} decreases (prev {prev_t})")
        else:
            prev_t = t
        kind = rec.get("kind")
        if kind not in _KNOWN:
            failures.append(f"line {i}: unknown event kind {kind!r}")
        if "step" in rec and not isinstance(rec["step"], int):
            failures.append(f"line {i}: non-int step {rec['step']!r}")
    return failures


def contains_in_order(
    events: Iterable[Mapping],
    specs: Sequence[tuple[str, Mapping[str, Any]] | str],
) -> bool:
    """True when ``events`` (time-ordered) contains a subsequence
    matching ``specs``: each spec is a kind, or ``(kind, {attr: value})``
    where every given attr must equal the event's (compared as str, so
    CLI-supplied expectations work). The causal-order oracle for
    postmortem timelines."""
    want = list(specs)
    it = iter(events)
    for spec in want:
        kind, attrs = (spec, {}) if isinstance(spec, str) else spec
        for e in it:
            if e.get("kind") != kind:
                continue
            if all(str(e.get(k)) == str(v) for k, v in attrs.items()):
                break
        else:
            return False
    return True


_default = FlightRecorder()


def default_recorder() -> FlightRecorder:
    """The process-wide flight recorder every emitter defaults to —
    one ring per process, so a postmortem interleaves train, checkpoint,
    retry, supervisor, fault, and serve events in true causal order."""
    return _default
