"""Process-wide metrics registry — Counter / Gauge / Histogram.

A copy of ``distributed_tensorflow_tpu/obs/registry.py``: the port imports
nothing of the JAX package (importing any module there runs that
package's ``__init__``, which imports jax), so it keeps its own.

Design rule, inherited from utils/metrics.py's AUC histograms: every
metric is a MERGEABLE SUFFICIENT STATISTIC. Counters and histogram
buckets merge by addition, so per-engine, per-thread, or per-process
registries aggregate exactly — the same contract that lets eval shards
sum confusion-matrix buckets. Percentiles (p50/p90/p99 TTFT, step
latency) are derived from fixed log-spaced buckets at READ time, never
accumulated as unmergeable running quantiles.

Histogram buckets are log-spaced because serving latencies span four
decades (sub-ms decode token to multi-second queue wait): with ratio
``r`` between consecutive upper bounds, any derived quantile is within a
factor ``r`` of the true value regardless of the distribution's shape.
The default latency ladder uses 8 buckets/decade (r ≈ 1.33) over
100 µs..100 s.

Nothing here imports jax — the registry is plain numpy + stdlib, usable
from the scheduler's pure-host tests and from tools that never touch a
device. Rendering lives in obs/export.py; span timing in obs/trace.py.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable, Mapping

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "LATENCY_BUCKETS",
    "log_buckets",
    "default_registry",
]

_NAME_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid metric name {name!r}")
    return name


def log_buckets(lo: float, hi: float, per_decade: int = 8) -> tuple[float, ...]:
    """Log-spaced histogram upper bounds covering [lo, hi].

    ``per_decade`` sets the resolution/width trade-off: quantiles read
    back from the buckets are exact to within one bucket ratio
    ``10**(1/per_decade)``.
    """
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
    return tuple(lo * 10 ** (i / per_decade) for i in range(n))


#: default latency ladder: 100 µs .. 100 s, 8 buckets/decade (49 buckets)
LATENCY_BUCKETS = log_buckets(1e-4, 100.0, per_decade=8)


class _Metric:
    """Base: identity is (name, sorted label pairs)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Mapping[str, str] | None = None):
        self.name = _check_name(name)
        self.help = help
        self.labels: tuple[tuple[str, str], ...] = tuple(
            sorted((str(k), str(v)) for k, v in (labels or {}).items())
        )

    def _check_mergeable(self, other: "_Metric") -> None:
        if type(other) is not type(self) or other.name != self.name \
                or other.labels != self.labels:
            raise ValueError(
                f"cannot merge {other.kind} {other.name}{dict(other.labels)} "
                f"into {self.kind} {self.name}{dict(self.labels)}"
            )


class Counter(_Metric):
    """Monotone accumulator; merges by addition."""

    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount

    def reset(self) -> None:
        self.value = 0.0

    def merge_from(self, other: "Counter") -> None:
        self._check_mergeable(other)
        self.value += other.value


class Gauge(_Metric):
    """Last-written instantaneous value (occupancy, queue depth).

    Merge takes the other side's value when it has been set more
    recently (per-metric monotone sequence number) — "latest write
    wins", the only coherent cross-registry rule for a point-in-time
    reading.
    """

    kind = "gauge"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self.value = 0.0
        self._seq = 0  # bumps on every set(); 0 = never written

    def set(self, value: float) -> None:
        self.value = float(value)
        self._seq += 1

    def reset(self) -> None:
        self.value = 0.0
        self._seq = 0

    def merge_from(self, other: "Gauge") -> None:
        self._check_mergeable(other)
        if other._seq >= self._seq and other._seq > 0:
            self.value = other.value
        # max, NOT sum: summing would inflate self past any future
        # source seq, freezing the value after repeated merges from the
        # same live registry (the scrape-aggregator pattern).
        self._seq = max(self._seq, other._seq)


class Histogram(_Metric):
    """Fixed-bucket histogram: per-bucket counts + sum + count.

    Buckets are UPPER BOUNDS (Prometheus ``le`` semantics); one implicit
    overflow bucket catches everything above the last bound. Counts are
    stored non-cumulative so merge is plain addition; export.py
    cumulates at render time.
    """

    kind = "histogram"

    def __init__(self, name, help="", labels=None,
                 buckets: Iterable[float] = LATENCY_BUCKETS):
        super().__init__(name, help, labels)
        self.bounds = tuple(float(b) for b in buckets)
        if not self.bounds or list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("buckets must be non-empty, sorted, unique")
        self.counts = np.zeros(len(self.bounds) + 1, np.int64)
        self.sum = 0.0

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def observe(self, value: float) -> None:
        value = float(value)
        self.counts[int(np.searchsorted(self.bounds, value, side="left"))] += 1
        self.sum += value

    def reset(self) -> None:
        self.counts[:] = 0
        self.sum = 0.0

    def percentile(self, q: float) -> float:
        """Quantile q ∈ [0, 1] read back from the buckets.

        Linear interpolation inside the containing bucket; exact to
        within one bucket width (one bucket RATIO for the log ladder).
        Returns nan when empty; the last finite bound when q lands in
        the overflow bucket (a floor, flagged by the caller if needed).
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        total = self.count
        if total == 0:
            return float("nan")
        target = q * total
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, target, side="left"))
        if b >= len(self.bounds):
            return self.bounds[-1]  # overflow: best available floor
        lo = self.bounds[b - 1] if b > 0 else 0.0
        hi = self.bounds[b]
        below = cum[b - 1] if b > 0 else 0
        inside = self.counts[b]
        frac = (target - below) / inside if inside else 1.0
        return lo + (hi - lo) * min(max(frac, 0.0), 1.0)

    def merge_from(self, other: "Histogram") -> None:
        self._check_mergeable(other)
        if other.bounds != self.bounds:
            raise ValueError(
                f"histogram {self.name}: bucket mismatch "
                f"({len(self.bounds)} vs {len(other.bounds)} bounds)"
            )
        self.counts += other.counts
        self.sum += other.sum


class Registry:
    """Get-or-create metric store, keyed by (name, labels).

    Thread-safe on registration and merge (serve engines and the train
    loop may share one registry across threads); individual metric
    updates are plain float/int ops on the single hot path and are NOT
    locked — per-CPython-op atomicity is enough for statistics whose
    consumers tolerate one-update skew.
    """

    def __init__(self):
        self._metrics: dict[tuple, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labels, **kw) -> _Metric:
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, labels, **kw)
                self._metrics[key] = m
            elif type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = LATENCY_BUCKETS,
                  **labels) -> Histogram:
        h = self._get_or_create(Histogram, name, help, labels,
                                buckets=buckets)
        if h.bounds != tuple(float(b) for b in buckets):
            raise ValueError(
                f"histogram {name!r} re-registered with different buckets"
            )
        return h

    def _sorted_unlocked(self) -> list[_Metric]:
        return sorted(self._metrics.values(),
                      key=lambda m: (m.name, m.labels))

    def collect(self) -> list[_Metric]:
        """All metrics, stable order: by name, then label values."""
        with self._lock:
            return self._sorted_unlocked()

    def get(self, name: str, **labels) -> _Metric | None:
        # under the lock: merge() may be inserting adopted metrics into
        # the table concurrently (dtflint: lock-discipline)
        with self._lock:
            return self._metrics.get(
                (name, tuple(sorted(labels.items())))
            )

    def total(self, name: str) -> float:
        """Sum a metric family across ALL label sets — e.g.
        Σ ``supervisor_restarts_total{cause=…}`` or
        Σ ``retry_exhausted_total{site=…}``. Counters/gauges contribute
        their value, histograms their observation count; 0.0 when the
        name was never registered."""
        with self._lock:
            ms = [m for m in self._metrics.values() if m.name == name]
        return float(sum(
            m.count if isinstance(m, Histogram) else m.value for m in ms
        ))

    def reset(self) -> None:
        """Zero every metric IN PLACE (handles stay valid — benches call
        this after warmup so compile-time observations don't pollute
        steady-state percentiles)."""
        with self._lock:
            for m in self._metrics.values():
                m.reset()

    def merge(self, other: "Registry") -> None:
        """Fold ``other`` into self (counters/histograms add, gauges take
        the freshest write); missing metrics are adopted as copies."""
        import copy

        # Snapshot other's table under ITS lock (a live registry may
        # register new metrics mid-merge), then fold under ours —
        # sequential, not nested, so concurrent a.merge(b) / b.merge(a)
        # cannot deadlock. Individual metric values may still move while
        # we fold: the same one-update skew the class tolerates.
        with other._lock:
            items = list(other._metrics.items())
        with self._lock:
            for key, om in items:
                mine = self._metrics.get(key)
                if mine is None:
                    self._metrics[key] = copy.deepcopy(om)
                else:
                    mine.merge_from(om)

    def snapshot(self) -> dict:
        """JSON-able dump (the JSONL exporter's payload).

        Reads every metric UNDER the registry lock: ``merge`` mutates a
        histogram's ``counts`` then ``sum`` while holding this lock, so
        a snapshot taken lock-free could capture the counts of one merge
        and the sum of another (torn ``sum``/``count``). Holding the
        lock for the whole read makes the snapshot a consistent cut
        w.r.t. merges; lock-free hot-path ``observe()`` keeps its
        documented one-update skew."""
        with self._lock:
            return self._snapshot_unlocked()

    def _snapshot_unlocked(self) -> dict:
        out = {}
        for m in self._sorted_unlocked():
            key = m.name if not m.labels else (
                m.name + "{" + ",".join(f"{k}={v}" for k, v in m.labels) + "}"
            )
            if isinstance(m, Histogram):
                out[key] = {
                    "kind": m.kind, "sum": m.sum, "count": m.count,
                    "bounds": list(m.bounds),
                    "counts": m.counts.tolist(),
                }
            else:
                out[key] = {"kind": m.kind, "value": m.value}
            if m.labels:
                # structured identity alongside the flattened key, so a
                # cross-process consumer (Registry.from_snapshot) never
                # has to re-parse label values out of the key string
                out[key]["name"] = m.name
                out[key]["labels"] = dict(m.labels)
        return out

    @classmethod
    def from_snapshot(cls, snap: Mapping, labels: Mapping[str, str]
                      | None = None,
                      kinds: Iterable[str] | None = None) -> "Registry":
        """Reconstruct a Registry from a ``snapshot()`` dict — the
        cross-PROCESS half of the merge contract: a worker ships its
        snapshot as JSON (obs/fleetview.py), the fleet rebuilds it here
        and folds it with ``merge()``, so fleet-wide percentiles come
        from summed buckets, never from averaged percentiles.

        ``labels`` are added to every metric (the fleet's ``worker=``
        convention; they override same-named labels from the snapshot).
        ``kinds`` restricts reconstruction (e.g. ``("counter",
        "histogram")`` for a fleet-wide union, where summing is exact
        but a "latest" gauge across processes is meaningless). Raises
        ``ValueError`` on a malformed snapshot."""
        reg = cls()
        extra = {str(k): str(v) for k, v in (labels or {}).items()}
        for key, entry in snap.items():
            try:
                kind = entry["kind"]
                if kinds is not None and kind not in kinds:
                    continue
                name = entry.get("name") or key.partition("{")[0]
                lab = dict(entry.get("labels") or {})
                lab.update(extra)
                if kind == "counter":
                    reg.counter(name, **lab).inc(float(entry["value"]))
                elif kind == "gauge":
                    reg.gauge(name, **lab).set(float(entry["value"]))
                elif kind == "histogram":
                    h = reg.histogram(name, buckets=entry["bounds"], **lab)
                    counts = entry["counts"]
                    if len(counts) != len(h.counts):
                        raise ValueError(
                            f"{len(counts)} counts for "
                            f"{len(h.bounds)} bounds")
                    h.counts[:] = np.asarray(counts, np.int64)
                    h.sum = float(entry["sum"])
                else:
                    raise ValueError(f"unknown metric kind {kind!r}")
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(
                    f"malformed snapshot entry {key!r}: {e}") from e
        return reg

    def delta(self, baseline: Mapping) -> dict:
        """What changed since ``baseline`` (a dict from ``snapshot()``),
        as a snapshot-shaped dict.

        The per-interval isolation primitive for sweep/bench harnesses:
        take ``snapshot()`` before an interval, ``delta(snap)`` after,
        and read only that interval's counters/histogram observations —
        WITHOUT a mid-run ``reset()``, which would break the registry's
        merge-not-reset invariant for every concurrent consumer (the
        supervised-restart ledger, a live scrape endpoint).

        Semantics per kind: counters and histograms report the
        DIFFERENCE (counts/sums are mergeable sufficient statistics, so
        subtraction is exact); gauges report their CURRENT value — a
        point-in-time reading has no meaningful diff — and are included
        only when the value differs from the baseline's (a rewrite of
        the same value is indistinguishable and omitted). Metrics absent
        from the baseline diff against zero.

        Reads the live table under the registry lock — the same
        consistent-cut guarantee as ``snapshot()``, so a concurrent
        ``merge`` cannot tear a histogram's counts/sum apart. Raises
        ``ValueError`` when the baseline is ahead of the live registry
        (a counter went down / histogram shrank): that means it came
        from a different registry or a ``reset()`` intervened, and a
        silently-negative delta would corrupt every derived rate."""
        with self._lock:
            current = self._snapshot_unlocked()
        out: dict = {}
        for key, now in current.items():
            old = baseline.get(key)
            if old is not None and old.get("kind") != now["kind"]:
                raise ValueError(
                    f"delta baseline kind mismatch for {key!r}: "
                    f"{old.get('kind')} vs {now['kind']}")
            if now["kind"] == "histogram":
                old_counts = old["counts"] if old else [0] * len(now["counts"])
                if len(old_counts) != len(now["counts"]):
                    raise ValueError(
                        f"delta baseline bucket mismatch for {key!r}")
                counts = [a - b for a, b in zip(now["counts"], old_counts)]
                if any(c < 0 for c in counts):
                    raise ValueError(
                        f"histogram {key!r} shrank since the baseline — "
                        f"not a baseline of this registry (or reset() "
                        f"intervened)")
                if any(counts):
                    out[key] = {
                        "kind": "histogram",
                        "sum": now["sum"] - (old["sum"] if old else 0.0),
                        "count": sum(counts),
                        "bounds": list(now["bounds"]),
                        "counts": counts,
                    }
            elif now["kind"] == "counter":
                diff = now["value"] - (old["value"] if old else 0.0)
                if diff < 0:
                    raise ValueError(
                        f"counter {key!r} went down since the baseline — "
                        f"not a baseline of this registry (or reset() "
                        f"intervened)")
                if diff != 0:
                    out[key] = {"kind": "counter", "value": diff}
            else:  # gauge: point-in-time reading, no meaningful diff
                if old is None or old["value"] != now["value"]:
                    out[key] = {"kind": now["kind"], "value": now["value"]}
        return out


_default = Registry()


def default_registry() -> Registry:
    """The process-wide registry (what export.serve_http scrapes when not
    given one explicitly)."""
    return _default
