"""Image classification streams and the stream-seeding scheme — the subset
of ``distributed_tensorflow_tpu/data/pipeline.py`` the ResNet slice needs,
numpy only.

``DataConfig``, ``batch_rng``, ``local_batch_size``,
``SyntheticClassification`` (a fixed random linear teacher labels
gaussian images) and ``NpzDataset`` (epoch-shuffled ``image``/``label``
arrays) give batches bit-identical to the JAX package's for the same
``(seed, index)``: the process index and count are
``parallel.cluster``'s (the JAX package reads
``jax.process_index/count``). ``make_dataset`` takes
``synthetic``, ``npz:<path>``, ``records:<path>`` (flat records through
the native loader, ``data/records.py``, with ``augment="crop_flip"`` in
training) and ``jpeg:<path>`` (a JPEG record pair decoded and augmented
on the host, ``data/jpeg_records.py``); it refuses an ``augment`` for the
first two, which the JAX package ignores there.

``Prefetcher`` keeps up to ``depth`` batches ready on a background
thread, as the JAX package's does; its transform for the card,
``DevicePut``, copies each host batch into a ring of pinned buffers and
from there to the card on a side stream, so the step's stream only waits
for the copy's event (``StagedBatch.wait``). ``RetryingIterator`` absorbs
a transient fault of the source by re-seeking it at the failed index.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ..parallel import cluster
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    # synthetic | npz:<path> | records:<path> | jpeg:<path>
    dataset: str = "synthetic"
    eval_dataset: str = ""
    global_batch_size: int = 128
    image_size: int = 28
    channels: int = 1
    num_classes: int = 10
    seed: int = 0
    flat: bool = False  # emit (N, H*W*C) instead of (N, H, W, C)
    # train-time host augmentation of records: (data/augment.py): "none" |
    # "crop_flip" (pad-4 random crop + hflip); jpeg: always runs the
    # ImageNet random-resized-crop recipe instead
    augment: str = "none"


def batch_rng(seed: int, index: int, shard: int | None = None) -> np.random.RandomState:
    """Per-batch, per-shard RandomState: deterministic in (seed, index)
    and disjoint across shards (the shard index folded in) — the JAX
    package's stream-seeding scheme, shared by every synthetic stream.
    ``shard`` defaults to the process index, as there; a stream whose
    ranks do not all take different rows (a ``model`` axis above 1)
    passes its data shard."""
    s = (seed * 1_000_003 + index) * 97 + (cluster.process_index() if shard is None
                                           else shard)
    return np.random.RandomState(s & 0x7FFFFFFF)


def local_batch_size(global_batch_size: int, shards: int | None = None) -> int:
    """Rows a shard takes of each global batch; ``shards`` defaults to the
    process count."""
    n = cluster.process_count() if shards is None else shards
    if global_batch_size % n != 0:
        raise ValueError(
            f"global_batch_size={global_batch_size} not divisible by "
            f"{'process_count' if shards is None else 'batch shards'}={n}"
        )
    return global_batch_size // n


class SyntheticClassification:
    """Deterministic, learnable synthetic images: a fixed random linear
    teacher ``[H*W*C, num_classes]`` labels gaussian inputs (NHWC,
    flattened for the teacher), so loss curves are meaningful without
    dataset files. At 224x224x3 the teacher is 602 MB and a batch of 256
    costs a 77 GFLOP host product: build the batches a run needs once."""

    def __init__(self, cfg: DataConfig, num_batches: int | None = None,
                 index_offset: int = 0):
        self.cfg = cfg
        self.num_batches = num_batches
        self.index_offset = index_offset
        self.local_bs = local_batch_size(cfg.global_batch_size)
        rng = np.random.RandomState(cfg.seed)
        dim = cfg.image_size * cfg.image_size * cfg.channels
        self.teacher = rng.randn(dim, cfg.num_classes).astype(np.float32)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        index += self.index_offset
        rng = batch_rng(self.cfg.seed, index)
        cfg = self.cfg
        shape = (
            (self.local_bs, cfg.image_size * cfg.image_size * cfg.channels)
            if cfg.flat
            else (self.local_bs, cfg.image_size, cfg.image_size, cfg.channels)
        )
        x = rng.randn(*shape).astype(np.float32)
        flat = x.reshape(self.local_bs, -1)
        label = np.argmax(flat @ self.teacher, axis=-1).astype(np.int32)
        return {"image": x, "label": label}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        i = 0
        while self.num_batches is None or i < self.num_batches:
            yield self.batch(i)
            i += 1


class NpzDataset:
    """Epoch-shuffled stream over an .npz with arrays ``image``/``label``.
    ``num_batches`` bounds the stream; ``index_offset`` fast-forwards past
    batches already consumed. Every epoch draws a fresh order from
    ``seed + epoch``, identical on every process, which takes its strided
    slice."""

    def __init__(self, path: str, cfg: DataConfig, shuffle: bool = True,
                 num_batches: int | None = None, index_offset: int = 0):
        data = np.load(path)
        self.images = data["image"]
        self.labels = data["label"]
        self.cfg = cfg
        self.shuffle = shuffle
        self.num_batches = num_batches
        self.index_offset = index_offset
        self.local_bs = local_batch_size(cfg.global_batch_size)

    def _batches_per_epoch(self) -> int:
        n = len(self.images) // cluster.process_count()
        return max(n // self.local_bs, 1)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        epoch, pos = divmod(index, self._batches_per_epoch())
        order = np.arange(len(self.images))
        if self.shuffle:
            np.random.RandomState(self.cfg.seed + epoch).shuffle(order)
        rank, world = cluster.process_index(), cluster.process_count()
        order = order[rank::world]
        idx = order[pos * self.local_bs: (pos + 1) * self.local_bs]
        return {"image": self.images[idx], "label": self.labels[idx]}

    def __iter__(self):
        i = 0
        while self.num_batches is None or i < self.num_batches:
            yield self.batch(i + self.index_offset)
            i += 1


def make_dataset(cfg: DataConfig, num_batches: int | None = None,
                 index_offset: int = 0, train: bool = True) -> Iterable:
    """The stream ``cfg.dataset`` names. ``train=False`` (the workloads'
    eval streams) turns stochastic augmentation off: ``records:`` without
    its ``augment``, ``jpeg:`` in file order with the resize + centre-crop
    decode."""
    if cfg.dataset == "synthetic" or cfg.dataset.startswith("npz:"):
        if train and cfg.augment != "none":
            raise ValueError(f"data.augment={cfg.augment!r} applies to records: only "
                             f"(dataset {cfg.dataset.split(':')[0]!r})")
        if cfg.dataset == "synthetic":
            return SyntheticClassification(cfg, num_batches, index_offset)
        return NpzDataset(cfg.dataset[4:], cfg, num_batches=num_batches,
                          index_offset=index_offset)
    if cfg.dataset.startswith("records:"):
        from .records import RecordClassificationDataset

        return RecordClassificationDataset(
            cfg.dataset[len("records:"):], (cfg.image_size, cfg.image_size, cfg.channels),
            cfg.global_batch_size, seed=cfg.seed, num_batches=num_batches,
            index_offset=index_offset, flat=cfg.flat,
            augment=cfg.augment if train else "none")
    if cfg.dataset.startswith("jpeg:"):
        from .jpeg_records import JpegClassificationDataset

        return JpegClassificationDataset(
            cfg.dataset[len("jpeg:"):], cfg.image_size, cfg.global_batch_size, seed=cfg.seed,
            train=train, num_batches=num_batches, index_offset=index_offset)
    raise ValueError(f"Unknown dataset '{cfg.dataset}'")


class RetryingIterator:
    """A batch stream that absorbs transient IOError-class faults by
    RE-SEEKING the source at the failed index (the JAX package's
    ``RetryingIterator``). Every stream here is a pure function of
    ``(seed, index)``, so the rebuilt source hands the consumer exactly
    the batch it was owed: a recovered stream is bitwise the unfaulted one.

    ``make_source(start_index)`` returns an iterable whose first batch is
    the stream's ``start_index``-th (0-based), e.g. ``lambda i:
    make_dataset(cfg, index_offset=i)``. Retries per fetch are bounded by
    ``policy`` (``resilience/retry.py``; counters ``retry_attempts_total{
    site}`` / ``retry_exhausted_total{site}``); a permanent failure
    surfaces as ``RetryExhausted`` with the IOError chained.
    """

    def __init__(self, make_source: Callable[[int], Iterable], policy=None, *,
                 start_index: int = 0, site: str = "data", registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        from ..resilience import retry as retry_lib

        self._retry = retry_lib
        self.policy = policy if policy is not None else retry_lib.RetryPolicy()
        self.make_source = make_source
        self.site = site
        self.registry = registry
        self.clock = clock
        self.sleep = sleep
        #: batches delivered so far (== the next index to fetch)
        self.index = start_index
        self._it = iter(make_source(start_index))

    def __iter__(self) -> "RetryingIterator":
        return self

    def _reseek(self, failures: int, exc: BaseException) -> None:
        self._it = iter(self.make_source(self.index))

    def __next__(self):
        batch = self._retry.retry_call(
            lambda: next(self._it), policy=self.policy, site=self.site,
            registry=self.registry, clock=self.clock, sleep=self.sleep, on_retry=self._reseek)
        self.index += 1
        return batch


class Prefetcher:
    """Background-thread prefetch: keeps up to ``depth`` items ready,
    each passed through ``transform`` on the thread. An exception of the
    worker (the source's or the transform's) is raised in the consumer
    after the items queued before it; closing the iterator early (or
    dropping it) stops the worker and drains the queue until the worker
    has ended."""

    _DONE = object()
    # bound at class definition: the generator's finally may run at
    # interpreter shutdown, after the module's globals are torn down
    _Empty = queue.Empty

    def __init__(self, source: Iterable, depth: int = 2,
                 transform: Callable[[Any], Any] | None = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.source = source
        self.depth = depth
        self.transform = transform
        self.thread: threading.Thread | None = None  # the last iteration's worker

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        error: list[BaseException] = []

        def worker():
            try:
                it = iter(self.source)
                while not stop.is_set():
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    if self.transform is not None:
                        item = self.transform(item)
                    q.put(item)
            except BaseException as e:  # raised again in the consumer
                error.append(e)
            finally:
                q.put(self._DONE)

        t = self.thread = threading.Thread(target=worker, daemon=True, name="prefetcher")
        t.start()
        done = False
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    done = True
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            # drain until the worker's last put: it may be blocked in put()
            while not done:
                done = q.get() is self._DONE


class StagedBatch:
    """A batch whose copy to the card was issued on ``DevicePut``'s side
    stream. ``wait()`` makes the caller's current stream wait for the
    copy's event, marks each tensor as used on that stream (so the caching
    allocator does not hand its memory to the side stream before the
    consumer is done) and returns the tensors."""

    def __init__(self, tensors: dict[str, torch.Tensor], event=None):
        self.tensors = tensors
        self.event = event

    def wait(self) -> dict[str, torch.Tensor]:
        if self.event is not None:
            stream = torch.cuda.current_stream(next(iter(self.tensors.values())).device)
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
        return self.tensors


class DevicePut:
    """``Prefetcher`` transform: a host batch (numpy arrays or CPU tensors)
    to a ``StagedBatch`` on ``device`` (the card by default). On the card
    each batch is copied into the next of ``SLOTS`` preallocated pinned
    host buffers — a slot is refilled only after its previous copy's event
    has completed — and from there with a ``non_blocking`` copy on this
    transform's own CUDA stream, entered on the calling (worker) thread,
    which then records an event. On the CPU the batch becomes tensors."""

    #: pinned buffers in the ring: one filling while the other's copy runs
    SLOTS = 2

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = None
        self._ring: list[tuple[dict[str, torch.Tensor], Any]] = []
        self._layout = None
        self._next = 0

    def __call__(self, batch) -> StagedBatch:
        host = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
                for k, v in batch.items()}
        if self.device.type != "cuda":
            return StagedBatch({k: v.to(self.device) for k, v in host.items()})
        layout = {k: (tuple(v.shape), v.dtype) for k, v in host.items()}
        with torch.cuda.device(self.device):
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.device)
            if layout != self._layout:  # first batch, or another shape: a new ring
                for _, ev in self._ring:
                    if ev is not None:
                        ev.synchronize()
                self._ring = [({k: torch.empty(shape, dtype=dt, pin_memory=True)
                                for k, (shape, dt) in layout.items()}, None)
                              for _ in range(self.SLOTS)]
                self._layout, self._next = layout, 0
            pinned, ev = self._ring[self._next]
            if ev is not None:
                ev.synchronize()  # this slot's previous copy has completed
            for k, v in host.items():
                pinned[k].copy_(v)
            with torch.cuda.stream(self.stream):
                out = {k: torch.empty_like(p, device=self.device) for k, p in pinned.items()}
                for k, p in pinned.items():
                    out[k].copy_(p, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
            self._ring[self._next] = (pinned, ev)
            self._next = (self._next + 1) % self.SLOTS
        return StagedBatch(out, ev)
