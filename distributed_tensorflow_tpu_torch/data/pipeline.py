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
``synthetic`` and ``npz:<path>``; ``records:`` and ``jpeg:`` (and the
``augment`` option they use) come with the real-ImageNet intake, ROADMAP
Queue A item 3.2.

``Prefetcher`` keeps up to ``depth`` batches ready on a background
thread, as the JAX package's does; its transform for the card,
``DevicePut``, copies each host batch into a ring of pinned buffers and
from there to the card on a side stream, so the step's stream only waits
for the copy's event (``StagedBatch.wait``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ..parallel.cluster import process_count, process_index
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    # synthetic | npz:<path> (records:<path> | jpeg:<path>: not ported)
    dataset: str = "synthetic"
    eval_dataset: str = ""
    global_batch_size: int = 128
    image_size: int = 28
    channels: int = 1
    num_classes: int = 10
    seed: int = 0
    flat: bool = False  # emit (N, H*W*C) instead of (N, H, W, C)
    augment: str = "none"  # "crop_flip" comes with data/augment.py (not ported)


def batch_rng(seed: int, index: int) -> np.random.RandomState:
    """Per-batch, per-process RandomState: deterministic in (seed, index)
    and disjoint across processes (the process index folded in) — the
    JAX package's stream-seeding scheme, shared by every synthetic
    stream."""
    s = (seed * 1_000_003 + index) * 97 + process_index()
    return np.random.RandomState(s & 0x7FFFFFFF)


def local_batch_size(global_batch_size: int) -> int:
    n = process_count()
    if global_batch_size % n != 0:
        raise ValueError(
            f"global_batch_size={global_batch_size} not divisible by "
            f"process_count={n}"
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
        n = len(self.images) // process_count()
        return max(n // self.local_bs, 1)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        epoch, pos = divmod(index, self._batches_per_epoch())
        order = np.arange(len(self.images))
        if self.shuffle:
            np.random.RandomState(self.cfg.seed + epoch).shuffle(order)
        rank, world = process_index(), process_count()
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
    eval streams) turns stochastic augmentation off."""
    if train and cfg.augment != "none":
        raise NotImplementedError(
            f"data.augment={cfg.augment!r}: data/augment.py is not ported yet "
            f"(ROADMAP Queue A item 3)")
    if cfg.dataset == "synthetic":
        return SyntheticClassification(cfg, num_batches, index_offset)
    if cfg.dataset.startswith("npz:"):
        return NpzDataset(cfg.dataset[4:], cfg, num_batches=num_batches,
                          index_offset=index_offset)
    if cfg.dataset.startswith(("records:", "jpeg:")):
        raise NotImplementedError(
            f"dataset {cfg.dataset.split(':')[0]}: (data/records.py, "
            f"data/jpeg_records.py) is not ported yet (ROADMAP Queue A item 3.2)")
    raise ValueError(f"Unknown dataset '{cfg.dataset}'")


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
