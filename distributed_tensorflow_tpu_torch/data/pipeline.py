"""Image classification streams and the stream-seeding scheme — the subset
of ``distributed_tensorflow_tpu/data/pipeline.py`` the ResNet slice needs,
numpy only.

``DataConfig``, ``batch_rng``, ``local_batch_size``,
``SyntheticClassification`` (a fixed random linear teacher labels
gaussian images) and ``NpzDataset`` (epoch-shuffled ``image``/``label``
arrays) give batches bit-identical to the JAX package's for the same
``(seed, index)``: the process index and count come from
``torch.distributed`` when a process group is up, else 0 and 1 (the JAX
package reads ``jax.process_index/count``). ``make_dataset`` takes
``synthetic`` and ``npz:<path>``; ``records:`` and ``jpeg:`` (and the
``augment`` option they use) come with the real-ImageNet intake, ROADMAP
Queue A item 3.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np


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


def process_index_count() -> tuple[int, int]:
    """(index, count) of this process: torch.distributed's rank and world
    size when a process group is up, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def batch_rng(seed: int, index: int) -> np.random.RandomState:
    """Per-batch, per-process RandomState: deterministic in (seed, index)
    and disjoint across processes (the process index folded in) — the
    JAX package's stream-seeding scheme, shared by every synthetic
    stream."""
    s = (seed * 1_000_003 + index) * 97 + process_index_count()[0]
    return np.random.RandomState(s & 0x7FFFFFFF)


def local_batch_size(global_batch_size: int) -> int:
    n = process_index_count()[1]
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
        n = len(self.images) // process_index_count()[1]
        return max(n // self.local_bs, 1)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        epoch, pos = divmod(index, self._batches_per_epoch())
        order = np.arange(len(self.images))
        if self.shuffle:
            np.random.RandomState(self.cfg.seed + epoch).shuffle(order)
        rank, world = process_index_count()
        order = order[rank::world]
        idx = order[pos * self.local_bs: (pos + 1) * self.local_bs]
        return {"image": self.images[idx], "label": self.labels[idx]}

    def __iter__(self):
        i = 0
        while self.num_batches is None or i < self.num_batches:
            yield self.batch(i + self.index_offset)
            i += 1


def make_dataset(cfg: DataConfig, num_batches: int | None = None,
                 index_offset: int = 0) -> Iterable:
    """The stream ``cfg.dataset`` names (training order)."""
    if cfg.augment != "none":
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
            f"data/jpeg_records.py) is not ported yet (ROADMAP Queue A item 3)")
    raise ValueError(f"Unknown dataset '{cfg.dataset}'")
