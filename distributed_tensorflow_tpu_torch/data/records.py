"""Classification datasets over flat record files through the record
loader — the port's counterpart of ``distributed_tensorflow_tpu/data/
records.py``.

Record layout: ``H*W*C uint8 image bytes ++ 4-byte LE int32 label``, a
dense-file analog of TFRecord for fixed-shape examples, so the loader
(``runtime/loader.py``) mmaps and copies records with no parsing; decode
is one cast. ``make_record_file`` writes one from arrays.

One deliberate difference: the crop_flip generator of a batch is seeded
from ``(seed * 1_000_003 + batch_index)`` with the batch's stream index.
The JAX loader calls its ``decode`` with the raw batch alone, so there
every batch draws from index 0; the port's loader hands ``decode`` the
index, and batch i is the JAX dataset's ``_decode(raw_i, i)`` bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..parallel import cluster
from ..runtime.loader import RecordFileLoader
from . import augment as aug


def make_record_file(path: str, images: np.ndarray, labels: np.ndarray) -> int:
    """Write images [N, ...] uint8 and labels [N] int32 as flat records;
    returns record_bytes."""
    n = images.shape[0]
    img = np.ascontiguousarray(images, np.uint8).reshape(n, -1)
    lab = np.ascontiguousarray(labels, np.int32).reshape(n, 1)
    rec = np.concatenate([img, lab.view(np.uint8)], axis=1)
    rec.tofile(path)
    return rec.shape[1]


class RecordClassificationDataset:
    """Iterable of {"image" f32 [B, *shape] / 255, "label" i32 [B]} batches
    of this process's rows (its stride of each epoch's order), resumable
    by ``index_offset`` (the ``make_dataset`` contract, ``data/pipeline.py``).
    ``augment="crop_flip"`` pads by 4, crops and flips (``data/augment.py``)."""

    def __init__(self, path: str, image_shape: tuple[int, ...], global_batch_size: int, *,
                 seed: int = 0, num_batches: int | None = None, index_offset: int = 0,
                 n_threads: int = 4, use_native: bool | None = None, flat: bool = False,
                 augment: str = "none"):
        from .pipeline import local_batch_size

        self.image_shape = tuple(image_shape)
        self.flat = flat  # emit (B, H*W*C): the DataConfig.flat contract
        if augment not in ("none", "crop_flip"):
            raise ValueError(f"Unknown augment mode {augment!r}")
        if augment == "crop_flip" and (flat or len(image_shape) != 3):
            raise ValueError("crop_flip needs [H, W, C] images (flat=False)")
        self.augment = augment
        self.seed = seed
        self.loader = RecordFileLoader(
            path, int(np.prod(image_shape)) + 4, local_batch_size(global_batch_size),
            seed=seed, shard=cluster.process_index(), n_shards=cluster.process_count(),
            n_threads=n_threads, decode=self._decode, start_batch=index_offset, num_batches=num_batches,
            use_native=use_native)

    def _decode(self, raw: np.ndarray, batch_index: int) -> dict[str, np.ndarray]:
        img = raw[:, :-4]
        if not self.flat:
            img = img.reshape(-1, *self.image_shape)
        if self.augment == "crop_flip":
            rng = np.random.RandomState((self.seed * 1_000_003 + batch_index) & 0x7FFFFFFF)
            img = aug.random_crop_flip(img, rng)
        img = img.astype(np.float32)
        img *= 1.0 / 255.0
        label = raw[:, -4:].copy().view(np.int32)[:, 0]
        return {"image": img, "label": label}

    def __iter__(self):
        return iter(self.loader)
