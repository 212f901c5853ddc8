"""JPEG record container and the decode/augment dataset of the real-ImageNet
path — the port's counterpart of ``distributed_tensorflow_tpu/data/
jpeg_records.py``.

The container is two flat files the host can mmap:

- ``<path>.dat``: the raw JPEG streams, concatenated;
- ``<path>.idx``: N x [u64 offset, u64 length, i64 label], little-endian.

Fixed 24-byte index entries make sharding and shuffling O(1) a record.
Decode and augmentation run on the host and overlap the card's step
through the ``Prefetcher``. Two decoders share one augmentation policy
(``augment.sample_crop_rect``): the native libjpeg stage
(``data/native_jpeg.py``; the default where it builds) and PIL on a thread
pool. They draw the same crops and flips but resample with different
filters, so their pixels are close, not equal; each is deterministic.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

from ..parallel import cluster
from . import augment

_ENTRY = np.dtype([("offset", "<u8"), ("length", "<u8"), ("label", "<i8")])


def make_jpeg_record_file(path: str, images: np.ndarray, labels: np.ndarray, *,
                          quality: int = 90) -> int:
    """[N, H, W, 3] uint8 images encoded as JPEGs (PIL) into
    <path>.dat/.idx; returns N. Real datasets are converted by
    ``tools/make_jpeg_records_torch.py``, which copies the streams."""
    import io

    from PIL import Image

    entries = np.empty(len(images), _ENTRY)
    with open(path + ".dat", "wb") as f:
        off = 0
        for i, (img, lab) in enumerate(zip(images, labels)):
            buf = io.BytesIO()
            Image.fromarray(np.asarray(img, np.uint8)).save(buf, "JPEG", quality=quality)
            raw = buf.getvalue()
            f.write(raw)
            entries[i] = (off, len(raw), int(lab))
            off += len(raw)
    entries.tofile(path + ".idx")
    return len(images)


class JpegClassificationDataset:
    """Iterable of {"image" f32 [B, S, S, 3] in [0, 1], "label" i32 [B]}
    batches from a JPEG record pair: this process's stride of each epoch's
    order, resumable by ``index_offset``, decoded on ``n_threads`` threads
    (``min(16, os.cpu_count())`` by default).

    ``train=True``: a shuffled order, random-resized-crop to
    ``image_size`` and a horizontal flip (the ImageNet recipe), seeded an
    image from (seed, stream index, record); ``train=False``: file order,
    the short side resized and a centre crop. ``decoder``: ``"native"``
    (raises when the library did not build), ``"pil"``, or ``"auto"``
    (native where it builds); ``DTF_JPEG_DECODER`` overrides it.
    """

    def __init__(self, path: str, image_size: int, global_batch_size: int, *, seed: int = 0,
                 train: bool = True, num_batches: int | None = None, index_offset: int = 0,
                 n_threads: int | None = None, decoder: str = "auto"):
        from .pipeline import local_batch_size

        self.path = path
        self.image_size = image_size
        self.seed = seed
        self.train = train
        self.num_batches = num_batches
        self.index_offset = index_offset
        self.local_bs = local_batch_size(global_batch_size)
        self.entries = np.fromfile(path + ".idx", _ENTRY)
        if not len(self.entries):
            raise ValueError(f"{path}.idx is empty")
        self._data = np.memmap(path + ".dat", np.uint8, "r")
        self._shard = cluster.process_index()
        self._n_shards = cluster.process_count()
        self._n_threads = n_threads or min(16, os.cpu_count() or 4)
        decoder = os.environ.get("DTF_JPEG_DECODER", decoder)
        if decoder not in ("auto", "pil", "native"):
            raise ValueError(f"unknown decoder {decoder!r}")
        if decoder != "pil":
            from . import native_jpeg

            if native_jpeg.available():
                decoder = "native"
            elif decoder == "native":
                raise RuntimeError(f"decoder='native' requested but native/dtf_jpeg.cpp did "
                                   f"not build: {native_jpeg.failure}")
            else:
                decoder = "pil"
        self.decoder = decoder
        self._pool = (cf.ThreadPoolExecutor(max_workers=self._n_threads)
                      if decoder == "pil" else None)

    def _batches_per_epoch(self) -> int:
        n = len(self.entries) // self._n_shards
        return max(n // self.local_bs, 1)

    def _decode_one(self, entry, rng_seed: int) -> np.ndarray:
        import io

        from PIL import Image

        raw = self._data[entry["offset"]: entry["offset"] + entry["length"]]
        img = np.asarray(Image.open(io.BytesIO(raw.tobytes())).convert("RGB"))
        rng = np.random.RandomState(rng_seed & 0x7FFFFFFF)
        if self.train:
            img = augment.random_resized_crop(img, rng, self.image_size)
            img = augment.hflip(img, rng)
        else:
            img = augment.resize_center_crop(img, self.image_size)
        return img

    def _decode_batch_native(self, entries, seeds) -> np.ndarray:
        """The PIL path's crop and flip draws (``sample_crop_rect``, then
        ``rand() < 0.5``) here; decode, crop and resize in the library."""
        from . import native_jpeg

        n = len(entries)
        dims = native_jpeg.jpeg_dims(self._data, entries["offset"], entries["length"])
        rects = np.empty((n, 4), np.int64)
        flips = np.zeros(n, bool)
        for i in range(n):
            h, w = int(dims[i, 0]), int(dims[i, 1])
            if h == 0 or w == 0:  # does not parse: the decode zero-fills it
                rects[i] = (0, 0, 1, 1)
                continue
            if self.train:
                rng = np.random.RandomState(seeds[i] & 0x7FFFFFFF)
                rects[i] = augment.sample_crop_rect(h, w, rng)
                flips[i] = rng.rand() < 0.5
            else:
                # resize_center_crop's window: the centred square of side
                # short * 0.875, resized to image_size
                side = max(1, int(round(min(h, w) * 0.875)))
                rects[i] = ((h - side) // 2, (w - side) // 2, side, side)
        out = native_jpeg.decode_crop_resize(self._data, entries["offset"], entries["length"],
                                             rects, self.image_size, self._n_threads)
        if flips.any():
            out[flips] = out[flips, :, ::-1]
        return out

    def batch(self, index: int) -> dict[str, np.ndarray]:
        index += self.index_offset
        epoch, pos = divmod(index, self._batches_per_epoch())
        order = np.arange(len(self.entries))
        if self.train:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        order = order[self._shard::self._n_shards]
        idx = order[pos * self.local_bs: (pos + 1) * self.local_bs]
        entries = self.entries[idx]
        seeds = [(self.seed * 1_000_003 + index) * 131 + int(i) for i in idx]
        if self.decoder == "native":
            img = self._decode_batch_native(entries, seeds).astype(np.float32)
        else:
            img = np.stack(list(self._pool.map(self._decode_one, entries, seeds)))
            img = img.astype(np.float32)
        img *= 1.0 / 255.0
        return {"image": img, "label": entries["label"].astype(np.int32)}

    def __iter__(self):
        i = 0
        while self.num_batches is None or i < self.num_batches:
            yield self.batch(i)
            i += 1
