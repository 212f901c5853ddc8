"""Record-file loader: the native C++ pipeline and a bit-identical Python
path — the port's counterpart of ``distributed_tensorflow_tpu/runtime/
loader.py``.

Worker threads of ``native/dtf_runtime.cpp`` assemble shuffled,
shard-disjoint batches from an mmap'd file of fixed-size records and hand
them over a bounded ordered queue; the Python path gathers the same
records from a ``np.memmap``. Format: a flat binary file of N records x
``record_bytes``; the caller's ``decode(raw_uint8_batch, batch_index)``
turns a raw batch into its batch dict (the JAX loader hands ``decode`` the
raw batch alone).

Determinism: epoch e's order is Fisher–Yates under SplitMix64 with seed
``seed + e``, the same bits in C++ and in ``epoch_permutation`` here (a
per-element loop, kept as the oracle of the native draw order), so the
two paths give identical streams and a resume at batch k is exact on
either. Each epoch's order is sliced stride-wise over ``n_shards`` (the
``Dataset.shard`` analog: disjoint across processes).
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

from . import native

_M64 = (1 << 64) - 1


def _splitmix64(state: int) -> tuple[int, int]:
    state = (state + 0x9E3779B97F4A7C15) & _M64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return state, (z ^ (z >> 31)) & _M64


def epoch_permutation(n: int, seed: int) -> np.ndarray:
    """The native Fisher–Yates under SplitMix64, one swap at a time."""
    out = np.arange(n, dtype=np.int64)
    s = seed & _M64
    for i in range(n - 1, 0, -1):
        s, r = _splitmix64(s)
        j = r % (i + 1)
        out[i], out[j] = out[j], out[i]
    return out


class RecordFileLoader:
    """Iterate batches of raw records as [batch_records, record_bytes]
    uint8 arrays, or ``decode(raw, batch_index)`` of each.

    ``shard``/``n_shards`` slice each epoch's shuffled order stride-wise;
    ``start_batch`` is the stream index of the first batch (checkpoint
    resume); ``num_batches`` bounds the stream; ``use_native`` picks the
    path (None: the native one when its library is in use).
    """

    def __init__(self, path: str, record_bytes: int, batch_records: int, *, seed: int = 0,
                 shard: int = 0, n_shards: int = 1, n_threads: int = 4,
                 depth: int | None = None,
                 decode: Callable[[np.ndarray, int], object] | None = None,
                 start_batch: int = 0, num_batches: int | None = None,
                 use_native: bool | None = None):
        if record_bytes <= 0 or batch_records <= 0 or not 0 <= shard < n_shards \
                or start_batch < 0:
            raise ValueError(f"record_bytes={record_bytes} batch_records={batch_records} "
                             f"shard={shard}/{n_shards} start_batch={start_batch}")
        self.path = path
        self.record_bytes = record_bytes
        self.batch_records = batch_records
        self.seed = seed
        self.shard = shard
        self.n_shards = n_shards
        self.n_threads = n_threads
        self.depth = n_threads if depth is None else depth  # one in flight a worker
        self.decode = decode
        self.start_batch = start_batch
        self.num_batches = num_batches
        self.use_native = native.available() if use_native is None else use_native
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self.n_records = self._mm.size // record_bytes
        self.batches_per_epoch = (self.n_records // n_shards) // batch_records
        if self.batches_per_epoch < 1:
            raise ValueError(f"{path}: {self.n_records} records can't fill one batch of "
                             f"{batch_records} over {n_shards} shard(s)")
        self._perm_epoch = -1
        self._perm: np.ndarray | None = None

    def batch_indices(self, bi: int) -> np.ndarray:
        """The record indices of stream batch ``bi`` (``Loader::batch_indices``)."""
        epoch, pos = divmod(bi, self.batches_per_epoch)
        if epoch != self._perm_epoch:
            self._perm = epoch_permutation(self.n_records, self.seed + epoch)
            self._perm_epoch = epoch
        k = (pos * self.batch_records + np.arange(self.batch_records)) * self.n_shards \
            + self.shard
        return self._perm[k]

    def _iter_native(self) -> Iterator[tuple[np.ndarray, int]]:
        lib = native.load_library()
        if lib is None:
            raise OSError(f"native loader unavailable: {native.failure}")
        h = lib.dtf_loader_create(self.path.encode(), self.record_bytes, self.batch_records,
                                  self.n_threads, self.depth, self.seed, self.shard,
                                  self.n_shards, self.start_batch)
        if not h:
            raise OSError(f"native loader failed to open {self.path}")
        try:
            nbytes = self.batch_records * self.record_bytes
            i = 0
            while self.num_batches is None or i < self.num_batches:
                b = lib.dtf_loader_next(h)
                if not b:
                    return
                buf = np.ctypeslib.as_array(lib.dtf_batch_data(b), shape=(nbytes,)).copy()
                bi = lib.dtf_batch_index(b)
                lib.dtf_loader_release(h, b)
                yield buf.reshape(self.batch_records, self.record_bytes), bi
                i += 1
        finally:
            lib.dtf_loader_destroy(h)

    def _iter_python(self) -> Iterator[tuple[np.ndarray, int]]:
        records = self._mm.reshape(self.n_records, self.record_bytes)
        i = 0
        while self.num_batches is None or i < self.num_batches:
            bi = self.start_batch + i
            # fancy indexing copies out of the memmap; asarray drops the subclass
            yield np.asarray(records[self.batch_indices(bi)]), bi
            i += 1

    def __iter__(self):
        it = self._iter_native() if self.use_native else self._iter_python()
        if self.decode is None:
            return (raw for raw, _ in it)
        return (self.decode(raw, bi) for raw, bi in it)
