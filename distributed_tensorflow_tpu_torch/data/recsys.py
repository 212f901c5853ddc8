"""CTR streams of the Wide&Deep workload — the port's counterpart of
``distributed_tensorflow_tpu/data/recsys.py``, numpy only.

- ``SyntheticCTR``: a fixed random teacher (a table per categorical
  feature and a linear head) labels clicks, over Zipf-skewed ids, so the
  loss and AUC curves mean something with no dataset file.
- ``CTRRecordDataset``: fixed-size binary records (``label f32 | dense
  f32 x D | cat i32 x F``) through the record loader (``runtime/
  loader.py``); ``tools/make_ctr_records_torch.py`` converts Criteo-format
  TSV into that layout.

Both give the JAX package's batches bit for bit for the same seed, batch
index and shard. The shard is ``(index, count)`` of the data shard a rank
belongs to: by default this process's index and the process count, as the
JAX streams read ``jax.process_index/count``. With tables sharded over a
``model`` axis, the ranks of one data shard must feed the same rows, so
the workload passes the rank's index and count over the mesh's batch axes
(``workloads/wide_deep.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator

import numpy as np

from ..parallel import cluster
from .pipeline import batch_rng, local_batch_size

Shard = tuple[int, int]  # (index, count)


def _shard(shard: Shard | None) -> Shard:
    return (cluster.process_index(), cluster.process_count()) if shard is None else shard


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    vocab_sizes: tuple[int, ...] = (1024, 1024, 512, 128, 64)
    dense_features: int = 13
    global_batch_size: int = 256
    teacher_dim: int = 8
    zipf_a: float = 1.3  # id popularity skew
    seed: int = 0


class SyntheticCTR:
    """``{"cat" i32 [B, F], "dense" f32 [B, D], "label" f32 [B]}`` batches
    of this shard: Zipf ids clipped to each vocab, gaussian dense
    features, the label ``score > 0`` of the teacher's linear head."""

    def __init__(self, cfg: RecsysConfig, num_batches: int | None = None,
                 index_offset: int = 0, shard: Shard | None = None):
        self.cfg = cfg
        self.num_batches = num_batches
        self.index_offset = index_offset
        self.shard, shards = _shard(shard)
        self.local_bs = local_batch_size(cfg.global_batch_size, shards)
        rng = np.random.RandomState(cfg.seed)
        self.teachers = [rng.randn(v, cfg.teacher_dim).astype(np.float32) * 0.5
                         for v in cfg.vocab_sizes]
        self.head = rng.randn(
            len(cfg.vocab_sizes) * cfg.teacher_dim + cfg.dense_features).astype(np.float32)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        index += self.index_offset
        rng = batch_rng(self.cfg.seed, index, self.shard)
        cfg = self.cfg
        b = self.local_bs
        cat = np.stack([np.minimum(rng.zipf(cfg.zipf_a, size=b) - 1, v - 1)
                        for v in cfg.vocab_sizes], axis=-1).astype(np.int32)
        dense = rng.randn(b, cfg.dense_features).astype(np.float32)
        feats = np.concatenate([t[cat[:, i]] for i, t in enumerate(self.teachers)] + [dense],
                               axis=-1)
        label = (feats @ self.head > 0).astype(np.float32)
        return {"cat": cat, "dense": dense, "label": label}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        i = 0
        while self.num_batches is None or i < self.num_batches:
            yield self.batch(i)
            i += 1


def ctr_record_dtype(dense_features: int, n_cat: int) -> np.dtype:
    """One fixed-size record: label f32 | dense f32 x D | cat i32 x F,
    little-endian 4-byte fields (a static record length for the loader)."""
    return np.dtype([("label", "<f4"), ("dense", "<f4", (dense_features,)),
                     ("cat", "<i4", (n_cat,))])


def make_ctr_record_file(path: str, label: np.ndarray, dense: np.ndarray,
                         cat: np.ndarray) -> int:
    """Write [N] label / [N, D] dense / [N, F] cat as a CTR record file;
    returns N."""
    n, d = dense.shape
    arr = np.empty(n, ctr_record_dtype(d, cat.shape[1]))
    arr["label"] = np.asarray(label, np.float32)
    arr["dense"] = np.asarray(dense, np.float32)
    arr["cat"] = np.asarray(cat, np.int32)
    arr.tofile(path)
    return n


class CTRRecordDataset:
    """CTR batches of this shard from a record file: the loader's
    epoch shuffle (SplitMix64 Fisher–Yates, the same bits native and in
    Python), shard-disjoint strides, resume by ``index_offset``. Ids
    outside the configured vocab clip to it (the file may have been hashed
    to a larger vocab than the model's)."""

    def __init__(self, path: str, cfg: RecsysConfig, num_batches: int | None = None,
                 index_offset: int = 0, seed: int | None = None, shard: Shard | None = None):
        from ..runtime.loader import RecordFileLoader

        self.cfg = cfg
        self._dt = ctr_record_dtype(cfg.dense_features, len(cfg.vocab_sizes))
        self._vocab = np.asarray(cfg.vocab_sizes, np.int32)
        self._validate_layout(path)
        index, count = _shard(shard)
        self.loader = RecordFileLoader(
            path, self._dt.itemsize, local_batch_size(cfg.global_batch_size, count),
            seed=cfg.seed if seed is None else seed, shard=index, n_shards=count,
            start_batch=index_offset, num_batches=num_batches, decode=self._decode)

    def _validate_layout(self, path: str) -> None:
        """A layout mismatch would train on misaligned bytes: the
        converter's sidecar must agree with the config, and the file must
        hold a whole number of records."""
        meta_path = path + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            want = (meta.get("dense_features"), len(meta.get("vocab_sizes", [])),
                    meta.get("record_bytes"))
            have = (self.cfg.dense_features, len(self.cfg.vocab_sizes), self._dt.itemsize)
            if want != have:
                raise ValueError(
                    f"{path}: layout mismatch — file has dense/cat/bytes {want} (from "
                    f"{meta_path}) but the model config implies {have}; set "
                    f"--model.dense_features/--model.vocab_sizes to match the converter output")
        size = os.path.getsize(path)
        if size % self._dt.itemsize:
            raise ValueError(f"{path}: {size} bytes is not a whole number of "
                             f"{self._dt.itemsize}-byte records — wrong "
                             f"dense_features/vocab_sizes for this file?")

    def _decode(self, raw: np.ndarray, batch_index: int) -> dict[str, np.ndarray]:
        rec = np.ascontiguousarray(raw).reshape(-1).view(self._dt)
        cat = np.minimum(np.maximum(rec["cat"], 0), self._vocab - 1)
        return {"cat": np.ascontiguousarray(cat), "dense": np.ascontiguousarray(rec["dense"]),
                "label": np.ascontiguousarray(rec["label"])}

    def __iter__(self):
        return iter(self.loader)
