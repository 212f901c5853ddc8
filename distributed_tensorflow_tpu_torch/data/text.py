"""Text streams for the causal-LM workload: the learnable synthetic
corpus and the token-file reader.

The LM subset of ``distributed_tensorflow_tpu/data/text.py`` with the
seeding of ``data/pipeline.py`` (``batch_rng``, ``local_batch_size``,
imported from the port's ``data/pipeline.py``), numpy only. A batch is bit-identical to the JAX package's for the same
``(seed, index)``: the process index and count are ``parallel.cluster``'s
(the JAX package reads them from ``jax.process_index/count``). The MLM
streams come with the ``bert_pretrain`` slice (ROADMAP Queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..parallel.cluster import process_count, process_index
from .pipeline import batch_rng, local_batch_size

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class TextDataConfig:
    dataset: str = "synthetic_mlm"  # synthetic_lm | tokens:<path.npy> (MLM: not ported)
    global_batch_size: int = 256
    seq_len: int = 128
    vocab_size: int = 30528
    mask_prob: float = 0.15
    seed: int = 0
    mask_token: int = 103  # [MASK] in BERT vocab
    max_predictions: int = 0


class SyntheticLM:
    """Learnable causal stream: first token free, then a noisy deterministic
    walk t[i+1] = perm[t[i]] (with ``noise`` chance of a uniform resample) —
    next-token accuracy converges toward 1-noise."""

    def __init__(self, cfg: TextDataConfig, num_batches: int | None = None,
                 index_offset: int = 0, noise: float = 0.05):
        self.cfg = cfg
        self.num_batches = num_batches
        self.index_offset = index_offset
        self.noise = noise
        self.local_bs = local_batch_size(cfg.global_batch_size)
        rng = np.random.RandomState(cfg.seed)
        self.perm = rng.permutation(cfg.vocab_size)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        index += self.index_offset
        rng = batch_rng(cfg.seed, index)
        seq = np.empty((self.local_bs, cfg.seq_len), np.int64)
        seq[:, 0] = rng.randint(0, cfg.vocab_size, self.local_bs)
        for i in range(1, cfg.seq_len):
            step = self.perm[seq[:, i - 1]]
            resample = rng.rand(self.local_bs) < self.noise
            seq[:, i] = np.where(
                resample, rng.randint(0, cfg.vocab_size, self.local_bs), step
            )
        return {"input_ids": seq.astype(np.int32)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        i = 0
        while self.num_batches is None or i < self.num_batches:
            yield self.batch(i)
            i += 1


class TokenFileLM:
    """Causal LM batches over a flat token array (.npy of int32 ids) — the
    hook for real corpora tokenized offline. Per-process disjoint strided
    windows; index_offset resumes the stream."""

    def __init__(self, path: str, cfg: TextDataConfig,
                 num_batches: int | None = None, index_offset: int = 0):
        self.tokens = np.load(path, mmap_mode="r")
        self.cfg = cfg
        self.num_batches = num_batches
        self.index_offset = index_offset
        self.local_bs = local_batch_size(cfg.global_batch_size)

    def _windows(self, index: int) -> np.ndarray:
        """[local_bs, seq_len] token windows for global batch ``index``:
        every process draws the same global start list (seed+index, no
        process fold) and takes its disjoint stride slice."""
        cfg = self.cfg
        rank, world = process_index(), process_count()
        rng = np.random.RandomState((cfg.seed + index) & 0x7FFFFFFF)
        n_windows = (len(self.tokens) - 1) // cfg.seq_len
        starts = rng.randint(0, n_windows, self.local_bs * world)
        starts = starts[rank::world] * cfg.seq_len
        return np.stack([self.tokens[s : s + cfg.seq_len] for s in starts])

    def batch(self, index: int) -> dict[str, np.ndarray]:
        index += self.index_offset
        return {"input_ids": self._windows(index).astype(np.int32)}

    def __iter__(self):
        i = 0
        while self.num_batches is None or i < self.num_batches:
            yield self.batch(i)
            i += 1


def make_text_dataset(cfg: TextDataConfig, num_batches: int | None = None,
                      index_offset: int = 0):
    if cfg.dataset == "synthetic_lm":
        return SyntheticLM(cfg, num_batches, index_offset)
    if cfg.dataset.startswith("tokens:"):
        return TokenFileLM(cfg.dataset[7:], cfg, num_batches, index_offset)
    if cfg.dataset in ("synthetic_mlm",) or cfg.dataset.startswith("tokens_mlm:"):
        raise NotImplementedError(
            f"text dataset {cfg.dataset!r}: the MLM streams come with the "
            f"bert_pretrain slice (ROADMAP Queue A item 2)")
    raise ValueError(f"Unknown text dataset '{cfg.dataset}'")
