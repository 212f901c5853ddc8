"""Text streams for the LM and MLM workloads: the learnable synthetic
corpora and the token-file readers.

``distributed_tensorflow_tpu/data/text.py`` with the seeding of
``data/pipeline.py`` (``batch_rng``, ``local_batch_size``, imported from
the port's ``data/pipeline.py``), numpy only. A batch is bit-identical to
the JAX package's for the same ``(seed, index)``: the process index and
count are ``parallel.cluster``'s (the JAX package reads them from
``jax.process_index/count``). A stream given ``shard=(index, count)``
takes that data shard's rows instead (every ``model`` rank of one data
shard reads the same rows; at ``model=1`` the shard is the process).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..parallel.cluster import process_count, process_index
from .pipeline import batch_rng, local_batch_size

MASK_FRACTION_KEEP = 0.1  # BERT 80/10/10 corruption split
MASK_FRACTION_RANDOM = 0.1
IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class TextDataConfig:
    # synthetic_mlm | synthetic_lm | tokens:<path.npy> | tokens_mlm:<path.npy>
    dataset: str = "synthetic_mlm"
    global_batch_size: int = 256
    seq_len: int = 128
    vocab_size: int = 30528
    mask_prob: float = 0.15
    seed: int = 0
    mask_token: int = 103  # [MASK] in BERT vocab
    # > 0: the gathered-head MLM format, exactly this many prediction
    # positions an example ("masked_positions" / "masked_labels" [B, K]);
    # 0: dense [B, S] labels; -1: round(mask_prob * seq_len).
    max_predictions: int = 0


def resolved_max_predictions(cfg: TextDataConfig) -> int:
    """0 = dense labels; -1 = auto (round(mask_prob * seq_len)); else the
    explicit count. Shared by the streams and the workloads' FLOPs."""
    if cfg.max_predictions == 0:
        return 0
    K = (max(1, int(round(cfg.mask_prob * cfg.seq_len)))
         if cfg.max_predictions < 0 else cfg.max_predictions)
    if K > cfg.seq_len:
        raise ValueError(f"max_predictions={K} > seq_len={cfg.seq_len}")
    return K


def mlm_mask_batch(tokens: np.ndarray, cfg: TextDataConfig,
                   rng: np.random.RandomState) -> dict[str, np.ndarray]:
    """BERT-style corruption of a [B, S] token batch (80% [MASK], 10%
    random, 10% kept), in the gathered-head format or as dense labels with
    IGNORE_INDEX, per ``resolved_max_predictions``. The draws are the JAX
    package's, in its order."""
    K = resolved_max_predictions(cfg)
    if K > 0:
        # exactly K positions an example, without replacement
        positions = np.argsort(
            rng.rand(*tokens.shape), axis=1)[:, :K].astype(np.int32)
        positions.sort(axis=1)
        masked = np.zeros(tokens.shape, bool)
        np.put_along_axis(masked, positions, True, axis=1)
    else:
        masked = rng.rand(*tokens.shape) < cfg.mask_prob
    u = rng.rand(*tokens.shape)
    inputs = tokens.copy()
    inputs[masked & (u < 0.8)] = cfg.mask_token
    rand_tok = rng.randint(0, cfg.vocab_size, tokens.shape)
    swap = masked & (u >= 0.8) & (u < 0.9)
    inputs[swap] = rand_tok[swap]
    if K > 0:
        return {
            "input_ids": inputs.astype(np.int32),
            "masked_positions": positions,
            "masked_labels": np.take_along_axis(
                tokens, positions, axis=1).astype(np.int32),
        }
    labels = np.where(masked, tokens, IGNORE_INDEX)
    return {"input_ids": inputs.astype(np.int32),
            "labels": labels.astype(np.int32)}


class SyntheticMLM:
    """Learnable synthetic MLM: positions alternate (free, determined), the
    token at an odd index is perm[token at the even index before it], so a
    masked token is recoverable from a neighbour and accuracy can reach
    about 1."""

    def __init__(self, cfg: TextDataConfig, num_batches: int | None = None,
                 index_offset: int = 0, shard: tuple[int, int] | None = None):
        self.cfg = cfg
        self.num_batches = num_batches
        self.index_offset = index_offset
        self.shard = shard
        self.local_bs = local_batch_size(cfg.global_batch_size, shard and shard[1])
        rng = np.random.RandomState(cfg.seed)
        self.perm = rng.permutation(cfg.vocab_size)

    def _tokens(self, rng: np.random.RandomState) -> np.ndarray:
        cfg = self.cfg
        half = (cfg.seq_len + 1) // 2
        even = rng.randint(0, cfg.vocab_size, (self.local_bs, half))
        seq = np.empty((self.local_bs, half * 2), np.int64)
        seq[:, 0::2] = even
        seq[:, 1::2] = self.perm[even]
        return seq[:, : cfg.seq_len]

    def batch(self, index: int) -> dict[str, np.ndarray]:
        index += self.index_offset
        rng = batch_rng(self.cfg.seed, index, self.shard and self.shard[0])
        return mlm_mask_batch(self._tokens(rng), self.cfg, rng)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        i = 0
        while self.num_batches is None or i < self.num_batches:
            yield self.batch(i)
            i += 1


class SyntheticLM:
    """Learnable causal stream: first token free, then a noisy deterministic
    walk t[i+1] = perm[t[i]] (with ``noise`` chance of a uniform resample) —
    next-token accuracy converges toward 1-noise."""

    def __init__(self, cfg: TextDataConfig, num_batches: int | None = None,
                 index_offset: int = 0, noise: float = 0.05,
                 shard: tuple[int, int] | None = None):
        self.cfg = cfg
        self.num_batches = num_batches
        self.index_offset = index_offset
        self.noise = noise
        self.shard = shard
        self.local_bs = local_batch_size(cfg.global_batch_size, shard and shard[1])
        rng = np.random.RandomState(cfg.seed)
        self.perm = rng.permutation(cfg.vocab_size)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        index += self.index_offset
        rng = batch_rng(cfg.seed, index, self.shard and self.shard[0])
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
                 num_batches: int | None = None, index_offset: int = 0,
                 shard: tuple[int, int] | None = None):
        self.tokens = np.load(path, mmap_mode="r")
        self.cfg = cfg
        self.num_batches = num_batches
        self.index_offset = index_offset
        self.shard = shard
        self.local_bs = local_batch_size(cfg.global_batch_size, shard and shard[1])

    def _windows(self, index: int) -> np.ndarray:
        """[local_bs, seq_len] token windows for global batch ``index``:
        every process draws the same global start list (seed+index, no
        process fold) and takes its disjoint stride slice."""
        cfg = self.cfg
        rank, world = self.shard or (process_index(), process_count())
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


class TokenFileMLM(TokenFileLM):
    """MLM batches over a tokenized corpus: TokenFileLM's windows (drawn
    alike on every process), corrupted by ``mlm_mask_batch`` with
    ``batch_rng``, which folds in the process index."""

    def batch(self, index: int) -> dict[str, np.ndarray]:
        index += self.index_offset
        tokens = self._windows(index).astype(np.int64)
        return mlm_mask_batch(tokens, self.cfg,
                              batch_rng(self.cfg.seed, index, self.shard and self.shard[0]))


def make_text_dataset(cfg: TextDataConfig, num_batches: int | None = None,
                      index_offset: int = 0, shard: tuple[int, int] | None = None):
    """The stream of ``cfg.dataset``; ``shard``: ``(index, count)`` of
    this rank's data shard (default: the process's)."""
    if cfg.dataset == "synthetic_mlm":
        return SyntheticMLM(cfg, num_batches, index_offset, shard=shard)
    if cfg.dataset == "synthetic_lm":
        return SyntheticLM(cfg, num_batches, index_offset, shard=shard)
    if cfg.dataset.startswith("tokens:"):
        return TokenFileLM(cfg.dataset[7:], cfg, num_batches, index_offset, shard=shard)
    if cfg.dataset.startswith("tokens_mlm:"):
        return TokenFileMLM(cfg.dataset[11:], cfg, num_batches,
                            index_offset, shard=shard)
    raise ValueError(f"Unknown text dataset '{cfg.dataset}'")
