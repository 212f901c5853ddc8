"""Streaming AUC as mergeable sufficient statistics — the port's
counterpart of ``distributed_tensorflow_tpu/utils/metrics.py``.

An eval step returns SUMMED statistics, so shards and batches aggregate
by addition (``train/evaluation.py``). The statistic for AUC is a pair
of fixed-size score histograms (positives, negatives), one scatter-add a
batch on the device; the finalizer computes, in float64 on the host, the
exact rank-sum (Mann–Whitney) AUC of the bucketized scores with half
credit for ties inside a bucket.

Scores are bucketized in LOGIT space, uniform over ``[-LOGIT_RANGE,
LOGIT_RANGE]`` (AUC is rank-based and sigmoid monotone; a probability
grid would pile every confident example into the two end buckets). The
bucket of a logit is the JAX package's to the bit: the same f32
arithmetic, truncated toward zero and clipped; the histogram counts are
sums of 0s and 1s, exact in any order.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["auc_histograms", "auc_from_histograms", "AUC_BINS", "LOGIT_RANGE"]

AUC_BINS = 512
LOGIT_RANGE = 15.0  # sigmoid is flat to <3e-7 beyond this


def auc_histograms(logits: torch.Tensor, labels: torch.Tensor, bins: int = AUC_BINS
                   ) -> dict[str, torch.Tensor]:
    """Per-batch AUC statistics on the logits' device: ``{"auc_pos_hist":
    [bins], "auc_neg_hist": [bins]}`` (f32), summable across batches and
    eval shards. logits: [N] pre-sigmoid scores; labels: [N] in {0, 1}."""
    x = logits.float()
    p = (x + LOGIT_RANGE) / (2.0 * LOGIT_RANGE)
    # clipping in float first is the same bucket for every finite logit
    # (truncation toward zero maps (-1, 0) to 0 either way) and keeps
    # ±inf away from an undefined float -> int conversion
    idx = torch.clamp(p * bins, 0.0, bins - 1).to(torch.int64)
    pos = labels.float()
    zeros = torch.zeros(bins, dtype=torch.float32, device=x.device)
    return {"auc_pos_hist": zeros.index_add(0, idx, pos),
            "auc_neg_hist": zeros.index_add(0, idx, 1.0 - pos)}


def auc_from_histograms(pos_hist, neg_hist) -> float:
    """Finalize: AUC = P(score_pos > score_neg) + 0.5 · P(tie) over every
    positive × negative pair of the bucketized scores; NaN when either
    class is empty."""
    pos = np.asarray(pos_hist, np.float64)
    neg = np.asarray(neg_hist, np.float64)
    P, N = pos.sum(), neg.sum()
    if P == 0 or N == 0:
        return float("nan")
    neg_below = np.cumsum(neg) - neg  # negatives strictly below bucket b
    wins = float((pos * (neg_below + 0.5 * neg)).sum())
    return float(wins / (P * N))
