"""Wide & Deep CTR model, embedding-parallel — the port's counterpart of
``distributed_tensorflow_tpu/models/wide_deep.py``.

A wide linear path (a ``[V, 1]`` weight column per categorical feature and
a Dense over the dense features) plus a deep MLP over the concatenated
embeddings (a ``[V, D]`` table per feature) and the dense features. The
tables are separate parameters, ``table_i`` and ``wide_table_i``, so the
workload trains the wide part with FTRL and the deep part with AdaGrad
(``workloads/wide_deep.py``); their names are the flax tree's paths, so
the JAX package's regexes (``WIDE_DEEP_RULES``, the optimizer split) read
them unchanged.

Placement: ``WIDE_DEEP_RULES`` shards every table's rows over the
``model`` axis, ``("model", None)``; the MLP is replicated. On a mesh
whose ``model`` axis is n > 1 each rank holds its range shard, ``[
shard_vocab(V, n), D]`` rows of the padded table (``ops/embedding.py``),
and every lookup runs the range-sharded exchange. The JAX model's
``embed_impl="take"`` leaves that exchange to GSPMD; the port has no
GSPMD, so both ``embed_impl`` values run the explicit exchange above
``model=1`` — a deliberate difference, with the same numbers. At
``model=1`` a lookup is ``F.embedding``.

Numerics as the flax model's: embeddings cast to ``dtype`` for the deep
path; the wide logit, ``wide_dense`` and ``deep_out`` in f32; ReLU;
dropout from the step's generator (``models/transformer.dropout``).
Batch: ``{"cat": (B, F) int, "dense": (B, Dd) f32, "label": (B,) in {0,
1}}``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import embedding as emb
from ..parallel import sharding
from ..parallel.mesh import MODEL
from ..utils import metrics as metrics_lib
from ..utils.device import resolve_device
from .transformer import dropout


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    vocab_sizes: tuple[int, ...] = (1024, 1024, 512, 128, 64)
    embed_dim: int = 32
    dense_features: int = 13
    hidden_sizes: tuple[int, ...] = (256, 128, 64)
    dropout: float = 0.0
    dtype: str = "bfloat16"
    # "take" | "explicit": the same range-sharded exchange in the port
    # above model=1 (module docstring)
    embed_impl: str = "take"


#: Coverage fixture: the default WideDeepConfig's parameter paths (5 vocab
#: features, 3 hidden layers) in the port's names.
_WIDE_DEEP_COVERAGE = (
    "deep_0/bias", "deep_0/weight", "deep_1/bias", "deep_1/weight",
    "deep_2/bias", "deep_2/weight", "deep_out/bias", "deep_out/weight",
    "table_0", "table_1", "table_2", "table_3", "table_4",
    "wide_dense/bias", "wide_dense/weight",
    "wide_table_0", "wide_table_1", "wide_table_2", "wide_table_3", "wide_table_4",
)

#: every table (deep embeddings and wide columns) vocab-sharded over
#: ``model``; the MLP replicated. Segment-anchored patterns, as the JAX
#: package's (an unanchored ``table_\d+`` would swallow ``wide_table_``).
WIDE_DEEP_RULES = sharding.partition_rules(
    "wide-deep",
    (
        (r"(^|/)table_\d+$", sharding.MODEL_ROWS),
        (r"(^|/)wide_table_\d+$", sharding.MODEL_ROWS),
        (sharding.CATCH_ALL, sharding.REPLICATED),
    ),
    coverage=_WIDE_DEEP_COVERAGE,
)


def embedding_rules() -> list[tuple[str, tuple]]:
    """The two table rows of ``WIDE_DEEP_RULES`` as ``(pattern, spec)``."""
    return [(r.pattern, r.spec) for r in WIDE_DEEP_RULES.rows
            if r.pattern != sharding.CATCH_ALL]


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)`` with f32 parameters: input, weight
    ``[out, in]`` and bias cast to the compute dtype at use."""

    def __init__(self, in_features: int, out_features: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def model_shards(mesh) -> tuple[int, int]:
    """(this rank's index, the count) over the ``model`` axis of ``mesh``."""
    if mesh is None:
        return 0, 1
    from ..parallel.collectives import axis_index

    return axis_index(MODEL, mesh), mesh.shape[MODEL]


class WideDeep(nn.Module):
    """The model of ``cfg``, holding this rank's shard of every table
    (``mesh``'s ``model`` axis; the whole tables without a mesh)."""

    def __init__(self, cfg: WideDeepConfig, mesh=None, device=None):
        super().__init__()
        if cfg.embed_impl not in ("take", "explicit"):
            raise ValueError(f"Unknown embed_impl {cfg.embed_impl!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.dtype = _DTYPES[cfg.dtype]
        _, n = model_shards(mesh)
        for i, v in enumerate(cfg.vocab_sizes):
            rows = emb.shard_vocab(v, n)
            setattr(self, f"table_{i}",
                    nn.Parameter(torch.empty(rows, cfg.embed_dim, device=device)))
        for i, v in enumerate(cfg.vocab_sizes):
            setattr(self, f"wide_table_{i}",
                    nn.Parameter(torch.empty(emb.shard_vocab(v, n), 1, device=device)))
        self.wide_dense = Dense(cfg.dense_features, 1, torch.float32, device)
        prev = len(cfg.vocab_sizes) * cfg.embed_dim + cfg.dense_features
        for j, width in enumerate(cfg.hidden_sizes):
            setattr(self, f"deep_{j}", Dense(prev, width, self.dtype, device))
            prev = width
        self.deep_out = Dense(prev, 1, torch.float32, device)
        #: the whole (unpadded) shape of every parameter
        self.global_shapes = {
            n: (cfg.vocab_sizes[int(n.rsplit("_", 1)[1])], p.shape[1]) if "table_" in n
            else tuple(p.shape) for n, p in self.named_parameters()}

    def lookup(self, ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return F.embedding(ids, table)
        return emb.range_sharded_lookup(ids, table, self.mesh, MODEL)

    def forward(self, cat: torch.Tensor, dense: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        cfg = self.cfg
        n_feat = len(cfg.vocab_sizes)
        if cat.shape[-1] != n_feat:
            raise ValueError(f"cat has {cat.shape[-1]} features, the model {n_feat}")
        ids = cat.long()
        embeds = [self.lookup(ids[..., i], getattr(self, f"table_{i}")).to(self.dtype)
                  for i in range(n_feat)]
        wide_logit = sum(self.lookup(ids[..., i], getattr(self, f"wide_table_{i}"))[..., 0]
                         .float() for i in range(n_feat))
        wide_logit = wide_logit + self.wide_dense(dense)[..., 0]
        h = torch.cat(embeds + [dense.to(self.dtype)], dim=-1)
        for j in range(len(cfg.hidden_sizes)):
            h = F.relu(getattr(self, f"deep_{j}")(h))
            h = dropout(h, cfg.dropout, train, generator)
        return wide_logit + self.deep_out(h)[..., 0]


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen) -> torch.Tensor:
    """flax's default Dense kernel init: variance 1/fan_in, a normal
    truncated at two standard deviations."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def init_params(cfg: WideDeepConfig, seed: int = 0, device="cuda") -> dict[str, torch.Tensor]:
    """Random weights of the WHOLE model as flax initialises them: tables
    normal(1/sqrt(embed_dim)), wide columns zeros, Dense kernels
    lecun_normal, biases zeros — drawn in f32 from a ``torch.Generator``
    on ``device`` (the card by default; raises without one unless
    ``device="cpu"``) seeded with ``seed``, whole tables, so every
    ``model`` shard count cuts the same numbers (``build``). The numbers
    differ from ``jax.random``'s."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, p in WideDeep(cfg, device="meta").named_parameters():
        t = torch.empty(p.shape, device=device)
        if name.startswith("table_"):
            t.normal_(0.0, 1.0 / math.sqrt(cfg.embed_dim), generator=gen)
        elif name.endswith(".weight"):
            _lecun_normal_(t, p.shape[1], gen)
        else:  # wide columns, biases
            t.zero_()
        out[name] = t
    return out


def build(cfg: WideDeepConfig, params: dict[str, torch.Tensor], device, mesh=None) -> WideDeep:
    """``WideDeep(cfg, mesh)`` on ``device`` holding a copy of ``params``
    (a WHOLE state dict, ``init_params``'s): each table cut to this rank's
    range shard over ``mesh``'s ``model`` axis; f32 masters that require
    grad."""
    device = resolve_device(device)
    model = WideDeep(cfg, mesh, device=device)
    shard, n = model_shards(mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = torch.as_tensor(params[name]).to(device=device, dtype=torch.float32)
            if "table_" in name:
                src = emb.range_shard(src, shard, n)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: {tuple(src.shape)} given, {tuple(p.shape)} wanted")
            p.copy_(src)
    return model


def ctr_loss_fn(model: WideDeep):
    """``loss_fn(batch, generator)``: the mean sigmoid binary cross-entropy
    of the click logits (optax's ``sigmoid_binary_cross_entropy``) and the
    accuracy of ``logits > 0``."""

    def loss_fn(batch, generator=None):
        logits = model(batch["cat"], batch["dense"], train=True, generator=generator)
        labels = batch["label"].float()
        loss = F.binary_cross_entropy_with_logits(logits, labels, reduction="none").mean()
        acc = ((logits > 0) == (labels > 0.5)).float().mean()
        return loss, {"accuracy": acc}

    return loss_fn


def ctr_eval_fn(model: WideDeep):
    """``eval_fn(batch)``: SUMMED loss, correct and count, and the AUC
    histograms (``utils/metrics.py``)."""

    @torch.no_grad()
    def eval_fn(batch):
        logits = model(batch["cat"], batch["dense"])
        labels = batch["label"].float()
        loss = F.binary_cross_entropy_with_logits(logits, labels, reduction="sum")
        correct = ((logits > 0) == (labels > 0.5)).float().sum()
        count = torch.tensor(float(labels.shape[0]), device=logits.device)
        return {"loss_sum": loss, "correct": correct, "count": count,
                **metrics_lib.auc_histograms(logits, labels)}

    return eval_fn


def flops_per_example(cfg: WideDeepConfig) -> float:
    """Analytic FORWARD FLOPs of the MLP matmuls (gathers are bytes)."""
    prev = len(cfg.vocab_sizes) * cfg.embed_dim + cfg.dense_features
    flops = 0.0
    for w in cfg.hidden_sizes:
        flops += 2.0 * prev * w
        prev = w
    return flops + 2.0 * prev + 2.0 * cfg.dense_features  # deep_out, wide_dense
