"""Wide&Deep CTR, embedding-parallel — the port's counterpart of
``distributed_tensorflow_tpu/workloads/wide_deep.py``: the tables
range-sharded over the ``model`` mesh axis (``models/wide_deep.py``,
``ops/embedding.py``), the batch over ``data``.

The preset's mesh is the JAX package's ``data=-1, model=2`` when the job
has an even number of processes above one (``torchrun`` sets
``WORLD_SIZE``), and ``model=1`` for a single process, which the JAX
preset's 8 virtual devices never are; an explicit ``--mesh.model`` wins.
``optimizer.name="auto"`` is the reference's split: FTRL on the wide part
(``wide_table_*``, ``wide_dense``; l1 1e-4 unless set) and AdaGrad on the
deep net and its tables (``make_multi_optimizer``); any other name
optimizes everything alike. Streams: ``synthetic_ctr`` (``SyntheticCTR``)
or ``ctr:<path>`` (CTR records); evaluation reads ``data.eval_dataset=
ctr:<path>`` when given, else the training file under another shuffle
seed with its AUC tagged ``train_auc``, else the synthetic stream at a
disjoint index range. Every rank of one data shard reads the same rows
(the shard is the rank's over the batch axes).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..data.pipeline import DataConfig
from ..data.recsys import CTRRecordDataset, RecsysConfig, SyntheticCTR
from ..models import wide_deep as wd
from ..parallel.collectives import axis_index, axis_size
from ..parallel.mesh import BATCH_AXES, MeshSpec
from ..train.optimizers import OptimizerConfig, make_multi_optimizer
from .runner import RunConfig, TrainSection, WorkloadParts


def _preset_model_axis() -> int:
    world = int(os.environ.get("WORLD_SIZE", "1"))
    return 2 if world > 1 and world % 2 == 0 else 1


def default_config() -> RunConfig:
    return RunConfig(
        workload="wide_deep",
        model=wd.WideDeepConfig(),
        mesh=MeshSpec(data=-1, model=_preset_model_axis()),
        data=DataConfig(dataset="synthetic_ctr", global_batch_size=256),
        optimizer=OptimizerConfig(name="auto", learning_rate=0.02),
        train=TrainSection(num_steps=500, log_every=50),
    )


def _recsys_cfg(cfg: RunConfig) -> RecsysConfig:
    return RecsysConfig(vocab_sizes=tuple(cfg.model.vocab_sizes),
                        dense_features=cfg.model.dense_features,
                        global_batch_size=cfg.data.global_batch_size, seed=cfg.data.seed)


def _canonical_tx(cfg: RunConfig):
    """``model -> MultiOptimizer``: FTRL(wide) + AdaGrad(deep, tables) when
    ``optimizer.name == "auto"``, else None (the runner's optimizer)."""
    if cfg.optimizer.name != "auto":
        return None
    ftrl_cfg = dataclasses.replace(cfg.optimizer, name="ftrl",
                                   l1=cfg.optimizer.l1 if cfg.optimizer.l1 > 0 else 1e-4)
    default = dataclasses.replace(cfg.optimizer, name="adagrad")
    return lambda model: make_multi_optimizer(((r"(^|/)wide_", ftrl_cfg),), default,
                                              model.named_parameters())


def _dataset_fn(cfg: RunConfig, rcfg: RecsysConfig, shard):
    ds = cfg.data.dataset
    if ds.startswith("ctr:"):
        return lambda start: CTRRecordDataset(ds[4:], rcfg, index_offset=start, shard=shard)
    if ds not in ("synthetic_ctr", "synthetic"):
        raise ValueError(f"wide_deep: unknown data.dataset={ds!r} (expected 'synthetic_ctr' "
                         f"or 'ctr:<path>')")
    return lambda start: SyntheticCTR(rcfg, index_offset=start, shard=shard)


def _eval_dataset_fn(cfg: RunConfig, rcfg: RecsysConfig, shard):
    """``(dataset_fn, metric_prefix)``: one decision for the eval source
    and its tag, so the two cannot drift."""
    ds, ev = cfg.data.dataset, cfg.data.eval_dataset
    if ev.startswith("ctr:"):
        return (lambda n: CTRRecordDataset(ev[4:], rcfg, num_batches=n, seed=rcfg.seed + 101,
                                           shard=shard)), ""
    if ev:
        raise ValueError(f"wide_deep: unsupported data.eval_dataset={ev!r} (expected "
                         f"'ctr:<path>' or empty)")
    if ds.startswith("ctr:"):
        # the training file under another shuffle seed: a train-set metric
        return (lambda n: CTRRecordDataset(ds[4:], rcfg, num_batches=n, seed=rcfg.seed + 101,
                                           shard=shard)), "train_"
    return (lambda n: SyntheticCTR(rcfg, n, index_offset=10**6, shard=shard)), ""


def build(cfg: RunConfig, device: torch.device, mesh=None) -> WorkloadParts:
    """A Wide&Deep model with random weights from ``cfg.train.seed`` on
    ``device`` (this rank's table shards over ``mesh``'s ``model`` axis),
    the CTR loss and eval statistics, this data shard's streams, the
    ``auto`` optimizer and the forward FLOPs per global step."""
    data = cfg.data
    if not isinstance(data, DataConfig):
        raise ValueError(f"wide_deep takes a DataConfig, got {type(data).__name__}")
    rcfg = _recsys_cfg(cfg)
    shard = ((axis_index(BATCH_AXES, mesh), axis_size(BATCH_AXES, mesh)) if mesh is not None
             else None)
    model = wd.build(cfg.model, wd.init_params(cfg.model, seed=cfg.train.seed, device=device),
                     device, mesh)
    eval_fn_, prefix = _eval_dataset_fn(cfg, rcfg, shard)
    return WorkloadParts(
        model=model,
        loss_fn=wd.ctr_loss_fn(model),
        eval_fn=wd.ctr_eval_fn(model),
        dataset_fn=_dataset_fn(cfg, rcfg, shard),
        eval_dataset_fn=eval_fn_,
        flops_per_step=wd.flops_per_example(cfg.model) * data.global_batch_size,
        batch_size=data.global_batch_size,
        param_rules=wd.WIDE_DEEP_RULES,
        optimizer_fn=_canonical_tx(cfg),
        eval_metric_prefix=prefix,
        consumed_eval_dataset=True,
    )
