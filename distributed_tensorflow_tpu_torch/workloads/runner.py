"""Workload runner — the data-parallel subset of ``distributed_tensorflow_tpu/
workloads/runner.py``: cluster → mesh → config → model on this process's
card → optimizer → step → prefetched feed → callback loop → distributed
eval (``train.eval_every`` mid-train passes and a final one, through
``train/evaluation.py``'s ``ShardedEvaluator``). Each workload module
contributes a preset config and a builder; everything else is shared.
One process per card: under ``torchrun --nproc_per_node=N`` (or with
``cluster.coordinator_address`` set) the processes join one process
group, the ``data`` axis absorbs them, each steps and evaluates on its
rows of the global batch, and only the chief logs.

The config tree keeps the JAX package's section names, so the same
``--section.key=value`` overrides parse; a config that asks for what the
port does not have yet raises with the ROADMAP item named: a checkpoint
directory, a mesh axis other than ``data`` above 1, a pipeline, a fleet,
the anomaly defense, sequence parallelism, MoE.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Iterable

import torch

from ..data.pipeline import DevicePut, Prefetcher
from ..data.text import TextDataConfig
from ..parallel import cluster
from ..parallel.cluster import ClusterConfig
from ..parallel.mesh import MeshSpec, build_mesh, describe
from ..parallel.sharding import replicate
from ..train import (
    OptimizerConfig,
    ShardedEvaluator,
    StepOptions,
    Trainer,
    callbacks as cb,
    init_train_state,
    derive_metrics,
    make_optimizer,
    make_train_step,
)
from ..utils import config as config_lib

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainSection:
    num_steps: int = 1000
    log_every: int = 100
    grad_accum_steps: int = 1
    seed: int = 0
    eval_every: int = 0  # 0 = no mid-train eval
    eval_batches: int = 16  # a pass's batches; 0 = no eval at all
    # Adds grad_norm + grads_finite to the step metrics (an extra pass
    # over every gradient per step)
    debug_metrics: bool = False
    # > 0: clip gradients to this global norm before the optimizer
    clip_grad_norm: float = 0.0
    # the numeric-anomaly defense needs checkpoints and quarantine
    # (not ported: ROADMAP Queue A item 6)
    anomaly_defense: bool = False


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str = ""  # non-empty: not ported yet (ROADMAP Queue A item 2.3)


@dataclasses.dataclass(frozen=True)
class FleetSection:
    dir: str = ""  # non-empty: not ported yet (ROADMAP Queue A item 6)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    workload: str = "gpt_lm"
    model: Any = None  # workload-specific config dataclass, set by preset
    cluster: ClusterConfig = ClusterConfig()
    mesh: MeshSpec = MeshSpec()
    data: Any = TextDataConfig()  # the workload's: TextDataConfig or data.pipeline.DataConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    train: TrainSection = TrainSection()
    checkpoint: CheckpointConfig = CheckpointConfig()
    fleet: FleetSection = FleetSection()


@dataclasses.dataclass
class WorkloadParts:
    """What a workload module's build() returns."""

    model: torch.nn.Module  # trainable, on the run's device, sync BN over the mesh
    loss_fn: Callable  # loss_fn(batch, generator) -> (loss, aux)
    # start_step -> host-batch iterable
    dataset_fn: Callable[[int], Iterable]
    flops_per_step: float | None = None  # analytic FORWARD flops, for MFU
    batch_size: int | None = None  # examples/step for throughput logs
    # eval_fn(batch) -> summed statistics (train/evaluation.py)
    eval_fn: Callable | None = None
    # num_batches -> host-batch iterable of the held-out stream
    eval_dataset_fn: Callable[[int], Iterable] | None = None


@dataclasses.dataclass
class RunResult:
    state: Any
    history: list[dict]
    device: torch.device
    mesh: Any = None
    eval_metrics: dict | None = None  # the final eval's, when the workload has one


def check_supported(cfg: RunConfig) -> None:
    """Refuse what this slice does not have, naming the ROADMAP item."""
    if cfg.checkpoint.directory:
        raise ValueError("checkpoint.directory: train/checkpoint.py is not ported yet "
                         "(ROADMAP Queue A item 2.3)")
    if cfg.mesh.pipe > 1:
        raise ValueError(f"mesh.pipe={cfg.mesh.pipe}: pipeline parallelism is not ported "
                         f"yet (ROADMAP Queue A item 6, parallel/pipeline.py)")
    axes = cfg.mesh.sizes()
    big = {k: v for k, v in axes.items() if k != "data" and v != 1}
    if big:
        raise ValueError(f"mesh {big}: no axis but data may span more than one process in "
                         f"the port so far (fsdp and model: ROADMAP Queue A item 3.1's "
                         f"sharding rule tables; seq, expert: item 6)")
    if cfg.fleet.dir:
        raise ValueError("fleet.dir: the fleet control plane is not ported yet "
                         "(ROADMAP Queue A item 6, resilience/)")
    if cfg.train.anomaly_defense:
        raise ValueError("train.anomaly_defense is not ported yet (ROADMAP Queue A item 6, "
                         "resilience/anomaly.py; it also needs checkpoints, item 2.3)")
    ev = getattr(cfg.data, "eval_dataset", "")
    if ev:
        raise ValueError(
            f"workload {cfg.workload!r} does not support data.eval_dataset (got {ev!r}); "
            "its eval stream is workload-defined — drop the flag (wide_deep, which honors "
            "it, is ROADMAP Queue A item 5)")


def run(cfg: RunConfig, build: Callable[[RunConfig, torch.device, Any], WorkloadParts],
        extra_callbacks: Iterable[cb.Callback] = (), device="cuda") -> RunResult:
    """``cluster.initialize(cfg.cluster)``, ``build_mesh(cfg.mesh)``,
    ``build(cfg, device, mesh) -> WorkloadParts`` (the model's weights
    then broadcast from process 0), then train ``cfg.train.num_steps``
    steps on this process's card (``device``: the card by default; no CPU
    fallback — pass ``device="cpu"`` for the plain versions, gloo between
    processes), each process fed its rows by a ``Prefetcher`` of depth 2
    through ``DevicePut``, with an eval pass every ``train.eval_every``
    steps and a final one of ``train.eval_batches`` batches when the
    workload has an eval surface (``RunResult.eval_metrics``). The steps
    and the eval passes run with
    ``torch.backends.cudnn.deterministic`` on, restored after: a step is
    bitwise repeatable, as the JAX package's is on a TPU (same-seed
    recovery relies on it), and with cuDNN's default convolution
    algorithms the card's ResNet steps were not. The process group, when
    this call started one, is left up for the caller (``cluster.
    shutdown``)."""
    check_supported(cfg)
    dev = cluster.initialize(cfg.cluster, device)
    if cfg.mesh.data > 1 and cluster.process_count() == 1:
        raise ValueError(
            f"mesh.data={cfg.mesh.data} spans more than one process, but this one runs "
            f"alone: launch it under torchrun --nproc_per_node={cfg.mesh.data} (or set "
            f"cluster.coordinator_address, cluster.num_processes and cluster.process_id)")
    mesh = build_mesh(cfg.mesh, dev)
    if cluster.is_chief():
        logger.info("mesh: %s", describe(mesh))
        logger.info("config:\n%s", config_lib.to_json(cfg))
    parts = build(cfg, dev, mesh)
    replicate(parts.model, mesh)
    optimizer = make_optimizer(cfg.optimizer, parts.model.parameters())
    state = init_train_state(parts.model, optimizer, seed=cfg.train.seed)
    metrics_logger = cb.MetricsLogger(
        every_n=cfg.train.log_every,
        batch_size=parts.batch_size or cfg.data.global_batch_size,
        model_flops_per_step=parts.flops_per_step if dev.type == "cuda" else None,
        history=True)
    callbacks: list[cb.Callback] = [metrics_logger, cb.NaNGuard(), *extra_callbacks]
    evaluator = None
    if (parts.eval_fn is not None and parts.eval_dataset_fn is not None
            and cfg.train.eval_batches > 0):
        evaluator = ShardedEvaluator(parts.eval_fn, mesh)
        if cfg.train.eval_every > 0:
            callbacks.append(_EvalCallback(cfg, parts, evaluator))
    step_fn = make_train_step(parts.loss_fn, StepOptions(
        grad_accum_steps=cfg.train.grad_accum_steps,
        compute_grad_norm=cfg.train.debug_metrics,
        check_grads_finite=cfg.train.debug_metrics,
        clip_grad_norm=cfg.train.clip_grad_norm or None), mesh=mesh)
    trainer = Trainer(step_fn, state, callbacks=callbacks)
    data = Prefetcher(parts.dataset_fn(state.step), depth=2, transform=DevicePut(dev))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    eval_metrics = None
    try:
        state = trainer.fit(data, num_steps=cfg.train.num_steps)
        if evaluator is not None:
            eval_metrics = evaluate(evaluator, trainer.state, parts, cfg.train.eval_batches)
            if cluster.is_chief():
                logger.info("final eval: %s", eval_metrics)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return RunResult(state, metrics_logger.history, dev, mesh, eval_metrics)


def evaluate(evaluator: ShardedEvaluator, state, parts: WorkloadParts,
             num_batches: int) -> dict:
    """Distributed eval of ``state`` over the evaluator's mesh:
    ``num_batches`` of the workload's eval stream, every summed statistic
    reduced bit-exactly (``train/evaluation.py``), ratios derived by
    ``derive_metrics``."""
    totals = evaluator.run(state, parts.eval_dataset_fn(num_batches), num_batches,
                           step=int(state.step))
    return derive_metrics(totals)


def evaluate_from_checkpoint(cfg: RunConfig, build, num_batches: int | None = None) -> dict:
    """Eval of a restored checkpoint: needs ``train/checkpoint.py``."""
    raise NotImplementedError("evaluate_from_checkpoint: train/checkpoint.py is not ported "
                              "yet (ROADMAP Queue A item 2.3)")


class _EvalCallback(cb.Callback):
    """A distributed eval every ``train.eval_every`` steps. Its wall time
    goes to every ``note_pause``-aware callback, so the cadence meters
    (steps/s, examples/s, MFU) measure the train loop, not the pauses."""

    def __init__(self, cfg: RunConfig, parts: WorkloadParts, evaluator: ShardedEvaluator,
                 clock=time.perf_counter):
        self.cfg, self.parts, self.evaluator = cfg, parts, evaluator
        self.clock = clock

    def on_step_end(self, trainer, step, metrics):
        if step % self.cfg.train.eval_every == 0:
            t0 = self.clock()
            m = evaluate(self.evaluator, trainer.state, self.parts,
                         self.cfg.train.eval_batches)
            pause = self.clock() - t0
            for other in trainer.callbacks:
                note = getattr(other, "note_pause", None)
                if note is not None:
                    note(pause)
            if cluster.is_chief():
                logger.info("eval @ step %d: %s", step, m)
