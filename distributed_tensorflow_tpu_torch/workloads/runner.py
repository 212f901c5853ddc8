"""Workload runner — the one-device subset of ``distributed_tensorflow_tpu/
workloads/runner.py``: config → model on the device → optimizer → step
→ callback loop. Each workload module contributes a preset config and a
builder; everything else is shared.

The config tree keeps the JAX package's section names, so the same
``--section.key=value`` overrides parse; a config that asks for what the
port does not have yet raises with the ROADMAP item named: a checkpoint
directory, a mesh of more than one device, a pipeline, a fleet, the
anomaly defense, sequence parallelism, MoE.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Iterable

import torch

from ..data.text import TextDataConfig
from ..train import (
    OptimizerConfig,
    StepOptions,
    Trainer,
    callbacks as cb,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from ..utils import config as config_lib
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainSection:
    num_steps: int = 1000
    log_every: int = 100
    grad_accum_steps: int = 1
    seed: int = 0
    # Adds grad_norm + grads_finite to the step metrics (an extra pass
    # over every gradient per step)
    debug_metrics: bool = False
    # > 0: clip gradients to this global norm before the optimizer
    clip_grad_norm: float = 0.0
    # the numeric-anomaly defense needs checkpoints and quarantine
    # (not ported: ROADMAP Queue A item 6)
    anomaly_defense: bool = False


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The JAX package's axis names; the port runs on one device, so
    every axis must be 1 (``data=-1`` absorbs the one device)."""

    pipe: int = 1
    data: int = -1
    fsdp: int = 1
    seq: int = 1
    expert: int = 1
    model: int = 1


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str = ""  # non-empty: not ported yet (ROADMAP Queue A item 2)


@dataclasses.dataclass(frozen=True)
class FleetSection:
    dir: str = ""  # non-empty: not ported yet (ROADMAP Queue A item 6)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    workload: str = "gpt_lm"
    model: Any = None  # workload-specific config dataclass, set by preset
    mesh: MeshSpec = MeshSpec()
    data: Any = TextDataConfig()  # the workload's: TextDataConfig or data.pipeline.DataConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    train: TrainSection = TrainSection()
    checkpoint: CheckpointConfig = CheckpointConfig()
    fleet: FleetSection = FleetSection()


@dataclasses.dataclass
class WorkloadParts:
    """What a workload module's build() returns."""

    model: torch.nn.Module  # trainable, on the run's device
    loss_fn: Callable  # loss_fn(batch, generator) -> (loss, aux)
    # start_step -> host-batch iterable
    dataset_fn: Callable[[int], Iterable]
    flops_per_step: float | None = None  # analytic FORWARD flops, for MFU
    batch_size: int | None = None  # examples/step for throughput logs


@dataclasses.dataclass
class RunResult:
    state: Any
    history: list[dict]
    device: torch.device


def check_supported(cfg: RunConfig) -> None:
    """Refuse what this slice does not have, naming the ROADMAP item."""
    if cfg.checkpoint.directory:
        raise ValueError("checkpoint.directory: train/checkpoint.py is not ported yet "
                         "(ROADMAP Queue A item 2)")
    if cfg.mesh.pipe > 1:
        raise ValueError(f"mesh.pipe={cfg.mesh.pipe}: pipeline parallelism is not ported "
                         f"yet (ROADMAP Queue A item 6, parallel/pipeline.py)")
    axes = dataclasses.asdict(cfg.mesh)
    big = {k: v for k, v in axes.items() if v not in (1, -1) or (k != "data" and v != 1)}
    if big:
        raise ValueError(f"mesh {big}: the port trains on one device; meshes of more "
                         f"than one are ROADMAP Queue A item 3 (parallel/mesh.py)")
    if cfg.fleet.dir:
        raise ValueError("fleet.dir: the fleet control plane is not ported yet "
                         "(ROADMAP Queue A item 6, resilience/)")
    if cfg.train.anomaly_defense:
        raise ValueError("train.anomaly_defense is not ported yet (ROADMAP Queue A item 6, "
                         "resilience/anomaly.py; it also needs checkpoints, item 2)")


def run(cfg: RunConfig, build: Callable[[RunConfig, torch.device], WorkloadParts],
        extra_callbacks: Iterable[cb.Callback] = (), device="cuda") -> RunResult:
    """``build(cfg, device) -> WorkloadParts``, then train
    ``cfg.train.num_steps`` steps on ``device`` (the card by default; no
    CPU fallback — pass ``device="cpu"`` for the plain versions). The
    steps run with ``torch.backends.cudnn.deterministic`` on, restored
    after: a step is bitwise repeatable, as the JAX package's is on a TPU
    (same-seed recovery relies on it), and with cuDNN's default convolution
    algorithms the card's ResNet steps were not."""
    check_supported(cfg)
    dev = resolve_device(device)
    logger.info("config:\n%s", config_lib.to_json(cfg))
    parts = build(cfg, dev)
    optimizer = make_optimizer(cfg.optimizer, parts.model.parameters())
    state = init_train_state(parts.model, optimizer, seed=cfg.train.seed)
    metrics_logger = cb.MetricsLogger(
        every_n=cfg.train.log_every,
        batch_size=parts.batch_size or cfg.data.global_batch_size,
        model_flops_per_step=parts.flops_per_step if dev.type == "cuda" else None,
        history=True)
    callbacks: list[cb.Callback] = [metrics_logger, cb.NaNGuard(), *extra_callbacks]
    step_fn = make_train_step(parts.loss_fn, StepOptions(
        grad_accum_steps=cfg.train.grad_accum_steps,
        compute_grad_norm=cfg.train.debug_metrics,
        check_grads_finite=cfg.train.debug_metrics,
        clip_grad_norm=cfg.train.clip_grad_norm or None))
    trainer = Trainer(step_fn, state, callbacks=callbacks)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state = trainer.fit(parts.dataset_fn(state.step), num_steps=cfg.train.num_steps)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return RunResult(state, metrics_logger.history, dev)
