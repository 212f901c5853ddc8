"""Workload runner — the data-parallel subset of ``distributed_tensorflow_tpu/
workloads/runner.py``: cluster → mesh → config → model on this process's
card → optimizer → step → init-or-restore (``checkpoint.directory``) →
prefetched feed from the restored step → callback loop (with
``train.summary_dir`` TensorBoard scalars, with ``train.profile`` a
profiler trace) → distributed eval
(``train.eval_every`` mid-train passes and a final one, through
``train/evaluation.py``'s ``ShardedEvaluator``). Each workload module
contributes a preset config and a builder; everything else is shared.
One process per card: under ``torchrun --nproc_per_node=N`` (or with
``cluster.coordinator_address`` set) the processes join one process
group, the ``data`` axis absorbs them, each steps and evaluates on its
rows of the global batch, and only the chief logs.

A workload whose parameter specs (``WorkloadParts.param_specs``, or the
matched ``param_rules``) shard parameters over the ``model`` axis may run
with ``mesh.model`` above 1 (Wide&Deep: tables range-sharded over
``model``; the transformers: megatron tensor parallelism and the
vocab-parallel head, ``models/transformer.py``), and one whose parts set
``fsdp`` (the transformers, as the JAX package's ``_transformer_common``)
with ``mesh.fsdp`` above 1 (``auto_fsdp_specs``; the batch split over
``data`` x ``fsdp``): each rank builds its shards, every tensor is set to
the value of the rank holding the same shard at index 0 of the other
axes (``sharding.place``), and the gradients are reduced by their spec
(``train/step.py``). The optimizer learns each parameter's spec
(``Optimizer.place``), so that a global norm — ``train.clip_grad_norm``,
``optimizer.clip_grad_norm``, ``train.debug_metrics`` — is the whole
tree's on every rank, and lamb's and adafactor's per-parameter sums are
the whole parameter's. A checkpoint gathers each shard whole
(``train/checkpoint.py``): a step dir restores at any mesh.

A workload whose parts do not ask for ``fsdp`` (Wide&Deep, ResNet-50,
the MLP and the CNN, as in the JAX package) still runs with ``mesh.fsdp``
above 1: its parameters stay as their rules place them, and the batch is
split over ``data`` x ``fsdp`` as JAX's ``batch_spec`` splits it. A
transformer whose ``model.seq_impl`` is set runs with ``mesh.seq`` above
1 (``parallel/ring_attention.py``): every ``seq`` rank of a data shard
reads that shard's rows and ends each step with the same gradients. The
two transformer workloads run with ``mesh.pipe`` above 1 as the JAX
package's pipelined family (``parallel/pipeline.py``, PP×TP with
``mesh.model``): ``train.pipeline_microbatches`` microbatches a step (0:
2·pipe·``train.pipeline_virtual``) and ``train.pipeline_virtual`` chunks
a stage; every ``pipe`` rank of a data shard reads its rows.

The config tree keeps the JAX package's section names, so the same
``--section.key=value`` overrides parse; a config that asks for what the
port does not have yet raises with the ROADMAP item named: ``expert``
above 1 and MoE (item 6c), a fleet and the anomaly defense (item 6e).
Refused too, because the ranks would only repeat each other's work (JAX
runs them): ``model`` above 1 for a workload that shards nothing over
it, ``seq`` above 1 for a model without ``seq_impl`` or a workload
without attention, ``pipe`` above 1 for a workload with no pipelined
family (``wide_deep``, ``resnet50_imagenet``, ``mnist_mlp``,
``cifar10_cnn``) or together with ``seq`` above 1 (the stages run no
sequence parallelism). An explicit ``data.eval_dataset`` a workload does
not consume raises too.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Iterable

import torch

from ..data.pipeline import DevicePut, Prefetcher
from ..data.text import TextDataConfig
from ..parallel import cluster
from ..parallel.cluster import ClusterConfig
from ..parallel.mesh import FSDP, MODEL, PIPE, SEQ, MeshSpec, build_mesh, describe
from ..parallel import sharding
from ..train import (
    OptimizerConfig,
    ShardedEvaluator,
    StepOptions,
    Trainer,
    callbacks as cb,
    checkpoint as ckpt_lib,
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
    # the pipeline schedule (mesh.pipe above 1, the transformer workloads):
    # microbatches a step (0 = 2·pipe·pipeline_virtual) and the chunks a
    # stage holds (1 = GPipe, above 1 the interleaved schedule)
    pipeline_microbatches: int = 0
    pipeline_virtual: int = 1
    # the JAX package's pipeline-memory estimate before a pipelined run on
    # the accelerator (not ported: ROADMAP Queue A item 6g; logged once)
    check_pipeline_memory: bool = True
    eval_batches: int = 16  # a pass's batches; 0 = no eval at all
    # Adds grad_norm + grads_finite to the step metrics (an extra pass
    # over every gradient per step)
    debug_metrics: bool = False
    # > 0: clip gradients to this global norm before the optimizer
    clip_grad_norm: float = 0.0
    # the numeric-anomaly defense (not ported: ROADMAP Queue A item 6)
    anomaly_defense: bool = False
    # a torch.profiler Chrome trace of steps 10-15 into profile_dir (the
    # JAX config's default directory, so one override list parses alike)
    profile: bool = False
    profile_dir: str = "/tmp/dtf_tpu_profile"
    # non-empty: TensorBoard scalar event files there (chief only, at
    # log_every)
    summary_dir: str = ""


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
    checkpoint: ckpt_lib.CheckpointConfig = ckpt_lib.CheckpointConfig()
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
    # the placement table of the model's parameters (None: all replicated)
    param_rules: sharding.PartitionRules | None = None
    # each parameter's spec as the model was built with it (the rules,
    # then auto_fsdp_specs); None: the rules matched on the model
    param_specs: dict | None = None
    # shard what the rules replicate over fsdp (JAX's fsdp=True)
    fsdp: bool = False
    # model -> optimizer, when the workload builds its own (None: the
    # runner's make_optimizer(cfg.optimizer))
    optimizer_fn: Callable | None = None
    # prefix of the eval AUC key ("train_" when the eval stream draws from
    # the training file)
    eval_metric_prefix: str = ""
    # did build() read cfg.data.eval_dataset? (an explicit one that it did
    # not read is refused)
    consumed_eval_dataset: bool = False


@dataclasses.dataclass
class RunResult:
    state: Any
    history: list[dict]
    device: torch.device
    mesh: Any = None
    eval_metrics: dict | None = None  # the final eval's, when the workload has one
    preempted: bool = False  # the run stopped on a preemption save


#: the workloads with a pipelined family (``mesh.pipe`` above 1)
PIPELINED_WORKLOADS = ("gpt_lm", "bert_pretrain")


def check_supported(cfg: RunConfig) -> None:
    """Refuse what this slice does not have, naming the ROADMAP item."""
    axes = cfg.mesh.sizes()
    big = {k: v for k, v in axes.items() if k not in (PIPE, "data", FSDP, SEQ, MODEL)
           and v != 1}
    if big:
        raise ValueError(f"mesh {big}: no axis but pipe, data, fsdp, seq and model may span "
                         f"more than one process in the port so far (expert: MoE, ROADMAP "
                         f"Queue A item 6c)")
    if cfg.mesh.pipe > 1:
        if cfg.workload not in PIPELINED_WORKLOADS:
            raise ValueError(f"mesh.pipe={cfg.mesh.pipe}: workload {cfg.workload!r} has no "
                             f"pipelined family (only {PIPELINED_WORKLOADS} do: ROADMAP Queue "
                             f"A item 6b), so its pipe ranks would only repeat each other's "
                             f"work; spread its batch over mesh.data")
        if cfg.mesh.seq > 1:
            raise ValueError(f"mesh.pipe={cfg.mesh.pipe} with mesh.seq={cfg.mesh.seq}: the "
                             f"pipeline's stages run no sequence parallelism (seq_impl is "
                             f"None inside them, as in the JAX package), so the seq ranks "
                             f"would only repeat each other's work")
    if cfg.mesh.seq != 1:
        if not hasattr(cfg.model, "seq_impl"):
            raise ValueError(f"mesh.seq={cfg.mesh.seq}: workload {cfg.workload!r} has no "
                             f"attention to split over seq, so its seq ranks would only repeat "
                             f"each other's work; spread its batch over mesh.data")
        if cfg.model.seq_impl is None:
            raise ValueError(f"mesh.seq={cfg.mesh.seq}: model.seq_impl is unset, so the seq "
                             f"ranks would only repeat each other's work; set model.seq_impl "
                             f"to ring, ulysses or allgather")
    if cfg.fleet.dir:
        raise ValueError("fleet.dir: the fleet control plane is not ported yet "
                         "(ROADMAP Queue A item 6, resilience/)")
    if cfg.train.anomaly_defense:
        raise ValueError("train.anomaly_defense is not ported yet (ROADMAP Queue A item 6, "
                         "resilience/anomaly.py)")


def _check_eval_dataset_consumed(cfg: RunConfig, parts: WorkloadParts) -> None:
    """An explicit ``data.eval_dataset`` the workload does not read is
    refused, not silently replaced by its default stream."""
    ev = getattr(cfg.data, "eval_dataset", "")
    if ev and not parts.consumed_eval_dataset:
        raise ValueError(
            f"workload {cfg.workload!r} does not support data.eval_dataset (got {ev!r}); its "
            f"eval stream is workload-defined — drop the flag or use a workload that honors "
            f"it (wide_deep)")


def setup(cfg: RunConfig, build, device="cuda"):
    """``check_supported``, the cluster, the mesh, ``build`` and
    ``prepare``: ``(device, mesh, parts, optimizer)`` — what ``run``
    trains, and what a benchmark of a workload starts from."""
    check_supported(cfg)
    dev = cluster.initialize(cfg.cluster, device)
    spans = {a: v for a, v in cfg.mesh.sizes().items() if v > 1}
    if spans and cluster.process_count() == 1:
        raise ValueError(
            f"mesh {spans} spans more than one process, but this one runs alone: launch it "
            f"under torchrun --nproc_per_node={math.prod(spans.values())} (or set "
            f"cluster.coordinator_address, cluster.num_processes and cluster.process_id)"
            + ("; or pass --mesh.data=-1 to let the data axis take the processes there are"
               if "data" in spans else "")
            + ("; each pipeline stage is a process of its own" if PIPE in spans else ""))
    mesh = build_mesh(cfg.mesh, dev)
    if cluster.is_chief():
        logger.info("mesh: %s", describe(mesh))
        logger.info("config:\n%s", config_lib.to_json(cfg))
        if mesh.shape[PIPE] > 1 and cfg.train.check_pipeline_memory and dev.type == "cuda":
            logger.info("train.check_pipeline_memory: the pipeline-memory estimate is not "
                        "ported (ROADMAP Queue A item 6g); running without it")
    parts = build(cfg, dev, mesh)
    return dev, mesh, parts, prepare(cfg, parts, mesh)


def param_specs(cfg: RunConfig, parts: WorkloadParts, mesh) -> dict:
    """The specs of ``parts.model``'s parameters on ``mesh``: the ones it
    was built with, else its rule table matched; refused where the mesh
    spans ``model`` and the workload places nothing there. With ``fsdp``
    above 1 and ``parts.fsdp`` unset, the parameters keep their rules'
    specs and ``fsdp`` only splits the batch (module docstring)."""
    specs = (parts.param_specs if parts.param_specs is not None
             else sharding.replicated_specs(parts.model) if parts.param_rules is None
             else sharding.specs_from_rules(parts.model, parts.param_rules))
    if mesh.shape[MODEL] > 1 and MODEL not in sharding.sharded_axes(specs):
        raise ValueError(f"mesh.model={mesh.shape[MODEL]}: workload {cfg.workload!r} places "
                         f"nothing on the model axis (its parts give no rule table over "
                         f"it), so it may not span more than one process there")
    return specs


def prepare(cfg: RunConfig, parts: WorkloadParts, mesh):
    """``parts`` on ``mesh``: the parameters' specs (``param_specs``), the
    weights placed (module docstring) and the optimizer built and placed
    alike. Returns the optimizer."""
    _check_eval_dataset_consumed(cfg, parts)
    specs = param_specs(cfg, parts, mesh)
    sharding.place(parts.model, mesh, specs)
    optimizer = (parts.optimizer_fn(parts.model) if parts.optimizer_fn is not None
                 else make_optimizer(cfg.optimizer, parts.model.parameters()))
    optimizer.place(mesh, specs, parts.model)
    return optimizer


def run(cfg: RunConfig, build: Callable[[RunConfig, torch.device, Any], WorkloadParts],
        extra_callbacks: Iterable[cb.Callback] = (), device="cuda") -> RunResult:
    """``cluster.initialize(cfg.cluster)``, ``build_mesh(cfg.mesh)``,
    ``build(cfg, device, mesh) -> WorkloadParts`` (the model's weights
    then broadcast from process 0), with ``checkpoint.directory`` the
    newest checkpoint restored into that state (``init_or_restore``: the
    model's tensors overwritten where they live, the optimizer's state,
    the step) and the stream started at the restored step, then train up to
    ``cfg.train.num_steps`` steps on this process's card (``device``: the card by default; no CPU
    fallback — pass ``device="cpu"`` for the plain versions, gloo between
    processes), each process fed its rows by a ``Prefetcher`` of depth 2
    through ``DevicePut``, with an eval pass every ``train.eval_every``
    steps and a final one of ``train.eval_batches`` batches when the
    workload has an eval surface (``RunResult.eval_metrics``). With a
    directory a ``CheckpointCallback`` saves on the cadence, on an agreed
    SIGTERM (the run then stops cleanly, ``RunResult.preempted``) and at
    the end; it runs after every other callback, so a step's save sees
    what they did at that step. The steps
    and the eval passes run with
    ``torch.backends.cudnn.deterministic`` on, restored after: a step is
    bitwise repeatable, as the JAX package's is on a TPU (same-seed
    recovery relies on it), and with cuDNN's default convolution
    algorithms the card's ResNet steps were not. The process group, when
    this call started one, is left up for the caller (``cluster.
    shutdown``)."""
    dev, mesh, parts, optimizer = setup(cfg, build, device)
    state = init_train_state(parts.model, optimizer, seed=cfg.train.seed)
    ckpt = None
    if cfg.checkpoint.directory:
        ckpt = ckpt_lib.Checkpointer(cfg.checkpoint)
        try:
            state, restored = ckpt_lib.init_or_restore(ckpt, state)
            ckpt.save_config(cfg)
        except BaseException:
            ckpt.close()
            raise
        if restored and cluster.is_chief():
            logger.info("resuming from checkpoint step %d", state.step)
    metrics_logger = cb.MetricsLogger(
        every_n=cfg.train.log_every,
        batch_size=parts.batch_size or cfg.data.global_batch_size,
        model_flops_per_step=parts.flops_per_step if dev.type == "cuda" else None,
        history=True)
    callbacks: list[cb.Callback] = [metrics_logger, cb.NaNGuard()]
    if cfg.train.summary_dir:
        # after metrics_logger, so its fetch of this step is fresh
        callbacks.append(cb.SummaryWriter(cfg.train.summary_dir, every_n=cfg.train.log_every,
                                          metrics_logger=metrics_logger))
    if cfg.train.profile:
        callbacks.append(cb.Profiler(cfg.train.profile_dir))
    callbacks.extend(extra_callbacks)
    evaluator = None
    if (parts.eval_fn is not None and parts.eval_dataset_fn is not None
            and cfg.train.eval_batches > 0):
        evaluator = ShardedEvaluator(parts.eval_fn, mesh)
        if cfg.train.eval_every > 0:
            callbacks.append(_EvalCallback(cfg, parts, evaluator))
    if ckpt is not None:
        callbacks.append(cb.CheckpointCallback(ckpt))
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
    ok = False
    try:
        state = trainer.fit(data, num_steps=cfg.train.num_steps)
        if evaluator is not None:
            eval_metrics = evaluate(evaluator, trainer.state, parts, cfg.train.eval_batches)
            if cluster.is_chief():
                logger.info("final eval: %s", eval_metrics)
        ok = True
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if ckpt is not None:
            _close(ckpt, raise_errors=ok)
    return RunResult(state, metrics_logger.history, dev, mesh, eval_metrics, trainer.preempted)


def _close(ckpt: ckpt_lib.Checkpointer, raise_errors: bool) -> None:
    """Drain and close ``ckpt``; on a failed run its own error is logged,
    not raised over the failure."""
    if raise_errors:
        ckpt.close()
        return
    try:
        ckpt.close()
    except Exception:
        logger.exception("closing the checkpointer after a failed run")


def evaluate(evaluator: ShardedEvaluator, state, parts: WorkloadParts,
             num_batches: int) -> dict:
    """Distributed eval of ``state`` over the evaluator's mesh:
    ``num_batches`` of the workload's eval stream, every summed statistic
    reduced bit-exactly (``train/evaluation.py``), ratios derived by
    ``derive_metrics``."""
    totals = evaluator.run(state, parts.eval_dataset_fn(num_batches), num_batches,
                           step=int(state.step))
    return derive_metrics(totals, parts.eval_metric_prefix)


def evaluate_from_checkpoint(cfg: RunConfig, build, num_batches: int | None = None,
                             step: int | None = None, device="cuda") -> dict:
    """Eval of a checkpoint, no Trainer (the reference evaluated from
    ``latest_checkpoint``): the workload built on ``device`` (the card by
    default), the newest step of ``cfg.checkpoint.directory`` (or
    ``step``) restored into it, and ``num_batches`` (default
    ``train.eval_batches``) of its eval stream through the
    ``ShardedEvaluator`` with deterministic cuDNN, as the runner's own
    eval. Returns the metrics with the restored ``step``."""
    if not cfg.checkpoint.directory:
        raise ValueError("evaluate_from_checkpoint needs checkpoint.directory")
    _, mesh, parts, optimizer = setup(cfg, build, device)
    if parts.eval_fn is None or parts.eval_dataset_fn is None:
        raise ValueError(f"workload {cfg.workload!r} has no eval surface")
    state = init_train_state(parts.model, optimizer, seed=cfg.train.seed)
    ckpt = ckpt_lib.Checkpointer(dataclasses.replace(cfg.checkpoint, save_on_preemption=False))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state, restored = ckpt_lib.init_or_restore(ckpt, state, step=step)
        if not restored:
            raise FileNotFoundError(f"no checkpoint found in {cfg.checkpoint.directory}")
        n = num_batches if num_batches is not None else cfg.train.eval_batches
        metrics = evaluate(ShardedEvaluator(parts.eval_fn, mesh), state, parts, n)
        metrics["step"] = int(state.step)
        if cluster.is_chief():
            logger.info("eval from checkpoint @ step %d: %s", state.step, metrics)
        return metrics
    finally:
        torch.backends.cudnn.deterministic = deterministic
        ckpt.close()


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
