"""The train step — the port's counterpart of ``distributed_tensorflow_tpu/
train/step.py``: no jit, no donation. The state's parameters live in its
model and are updated in place by its optimizer.

- **Data parallelism**: with a mesh whose ``BATCH_AXES`` span more than
  one rank, each rank steps on its rows of the global batch and, after
  the backward pass (and the accumulation), the gradients are averaged
  over the batch axes in one all-reduce of one flat f32 buffer — before
  the global norm and the clipping, as JAX's gradients are global before
  ``clip_grad_norm`` — with the loss and aux metrics at its end, so that
  every rank updates, decides and logs alike. The mean of the ranks'
  gradients of their local mean losses is the gradient of the global
  mean loss (BatchNorm statistics are global, ``models/resnet.py``).

- **Gradient accumulation**: ``grad_accum_steps`` microbatches, the
  gradient the mean of the microbatch gradients (summed in f32), the
  loss the mean of the microbatch means.
- **RNG**: the state holds a seed and one ``torch.Generator``; each step
  reseeds it from ``(seed, step)``, so a step's dropout draws are a pure
  function of the two (a resumed run redraws the same masks). Under data
  parallelism the loss gets it as a ``parallel.sharding.RowGenerator``:
  each rank draws the global batch's masks and keeps its rows, so a row's
  mask is the one a single process on the global batch draws for it.
- **Model state**: buffers a model updates in its train forward
  (BatchNorm running statistics) are the JAX step's ``model_state``;
  under gradient accumulation each microbatch's forward sees the buffers
  the previous one left, as the JAX scan threads ``model_state``.
- **skip_nonfinite**: a step whose loss or any gradient is non-finite
  leaves the parameters, the buffers, the optimizer state AND the step
  counter unchanged and reports ``nonfinite = 1``; the JAX step selects
  the old state on the device, the port decides on the host (one scalar
  read, of the all-reduced loss and gradients, so every rank decides
  alike) and copies the buffers back from a snapshot taken before the
  forward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..parallel.collectives import all_reduce_mean
from ..parallel.collectives import axis_index
from ..parallel.mesh import BATCH_AXES, mesh_axis_size
from ..parallel.sharding import RowGenerator
from .optimizers import Optimizer, global_norm

#: loss_fn(batch, generator) -> (loss, aux metrics)
LossFn = Callable[[dict, torch.Generator], tuple[torch.Tensor, dict]]


@dataclasses.dataclass
class TrainState:
    """Everything a step reads and updates."""

    step: int
    model: torch.nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    seed: int = 0


def init_train_state(model: torch.nn.Module, optimizer: Optimizer, seed: int = 0) -> TrainState:
    device = next(model.parameters()).device
    return TrainState(step=0, model=model, optimizer=optimizer,
                      generator=torch.Generator(device=device), seed=seed)


def step_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step`` (the JAX step's fold_in)."""
    return (seed * 1_000_003 + step) & 0x7FFF_FFFF_FFFF_FFFF


@dataclasses.dataclass(frozen=True)
class StepOptions:
    grad_accum_steps: int = 1
    # debug signals (an extra pass over every gradient per step)
    compute_grad_norm: bool = False
    check_grads_finite: bool = False
    clip_grad_norm: float | None = None  # applied here, before the optimizer
    # no update on a non-finite loss/gradient (see module docstring)
    skip_nonfinite: bool = False


def mean_over_batch_axes(tensors: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """``tensors`` averaged over ``mesh``'s batch axes in one all-reduce
    of one flat f32 buffer, each returned in its own shape and dtype."""
    flat = all_reduce_mean(torch.cat([t.reshape(-1).float() for t in tensors]), BATCH_AXES,
                           mesh)
    return [f.view(t.shape).to(t.dtype)
            for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_train_step(loss_fn: LossFn, options: StepOptions = StepOptions(), mesh=None
                    ) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """``train_step(state, batch) -> (state, metrics)``: forward, backward
    and one optimizer update (the state is updated in place and
    returned). ``metrics`` holds device scalars: ``loss``, the loss
    function's aux metrics, and per the options ``grad_norm``,
    ``grads_finite`` and ``nonfinite``. ``mesh``: ``batch`` is this rank's
    rows, and the gradients and metrics are averaged over the batch axes
    (module docstring)."""
    accum = options.grad_accum_steps
    if accum < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {accum}")
    shards = 1 if mesh is None else mesh_axis_size(mesh, BATCH_AXES)
    data_parallel = shards > 1
    shard = axis_index(BATCH_AXES, mesh) if data_parallel else 0

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = state.optimizer.params
        state.generator.manual_seed(step_seed(state.seed, state.step))
        gen = (RowGenerator(state.generator, shards, shard) if data_parallel
               else state.generator)
        buffers = list(state.model.buffers()) if options.skip_nonfinite else []
        saved = [b.detach().clone() for b in buffers]
        if accum == 1:
            loss, aux = loss_fn(batch, gen)
            grads = torch.autograd.grad(loss, params)
            loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        else:
            for k, v in batch.items():
                if v.shape[0] % accum:
                    raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not divisible "
                                     f"by grad_accum_steps={accum}")
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss, auxes = torch.zeros((), device=params[0].device), []
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss_i, aux_i = loss_fn(mb, gen)
                for a, g in zip(grads, torch.autograd.grad(loss_i, params)):
                    a.add_(g.float() / accum)
                loss = loss + loss_i.detach() / accum
                auxes.append({k: v.detach() for k, v in aux_i.items()})
            aux = {k: torch.stack([a[k] for a in auxes]).mean(0) for k in auxes[0]}

        metrics = {"loss": loss.float(), **aux}
        if data_parallel:  # one all-reduce: the gradients, then the metrics
            names = sorted(metrics)
            both = mean_over_batch_axes([*grads, *(metrics[k] for k in names)], mesh)
            grads, metrics = both[:len(grads)], dict(zip(names, both[len(grads):]))
            loss = metrics["loss"]
        if options.compute_grad_norm or options.clip_grad_norm:
            gnorm = global_norm(grads)
            metrics["grad_norm"] = gnorm
        if options.clip_grad_norm:
            scale = torch.clamp(options.clip_grad_norm / (gnorm + 1e-9), max=1.0)
            grads = [g * scale.to(g.dtype) for g in grads]
        if options.check_grads_finite:
            metrics["grads_finite"] = torch.stack(
                [torch.isfinite(g).all() for g in grads]).all().float()
        elif options.compute_grad_norm or options.clip_grad_norm:
            # one non-finite gradient poisons the norm: free same-step signal
            metrics["grads_finite"] = torch.isfinite(gnorm).float()
        if options.skip_nonfinite:
            ok = torch.stack([torch.isfinite(loss)]
                             + [torch.isfinite(g).all() for g in grads]).all()
            metrics["nonfinite"] = 1.0 - ok.float()
            if not bool(ok):
                with torch.no_grad():
                    for b, old in zip(buffers, saved):
                        b.copy_(old)
                return state, metrics  # nothing updated, step not counted
        state.optimizer.update(grads)
        state.step += 1
        return state, metrics

    return train_step


def step_nonfinite(metrics) -> bool:
    """Host read of the per-step ``nonfinite`` flag (False when absent)."""
    flag = metrics.get("nonfinite")
    return flag is not None and float(flag) != 0.0
