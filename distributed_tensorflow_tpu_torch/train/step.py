"""The train step — the port's counterpart of ``distributed_tensorflow_tpu/
train/step.py``: no jit, no donation. The state's parameters live in its
model and are updated in place by its optimizer.

- **Data parallelism**: with a mesh whose ``BATCH_AXES`` span more than
  one rank, each rank steps on its rows of the global batch and, after
  the backward pass (and the accumulation), the gradients are averaged
  over the batch axes in one all-reduce of one flat f32 buffer — before
  the global norm and the clipping, as JAX's gradients are global before
  ``clip_grad_norm`` (the norm is the optimizer's ``grad_norm``: with
  tables sharded over ``model``, the whole tree's) — with the loss and
  aux metrics at its end, so that every rank updates, decides and logs
  alike. The mean of the ranks' gradients of their local mean losses is
  the gradient of the global mean loss (BatchNorm statistics are
  global, ``models/resnet.py``). The gradients are reduced by their
  parameter's spec (the optimizer's ``layouts``, ``Optimizer.place``):
  a replicated or ``model``-sharded parameter's over the batch axes, an
  ``fsdp`` shard's — already summed over ``fsdp`` by ``gather_fsdp``'s
  reduce-scatter — over ``data`` alone, both divided by the batch shards.

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
- **The update span**: PyTorch updates in place, so a step that raises
  partway can leave a torn state (some parameters updated, or BatchNorm
  buffers moved by a forward whose update never came). ``TrainState.
  updating`` is True from the step's first in-place write (the forward
  when the model has buffers, else the optimizer update) until the step
  is counted; the loop's emergency save refuses a state caught inside it.
- **Checkpoint leaves**: ``state_leaves`` flattens the state into a fixed
  order of named tensors — ``step``, ``seed``, ``optimizer/count``, every
  ``model/<name>`` of ``model.state_dict()`` (parameters and buffers:
  BatchNorm running statistics), then the optimizer's state
  ``optimizer/<param index>/<key>`` (Adam's moments and step, the
  momentum trace, AdaGrad's ``sum``, FTRL's ``n`` and ``z``; a
  ``MultiOptimizer`` gives each parameter its group's keys) — and
  ``load_state_leaves`` is its inverse, copying into the state's tensors
  where they live. The generator needs no leaf:
  dropout is reseeded from ``step_seed(seed, step)`` every step. On a
  sharded state (the optimizer placed with shards, ``Optimizer.place``)
  ``whole_leaves`` gives the same names with each shard gathered whole
  (collective: every rank calls it), what a checkpoint writes, so a step
  dir restores at any mesh; ``load_state_leaves`` takes whole leaves and
  keeps this rank's shard of each.
- **Pipeline stages** (a ``PipelinedTransformer`` over ``pipe`` above 1):
  each rank holds the replicated ends and its stage's own Blocks, whose
  gradients are its own — the step reduces over the batch axes alone, and
  the global norm sums the stages' squares over ``pipe``
  (``Layout.stage``). A step decides ``skip_nonfinite`` on every rank
  alike (the flag all-reduced over the axes that shard parameters). The
  checkpoint leaves of such a state (its optimizer placed with a
  ``Layout.stage``) are the DENSE model's
  (``leaf_names``: every layer's, each optimizer leaf under the dense
  model's parameter index): ``whole_leaves`` broadcasts each layer's
  tensors from the stage that holds them (gathered over ``model`` there),
  and ``load_state_leaves`` keeps this stage's, so a step dir saved at one
  (S, V) restores in one process and at any other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..parallel.collectives import all_reduce, all_reduce_mean, all_reduce_min, broadcast
from ..parallel.collectives import axis_index
from ..parallel.mesh import BATCH_AXES, DATA, FSDP, MODEL, PIPE, mesh_axis_size
from ..parallel.sharding import RowGenerator
from .optimizers import Layout, Optimizer, state_layout

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
    #: True inside the update span (module docstring): the state is torn
    updating: bool = False


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


def mean_over_batch_axes(tensors: list[torch.Tensor], mesh, axes=BATCH_AXES
                         ) -> list[torch.Tensor]:
    """``tensors`` averaged over ``mesh``'s batch axes in one all-reduce
    of one flat f32 buffer, each returned in its own shape and dtype.
    ``axes``: the part of the batch axes to sum over (the rest summed
    already), the divisor still every batch shard."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = (all_reduce_mean(flat, BATCH_AXES, mesh) if tuple(axes) == BATCH_AXES
            else all_reduce(flat, axes, mesh) / mesh_axis_size(mesh, BATCH_AXES))
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
    #: the axes over which parameters (or a pipeline's stages) differ
    param_axes = () if mesh is None else tuple(a for a in (PIPE, FSDP, MODEL)
                                               if mesh.shape[a] > 1)
    model_sharded = bool(param_axes)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = state.optimizer.params
        if model_sharded and state.optimizer.mesh is not mesh:
            raise ValueError("the mesh's pipe, model or fsdp axis exceeds 1 but the optimizer "
                             "was not placed on it (Optimizer.place): its gradient reduction "
                             "and global norms would miss the other ranks' shards")
        state.generator.manual_seed(step_seed(state.seed, state.step))
        gen = (RowGenerator(state.generator, shards, shard) if data_parallel
               else state.generator)
        buffers = list(state.model.buffers()) if options.skip_nonfinite else []
        saved = [b.detach().clone() for b in buffers]
        # a model with buffers writes them in its train forward
        state.updating = any(True for _ in state.model.buffers())
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
            is_fsdp = [lay is not None and FSDP in lay.axes
                       for lay in (state.optimizer.layouts or [None] * len(grads))]
            rest = [g for g, f in zip(grads, is_fsdp) if not f]
            both = iter(mean_over_batch_axes([*rest, *(metrics[k] for k in names)], mesh))
            fsdp = iter(mean_over_batch_axes([g for g, f in zip(grads, is_fsdp) if f], mesh,
                                             (DATA,)) if any(is_fsdp) else ())
            grads = [next(fsdp) if f else next(both) for f in is_fsdp]
            metrics = dict(zip(names, both))
            loss = metrics["loss"]
        if options.compute_grad_norm or options.clip_grad_norm:
            gnorm = state.optimizer.grad_norm(grads)
            metrics["grad_norm"] = gnorm
        if options.clip_grad_norm:
            scale = torch.clamp(options.clip_grad_norm / (gnorm + 1e-9), max=1.0)
            grads = [g * scale.to(g.dtype) for g in grads]
        if options.check_grads_finite:
            metrics["grads_finite"] = _agreed(torch.stack(
                [torch.isfinite(g).all() for g in grads]).all().float(), param_axes, mesh)
        elif options.compute_grad_norm or options.clip_grad_norm:
            # one non-finite gradient poisons the norm: free same-step signal
            metrics["grads_finite"] = torch.isfinite(gnorm).float()
        if options.skip_nonfinite:
            ok = _agreed(torch.stack([torch.isfinite(loss)]
                                     + [torch.isfinite(g).all() for g in grads]).all().float(),
                         param_axes, mesh) > 0
            metrics["nonfinite"] = 1.0 - ok.float()
            if not bool(ok):
                with torch.no_grad():
                    for b, old in zip(buffers, saved):
                        b.copy_(old)
                state.updating = False
                return state, metrics  # nothing updated, step not counted
        state.updating = True
        state.optimizer.update(grads)
        state.step += 1
        state.updating = False
        return state, metrics

    return train_step


def _agreed(flag: torch.Tensor, axes, mesh) -> torch.Tensor:
    """A 0/1 flag of this rank's gradients made every rank's: its minimum
    over the axes over which the gradients differ."""
    return all_reduce_min(flag, axes, mesh) if axes else flag


def step_nonfinite(metrics) -> bool:
    """Host read of the per-step ``nonfinite`` flag (False when absent)."""
    flag = metrics.get("nonfinite")
    return flag is not None and float(flag) != 0.0


#: the leaves ahead of the model's, in this order
HEADER_LEAVES = ("step", "seed", "optimizer/count")


def state_leaves(state: TrainState) -> list[tuple[str, torch.Tensor]]:
    """The state as a fixed order of named tensors (module docstring):
    the live tensors themselves, not copies."""
    out = [("step", torch.tensor(state.step, dtype=torch.int64)),
           ("seed", torch.tensor(state.seed, dtype=torch.int64)),
           ("optimizer/count", torch.tensor(state.optimizer.count, dtype=torch.int64))]
    out += [(f"model/{k}", v) for k, v in state.model.state_dict().items()]
    opt_state = state.optimizer.opt.state_dict()["state"]
    for i in sorted(opt_state):
        for k in sorted(opt_state[i]):
            v = opt_state[i][k]
            if v is not None:
                out.append((f"optimizer/{i}/{k}",
                            v if isinstance(v, torch.Tensor) else torch.tensor(v)))
    return out


def leaf_layouts(state: TrainState) -> dict[str, Layout]:
    """The ``Layout`` of every leaf of ``state_leaves`` that is a shard
    (the optimizer's ``layouts``; an optimizer leaf's by ``state_layout``)."""
    opt = state.optimizer
    lays = list(getattr(opt, "layouts", None) or [])
    if not any(lay is not None for lay in lays):
        return {}
    by_id = {id(p): lay for p, lay in zip(opt.params, lays) if lay is not None}
    out = {f"model/{n}": by_id[id(p)] for n, p in state.model.named_parameters()
           if id(p) in by_id}
    for i, (lay, keys) in enumerate(zip(lays, opt.param_state_keys())):
        for key in keys if lay is not None else ():
            if state_layout(lay, key) is not None:
                out[f"optimizer/{i}/{key}"] = state_layout(lay, key)
    return out


def whole_leaves(state: TrainState) -> list[tuple[str, torch.Tensor]]:
    """``state_leaves`` with each shard gathered whole (module docstring);
    the live tensors themselves where nothing is sharded. A pipeline
    stage's state: the dense model's leaves (``leaf_names``), each layer's
    broadcast from its stage (collective over ``pipe``)."""
    lays = leaf_layouts(state)
    model = _staged(state)
    if model is None:
        return [(k, lays[k].gather(v) if k in lays else v) for k, v in state_leaves(state)]
    local = dict(state_leaves(state))
    out = []
    for name in leaf_names(state, state.optimizer.count):
        k = leaf_template(state, name)
        v = lays[k].gather(local[k]) if k in lays else local[k]
        layer = _layer_of(state, name)
        if layer is not None:  # a non-owner's template only lends its shape
            v = broadcast(v.to(model.mesh.device), PIPE, model.mesh,
                          src=model.stage_of(layer)).to(v.device)
        out.append((name, v))
    return out


def _staged(state: TrainState):
    """The state's model when its optimizer was placed as one stage of a
    pipeline over ``pipe`` above 1 (a ``Layout.stage``: a
    ``models/transformer.PipelinedTransformer``), else None."""
    lays = getattr(state.optimizer, "layouts", None) or ()
    return state.model if any(lay is not None and lay.stage for lay in lays) else None


def _param_names(state: TrainState) -> list[str]:
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for p in state.optimizer.params]


def _layer_of(state: TrainState, name: str) -> int | None:
    """The global layer of a dense leaf name, None for the ends."""
    parts = name.split("/")
    if parts[0] == "optimizer" and len(parts) == 3:
        parts = ["model", state.model.dense_param_names[int(parts[1])]]
    if parts[0] != "model" or not parts[1].startswith("layers."):
        return None
    return int(parts[1].split(".")[1])


def leaf_template(state: TrainState, name: str) -> str:
    """The leaf of ``state_leaves`` of the same whole shape and dtype as
    the checkpoint leaf ``name``: itself, but for a pipeline stage's state
    (``leaf_names``'s dense names) this stage's — its own layer's, or for
    another stage's layer the same tensor of this stage's first one — and
    an optimizer leaf under this state's parameter index."""
    model = _staged(state)
    if model is None:
        return name
    parts = name.split("/")
    opt = parts[0] == "optimizer" and len(parts) == 3
    if parts[0] != "model" and not opt:
        return name
    pname = model.dense_param_names[int(parts[1])] if opt else parts[1]
    if pname.startswith("layers."):
        _, layer, rest = pname.split(".", 2)
        if layer not in model.layers:
            pname = f"layers.{next(iter(model.layers))}.{rest}"
    if not opt:
        return f"model/{pname}"
    return f"optimizer/{_param_names(state).index(pname)}/{parts[2]}"


def whole_shape(state: TrainState, name: str, local) -> tuple[int, ...]:
    """The whole shape of leaf ``name`` whose shard here is ``local``."""
    lay = leaf_layouts(state).get(name)
    return tuple(local) if lay is None else lay.shape


def opt_leaf_shape(state: TrainState, name: str) -> tuple[int, ...]:
    """The whole shape of optimizer leaf ``name`` (``optimizer/<i>/<key>``,
    not a ``step``) before the optimizer holds it (``state_layout``)."""
    _, i, key = name.split("/")
    p = state.optimizer.params[int(i)]
    lay = (state.optimizer.layouts or [None] * (int(i) + 1))[int(i)]
    return state_layout(lay or Layout.of((), tuple(p.shape), None), key).shape


def leaf_names(state: TrainState, count: int) -> list[str]:
    """The names of this state's checkpoint leaves after ``count`` updates:
    ``state_leaves``' (the optimizer holds no state before its first); a
    pipeline stage's, the dense model's (module docstring)."""
    model = _staged(state)
    if model is None:
        return _local_leaf_names(state, count)
    names = [*HEADER_LEAVES, *(f"model/{k}" for k in model.dense_state_names)]
    if count > 0:
        keys = state.optimizer.param_state_keys()
        for j in range(len(model.dense_param_names)):
            i = int(leaf_template(state, f"optimizer/{j}/-").split("/")[1])
            names += [f"optimizer/{j}/{k}" for k in sorted(keys[i])]
    return names


def _local_leaf_names(state: TrainState, count: int) -> list[str]:
    """The names ``state_leaves`` gives after ``count`` updates."""
    names = [*HEADER_LEAVES, *(f"model/{k}" for k in state.model.state_dict())]
    if count > 0:
        names += [f"optimizer/{i}/{k}"
                  for i, keys in enumerate(state.optimizer.param_state_keys())
                  for k in sorted(keys)]
    return names


def _owns(state: TrainState, name: str) -> bool:
    """Whether this stage holds the dense leaf ``name``."""
    layer = _layer_of(state, name)
    return layer is None or state.model.stage_of(layer) == state.model.stage


def load_state_leaves(state: TrainState, leaves: dict[str, torch.Tensor]) -> TrainState:
    """Inverse of ``whole_leaves``: ``leaves`` (name -> whole host tensor,
    every name of ``leaf_names``; this rank's shard kept of each) copied
    into ``state`` in place — the model's
    tensors stay where they live (the card), the fused modules stay the
    model's, and the optimizer's state goes where its parameters are."""
    count = int(leaves["optimizer/count"])
    want = leaf_names(state, count)
    if sorted(leaves) != sorted(want):
        raise ValueError(f"checkpoint leaves {sorted(set(leaves) ^ set(want))[:8]} do not "
                         f"match the state's")
    if _staged(state) is not None:  # this stage's of the dense leaves
        dense = {leaf_template(state, n): n for n in want if _owns(state, n)}
        leaves = {k: leaves[dense[k]] for k in _local_leaf_names(state, count)}
    lays = leaf_layouts(state)
    leaves = {k: lays[k].shard(v) if k in lays else v for k, v in leaves.items()}
    with torch.no_grad():
        model_sd = {k[len("model/"):]: v for k, v in leaves.items() if k.startswith("model/")}
        state.model.load_state_dict(model_sd, strict=True)
        opt = state.optimizer.opt
        sd = opt.state_dict()
        sd["state"] = {}
        for name, v in leaves.items():
            parts = name.split("/")
            if len(parts) == 3 and parts[0] == "optimizer":
                i, key = int(parts[1]), parts[2]
                p = state.optimizer.params[i]
                # a tensor the optimizer keeps: on its parameter's device, or
                # (on the CPU, and Adam's step) a copy the optimizer may write
                sd["state"].setdefault(i, {})[key] = (
                    v.to(p.device) if p.device.type != "cpu" and key != "step" else v.clone())
        opt.load_state_dict(sd)
    state.step = int(leaves["step"])
    state.seed = int(leaves["seed"])
    state.optimizer.count = count
    state.updating = False
    return state
