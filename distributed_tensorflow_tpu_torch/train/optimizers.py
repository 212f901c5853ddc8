"""Optimizers + LR schedules — the port's counterpart of
``distributed_tensorflow_tpu/train/optimizers.py`` (optax there,
``torch.optim`` here, with optax's semantics kept exactly):

- the schedule is evaluated at the update count BEFORE it increments, so
  with warmup the first update has lr 0 (``optax.join_schedules`` of
  ``linear_schedule(0, lr, warmup)`` and the decay);
- ``adamw`` decays EVERY parameter (optax.adamw has no mask), eps outside
  the square root: ``torch.optim.AdamW`` over one group does that;
- the coupled L2 of ``sgd``/``momentum``/``adam`` decays kernels only
  (``ndim > 1``) and is added to the gradient before everything else,
  clipping included (the JAX chain puts ``add_decayed_weights``
  outermost);
- ``clip_grad_norm`` is optax's ``clip_by_global_norm``
  (``g * max / norm`` when ``norm >= max``), applied before the update;
  the norm is the whole tree's: after ``place`` tells the optimizer each
  parameter's spec (``parallel/sharding.py``), the squares of the shards
  over ``model`` or ``fsdp`` are summed over those axes and the
  replicated ones' counted once (``global_norm``), as JAX's norm is over
  its sharded arrays. The optimizer's state lives in its parameter's
  shard (``state_layout``);
- ``adagrad`` is ``optax.adagrad``, written out (``Adagrad``): the
  accumulator starts at 0.1 and the update is ``g * rsqrt(sum + eps)``
  (``torch.optim.Adagrad`` starts at 0 and divides by ``sqrt(sum) +
  eps``);
- ``ftrl`` is the JAX package's own FTRL-Proximal (TF's ``ApplyFtrl``,
  ``Ftrl``) line for line, with no coupled L2;
- ``make_multi_optimizer`` labels each parameter by the first regex of
  its rules that its path (``parallel/sharding.param_path``) matches, else
  ``default``, and runs each group's own chain (schedule, clipping,
  coupled L2), as ``optax.multi_transform`` does: a clip norm is a
  group's.

- ``rmsprop`` is ``optax.rmsprop(lr, momentum=cfg.momentum, eps=cfg.eps)``
  (``RMSprop``): ``nu`` from 0 at decay 0.9, ``g * rsqrt(nu + eps)`` (eps
  inside the root, not ``torch.optim.RMSprop``'s ``sqrt(nu) + eps``),
  times ``-lr``, then a momentum trace of those updates; coupled L2;
- ``lamb`` is ``optax.lamb`` (``Lamb``): Adam's moments with
  ``eps_root=0``, the decoupled decay on EVERY parameter, the trust ratio
  ‖p‖/‖u‖ per parameter (1 where either is 0), then ``-lr``; no coupled
  L2;
- ``adafactor`` is ``optax.adafactor(lr)`` with its defaults
  (``Adafactor``): factored second moments for a parameter whose two
  largest dims are both at least 128, a full one otherwise, decay
  ``1 - (t+1)^-0.8``, the update clipped to block RMS 1, times ``lr`` and
  the parameter's RMS (at least 1e-3), then negated; coupled L2.
  ``lamb``'s trust ratio and ``adafactor``'s statistics are over a whole
  parameter: on a shard (``place``), each sum of squares, and each of
  adafactor's row and column means, is summed over the axes that shard
  the dims it reduces (``Layout``), padded rows left out.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Iterable, Sequence

import torch

from ..parallel.collectives import all_reduce
from ..parallel.mesh import AXIS_NAMES

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"  # sgd|momentum|adam|adamw|adagrad|ftrl|rmsprop|lamb|adafactor
    learning_rate: float = 0.01
    # schedule: constant|cosine|warmup_cosine|exponential|linear
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0  # required by cosine/linear decays
    end_lr_factor: float = 0.0  # final lr = learning_rate * factor
    decay_rate: float = 0.96  # exponential
    decay_steps: int = 1000  # exponential
    momentum: float = 0.9
    nesterov: bool = False
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # ftrl
    lr_power: float = -0.5
    l1: float = 0.0
    l2: float = 0.0
    clip_grad_norm: float = 0.0  # 0 = off; optax.clip_by_global_norm semantics


# -- optax's schedules, as plain functions of the update count -------------


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def sched(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return sched


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay requires positive decay_steps, got {decay_steps}")

    def sched(count):
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return sched


def _exponential(init: float, transition_steps: int, rate: float) -> Schedule:
    if transition_steps <= 0 or rate == 0:
        return lambda count: init
    return lambda count: init if count <= 0 else init * rate ** (count / transition_steps)


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def sched(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out

    return sched


def make_schedule(cfg: OptimizerConfig) -> Schedule:
    """``lr(count)`` for update count ``count`` (0 for the first update)."""
    lr = cfg.learning_rate
    if cfg.schedule == "constant":
        base = lambda count: lr  # noqa: E731
    elif cfg.schedule == "cosine":
        base = _cosine(lr, max(cfg.total_steps - cfg.warmup_steps, 1), cfg.end_lr_factor)
    elif cfg.schedule == "warmup_cosine":
        end = lr * cfg.end_lr_factor
        return _join([_linear(0.0, lr, cfg.warmup_steps),
                      _cosine(lr, max(cfg.total_steps, 1) - cfg.warmup_steps,
                              0.0 if lr == 0 else end / lr)],
                     [cfg.warmup_steps])
    elif cfg.schedule == "exponential":
        base = _exponential(lr, cfg.decay_steps, cfg.decay_rate)
    elif cfg.schedule == "linear":
        base = _linear(lr, lr * cfg.end_lr_factor, max(cfg.total_steps - cfg.warmup_steps, 1))
    else:
        raise ValueError(f"Unknown schedule '{cfg.schedule}'")
    if cfg.warmup_steps > 0:
        return _join([_linear(0.0, lr, cfg.warmup_steps), base], [cfg.warmup_steps])
    return base


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a tensor is split over a mesh: ``dims[i]`` is ``(global size,
    axis)`` of its dim i (axis None: whole). A shard's rows past the global
    size are padding (``sharding.shard_tensor``). ``stage``: the axis
    (``pipe``) over which the tensor is one rank's own — a pipeline stage's
    parameter, its row of the stacked ``[S, ...]`` leaf, whose pipe dim the
    rank's tensor no longer has: the other ranks of that axis hold other
    tensors, not shards of this one."""

    dims: tuple
    mesh: object
    stage: str | None = None

    @classmethod
    def of(cls, spec, shape, mesh, stage: str | None = None) -> "Layout":
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        return cls(tuple((n, e if isinstance(e, str) and mesh.shape[e] > 1 else None)
                         for n, e in zip(shape, spec)), mesh, stage)

    @property
    def spec(self) -> tuple:
        return tuple(a for _, a in self.dims)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(n for n, _ in self.dims)

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole tensor (every rank of its axes takes part)."""
        from ..parallel.sharding import gather_tensor

        return gather_tensor(shard, self.spec, self.mesh, self.shape)

    def shard(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole tensor."""
        from ..parallel.sharding import shard_tensor

        return shard_tensor(whole, self.spec, self.mesh)

    @property
    def axes(self) -> tuple[str, ...]:
        """The axes that shard it (its ``stage`` axis among them), in mesh
        order."""
        return tuple(a for a in AXIS_NAMES if a in {self.stage, *(ax for _, ax in self.dims)})

    @property
    def numel(self) -> int:
        return math.prod(n for n, _ in self.dims)

    def drop(self, dim: int) -> "Layout":
        return Layout(self.dims[:dim] + self.dims[dim + 1:], self.mesh, self.stage)

    def mask(self, t: torch.Tensor) -> torch.Tensor | None:
        """True on the shard's real (unpadded) entries; None when none is
        padding."""
        from ..parallel.collectives import axis_index

        out = None
        for d, (n, a) in enumerate(self.dims):
            if a is None or t.shape[d] * self.mesh.shape[a] == n:
                continue
            idx = axis_index(a, self.mesh) * t.shape[d] + torch.arange(t.shape[d],
                                                                      device=t.device)
            m = (idx < n).reshape([-1 if i == d else 1 for i in range(t.dim())])
            out = m if out is None else out & m
        return out

    def sum(self, t: torch.Tensor, dims=None, keepdim: bool = False) -> torch.Tensor:
        """``t`` summed over ``dims`` (all when None) of the whole tensor:
        the shard's sum, summed over the axes that shard those dims."""
        dims = list(range(t.dim())) if dims is None else list(dims)
        axes = tuple(a for a in AXIS_NAMES
                     if a in {self.dims[d][1] for d in dims} - {None})
        out = t.sum(dims, keepdim=keepdim)
        return all_reduce(out, axes, self.mesh) if axes else out


def state_layout(lay: "Layout", key: str) -> "Layout | None":
    """The ``Layout`` of the optimizer state leaf ``key`` of a parameter
    shard laid out as ``lay`` (JAX's ``opt_state_specs``: the state shards
    with its parameter, a count is whole): adafactor's ``v_row`` drops the
    dim it averages over (the largest, ``factored_dims``' d0), ``v_col``
    the second-largest; ``step`` is None (whole)."""
    if key == "step":
        return None
    if key in ("v_row", "v_col"):
        d1, d0 = factored_dims(lay.shape)
        return lay.drop(d0 if key == "v_row" else d1)
    return lay


def global_norm(tensors: Iterable[torch.Tensor], layouts: Sequence["Layout | None"] = (),
                mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax.global_norm).
    Where ``layouts[i]`` shards ``tensors[i]`` (``Layout.axes``), it is this
    rank's shard: the squares of the shards over each set of axes are
    summed over those axes and the others' counted once, so every rank gets
    the norm of the whole tree. A pipeline stage's own tensors (``stage``)
    are summed over ``pipe`` so (and over ``model`` too where they are
    tensor-parallel shards), the replicated ends counted once."""
    tensors = list(tensors)
    axes = [() if lay is None else lay.axes for lay in layouts] or [()] * len(tensors)
    if not any(axes) or mesh is None:
        return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))
    squares = [t.float().pow(2).sum() for t in tensors]
    total = None
    for group in dict.fromkeys(a for a in axes if a):
        part = all_reduce(torch.stack([q for q, a in zip(squares, axes) if a == group]).sum(),
                          group, mesh)
        total = part if total is None else total + part
    rest = [q for q, a in zip(squares, axes) if not a]
    return torch.sqrt(total + torch.stack(rest).sum() if rest else total)


def _layouts(params: Sequence[torch.nn.Parameter], specs, model, mesh
             ) -> list["Layout | None"]:
    """For each of ``params``: its ``Layout`` over ``mesh`` when a shard
    (``specs``: ``model``'s parameter names to their placement,
    ``parallel/sharding.py``; the whole shapes are the model's
    ``global_shapes`` where it has them, else the shard's times the axis
    sizes) or a pipeline stage's own (a ``StageSpec``, over ``pipe``
    above 1), else None."""
    from ..parallel.mesh import PIPE
    from ..parallel.sharding import StageSpec, spec_axes

    names = {id(p): n for n, p in model.named_parameters()}
    shapes = getattr(model, "global_shapes", {})
    out = []
    for p in params:
        name = names.get(id(p))
        spec = specs.get(name, ())
        stage = PIPE if isinstance(spec, StageSpec) and mesh.shape[PIPE] > 1 else None
        spec = tuple(spec)
        if not stage and not any(mesh.shape[a] > 1 for a in spec_axes(spec)):
            out.append(None)
            continue
        shape = shapes.get(name) or tuple(
            n * (mesh.shape[e] if isinstance(e, str) else 1)
            for n, e in zip(p.shape, spec + (None,) * (p.dim() - len(spec))))
        out.append(Layout.of(spec, shape, mesh, stage))
    return out


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad`` (``scale_by_rss`` then the learning rate): per
    coordinate ``sum += g*g`` (from ``initial_accumulator_value``) and
    ``p += -lr * (g * rsqrt(sum + eps))`` where ``sum > 0`` (0 elsewhere),
    in f32. State: ``sum``."""

    def __init__(self, params, lr: float = 0.0, eps: float = 1e-7,
                 initial_accumulator_value: float = 0.1):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      initial_accumulator_value=initial_accumulator_value))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["sum"] = torch.full(p.shape, group["initial_accumulator_value"],
                                           dtype=torch.float32, device=p.device)
                g = p.grad.float()
                s = st["sum"]
                s.add_(g * g)
                inv = torch.where(s > 0, torch.rsqrt(s + eps), 0.0)
                p.add_((inv * g * -lr).to(p.dtype))


class Ftrl(torch.optim.Optimizer):
    """FTRL-Proximal as the JAX package's ``train/optimizers.ftrl``
    (``tf.train.FtrlOptimizer``'s ``ApplyFtrl``), per coordinate with
    ``p = -lr_power``::

        n+ = n + g²;  σ = (n+^p − n^p) / lr;  z+ = z + g − σ·w
        w+ = 0 if |z+| ≤ l1 else −(z+ − sign(z+)·l1) / (n+^p / lr + 2·l2)

    and ``w += w+ - w``; a step at lr 0 changes nothing. State: ``z``
    (from 0) and ``n`` (from ``initial_accumulator_value``), f32."""

    def __init__(self, params, lr: float = 0.0, lr_power: float = -0.5, l1: float = 0.0,
                 l2: float = 0.0, initial_accumulator_value: float = 0.1):
        super().__init__(params, dict(lr=lr, lr_power=lr_power, l1=l1, l2=l2,
                                      initial_accumulator_value=initial_accumulator_value))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr = group["lr"]
            if not lr > 0.0:  # the JAX update masks it to a no-op
                for p in group["params"]:
                    if p.grad is not None:
                        self._state(p, group)
                continue
            p_ = group["lr_power"]
            l1, l2 = group["l1"], group["l2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self._state(p, group)
                g = p.grad.float()
                w32 = p.float()
                z, n = st["z"], st["n"]
                n_new = n + g * g
                sigma = (torch.pow(n_new, -p_) - torch.pow(n, -p_)) / lr
                z_new = z + g - sigma * w32
                quad = torch.pow(n_new, -p_) / lr + 2.0 * l2
                w_new = torch.where(torch.abs(z_new) <= l1, 0.0,
                                    -(z_new - torch.sign(z_new) * l1) / quad)
                p.add_((w_new - w32).to(p.dtype))
                z.copy_(z_new)
                n.copy_(n_new)

    def _state(self, p, group) -> dict:
        st = self.state[p]
        if not st:
            st["z"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            st["n"] = torch.full(p.shape, group["initial_accumulator_value"],
                                 dtype=torch.float32, device=p.device)
        return st


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps, momentum=momentum)`` (not centred,
    ``initial_scale`` 0, eps inside the root): ``nu = (1 - decay)·g² +
    decay·nu``, ``u = -lr · g · rsqrt(nu + eps)``, ``trace = u +
    momentum·trace``, ``p += trace``; f32. State: ``square_avg`` (optax's
    ``nu``) and ``momentum_buffer`` (its ``trace``)."""

    def __init__(self, params, lr: float = 0.0, decay: float = 0.9, eps: float = 1e-8,
                 momentum: float = 0.9):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, decay, eps, mom = group["lr"], group["decay"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["square_avg"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    st["momentum_buffer"] = torch.zeros(p.shape, dtype=torch.float32,
                                                        device=p.device)
                g = p.grad.float()
                nu, trace = st["square_avg"], st["momentum_buffer"]
                nu.copy_((1 - decay) * (g * g) + decay * nu)
                trace.copy_(g * torch.rsqrt(nu + eps) * -lr + mom * trace)
                p.add_(trace.to(p.dtype))


class Lamb(torch.optim.Optimizer):
    """``optax.lamb(lr, b1, b2, eps, weight_decay)``: Adam's bias-corrected
    ``m / (sqrt(v) + eps)`` (``eps_root`` 0), plus ``weight_decay · p`` on
    every parameter, scaled by the trust ratio ``‖p‖ / ‖u‖`` (1 where either
    norm is 0), times ``-lr``; f32. State: ``exp_avg``, ``exp_avg_sq``
    (optax's ``mu``, ``nu``) and ``step`` (its count)."""

    def __init__(self, params, lr: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))
        self.layouts: dict = {}  # parameter -> Layout of a shard (Optimizer.place)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, b1, b2 = group["lr"], group["b1"], group["b2"]
            eps, wd = group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["exp_avg"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    st["exp_avg_sq"] = torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device)
                    st["step"] = torch.tensor(0.0)
                g, w = p.grad.float(), p.float()
                mu, nu = st["exp_avg"], st["exp_avg_sq"]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                st["step"] += 1
                t = float(st["step"])
                u = (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t)) + eps)
                if wd:
                    u = u + wd * w
                # sqrt of a summed square: torch.linalg.vector_norm on the CPU is
                # off by ~2e-3 over gpt_small's 38.6M-element token table; a
                # shard's sums are summed over its axes (padding is 0 in both)
                lay = self.layouts.get(p)
                if lay is None:
                    p_norm, u_norm = torch.sqrt((w * w).sum()), torch.sqrt((u * u).sum())
                else:
                    p_norm = torch.sqrt(lay.sum(w * w))
                    u_norm = torch.sqrt(lay.sum(u * u))
                ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
                p.add_((u * ratio * -lr).to(p.dtype))


#: optax.adafactor's defaults as the JAX package calls it
ADAFACTOR_MIN_DIM = 128
ADAFACTOR_DECAY = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0
ADAFACTOR_MIN_SCALE = 1e-3


def factored_dims(shape) -> tuple[int, int] | None:
    """optax's ``_factored_dims`` at ``min_dim_size_to_factor=128``: the
    axes ``(d1, d0)`` of the second-largest and the largest dim when the
    second-largest is at least 128, else None (ties broken as
    ``np.argsort`` breaks them)."""
    import numpy as np

    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])



def adafactor_state_keys(shape) -> tuple[str, ...]:
    """The state a parameter of ``shape`` holds under ``Adafactor``."""
    return ("v_col", "v_row") if factored_dims(shape) is not None else ("v",)


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)`` with its defaults (module docstring), f32.
    A parameter with ``factored_dims`` (d1, d0) keeps ``v_row`` (the mean
    of g² + 1e-30 over d0) and ``v_col`` (over d1), otherwise a full
    ``v``; each decays at ``1 - (t+1)^-0.8`` for the update count ``t``
    (the group's ``count``, set by ``Optimizer.update``). The update
    ``g · (v_row/mean v_row)^-½ · v_col^-½`` (or ``g · v^-½``) is divided
    by ``max(1, rms(u))``, times ``lr`` and ``max(rms(p), 1e-3)``, and
    subtracted."""

    def __init__(self, params, lr: float = 0.0):
        super().__init__(params, dict(lr=lr, count=0))
        self.layouts: dict = {}  # parameter -> Layout of a shard (Optimizer.place)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr = group["lr"]
            rate = 1.0 - (group["count"] + 1.0) ** -ADAFACTOR_DECAY
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, w = p.grad.float(), p.float()
                st = self.state[p]
                if p in self.layouts:
                    self._sharded_step(p, g, w, st, self.layouts[p], lr, rate)
                    continue
                dims = factored_dims(tuple(p.shape))
                sq = g * g + ADAFACTOR_EPS
                if dims is not None:
                    d1, d0 = dims
                    if not st:
                        st["v_row"] = torch.zeros(sq.mean(d0).shape, device=p.device)
                        st["v_col"] = torch.zeros(sq.mean(d1).shape, device=p.device)
                    vr, vc = st["v_row"], st["v_col"]
                    vr.copy_(rate * vr + (1.0 - rate) * sq.mean(d0))
                    vc.copy_(rate * vc + (1.0 - rate) * sq.mean(d1))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row = (vr / vr.mean(reduced_d1, keepdim=True)) ** -0.5
                    u = g * row.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
                else:
                    if not st:
                        st["v"] = torch.zeros(p.shape, device=p.device)
                    v = st["v"]
                    v.copy_(rate * v + (1.0 - rate) * sq)
                    u = g * v ** -0.5
                u = u / torch.clamp(torch.sqrt((u * u).mean()) / ADAFACTOR_CLIP, min=1.0)
                rms = torch.sqrt((w * w).mean())
                scale = torch.where(rms <= ADAFACTOR_MIN_SCALE, ADAFACTOR_MIN_SCALE, rms)
                p.add_((u * lr * scale * -1.0).to(p.dtype))

    @staticmethod
    def _sharded_step(p, g, w, st, lay: "Layout", lr: float, rate: float) -> None:
        """The step on a shard: the factoring by the whole shape, each mean
        a ``Layout.sum`` over the whole dims divided by their size, the
        padding masked out of every statistic and update."""
        shape = tuple(n for n, _ in lay.dims)
        mask = lay.mask(g)

        def real(t, m=mask):
            return t if m is None else torch.where(m, t, 0.0)

        dims = factored_dims(shape)
        sq = real(g * g + ADAFACTOR_EPS)
        if dims is not None:
            d1, d0 = dims
            if not st:
                st["v_row"] = torch.zeros(sq.sum(d0).shape, device=p.device)
                st["v_col"] = torch.zeros(sq.sum(d1).shape, device=p.device)
            vr, vc = st["v_row"], st["v_col"]
            vr.copy_(rate * vr + (1.0 - rate) * lay.sum(sq, [d0]) / shape[d0])
            vc.copy_(rate * vc + (1.0 - rate) * lay.sum(sq, [d1]) / shape[d1])
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            rows = lay.drop(d0)
            vr_mean = rows.sum(real(vr, rows.mask(vr)), [reduced_d1], keepdim=True) / shape[d1]
            u = g * (vr / vr_mean).pow(-0.5).unsqueeze(d0) * vc.pow(-0.5).unsqueeze(d1)
        else:
            if not st:
                st["v"] = torch.zeros(p.shape, device=p.device)
            v = st["v"]
            v.copy_(rate * v + (1.0 - rate) * sq)
            u = g * v.pow(-0.5)
        u = real(u)
        u = u / torch.clamp(torch.sqrt(lay.sum(u * u) / lay.numel) / ADAFACTOR_CLIP, min=1.0)
        rms = torch.sqrt(lay.sum(w * w) / lay.numel)
        scale = torch.where(rms <= ADAFACTOR_MIN_SCALE, ADAFACTOR_MIN_SCALE, rms)
        p.add_((u * lr * scale * -1.0).to(p.dtype))


class Optimizer:
    """One optimizer over ``params`` with optax's update semantics (see
    module docstring). ``update(grads)`` applies one update in place and
    advances ``count``; the torch optimizer's state lives in ``.opt``."""

    def __init__(self, cfg: OptimizerConfig, params: Iterable[torch.nn.Parameter]):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.count = 0
        self.params = [p for p in params if p.requires_grad]
        self.mesh, self.layouts = None, []  # see place
        name = cfg.name.lower()
        self.coupled_l2 = cfg.weight_decay > 0 and name not in ("adamw", "lamb", "ftrl")
        if name == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=0.0)
        elif name == "momentum":
            self.opt = torch.optim.SGD(self.params, lr=0.0, momentum=cfg.momentum,
                                       nesterov=cfg.nesterov)
        elif name == "adam":
            self.opt = torch.optim.Adam(self.params, lr=0.0, betas=(cfg.b1, cfg.b2),
                                        eps=cfg.eps)
        elif name == "adamw":
            self.opt = torch.optim.AdamW(self.params, lr=0.0, betas=(cfg.b1, cfg.b2),
                                         eps=cfg.eps, weight_decay=cfg.weight_decay)
        elif name == "adagrad":
            self.opt = Adagrad(self.params, eps=cfg.eps)
        elif name == "ftrl":
            self.opt = Ftrl(self.params, lr_power=cfg.lr_power, l1=cfg.l1, l2=cfg.l2)
        elif name == "rmsprop":
            self.opt = RMSprop(self.params, eps=cfg.eps, momentum=cfg.momentum)
        elif name == "lamb":
            self.opt = Lamb(self.params, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                            weight_decay=cfg.weight_decay)
        elif name == "adafactor":
            self.opt = Adafactor(self.params)
        else:
            raise ValueError(f"Unknown optimizer '{cfg.name}'")

    def state_keys(self) -> tuple[str, ...]:
        """The keys of the torch optimizer's state a parameter holds after
        the first update (``train/step.py``'s checkpoint leaves)."""
        if isinstance(self.opt, torch.optim.SGD):
            return ("momentum_buffer",) if self.cfg.name.lower() == "momentum" else ()
        if isinstance(self.opt, Adagrad):
            return ("sum",)
        if isinstance(self.opt, Ftrl):
            return ("n", "z")
        if isinstance(self.opt, RMSprop):
            return ("momentum_buffer", "square_avg")
        if isinstance(self.opt, Adafactor):
            raise ValueError("adafactor's state keys differ by parameter: param_state_keys")
        return ("exp_avg", "exp_avg_sq", "step")

    def param_state_keys(self) -> list[tuple[str, ...]]:
        """The state keys of each parameter, in ``params`` order
        (``state_keys()``, but adafactor's by the parameter's shape)."""
        if isinstance(self.opt, Adafactor):  # factored by the whole shape
            lays = self.layouts or [None] * len(self.params)
            return [adafactor_state_keys(lay.shape if lay is not None else tuple(p.shape))
                    for p, lay in zip(self.params, lays)]
        return [self.state_keys()] * len(self.params)

    def place(self, mesh, specs, model) -> None:
        """Each of ``params``' ``Layout`` over ``mesh`` when a shard
        (``specs``: ``model``'s parameter names to their placement, as
        ``runner.prepare`` computed them): what ``grad_norm`` sums over, and
        lamb's and adafactor's per-parameter reductions (module docstring)."""
        self.mesh, self.layouts = mesh, _layouts(self.params, specs, model, mesh)
        if hasattr(self.opt, "layouts"):
            self.opt.layouts = {p: lay for p, lay in zip(self.params, self.layouts)
                                if lay is not None}

    def grad_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of ``grads`` (one a parameter, in ``params``
        order) over the whole tree, the shards' included (``place``)."""
        return global_norm(grads, self.layouts, self.mesh)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if self.coupled_l2:
            wd = self.cfg.weight_decay
            grads = [g + wd * p if p.dim() > 1 else g for g, p in zip(grads, self.params)]
        if self.cfg.clip_grad_norm > 0:
            norm = self.grad_norm(grads)
            scale = torch.where(norm < self.cfg.clip_grad_norm, 1.0,
                                self.cfg.clip_grad_norm / norm)
            grads = [g * scale.to(g.dtype) for g in grads]
        lr = float(self.schedule(self.count))
        for group in self.opt.param_groups:
            group["lr"] = lr
            if "count" in group:
                group["count"] = self.count
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        self.opt.step()
        for p in self.params:
            p.grad = None
        self.count += 1


def make_optimizer(cfg: OptimizerConfig, params: Iterable[torch.nn.Parameter]) -> Optimizer:
    return Optimizer(cfg, params)


class _GroupedState:
    """The ``.opt`` of a ``MultiOptimizer``: the groups' torch optimizers
    seen as one, their state keyed by the index of the parameter in the
    multi-optimizer's ``params`` (what ``train/step.py`` reads and
    writes)."""

    def __init__(self, groups: list[tuple[Optimizer, list[int]]]):
        self.groups = groups

    @property
    def state(self) -> dict:
        out = {}
        for sub, _ in self.groups:
            out.update(sub.opt.state)
        return out

    def state_dict(self) -> dict:
        state = {}
        for sub, idx in self.groups:
            for j, st in sub.opt.state_dict()["state"].items():
                state[idx[j]] = st
        return {"state": state, "param_groups": []}

    def load_state_dict(self, sd: dict) -> None:
        for sub, idx in self.groups:
            own = sub.opt.state_dict()
            own["state"] = {j: sd["state"][i] for j, i in enumerate(idx) if i in sd["state"]}
            sub.opt.load_state_dict(own)


class MultiOptimizer:
    """Per-group optimizers over one parameter list (module docstring):
    the ``Optimizer`` interface — ``params``, ``count``, ``opt``,
    ``update``, ``param_state_keys`` — over the groups' own optimizers.
    ``labels[i]`` is the group of ``params[i]``."""

    def __init__(self, groups: dict[str, Optimizer], labels: list[str],
                 params: list[torch.nn.Parameter]):
        self.groups = groups
        self.labels = labels
        self.params = params
        self.cfg = None
        self.mesh, self.layouts = None, []  # see place
        self.index = {k: [i for i, lab in enumerate(labels) if lab == k] for k in groups}
        self.opt = _GroupedState([(groups[k], self.index[k]) for k in groups])

    @property
    def count(self) -> int:
        return next(iter(self.groups.values())).count

    @count.setter
    def count(self, value: int) -> None:
        for sub in self.groups.values():
            sub.count = value

    def param_state_keys(self) -> list[tuple[str, ...]]:
        keys: list[tuple[str, ...]] = [()] * len(self.params)
        for k, sub in self.groups.items():
            for i, ks in zip(self.index[k], sub.param_state_keys()):
                keys[i] = ks
        return keys

    def place(self, mesh, specs, model) -> None:
        """``Optimizer.place`` for the whole list and each group (a
        group's clip norm is its own parameters' global norm)."""
        self.mesh, self.layouts = mesh, _layouts(self.params, specs, model, mesh)
        for sub in self.groups.values():
            sub.place(mesh, specs, model)

    def grad_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        return global_norm(grads, self.layouts, self.mesh)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        for k, sub in self.groups.items():
            sub.update([grads[i] for i in self.index[k]])


def make_multi_optimizer(rules: Sequence[tuple[str, OptimizerConfig]],
                         default: OptimizerConfig,
                         named_params: Iterable[tuple[str, torch.nn.Parameter]]
                         ) -> MultiOptimizer:
    """Per-parameter-group optimizers by path regex, first match wins
    (``re.search`` on ``parallel.sharding.param_path(name)``); a parameter
    no rule matches takes ``default``. A group no parameter falls in is
    left out. Wide&Deep's canonical use: FTRL on the wide columns, AdaGrad
    on the rest (``workloads/wide_deep.py``)."""
    from ..parallel.sharding import param_path

    named = [(n, p) for n, p in named_params if p.requires_grad]
    compiled = [(re.compile(pat), f"rule{i}") for i, (pat, _) in enumerate(rules)]
    cfgs = {f"rule{i}": c for i, (_, c) in enumerate(rules)}
    cfgs["default"] = default
    labels = []
    for name, _ in named:
        path = param_path(name)
        labels.append(next((key for rx, key in compiled if rx.search(path)), "default"))
    params = [p for _, p in named]
    groups = {k: Optimizer(c, [p for p, lab in zip(params, labels) if lab == k])
              for k, c in cfgs.items() if k in labels}
    return MultiOptimizer(groups, labels, params)
