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
  the norm is the whole tree's: after ``place`` tells the optimizer which
  parameters are table shards over the mesh's ``model`` axis, their
  squares are summed over that axis and the replicated ones' counted
  once (``global_norm``), as JAX's norm is over its sharded arrays;
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

``rmsprop``, ``lamb`` and ``adafactor`` are not ported yet (ROADMAP Queue
A item 2.6) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Iterable, Sequence

import torch

from ..parallel.collectives import all_reduce
from ..parallel.mesh import MODEL

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"  # sgd|momentum|adam|adamw (others: not ported yet)
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


def global_norm(tensors: Iterable[torch.Tensor], sharded: Sequence[bool] = (),
                mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax.global_norm).
    Where ``sharded[i]``, ``tensors[i]`` is this rank's shard of a tensor
    split over ``mesh``'s ``model`` axis: the shards' squares are summed
    over that axis and the others' counted once, so every rank gets the
    norm of the whole tree."""
    tensors = list(tensors)
    if not any(sharded) or mesh is None or mesh.shape[MODEL] == 1:
        return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))
    squares = [t.float().pow(2).sum() for t in tensors]
    total = all_reduce(torch.stack([q for q, sh in zip(squares, sharded) if sh]).sum(),
                       MODEL, mesh)
    rest = [q for q, sh in zip(squares, sharded) if not sh]
    return torch.sqrt(total + torch.stack(rest).sum() if rest else total)


def _shard_mask(params: Sequence[torch.nn.Parameter], specs, model) -> list[bool]:
    """For each of ``params``: is it a shard? (``specs``: ``model``'s
    parameter names to their placement, ``parallel/sharding.py``; a
    non-empty spec shards.)"""
    names = {id(p): n for n, p in model.named_parameters()}
    return [bool(specs.get(names.get(id(p)), ())) for p in params]


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


class Optimizer:
    """One optimizer over ``params`` with optax's update semantics (see
    module docstring). ``update(grads)`` applies one update in place and
    advances ``count``; the torch optimizer's state lives in ``.opt``."""

    def __init__(self, cfg: OptimizerConfig, params: Iterable[torch.nn.Parameter]):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.count = 0
        self.params = [p for p in params if p.requires_grad]
        self.mesh, self.sharded = None, []  # see place
        name = cfg.name.lower()
        self.coupled_l2 = cfg.weight_decay > 0 and name not in ("adamw", "ftrl")
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
        elif name in ("rmsprop", "lamb", "adafactor"):
            raise NotImplementedError(
                f"optimizer {cfg.name!r} is not ported yet (ROADMAP Queue A item 2.6: "
                f"rmsprop, lamb, adafactor)")
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
        return ("exp_avg", "exp_avg_sq", "step")

    def param_state_keys(self) -> list[tuple[str, ...]]:
        """``state_keys()`` for each parameter, in ``params`` order."""
        return [self.state_keys()] * len(self.params)

    def place(self, mesh, specs, model) -> None:
        """Which of ``params`` are shards over ``mesh``'s ``model`` axis
        (``specs``: ``model``'s parameter names to their placement, as
        ``runner.prepare`` matched them): what ``grad_norm`` sums over it."""
        self.mesh, self.sharded = mesh, _shard_mask(self.params, specs, model)

    def grad_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of ``grads`` (one a parameter, in ``params``
        order) over the whole tree, the shards' included (``place``)."""
        return global_norm(grads, self.sharded, self.mesh)

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
        self.mesh, self.sharded = None, []  # see place
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
        return [self.groups[lab].state_keys() for lab in self.labels]

    def place(self, mesh, specs, model) -> None:
        """``Optimizer.place`` for the whole list and each group (a
        group's clip norm is its own parameters' global norm)."""
        self.mesh, self.sharded = mesh, _shard_mask(self.params, specs, model)
        for sub in self.groups.values():
            sub.place(mesh, specs, model)

    def grad_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        return global_norm(grads, self.sharded, self.mesh)

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
