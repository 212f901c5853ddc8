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
  (``g * max / norm`` when ``norm >= max``), applied before the update.

``adagrad``, ``ftrl``, ``rmsprop``, ``lamb``, ``adafactor`` and the
per-group ``make_multi_optimizer`` are not ported yet (ROADMAP Queue A
item 2.6) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Sequence

import torch

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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class Optimizer:
    """One optimizer over ``params`` with optax's update semantics (see
    module docstring). ``update(grads)`` applies one update in place and
    advances ``count``; the torch optimizer's state lives in ``.opt``."""

    def __init__(self, cfg: OptimizerConfig, params: Iterable[torch.nn.Parameter]):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.count = 0
        self.params = [p for p in params if p.requires_grad]
        name = cfg.name.lower()
        self.coupled_l2 = cfg.weight_decay > 0 and name != "adamw"
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
        elif name in ("adagrad", "ftrl", "rmsprop", "lamb", "adafactor"):
            raise NotImplementedError(
                f"optimizer {cfg.name!r} is not ported yet (ROADMAP Queue A item 2.6)")
        else:
            raise ValueError(f"Unknown optimizer '{cfg.name}'")

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if self.coupled_l2:
            wd = self.cfg.weight_decay
            grads = [g + wd * p if p.dim() > 1 else g for g, p in zip(grads, self.params)]
        if self.cfg.clip_grad_norm > 0:
            norm = global_norm(grads)
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
