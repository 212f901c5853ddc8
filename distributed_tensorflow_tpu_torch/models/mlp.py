"""MNIST MLP — the port's counterpart of ``distributed_tensorflow_tpu/models/
mlp.py`` (BASELINE.json:7 workload 1).

Same config and math: the NHWC image flattened to ``[B, H*W*C]``, then
per hidden size a Dense (``dense_{i}``), ReLU and, at
``dropout_rate > 0`` in training, dropout, then the ``head`` Dense. The
products run in ``dtype``; the parameters are f32 masters. Dropout
draws from the step's generator (``models/transformer.dropout``): under
data parallelism a ``RowGenerator`` gives each rank its rows of the
global batch's draw, so a row's mask is the one a single process stepping
on the global batch draws for it. No kernel of the port: the products are
plain ``F.linear`` (the JAX model's are XLA dots, outside any Pallas
kernel).

Parameters as flax names them: ``dense_{i}.weight`` ``[out, in]`` (flax
``kernel`` ``[in, out]``) and ``.bias``, ``head.weight``/``head.bias``
(``weights.mlp_from_jax`` converts the flax tree).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .resnet import _variance_scaling_
from .transformer import dropout, torch_dtype


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    hidden_sizes: tuple = (512, 512)
    num_classes: int = 10
    dropout_rate: float = 0.0
    dtype: str = "float32"  # compute dtype; params stay float32


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias cast to
    ``dtype``, the product in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MLP(nn.Module):
    """``MLP(cfg, input_dim)``: the flattened image of ``input_dim``
    values a row in, ``num_classes`` logits (in ``dtype``) out."""

    def __init__(self, cfg: MLPConfig, input_dim: int, device=None):
        super().__init__()
        self.cfg = cfg
        dims = [input_dim, *cfg.hidden_sizes]
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            self.add_module(f"dense_{i}", nn.Linear(a, b, device=device))
        self.head = nn.Linear(dims[-1], cfg.num_classes, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        x = x.reshape(x.shape[0], -1)
        for i in range(len(cfg.hidden_sizes)):
            x = torch.relu(dense(x, getattr(self, f"dense_{i}"), dtype))
            x = dropout(x, cfg.dropout_rate, train, generator)
        return dense(x, self.head, dtype)


def init_params(cfg: MLPConfig, input_dim: int, seed: int = 0,
                device="cuda") -> dict[str, torch.Tensor]:
    """Random weights as flax initialises them — lecun_normal kernels,
    zero biases — drawn in f32 from a ``torch.Generator`` on ``device``
    (the card by default; raises without one unless ``device="cpu"``)
    seeded with ``seed``. The numbers differ from ``jax.random``'s."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, p in MLP(cfg, input_dim, device="meta").named_parameters():
        t = torch.empty(p.shape, device=device)
        if name.endswith(".weight"):
            _variance_scaling_(t, 1.0, p.shape[1], gen)
        else:
            t.zero_()
        out[name] = t
    return out


def build(cfg: MLPConfig, params: dict[str, torch.Tensor], device) -> MLP:
    """``MLP(cfg)`` on ``device`` holding a copy of ``params`` (its input
    width is ``dense_0.weight``'s, or ``head.weight``'s with no hidden
    layer) as f32 masters that require grad."""
    first = "dense_0.weight" if cfg.hidden_sizes else "head.weight"
    model = MLP(cfg, params[first].shape[1], device="meta")
    model.load_state_dict({k: torch.as_tensor(v).to(device=device, dtype=torch.float32,
                                                    copy=True)
                           for k, v in params.items()}, assign=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def flops_per_example(cfg: MLPConfig, input_dim: int = 784) -> float:
    """Forward FLOPs (the framework contract: forward only, as
    ``utils/flops.py``)."""
    dims = [input_dim, *cfg.hidden_sizes, cfg.num_classes]
    return sum(2.0 * a * b for a, b in zip(dims, dims[1:]))
