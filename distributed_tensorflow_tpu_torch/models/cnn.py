"""CIFAR-10 CNN — the port's counterpart of ``distributed_tensorflow_tpu/models/
cnn.py`` (BASELINE.json:8 workload 2, sync data-parallel).

Same config and math: per stage a 3x3 ``SAME`` convolution with a bias
(``conv_{i}``), BatchNorm (``bn_{i}``, flax's: momentum 0.9, biased
variance, eps 1e-5; with ``use_batchnorm``), ReLU and a 2x2 ``VALID``
max-pool; then the map flattened, ``dense``, ReLU, dropout (at
``dropout_rate > 0`` in training, from the step's generator as in
``models/mlp.py``) and ``head``. Convolutions and products run in
``dtype``; parameters and BatchNorm statistics are f32.

Activations stay NHWC, as in the JAX model: a convolution sees them as an
NCHW view in ``channels_last`` memory. The flatten before ``dense`` is
flax's, in (h, w, c) order of the NHWC map (``reshape`` of the logical
NHWC tensor), so ``dense``'s rows are flax's kernel rows as they are.

BatchNorm is the ResNet's (``models/resnet.BatchNorm`` and its
``global_moments``): with a mesh whose batch axes span more than one
rank, every layer normalises with the global batch's statistics, as the
JAX CNN does under GSPMD. No kernel of the port: the convolutions are
``F.conv2d`` (the JAX model's are flax ``nn.Conv``, which no Pallas
kernel of the JAX package computes).

Parameters: ``conv_{i}.weight`` OIHW (flax HWIO), ``conv_{i}.bias``,
``bn_{i}.{weight,bias,running_mean,running_var}`` (flax ``scale``/
``bias`` and ``batch_stats`` ``mean``/``var``), ``dense``/``head``
``[out, in]`` (``weights.cnn_from_jax`` / ``cnn_to_jax``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .mlp import dense
from .resnet import BatchNorm, _variance_scaling_
from .transformer import dropout, torch_dtype


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    channels: tuple = (32, 64, 128)
    dense_size: int = 256
    num_classes: int = 10
    dropout_rate: float = 0.0
    use_batchnorm: bool = True
    dtype: str = "float32"

    # flax nn.BatchNorm(momentum=0.9) with its default epsilon, as
    # ``resnet.BatchNorm`` reads them from its config (class attributes,
    # not fields: the JAX config has no such fields)
    bn_momentum = 0.9
    bn_epsilon = 1e-5


class Conv(nn.Module):
    """A 3x3 convolution's OIHW weight and its bias (f32 masters)."""

    def __init__(self, cout: int, cin: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """flax ``nn.Conv(k, (3, 3), dtype=dtype)`` on NHWC ``x`` (SAME: one
        row and column of zeros on each side); returns NHWC."""
        x = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x, self.weight.to(dtype), self.bias.to(dtype), padding=1)
        return y.permute(0, 2, 3, 1)


class CNN(nn.Module):
    """``CNN(cfg, input_shape=(H, W, C))``: NHWC images in,
    ``num_classes`` logits (in ``dtype``) out. ``mesh``: sync BatchNorm
    over its batch axes."""

    def __init__(self, cfg: CNNConfig, input_shape=(32, 32, 3), device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        h, w, cin = input_shape
        for i, ch in enumerate(cfg.channels):
            self.add_module(f"conv_{i}", Conv(ch, cin, device))
            if cfg.use_batchnorm:
                self.add_module(f"bn_{i}", BatchNorm(ch, device=device, mesh=mesh))
            h, w, cin = h // 2, w // 2, ch
        self.dense = nn.Linear(h * w * cin, cfg.dense_size, device=device)
        self.head = nn.Linear(cfg.dense_size, cfg.num_classes, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        for i in range(len(cfg.channels)):
            x = getattr(self, f"conv_{i}")(x, dtype)
            if cfg.use_batchnorm:
                x = getattr(self, f"bn_{i}")(x, train=train, cfg=cfg).to(dtype)
            x = torch.relu(x)
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        x = torch.relu(dense(x.reshape(x.shape[0], -1), self.dense, dtype))
        x = dropout(x, cfg.dropout_rate, train, generator)
        return dense(x, self.head, dtype)


def init_params(cfg: CNNConfig, input_shape=(32, 32, 3), seed: int = 0,
                device="cuda") -> dict[str, torch.Tensor]:
    """Random weights as flax initialises them — lecun_normal kernels
    (convolutions: fan-in 9 x in-channels), zero biases, BatchNorm scale
    1, running mean 0 and var 1 — drawn in f32 from a ``torch.Generator``
    on ``device`` (the card by default; raises without one unless
    ``device="cpu"``) seeded with ``seed``. The numbers differ from
    ``jax.random``'s."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, p in CNN(cfg, input_shape, device="meta").state_dict().items():
        owner, leaf = name.rsplit(".", 1)
        t = torch.empty(p.shape, device=device)
        if leaf == "weight" and p.dim() > 1:  # conv OIHW or Dense [out, in]
            _variance_scaling_(t, 1.0, p[0].numel(), gen)
        elif (leaf == "weight" and owner.startswith("bn_")) or leaf == "running_var":
            t.fill_(1.0)
        else:  # biases, running means
            t.zero_()
        out[name] = t
    return out


def build(cfg: CNNConfig, params: dict[str, torch.Tensor], device, input_shape=(32, 32, 3),
          mesh=None) -> CNN:
    """``CNN(cfg, input_shape, mesh=mesh)`` on ``device`` holding a copy of
    ``params`` (a state dict, ``init_params``'s or converted from flax) as
    f32 masters that require grad."""
    model = CNN(cfg, input_shape, device="meta", mesh=mesh)
    model.load_state_dict({k: torch.as_tensor(v).to(device=device, dtype=torch.float32,
                                                    copy=True)
                           for k, v in params.items()}, assign=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def flops_per_example(cfg: CNNConfig, image_size: int = 32) -> float:
    """Forward FLOPs (the framework contract: forward only), the JAX
    package's formula (3 input channels)."""
    fwd = 0.0
    h = image_size
    in_c = 3
    for ch in cfg.channels:
        fwd += 2.0 * h * h * ch * in_c * 9  # 3x3 conv at same resolution
        h //= 2
        in_c = ch
    fwd += 2.0 * (h * h * in_c) * cfg.dense_size
    fwd += 2.0 * cfg.dense_size * cfg.num_classes
    return fwd
