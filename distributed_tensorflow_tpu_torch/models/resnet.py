"""ResNet-50 (v1.5) — the port's counterpart of ``distributed_tensorflow_tpu/
models/resnet.py``.

Same config, same math, same parameter tree (``weights.resnet_from_jax``
converts the flax one): bf16 convolutions and matmuls with f32 parameters
and f32 BatchNorm statistics, NHWC activations, stride 2 on the 3x3 conv
(v1.5), the ``conv`` (7x7/2) or ``space_to_depth`` (2x2 fold + 4x4/1)
stem, BatchNorm with flax's semantics (biased batch variance
``E[x^2] - E[x]^2`` clamped at 0, running stats ``m*old + (1-m)*batch``
with ``m = bn_momentum``, updated in the train forward), and a zero-init
bn3 scale. Activations stay NHWC, as in the JAX model: a convolution sees
them as an NCHW view in ``channels_last`` memory, so the rows ``[B*H*W,
C]`` of a 1x1 conv are a view, not a copy. Padding is flax's ``SAME``
(asymmetric at stride 2: the 3x3/2 pads (0, 1) at even sizes, the 7x7/2
stem (2, 3), the 4x4/1 stem (1, 2); max-pool pads with -inf).

``block_impl``:

- ``"standard"``: convolutions through ``F.conv2d`` and BatchNorm in plain
  PyTorch — no kernel of the port;
- ``"fused"``: the 1x1 convs (conv1, conv3, the projection) run through
  ``ops.fused_conv_bn.conv1x1_bn_act`` — conv1 and the projection emit
  their BatchNorm's statistics from the kernel's epilogue, conv3 applies
  bn2 + ReLU in its prologue — 36 forward launches a ResNet-50 step; the
  backward follows ``DTF_FUSED_BWD`` (``ops/_policy.py``).

With a mesh (``ResNet(cfg, mesh=...)``, as JAX's ``ResNet50(cfg, mesh)``)
whose ``BATCH_AXES`` span more than one rank, every BatchNorm of both
implementations normalises with the statistics of the global batch (sync
BN): each rank's f32 column sums and sums of squares are all-reduced
over the batch axes in one differentiable collective a layer, so the
backward hands the fused kernels all-reduced ``dsum``/``dssq``
cotangents, and the running statistics are updated from the global
moments, equal on every rank.

Both share one state dict (``stageS_blockB.conv1.weight``,
``...bn1.{weight,bias,running_mean,running_var}``, ...). Conv weights are
OIHW, the head is ``[num_classes, features]`` (``nn.Linear``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce
from ..parallel.mesh import BATCH_AXES, mesh_axis_size
from ..utils.device import resolve_device
from .transformer import torch_dtype


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: str = "bfloat16"
    # BatchNorm output dtype; None = follow ``dtype`` (statistics are f32)
    norm_dtype: str | None = None
    bn_momentum: float = 0.9
    bn_epsilon: float = 1e-5
    stem: str = "conv"  # "conv" (7x7/2) | "space_to_depth" (2x2 fold, 4x4/1)
    block_impl: str = "standard"  # "standard" | "fused"


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, C*b*b), channel ``(dy*b + dx)*C + c``
    (the JAX package's order, not ``pixel_unshuffle``'s)."""
    b_, h, w, c = x.shape
    x = x.reshape(b_, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b_, h // block, w // block, c * block * block)


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding (lo, hi) of one spatial dim."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int, dtype) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", use_bias=False, dtype=dtype)`` on NHWC
    ``x`` with an OIHW ``weight``: both cast to ``dtype``; symmetric SAME
    padding goes to the convolution, asymmetric padding is applied
    explicitly. Returns NHWC (a view of the channels_last result)."""
    k = weight.shape[-1]
    x = x.to(dtype)
    (hl, hh), (wl, wh) = same_pads(x.shape[1], k, stride), same_pads(x.shape[2], k, stride)
    pad = 0
    if hl == hh and wl == wh:
        pad = (hl, wl)
    else:
        x = F.pad(x, (0, 0, wl, wh, hl, hh))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(dtype), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax ``nn.max_pool(padding="SAME")`` on NHWC: pads with -inf."""
    (hl, hh), (wl, wh) = same_pads(x.shape[1], k, s), same_pads(x.shape[2], k, s)
    x = F.pad(x, (0, 0, wl, wh, hl, hh), value=float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def global_moments(col_sum: torch.Tensor, col_sumsq: torch.Tensor, rows: int, mesh=None):
    """(mean, biased variance) of the global batch from this rank's f32
    column sums and sums of squares over ``rows`` rows: the two all-reduced
    over ``BATCH_AXES`` in one collective (differentiable), the count
    ``rows`` times the number of batch shards (the shards are equal)."""
    from ..ops.fused_conv_bn import moments_from_sums

    shards = 1 if mesh is None else mesh_axis_size(mesh, BATCH_AXES)
    if shards > 1:
        c = col_sum.shape[0]
        both = all_reduce(torch.cat([col_sum, col_sumsq]), BATCH_AXES, mesh)
        col_sum, col_sumsq = both[:c], both[c:]
    return moments_from_sums(col_sum, col_sumsq, rows * shards)


class ConvKernel(nn.Module):
    """A bias-free convolution's OIHW weight (f32 master)."""

    def __init__(self, cout: int, cin: int, k: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` state: ``weight`` (flax ``scale``), ``bias``,
    and the ``running_mean``/``running_var`` buffers (flax ``batch_stats``
    ``mean``/``var``). ``mesh``: the batch statistics are the global
    batch's (``global_moments``)."""

    def __init__(self, features: int, zero_scale: bool = False, device=None, mesh=None):
        super().__init__()
        self.zero_scale = zero_scale
        self.mesh = mesh
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean", torch.empty(features, device=device))
        self.register_buffer("running_var", torch.empty(features, device=device))

    @torch.no_grad()
    def update(self, mean: torch.Tensor, var: torch.Tensor, momentum: float) -> None:
        """Running stats ``momentum*old + (1-momentum)*batch`` (biased var)."""
        self.running_mean.copy_(momentum * self.running_mean + (1.0 - momentum) * mean)
        self.running_var.copy_(momentum * self.running_var + (1.0 - momentum) * var)

    def forward(self, x: torch.Tensor, *, train: bool, cfg: ResNetConfig) -> torch.Tensor:
        """flax BatchNorm over every axis but the last, returning f32
        (callers cast): train mode normalises with the batch statistics and
        updates the running ones."""
        x32 = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            mean, var = global_moments(x32.sum(axes), (x32 * x32).sum(axes),
                                       x32.numel() // x32.shape[-1], self.mesh)
            self.update(mean.detach(), var.detach(), cfg.bn_momentum)
        else:
            mean, var = self.running_mean, self.running_var
        return (x32 - mean) * (self.weight * torch.rsqrt(var + cfg.bn_epsilon)) + self.bias


def _dtypes(cfg: ResNetConfig):
    return torch_dtype(cfg.dtype), torch_dtype(cfg.norm_dtype or cfg.dtype)


class _Bottleneck(nn.Module):
    """The parameters both block implementations share."""

    def __init__(self, cin: int, filters: int, strides: int, cfg: ResNetConfig, device=None,
                 mesh=None):
        super().__init__()
        self.cfg, self.cin, self.filters, self.strides = cfg, cin, filters, strides
        f = filters
        self.conv1 = ConvKernel(f, cin, 1, device)
        self.bn1 = BatchNorm(f, device=device, mesh=mesh)
        self.conv2 = ConvKernel(f, f, 3, device)
        self.bn2 = BatchNorm(f, device=device, mesh=mesh)
        self.conv3 = ConvKernel(4 * f, f, 1, device)
        self.bn3 = BatchNorm(4 * f, zero_scale=True, device=device, mesh=mesh)
        self.need_proj = cin != 4 * f or strides != 1
        if self.need_proj:
            self.proj_conv = ConvKernel(4 * f, cin, 1, device)
            self.proj_bn = BatchNorm(4 * f, device=device, mesh=mesh)


class BottleneckBlock(_Bottleneck):
    """The flax ``BottleneckBlock``: convolutions and BatchNorm as they are."""

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        cfg = self.cfg
        dtype, nd = _dtypes(cfg)
        bn = lambda m, t: m(t, train=train, cfg=cfg).to(nd)  # noqa: E731
        y = torch.relu(bn(self.bn1, conv_nhwc(x, self.conv1.weight, 1, dtype)))
        y = torch.relu(bn(self.bn2, conv_nhwc(y, self.conv2.weight, self.strides, dtype)))
        y = bn(self.bn3, conv_nhwc(y, self.conv3.weight, 1, dtype))
        residual = x
        if self.need_proj:
            residual = bn(self.proj_bn, conv_nhwc(x, self.proj_conv.weight, self.strides, dtype))
        return torch.relu(residual.to(y.dtype) + y)


class FusedBottleneckBlock(_Bottleneck):
    """The flax ``FusedBottleneckBlock``: the three 1x1 convs through
    ``conv1x1_bn_act`` in train mode, the column sums their kernels emit
    (and conv2's) reduced over the global batch by ``global_moments``, as
    JAX psums them inside its shard_map; eval with the running statistics
    in plain PyTorch."""

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        from ..ops.fused_conv_bn import bn_scale_shift, conv1x1_bn_act

        cfg = self.cfg
        dtype, nd = _dtypes(cfg)
        f, s, cin = self.filters, self.strides, self.cin
        eps, mom = cfg.bn_epsilon, cfg.bn_momentum
        B, H, W, _ = x.shape
        Ho, Wo = -(-H // s), -(-W // s)  # SAME: ceil(H/s), also for the ::s residual
        w2d = lambda conv: conv.weight.to(dtype).reshape(conv.weight.shape[0], -1).t()  # noqa: E731

        if not train:
            def aff(y, bn):
                sc, sh = bn_scale_shift(bn.running_mean, bn.running_var, bn.weight, bn.bias, eps)
                return y.float() * sc + sh

            h1 = torch.relu(aff(x.reshape(-1, cin).to(dtype) @ w2d(self.conv1), self.bn1))
            y2 = conv_nhwc(h1.to(dtype).reshape(B, H, W, f), self.conv2.weight, s, dtype)
            h2 = torch.relu(aff(y2, self.bn2)).to(dtype).reshape(-1, f)
            y3 = aff(h2 @ w2d(self.conv3), self.bn3)
            if self.need_proj:
                xs = x[:, ::s, ::s, :].reshape(-1, cin).to(dtype)
                res = aff(xs @ w2d(self.proj_conv), self.proj_bn)
            else:
                res = x.reshape(-1, 4 * f).float()
            return torch.relu(y3 + res).to(nd).reshape(B, Ho, Wo, 4 * f)

        def bn_affine(bn, col_sum, col_sumsq, count):
            mu, var = global_moments(col_sum, col_sumsq, count, bn.mesh)
            bn.update(mu.detach(), var.detach(), mom)
            return bn_scale_shift(mu, var, bn.weight, bn.bias, eps)

        y1, s1, q1 = conv1x1_bn_act(x.reshape(-1, cin).to(dtype), w2d(self.conv1),
                                    emit_stats=True, out_dtype=nd)
        sc1, sh1 = bn_affine(self.bn1, s1, q1, y1.shape[0])
        h1 = torch.relu(y1.float() * sc1 + sh1).to(dtype)
        y2 = conv_nhwc(h1.reshape(B, H, W, f), self.conv2.weight, s, dtype)
        y2 = y2.to(nd).reshape(-1, f)
        st2 = y2.float()
        sc2, sh2 = bn_affine(self.bn2, st2.sum(0), (st2 * st2).sum(0), y2.shape[0])
        y3, s3, q3 = conv1x1_bn_act(y2, w2d(self.conv3), sc2, sh2, relu=True, emit_stats=True,
                                    out_dtype=nd)
        sc3, sh3 = bn_affine(self.bn3, s3, q3, y2.shape[0])
        out = y3.float() * sc3 + sh3
        if self.need_proj:
            # a copy at stride 2 (a view where the strided rows stay regular,
            # as at 1x1 outputs: the kernels take contiguous rows)
            xs = x[:, ::s, ::s, :].reshape(-1, cin).to(dtype).contiguous()
            yp, sp, qp = conv1x1_bn_act(xs, w2d(self.proj_conv), emit_stats=True, out_dtype=nd)
            scp, shp = bn_affine(self.proj_bn, sp, qp, y2.shape[0])
            res = yp.float() * scp + shp
        else:
            res = x.reshape(-1, 4 * f).float()
        return torch.relu(out + res).to(nd).reshape(B, Ho, Wo, 4 * f)


BLOCKS = {"standard": BottleneckBlock, "fused": FusedBottleneckBlock}


class ResNet(nn.Module):
    """The flax ``ResNet``: NHWC images in, f32 logits out; ``mesh``: sync
    BN over its batch axes."""

    def __init__(self, cfg: ResNetConfig, device=None, mesh=None):
        super().__init__()
        if cfg.block_impl not in BLOCKS:
            raise ValueError(f"Unknown block_impl {cfg.block_impl!r}")
        self.cfg = cfg
        if cfg.stem == "space_to_depth":
            self.stem_conv_s2d = ConvKernel(cfg.width, 12, 4, device)
        elif cfg.stem == "conv":
            self.stem_conv = ConvKernel(cfg.width, 3, 7, device)
        else:
            raise ValueError(f"Unknown stem {cfg.stem!r}")
        self.stem_bn = BatchNorm(cfg.width, device=device, mesh=mesh)
        self.block_names = []
        cin = cfg.width
        for stage, blocks in enumerate(cfg.stage_sizes):
            for block in range(blocks):
                name = f"stage{stage}_block{block}"
                strides = 2 if stage > 0 and block == 0 else 1
                filters = cfg.width * 2 ** stage
                self.add_module(name, BLOCKS[cfg.block_impl](cin, filters, strides, cfg, device,
                                                             mesh))
                self.block_names.append(name)
                cin = 4 * filters
        self.head = nn.Linear(cin, cfg.num_classes, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        """Logits of NHWC ``x``. ``generator`` is unused (no dropout): every
        classification model takes the step's, so one loss adapter calls
        them all alike."""
        cfg = self.cfg
        dtype, nd = _dtypes(cfg)
        x = x.to(dtype)
        if cfg.stem == "space_to_depth":
            x = conv_nhwc(space_to_depth(x, 2), self.stem_conv_s2d.weight, 1, dtype)
        else:
            x = conv_nhwc(x, self.stem_conv.weight, 2, dtype)
        x = torch.relu(self.stem_bn(x, train=train, cfg=cfg).to(nd))
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train=train)
        x = x.float().mean(dim=(1, 2)).to(x.dtype)  # global average pool (jnp.mean)
        # head in f32: the last matmul is tiny; keep logits stable
        return F.linear(x.float(), self.head.weight, self.head.bias)


def ResNet50(cfg: ResNetConfig | None = None, device=None, mesh=None) -> ResNet:
    return ResNet(cfg or ResNetConfig(), device, mesh)


def _variance_scaling_(t: torch.Tensor, scale: float, fan_in: int, gen) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``: a
    normal truncated at two standard deviations, rescaled to variance
    ``scale / fan_in``."""
    std = (scale / fan_in) ** 0.5 / 0.87962566103423978
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def init_params(cfg: ResNetConfig, seed: int = 0, device="cuda") -> dict[str, torch.Tensor]:
    """Random weights as flax initialises them — he_normal convolutions,
    lecun_normal head, zero biases, BatchNorm scale 1 (bn3: 0), running
    mean 0 and var 1 — drawn in f32 from a ``torch.Generator`` on
    ``device`` (the card by default; raises without one unless
    ``device="cpu"``) seeded with ``seed``. Returns a state dict for
    ``ResNet(cfg)``; the numbers differ from ``jax.random``'s."""
    device = resolve_device(device)
    model = ResNet(cfg, device="meta")
    gen = torch.Generator(device=device).manual_seed(seed)
    bn_zero = {n for n, m in model.named_modules() if isinstance(m, BatchNorm) and m.zero_scale}
    out = {}
    for name, p in model.state_dict().items():
        owner, leaf = name.rsplit(".", 1)
        t = torch.empty(p.shape, device=device)
        if p.dim() == 4:  # conv OIHW: he_normal
            _variance_scaling_(t, 2.0, p.shape[1] * p.shape[2] * p.shape[3], gen)
        elif owner == "head" and leaf == "weight":  # lecun_normal
            _variance_scaling_(t, 1.0, p.shape[1], gen)
        elif leaf == "weight":  # BatchNorm scale
            t.fill_(0.0 if owner in bn_zero else 1.0)
        elif leaf == "running_var":
            t.fill_(1.0)
        else:  # biases, running means
            t.zero_()
        out[name] = t
    return out


def build(cfg: ResNetConfig, params, device, mesh=None) -> ResNet:
    """``ResNet(cfg, mesh=mesh)`` on ``device`` holding a copy of ``params``
    (a state dict or another ``ResNet``'s weights) as f32 masters that
    require grad."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    model = ResNet(cfg, device="meta", mesh=mesh)
    want = model.state_dict()
    missing, extra = set(want) - set(params), set(params) - set(want)
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    model.load_state_dict({k: params[k].to(device=device, dtype=torch.float32, copy=True)
                           for k in want}, assign=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def flops_per_example(cfg: ResNetConfig, image_size: int = 224) -> float:
    """Analytic FORWARD FLOPs per image (conv/dense MACs x 2), as in the
    JAX package; the x3 of training is applied in ``obs.goodput.train_mfu``."""
    total = 0.0
    size = image_size // 2  # stem stride 2 (or s2d fold)
    if cfg.stem == "space_to_depth":
        stem_macs = 12 * 16
    elif cfg.stem == "conv":
        stem_macs = 3 * 49
    else:
        raise ValueError(f"Unknown stem {cfg.stem!r}")
    total += 2.0 * size * size * cfg.width * stem_macs
    size //= 2  # maxpool
    in_c = cfg.width
    for stage, blocks in enumerate(cfg.stage_sizes):
        filters = cfg.width * 2 ** stage
        for block in range(blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            out_size = size // stride
            total += 2.0 * size * size * filters * in_c
            total += 2.0 * out_size * out_size * filters * filters * 9
            total += 2.0 * out_size * out_size * (filters * 4) * filters
            if in_c != filters * 4 or stride != 1:
                total += 2.0 * out_size * out_size * (filters * 4) * in_c
            in_c = filters * 4
            size = out_size
    total += 2.0 * in_c * cfg.num_classes
    return total

