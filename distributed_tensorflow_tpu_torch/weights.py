"""Convert the JAX package's flax parameter trees into the port's models.

``from_jax_params(params_np, cfg)`` takes the tree of a
``distributed_tensorflow_tpu.models.transformer.Transformer`` (pre-LN
with ``final_ln``, or post-LN with ``embed_ln``; a non-causal model's
``mlm_transform`` and ``mlm_ln``; split q/k/v; as nested dicts of numpy
arrays — ``jax.device_get`` of the params gives one) and returns a
``models.transformer.Transformer`` holding the same numbers. Layout: a flax Dense ``kernel`` is ``[in,
out]``, the port's ``Dense.weight`` is ``[out, in]`` (``nn.Linear``).
The same tree serves ``fused_ln_matmul=True``: both flax paths own the
same parameters.

``resnet_from_jax(params_np, batch_stats_np, cfg)`` does the same for a
``distributed_tensorflow_tpu.models.resnet.ResNet`` (``block_impl``
standard or fused: one tree): every conv ``kernel`` HWIO -> OIHW
(``stem_conv_s2d`` ``[4, 4, 12, w]`` included: the port's
``space_to_depth`` keeps the JAX channel order), the head's Dense
``[in, out]`` -> ``[out, in]``, BatchNorm ``scale``/``bias`` -> ``weight``/
``bias`` and ``batch_stats`` ``mean``/``var`` -> ``running_mean``/
``running_var``. Nothing here imports jax.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models import resnet
from .models.transformer import Transformer, TransformerConfig, build
from .utils.device import resolve_device


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _state_dict_from_jax(params_np: Mapping, cfg: TransformerConfig
                        ) -> dict[str, torch.Tensor]:
    """The flax tree as a state dict of ``Transformer(cfg)`` (f32; the
    model casts Dense weights to ``cfg.dtype`` when it loads them)."""
    sd = {
        "tok_embed.weight": _t(params_np["tok_embed"]["embedding"]),
        "pos_embed": _t(params_np["pos_embed"]),
        "mlm_bias": _t(params_np["mlm_bias"]),
    }
    for ln in ("final_ln",) if cfg.pre_ln else ("embed_ln",):
        sd[ln + ".weight"] = _t(params_np[ln]["scale"])
        sd[ln + ".bias"] = _t(params_np[ln]["bias"])
    if not cfg.causal:
        sd["mlm_transform.weight"] = _t(params_np["mlm_transform"]["kernel"]).t().contiguous()
        sd["mlm_transform.bias"] = _t(params_np["mlm_transform"]["bias"])
        sd["mlm_ln.weight"] = _t(params_np["mlm_ln"]["scale"])
        sd["mlm_ln.bias"] = _t(params_np["mlm_ln"]["bias"])
    for i in range(cfg.num_layers):
        layer = params_np[f"layer_{i}"]
        pre = f"layers.{i}."
        for ln in ("ln1", "ln2"):
            sd[pre + ln + ".weight"] = _t(layer[ln]["scale"])
            sd[pre + ln + ".bias"] = _t(layer[ln]["bias"])
        dense = {f"attn.{n}": layer["attn"][n]
                 for n in ("query", "key", "value", "attn_out")}
        dense.update(mlp_in=layer["mlp_in"], mlp_out=layer["mlp_out"])
        for name, p in dense.items():
            sd[pre + name + ".weight"] = _t(p["kernel"]).t().contiguous()
            sd[pre + name + ".bias"] = _t(p["bias"])
    return sd


def from_jax_params(params_np: Mapping, cfg: TransformerConfig,
                    device="cuda", trainable: bool = False) -> Transformer:
    """``Transformer(cfg)`` on ``device`` with the flax tree's weights —
    the card by default (raises without one unless ``device="cpu"``).
    ``trainable=True`` gives f32 masters with gradients on (a model to
    train); otherwise a frozen serving model."""
    device = resolve_device(device)
    return build(cfg, _state_dict_from_jax(params_np, cfg), device, trainable=trainable)


def resnet_state_dict_from_jax(params_np: Mapping, cfg: resnet.ResNetConfig,
                               batch_stats_np: Mapping | None = None
                               ) -> dict[str, torch.Tensor]:
    """The flax ResNet tree as a state dict of ``resnet.ResNet(cfg)`` (f32).
    Without ``batch_stats_np`` the running-statistics buffers are left out
    (a gradient tree converts this way)."""
    sd = {}
    for name, mod in resnet.ResNet(cfg, device="meta").named_modules():
        node = params_np
        for part in name.split(".") if name else ():
            node = node[part]
        if isinstance(mod, resnet.ConvKernel):
            sd[name + ".weight"] = _t(node["kernel"]).permute(3, 2, 0, 1).contiguous()
        elif isinstance(mod, resnet.BatchNorm):
            sd[name + ".weight"] = _t(node["scale"])
            sd[name + ".bias"] = _t(node["bias"])
            if batch_stats_np is not None:
                stats = batch_stats_np
                for part in name.split("."):
                    stats = stats[part]
                sd[name + ".running_mean"] = _t(stats["mean"])
                sd[name + ".running_var"] = _t(stats["var"])
        elif name == "head":
            sd["head.weight"] = _t(node["kernel"]).t().contiguous()
            sd["head.bias"] = _t(node["bias"])
    return sd


def resnet_from_jax(params_np: Mapping, batch_stats_np: Mapping, cfg: resnet.ResNetConfig,
                    device="cuda") -> resnet.ResNet:
    """``resnet.ResNet(cfg)`` on ``device`` (the card by default; raises
    without one unless ``device="cpu"``) holding the flax tree's params and
    batch_stats, as f32 masters that require grad."""
    device = resolve_device(device)
    return resnet.build(cfg, resnet_state_dict_from_jax(params_np, cfg, batch_stats_np), device)
