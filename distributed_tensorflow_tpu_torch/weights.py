"""Convert the JAX package's flax parameter tree into the port's model.

``from_jax_params(params_np, cfg)`` takes the tree of a
``distributed_tensorflow_tpu.models.transformer.Transformer`` (causal,
pre-LN; split q/k/v; as nested dicts of numpy arrays — ``jax.device_get``
of the params gives one) and returns a ``models.transformer.Transformer``
holding the same numbers. Layout: a flax Dense ``kernel`` is ``[in,
out]``, the port's ``Dense.weight`` is ``[out, in]`` (``nn.Linear``).
The same tree serves ``fused_ln_matmul=True``: both flax paths own the
same parameters. Nothing here imports jax.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

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
        "final_ln.weight": _t(params_np["final_ln"]["scale"]),
        "final_ln.bias": _t(params_np["final_ln"]["bias"]),
        "mlm_bias": _t(params_np["mlm_bias"]),
    }
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
