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

``wide_deep_from_jax(params_np, cfg, mesh)`` does it for a
``distributed_tensorflow_tpu.models.wide_deep.WideDeep``: the tables as
they are, cut to this rank's range shard over ``mesh``'s ``model`` axis,
and each Dense ``[in, out]`` -> ``[out, in]``; ``wide_deep_to_jax`` is its
inverse over the ranks' state dicts (the tables reassembled).

``mlp_from_jax(params_np, cfg)`` and ``cnn_from_jax(params_np,
batch_stats_np, cfg)`` do it for the MNIST MLP and the CIFAR-10 CNN: each
Dense ``[in, out]`` -> ``[out, in]`` (the CNN's ``dense`` rows stay in
flax's (h, w, c) order: the port flattens its NHWC map the same way),
each conv ``kernel`` HWIO -> OIHW, BatchNorm as the ResNet's;
``cnn_to_jax`` is the CNN's inverse (params and batch_stats).

``optimizer_state_from_jax(opt_state_np, optimizer, cfg)`` carries an
optax state across: adam/adamw's ``mu`` / ``nu`` / ``count`` (and
momentum's ``trace``, adagrad's ``sum_of_squares``, the JAX package's
ftrl ``z`` / ``n``) become the port ``Optimizer``'s state (each tree
converted like the parameters), its update count and Adam's step, so a
JAX ``TrainState`` taken at step k continues in the port as in JAX; a
``multi_transform`` state goes group by group into a ``MultiOptimizer``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .models import cnn, mlp, resnet
from .models import wide_deep as wd
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


def mlp_state_dict_from_jax(params_np: Mapping, cfg: mlp.MLPConfig) -> dict[str, torch.Tensor]:
    """The flax MLP tree (or a gradient tree over it) as a state dict of
    ``mlp.MLP(cfg)`` (f32)."""
    names = [f"dense_{i}" for i in range(len(cfg.hidden_sizes))] + ["head"]
    sd = {}
    for name in names:
        sd[name + ".weight"] = _t(params_np[name]["kernel"]).t().contiguous()
        sd[name + ".bias"] = _t(params_np[name]["bias"])
    return sd


def mlp_from_jax(params_np: Mapping, cfg: mlp.MLPConfig, device="cuda") -> mlp.MLP:
    """``mlp.MLP(cfg)`` on ``device`` (the card by default; raises without
    one unless ``device="cpu"``) holding the flax tree's weights, as f32
    masters that require grad."""
    return mlp.build(cfg, mlp_state_dict_from_jax(params_np, cfg), resolve_device(device))


def cnn_state_dict_from_jax(params_np: Mapping, cfg: cnn.CNNConfig,
                            batch_stats_np: Mapping | None = None) -> dict[str, torch.Tensor]:
    """The flax CNN tree as a state dict of ``cnn.CNN(cfg)`` (f32); without
    ``batch_stats_np`` the running statistics are left out (a gradient
    tree converts this way)."""
    sd = {}
    for i in range(len(cfg.channels)):
        conv = params_np[f"conv_{i}"]
        sd[f"conv_{i}.weight"] = _t(conv["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"conv_{i}.bias"] = _t(conv["bias"])
        if cfg.use_batchnorm:
            sd[f"bn_{i}.weight"] = _t(params_np[f"bn_{i}"]["scale"])
            sd[f"bn_{i}.bias"] = _t(params_np[f"bn_{i}"]["bias"])
            if batch_stats_np is not None:
                sd[f"bn_{i}.running_mean"] = _t(batch_stats_np[f"bn_{i}"]["mean"])
                sd[f"bn_{i}.running_var"] = _t(batch_stats_np[f"bn_{i}"]["var"])
    for name in ("dense", "head"):
        sd[name + ".weight"] = _t(params_np[name]["kernel"]).t().contiguous()
        sd[name + ".bias"] = _t(params_np[name]["bias"])
    return sd


def cnn_from_jax(params_np: Mapping, batch_stats_np: Mapping, cfg: cnn.CNNConfig,
                 device="cuda", input_shape=(32, 32, 3)) -> cnn.CNN:
    """``cnn.CNN(cfg, input_shape)`` on ``device`` (the card by default;
    raises without one unless ``device="cpu"``) holding the flax tree's
    params and batch_stats, as f32 masters that require grad."""
    return cnn.build(cfg, cnn_state_dict_from_jax(params_np, cfg, batch_stats_np),
                     resolve_device(device), input_shape)


def cnn_to_jax(state_dict: Mapping, cfg: cnn.CNNConfig) -> tuple[dict, dict]:
    """``(params, batch_stats)``, the flax trees (numpy) of a CNN whose
    state dict (parameters and buffers) is ``state_dict``."""
    arr = lambda n: np.asarray(torch.as_tensor(state_dict[n]).detach().float().cpu())  # noqa: E731
    params, stats = {}, {}
    for i in range(len(cfg.channels)):
        params[f"conv_{i}"] = {"kernel": arr(f"conv_{i}.weight").transpose(2, 3, 1, 0),
                               "bias": arr(f"conv_{i}.bias")}
        if cfg.use_batchnorm:
            params[f"bn_{i}"] = {"scale": arr(f"bn_{i}.weight"), "bias": arr(f"bn_{i}.bias")}
            stats[f"bn_{i}"] = {"mean": arr(f"bn_{i}.running_mean"),
                                "var": arr(f"bn_{i}.running_var")}
    for name in ("dense", "head"):
        params[name] = {"kernel": arr(name + ".weight").T, "bias": arr(name + ".bias")}
    return params, stats


def wide_deep_state_dict_from_jax(params_np: Mapping, cfg: wd.WideDeepConfig,
                                  shard: tuple[int, int] = (0, 1)) -> dict[str, torch.Tensor]:
    """The flax Wide&Deep tree (or an optimizer's tree over it) as a
    state dict of ``WideDeep(cfg)``, each table cut to range shard
    ``shard = (index, count)`` (``ops/embedding.range_shard``). Entries
    that are not arrays (optax's ``MaskedNode`` of a group the parameter is
    not in) are left out."""
    from .ops.embedding import range_shard

    sd = {}
    for name, _ in wd.WideDeep(cfg, device="meta").named_parameters():
        owner, _, leaf = name.partition(".")
        node = params_np.get(owner) if isinstance(params_np, Mapping) else None
        if leaf:
            node = node.get("kernel" if leaf == "weight" else "bias") \
                if isinstance(node, Mapping) else None
        if not isinstance(node, np.ndarray) and not hasattr(node, "__array__"):
            continue
        t = _t(node)
        if leaf == "weight":
            t = t.t().contiguous()
        elif not leaf:  # a table
            t = range_shard(t, *shard)
        sd[name] = t
    return sd


def wide_deep_from_jax(params_np: Mapping, cfg: wd.WideDeepConfig, mesh=None,
                       device="cuda") -> wd.WideDeep:
    """``WideDeep(cfg, mesh)`` on ``device`` (the card by default; raises
    without one unless ``device="cpu"``) holding the flax tree's weights,
    each table this rank's range shard over ``mesh``'s ``model`` axis;
    f32 masters that require grad."""
    sd = wide_deep_state_dict_from_jax(params_np, cfg)
    return wd.build(cfg, sd, resolve_device(device), mesh)


def wide_deep_to_jax(state_dicts: list[Mapping], cfg: wd.WideDeepConfig) -> dict:
    """The flax tree (numpy) of the model whose ``model``-axis ranks hold
    ``state_dicts`` (in rank order; one for an unsharded model): the table
    shards concatenated and the padding cut, each Dense ``[out, in]`` ->
    ``[in, out]``."""
    arr = lambda v: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)  # noqa: E731
    tree: dict = {}
    for name in state_dicts[0]:
        owner, _, leaf = name.partition(".")
        if not leaf:
            i = int(owner.rsplit("_", 1)[1])
            tree[owner] = np.concatenate([arr(sd[name]) for sd in state_dicts])[
                :cfg.vocab_sizes[i]]
        else:
            v = arr(state_dicts[0][name])
            tree.setdefault(owner, {})["kernel" if leaf == "weight" else "bias"] = (
                v.T if leaf == "weight" else v)
    return tree


def _optax_leaves(opt_state: Any) -> dict[str, Any]:
    """The fields of an optax state (nested tuples and namedtuples of numpy
    arrays, as ``jax.device_get`` gives them) this port reads: ``mu``,
    ``nu``, ``trace``, ``sum_of_squares``, ``inner_states`` (a
    ``multi_transform``'s), the ftrl dict's ``z`` / ``n`` and the first
    ``count``."""
    found: dict[str, Any] = {}

    def walk(node):
        fields = getattr(node, "_fields", None)
        if fields is not None:
            for f in fields:
                v = getattr(node, f)
                if f in ("mu", "nu", "trace", "sum_of_squares", "inner_states") \
                        and f not in found:
                    found[f] = v
                elif f == "count" and "count" not in found:
                    found["count"] = v
                else:
                    walk(v)
        elif isinstance(node, Mapping) and set(node) == {"z", "n", "count"}:
            for f in ("z", "n", "count"):
                found.setdefault(f, node[f])
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(opt_state)
    return found


def optimizer_state_from_jax(opt_state_np: Any, model: torch.nn.Module, optimizer) -> None:
    """Load ``opt_state_np`` (an optax state of the JAX package's
    ``make_optimizer`` or ``make_multi_optimizer``, as numpy) into
    ``optimizer`` (the port's ``train.optimizers.Optimizer`` or
    ``MultiOptimizer`` over ``model``, a ``Transformer``, a
    ``resnet.ResNet`` or a ``WideDeep``), in place: Adam's ``exp_avg`` /
    ``exp_avg_sq`` / ``step`` from ``mu`` / ``nu`` / ``count``, momentum's
    ``momentum_buffer`` from ``trace``, AdaGrad's ``sum`` from
    ``sum_of_squares``, FTRL's ``z`` / ``n``, and the update count (the
    schedule's) from ``count``; each on its parameter's device (a table's
    cut to the parameter's shard). A ``multi_transform`` state's groups
    go to the ``MultiOptimizer``'s groups of the same labels."""
    from .train.optimizers import MultiOptimizer

    if isinstance(optimizer, MultiOptimizer):
        inner = _optax_leaves(opt_state_np).get("inner_states")
        if inner is None:
            raise ValueError("a MultiOptimizer takes a multi_transform state")
        for label, sub in optimizer.groups.items():
            optimizer_state_from_jax(inner[label], model, sub)
        return
    leaves = _optax_leaves(opt_state_np)
    if "count" not in leaves:
        raise ValueError("optax state has no count")
    keys = optimizer.state_keys()
    source = {"exp_avg": "mu", "exp_avg_sq": "nu", "momentum_buffer": "trace",
              "sum": "sum_of_squares", "z": "z", "n": "n"}
    missing = [source[k] for k in keys if k != "step" and source[k] not in leaves]
    if missing:
        raise ValueError(f"optax state has no {missing} for optimizer {optimizer.cfg.name!r}")
    cfg = model.cfg
    if isinstance(cfg, resnet.ResNetConfig):
        to_sd = lambda tree: resnet_state_dict_from_jax(tree, cfg)  # noqa: E731
    elif isinstance(cfg, wd.WideDeepConfig):
        shard = wd.model_shards(model.mesh)
        to_sd = lambda tree: wide_deep_state_dict_from_jax(tree, cfg, shard)  # noqa: E731
    else:
        to_sd = lambda tree: _state_dict_from_jax(tree, cfg)  # noqa: E731
    trees = {k: to_sd(leaves[source[k]]) for k in keys if k != "step"}
    names = {id(p): n for n, p in model.named_parameters()}
    count = int(np.asarray(leaves["count"]))
    sd = optimizer.opt.state_dict()
    sd["state"] = {}
    for i, p in enumerate(optimizer.params if count > 0 else ()):
        sd["state"][i] = {k: (torch.tensor(float(count)) if k == "step" else
                              trees[k][names[id(p)]].to(device=p.device, dtype=p.dtype))
                          for k in keys}
    optimizer.opt.load_state_dict(sd)
    optimizer.count = count
