"""Convert the JAX package's flax parameter trees into the port's models.

``from_jax_params(params_np, cfg)`` takes the tree of a
``distributed_tensorflow_tpu.models.transformer.Transformer`` (pre-LN
with ``final_ln``, or post-LN with ``embed_ln``; a non-causal model's
``mlm_transform`` and ``mlm_ln``; split q/k/v, or with ``fused_qkv`` one
``qkv`` Dense whose columns are head-major ``[H, 3, D]``; as nested
dicts of numpy arrays — ``jax.device_get`` of the params gives one) and
returns a ``models.transformer.Transformer`` holding the same numbers.
Layout: a flax Dense ``kernel`` is ``[in, out]``, the port's
``Dense.weight`` is ``[out, in]`` (``nn.Linear``). The same tree serves
``fused_ln_matmul=True``: both flax paths own the same parameters.
``transformer_to_jax`` is the inverse; ``fuse_qkv`` / ``split_qkv`` turn
a split state dict into the fused one of the same function and back.
With ``mesh=`` (tensor and fully-sharded data parallelism,
``models/transformer.py``) each rank gets its shard of the tree
(``sharding.shard_tensor`` of the whole tensors, by
``transformer_specs``); ``transformer_to_jax`` takes the ranks' state
dicts (``mesh_shape=``) and reassembles each sharded tensor
(``sharding.assemble``). ``pipelined_from_jax(params_np, cfg, mesh=,
n_virtual=)`` gives this rank's stage of a
``models.transformer.PipelinedTransformer`` from the JAX package's
pipelined tree (``{"ends", "blocks"}``, every block leaf stacked ``[S,
(V,) layers, ...]``: its ``to_pipeline_params``) or from the dense flax
tree (stacked at the mesh's ``pipe`` size).

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
optax state across: adam/adamw/lamb's ``mu`` / ``nu`` / ``count`` (and
momentum's ``trace``, rmsprop's ``nu`` / ``trace``, adagrad's
``sum_of_squares``, adafactor's factored ``v_row`` / ``v_col`` or full
``v``, the JAX package's ftrl ``z`` / ``n``) become the port
``Optimizer``'s state (each tree converted like the parameters), its
update count and Adam's step, so a
JAX ``TrainState`` taken at step k continues in the port as in JAX; a
``multi_transform`` state goes group by group into a ``MultiOptimizer``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .models import cnn, mlp, resnet
from .models import wide_deep as wd
from .models.transformer import (
    PipelinedTransformer,
    Transformer,
    TransformerConfig,
    build,
    build_pipelined,
)
from .utils.device import resolve_device


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


#: the attention projections' names, split or fused (``cfg.fused_qkv``)
_QKV_NAMES = {False: ("query", "key", "value"), True: ("qkv",)}


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
                 for n in (_QKV_NAMES[cfg.fused_qkv] + ("attn_out",))}
        dense.update(mlp_in=layer["mlp_in"], mlp_out=layer["mlp_out"])
        for name, p in dense.items():
            sd[pre + name + ".weight"] = _t(p["kernel"]).t().contiguous()
            sd[pre + name + ".bias"] = _t(p["bias"])
    return sd


def transformer_to_jax(state_dict, cfg: TransformerConfig, mesh_shape=None,
                       specs=None) -> dict:
    """Inverse of ``_state_dict_from_jax``: a ``Transformer(cfg)`` state
    dict (any dtype, any device) as the flax tree of numpy f32 arrays, each
    Dense ``[out, in]`` back to ``[in, out]`` (a fused ``qkv`` keeps its
    head-major columns). Sharded: ``state_dict`` is the list of every
    rank's, in rank order over ``mesh_shape`` (axis -> size), each tensor
    reassembled by its spec (``specs``, default ``transformer_specs``)."""
    if not isinstance(state_dict, Mapping):
        from .models.transformer import transformer_specs
        from .parallel.mesh import Mesh
        from .parallel.sharding import assemble

        sizes = {a: int(mesh_shape.get(a, 1)) for a in Mesh.axis_names}
        specs = specs or transformer_specs(cfg, Mesh(sizes, torch.device("cpu")))
        shapes = Transformer(cfg, device="meta").global_shapes
        state_dict = {k: assemble([torch.as_tensor(sd[k]) for sd in state_dict],
                                  specs.get(k, ()), sizes, shapes[k])
                      for k in state_dict[0]}
    a = lambda t: np.asarray(torch.as_tensor(t).detach().float().cpu().numpy())  # noqa: E731
    tree: dict = {"tok_embed": {"embedding": a(state_dict["tok_embed.weight"])},
                  "pos_embed": a(state_dict["pos_embed"]),
                  "mlm_bias": a(state_dict["mlm_bias"])}

    def ln(name, prefix=""):
        return {"scale": a(state_dict[f"{prefix}{name}.weight"]),
                "bias": a(state_dict[f"{prefix}{name}.bias"])}

    def dense(name):
        return {"kernel": a(state_dict[f"{name}.weight"]).T.copy(),
                "bias": a(state_dict[f"{name}.bias"])}

    for name in ("final_ln",) if cfg.pre_ln else ("embed_ln",):
        tree[name] = ln(name)
    if not cfg.causal:
        tree["mlm_transform"] = dense("mlm_transform")
        tree["mlm_ln"] = ln("mlm_ln")
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        tree[f"layer_{i}"] = {
            "ln1": ln("ln1", pre), "ln2": ln("ln2", pre),
            "attn": {n: dense(f"{pre}attn.{n}")
                     for n in _QKV_NAMES[cfg.fused_qkv] + ("attn_out",)},
            "mlp_in": dense(pre + "mlp_in"), "mlp_out": dense(pre + "mlp_out")}
    return tree


def fuse_qkv(state_dict: Mapping, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """A split-q/k/v ``Transformer(cfg)`` state dict as the one of
    ``fused_qkv=True`` holding the same function: each layer's query, key
    and value rows interleaved head-major into ``attn.qkv`` (row
    ``h·3D + i·D + j`` is projection ``i``'s row ``h·D + j``)."""
    H, D = cfg.num_heads, cfg.head_dim
    out = dict(state_dict)
    for i in range(cfg.num_layers):
        pre = f"layers.{i}.attn."
        for leaf in ("weight", "bias"):
            parts = [out.pop(f"{pre}{n}.{leaf}") for n in _QKV_NAMES[False]]
            rest = parts[0].shape[1:]
            out[f"{pre}qkv.{leaf}"] = torch.stack(
                [t.reshape(H, D, *rest) for t in parts], 1).reshape(3 * H * D, *rest)
    return out


def split_qkv(state_dict: Mapping, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """Inverse of ``fuse_qkv``."""
    H, D = cfg.num_heads, cfg.head_dim
    out = dict(state_dict)
    for i in range(cfg.num_layers):
        pre = f"layers.{i}.attn."
        for leaf in ("weight", "bias"):
            t = out.pop(f"{pre}qkv.{leaf}")
            rest = t.shape[1:]
            t = t.reshape(H, 3, D, *rest)
            for j, n in enumerate(_QKV_NAMES[False]):
                out[f"{pre}{n}.{leaf}"] = t[:, j].reshape(H * D, *rest).contiguous()
    return out


def from_jax_params(params_np: Mapping, cfg: TransformerConfig,
                    device="cuda", trainable: bool = False, mesh=None,
                    specs=None) -> Transformer:
    """``Transformer(cfg)`` on ``device`` with the flax tree's weights —
    the card by default (raises without one unless ``device="cpu"``).
    ``trainable=True`` gives f32 masters with gradients on (a model to
    train); otherwise a frozen serving model. ``mesh``: this rank's shard
    of each tensor by ``specs`` (default ``transformer_specs``)."""
    device = resolve_device(device)
    if mesh is not None and specs is None:
        from .models.transformer import transformer_specs

        specs = transformer_specs(cfg, mesh)
    return build(cfg, _state_dict_from_jax(params_np, cfg), device, trainable=trainable,
                 mesh=mesh, specs=specs)


def _unstack_jax_pipeline(pparams_np: Mapping, cfg: TransformerConfig,
                          n_virtual: int) -> dict:
    """JAX's ``from_pipeline_params`` on numpy: the pipelined tree's
    stacked blocks back into one ``layer_<i>`` subtree a layer."""

    def per_layer(node, i):
        if isinstance(node, Mapping):
            return {k: per_layer(v, i) for k, v in node.items()}
        x = np.asarray(node)
        flat = (x.reshape(-1, *x.shape[2:]) if n_virtual == 1
                else x.swapaxes(0, 1).reshape(-1, *x.shape[3:]))
        return flat[i]

    out = dict(pparams_np["ends"])
    out.update({f"layer_{i}": per_layer(pparams_np["blocks"], i)
                for i in range(cfg.num_layers)})
    return out


def pipelined_from_jax(params_np: Mapping, cfg: TransformerConfig, device="cuda", *,
                       trainable: bool = False, mesh=None, n_virtual: int = 1,
                       n_microbatches: int = 1) -> PipelinedTransformer:
    """This rank's ``PipelinedTransformer`` on ``device`` (the card by
    default) with the weights of the JAX package's pipelined tree
    (``{"ends", "blocks"}``, laid out for ``n_virtual``) or of its dense
    flax tree (module docstring); ``trainable`` as ``from_jax_params``."""
    if "blocks" in params_np:
        params_np = _unstack_jax_pipeline(params_np, cfg, n_virtual)
    return build_pipelined(cfg, _state_dict_from_jax(params_np, cfg), resolve_device(device),
                           trainable=trainable, mesh=mesh, n_virtual=n_virtual,
                           n_microbatches=n_microbatches)


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
    ``nu``, ``trace``, ``sum_of_squares``, adafactor's ``v_row`` /
    ``v_col`` / ``v``, ``inner_states`` (a ``multi_transform``'s), the ftrl
    dict's ``z`` / ``n`` and the first ``count``."""
    found: dict[str, Any] = {}

    def walk(node):
        fields = getattr(node, "_fields", None)
        if fields is not None:
            for f in fields:
                v = getattr(node, f)
                if f in ("mu", "nu", "trace", "sum_of_squares", "inner_states",
                         "v_row", "v_col", "v") and f not in found:
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


def _zip_trees(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], Mapping):
        return {k: _zip_trees(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _adafactor_stats(leaves: dict, to_sd) -> dict[str, dict[str, torch.Tensor]]:
    """optax adafactor's ``v`` / ``v_row`` / ``v_col`` trees as the port's
    state per parameter name: ``{"v"}`` for an unfactored parameter,
    ``{"v_row", "v_col"}`` for a factored one. optax's ``v_row`` is the mean
    over the larger axis, indexed by the other (for a square one: the mean
    over axis 1), as the port's of its own shape is; so only a square
    parameter the layout conversion transposes (a Dense kernel) swaps the
    two. Which parameter is which, and which square one is transposed,
    comes from converting probes of the JAX shapes with ``to_sd``."""
    ids: list = []

    def jax_shape(v, vr, vc):
        if np.size(v) > 1 or np.size(vr) == np.size(vc) == 1:
            return np.shape(v)
        if np.ndim(vr) != 1:
            raise NotImplementedError(
                "adafactor state of a factored parameter above 2-D cannot be carried across "
                "(its layout change is not a transpose)")
        return (np.size(vr), np.size(vc))

    def tag(v, vr, vc):  # every element of a leaf holds its index
        ids.append((v, vr, vc))
        return np.full(jax_shape(v, vr, vc), len(ids) - 1, np.float32)

    def probe(v, vr, vc):  # a factored leaf's row index, an unfactored one's v
        shape = jax_shape(v, vr, vc)
        if np.size(v) > 1 or len(shape) < 2:
            return v
        return np.broadcast_to(np.arange(shape[0], dtype=np.float32)[:, None], shape)

    trees = (leaves["v"], leaves["v_row"], leaves["v_col"])
    which = to_sd(_zip_trees(tag, *trees))
    probed = to_sd(_zip_trees(probe, *trees))
    out = {}
    for name, t in which.items():
        v, vr, vc = ids[int(t.reshape(-1)[0])]
        if np.size(v) > 1 or t.dim() < 2:
            out[name] = {"v": probed[name]}
            continue
        rows, cols = _t(vr).reshape(-1), _t(vc).reshape(-1)
        p = probed[name]
        transposed = p.shape[0] == p.shape[1] and not bool(
            (p[:, 0] == torch.arange(p.shape[0], dtype=p.dtype)).all())
        out[name] = {"v_row": cols, "v_col": rows} if transposed else \
            {"v_row": rows, "v_col": cols}
    return out


#: the port's optimizer state keys -> the optax state fields they come from
_OPTAX_SOURCE = {"exp_avg": "mu", "exp_avg_sq": "nu", "momentum_buffer": "trace",
                 "square_avg": "nu", "sum": "sum_of_squares", "z": "z", "n": "n",
                 "v_row": "v_row", "v_col": "v_col", "v": "v"}


def optimizer_state_from_jax(opt_state_np: Any, model: torch.nn.Module, optimizer) -> None:
    """Load ``opt_state_np`` (an optax state of the JAX package's
    ``make_optimizer`` or ``make_multi_optimizer``, as numpy) into
    ``optimizer`` (the port's ``train.optimizers.Optimizer`` or
    ``MultiOptimizer`` over ``model``, a ``Transformer``, a
    ``resnet.ResNet`` or a ``WideDeep``), in place: Adam's and lamb's
    ``exp_avg`` / ``exp_avg_sq`` / ``step`` from ``mu`` / ``nu`` /
    ``count``, momentum's ``momentum_buffer`` from ``trace``, rmsprop's
    ``square_avg`` / ``momentum_buffer`` from ``nu`` / ``trace``, AdaGrad's
    ``sum`` from ``sum_of_squares``, FTRL's ``z`` / ``n``, adafactor's
    ``v_row`` / ``v_col`` or ``v`` (``_adafactor_stats``), and the update
    count (the schedule's) from ``count``; each on its parameter's device
    (a table's cut to the parameter's shard). A ``multi_transform`` state's
    groups go to the ``MultiOptimizer``'s groups of the same labels."""
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
    per_param = optimizer.param_state_keys()
    needed = sorted({_OPTAX_SOURCE[k] for keys in per_param for k in keys if k != "step"})
    missing = [f for f in needed if f not in leaves]
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
    if "v" in needed:
        stats = _adafactor_stats(leaves, to_sd)
        trees = {k: {n: st[k] for n, st in stats.items() if k in st}
                 for k in ("v", "v_row", "v_col")}
    else:
        trees = {f: to_sd(leaves[f]) for f in needed}
    names = {id(p): n for n, p in model.named_parameters()}
    count = int(np.asarray(leaves["count"]))
    # a sharded Transformer's moments: the whole ones cut to the shard, as
    # its parameters are (a table's of Wide&Deep are cut by to_sd)
    lays = ({} if isinstance(cfg, (resnet.ResNetConfig, wd.WideDeepConfig)) else
            _opt_layouts(optimizer))
    sd = optimizer.opt.state_dict()
    sd["state"] = {}
    for i, p in enumerate(optimizer.params if count > 0 else ()):
        st = {}
        for k in per_param[i]:
            if k == "step":
                st[k] = torch.tensor(float(count))
                continue
            v = trees[_OPTAX_SOURCE[k]][names[id(p)]]
            if (i, k) in lays:
                v = lays[i, k].shard(v)
            st[k] = v.to(device=p.device, dtype=p.dtype)
        sd["state"][i] = st
    optimizer.opt.load_state_dict(sd)
    optimizer.count = count


def _opt_layouts(optimizer) -> dict:
    """``(param index, state key) -> Layout`` of each sharded state leaf
    (``train/optimizers.state_layout``)."""
    from .train.optimizers import state_layout

    return {(i, k): state_layout(lay, k)
            for i, (lay, keys) in enumerate(zip(getattr(optimizer, "layouts", None) or [],
                                                optimizer.param_state_keys()))
            if lay is not None for k in keys if state_layout(lay, k) is not None}
