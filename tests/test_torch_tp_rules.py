"""The port's parameter specs for tensor and fully-sharded data
parallelism (``models/transformer.transformer_specs``) against the JAX
package's, leaf for leaf: JAX computes them as ``init_train_state`` does
for the transformer workloads (``jax.eval_shape`` of the init, the
``transformer_rules`` table, then ``auto_fsdp_specs`` merged), on the
BERT encoder (split QKV), the causal decoder and the fused-QKV decoder,
at four meshes. A port spec is in the port's layout (a Dense weight is
``[out, in]``), so a JAX kernel's spec is compared reversed. The sizes
put ``pos_embed`` (128 x 128) and BERT's ``mlm_transform`` kernel at the
2^14 elements where ``auto_fsdp_specs`` starts sharding. No process is
spawned; the converters' sharded paths run each rank in turn with
``sharding.axis_index`` answering as that rank.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from distributed_tensorflow_tpu.models import transformer as jtfm
from distributed_tensorflow_tpu.parallel import MeshSpec as JMeshSpec
from distributed_tensorflow_tpu.parallel import build_mesh as jbuild_mesh
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.workloads import run_workload

SIZES = dict(vocab_size=250, max_len=128, num_layers=2, d_model=128, num_heads=4, d_ff=256)
CONFIGS = {
    "bert": dict(causal=False, pre_ln=False),
    "decoder": dict(causal=True, pre_ln=True),
    "decoder_fused_qkv": dict(causal=True, pre_ln=True, fused_qkv=True),
}
MESHES = {
    "data2_model2": dict(data=2, model=2),
    "fsdp2_model2": dict(fsdp=2, model=2),
    "fsdp4": dict(fsdp=4),
    "data2_fsdp2_model2": dict(data=2, fsdp=2, model=2),
}


def _jax_specs(jcfg, mesh):
    """JAX ``init_train_state``'s parameter specs for the transformer
    workloads (``param_rules=transformer_rules(cfg)``, ``fsdp=True``)."""
    model = jtfm.Transformer(jcfg, mesh)
    abstract = jax.eval_shape(jtfm.make_init_fn(model, 16), jax.random.PRNGKey(0))[0]
    specs = jsh.specs_from_rules(abstract, jtfm.transformer_rules(jcfg))
    specs = jsh.merge_specs(specs, jsh.auto_fsdp_specs(abstract, mesh))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    shapes = dict((jsh._path_str(p), leaf.shape)
                  for p, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0])
    return {jsh._path_str(p): (tuple(s) + (None,) * (len(shapes[jsh._path_str(p)]) - len(s)))
            for p, s in flat}


def _port(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_port_specs_equal_jax_init_train_state_specs(cfg_name, mesh_name, devices):
    sizes = MESHES[mesh_name]
    n = 1
    for v in sizes.values():
        n *= v
    jcfg = H.jax_cfg(**SIZES, **CONFIGS[cfg_name])
    jspecs = _jax_specs(jcfg, jbuild_mesh(JMeshSpec(**sizes), devices[:n]))
    tcfg = H.port_cfg(jcfg)
    mesh = tmesh.Mesh(dict(tmesh.MeshSpec(**sizes).sizes()), torch.device("cpu"))
    specs = ttfm.transformer_specs(tcfg, mesh)
    meta = ttfm.Transformer(tcfg, device="meta", trainable=True)
    seen = set()
    for name, p in meta.named_parameters():
        path, jshape, transposed = meta.jax_view(name)
        want = jspecs[path]
        assert tuple(jshape) == tuple(reversed(p.shape)) if transposed else tuple(p.shape)
        got = _port(specs[name], p.dim())
        assert (tuple(reversed(got)) if transposed else got) == want, (name, got, want)
        seen.add(path)
    assert seen == set(jspecs)  # every leaf of the flax tree, once
    # which leaves auto_fsdp_specs shards: only the ones the table replicates
    fsdp_leaves = sorted(n_ for n_, s in specs.items() if "fsdp" in s)
    if sizes.get("fsdp", 1) == 1:
        assert fsdp_leaves == []
    else:
        assert fsdp_leaves == (["mlm_transform.weight", "pos_embed"] if cfg_name == "bert"
                               else ["pos_embed"])


def test_gpt_small_and_bert_base_shard_the_leaves_jax_shards(devices):
    """At the full widths, fsdp=2 x model=2: gpt_small's only fsdp leaf is
    ``pos_embed``; bert_base's are ``pos_embed`` and ``mlm_transform``'s
    kernel (the ``[in, out]`` dim 0 JAX picks on a square kernel is the
    port's weight's dim 1); the TP leaves keep their model specs."""
    mesh = tmesh.Mesh(dict(tmesh.MeshSpec(fsdp=2, model=2).sizes()), torch.device("cpu"))
    gpt = ttfm.transformer_specs(ttfm.gpt_small(), mesh)
    bert = ttfm.transformer_specs(ttfm.bert_base(), mesh)
    assert sorted(k for k, s in gpt.items() if "fsdp" in s) == ["pos_embed"]
    assert gpt["pos_embed"] == ("fsdp", None)  # 1024 rows > 768 columns
    assert sorted(k for k, s in bert.items() if "fsdp" in s) == [
        "mlm_transform.weight", "pos_embed"]
    assert bert["pos_embed"] == (None, "fsdp")  # 768 columns > 512 rows
    assert bert["mlm_transform.weight"] == (None, "fsdp")
    for specs in (gpt, bert):
        assert specs["tok_embed.weight"] == ("model", None) and specs["mlm_bias"] == ("model",)
        assert specs["layers.0.attn.attn_out.weight"] == (None, "model")
        assert specs["layers.0.attn.attn_out.bias"] == ()
        assert specs["layers.0.mlp_in.bias"] == ("model",)
    assert tsh.local_shape((50304, 768), gpt["tok_embed.weight"], mesh) == (25152, 768)


def test_port_table_is_the_jax_table_row_for_row():
    jrows = [(r.pattern, tuple(r.spec), r.tag) for r in jtfm.TRANSFORMER_RULES.rows]
    trows = [(r.pattern, tuple(r.spec), r.tag) for r in ttfm.TRANSFORMER_RULES.rows]
    assert trows == jrows
    assert ttfm.tp_rules() == tuple((p, s) for p, s, _ in trows)
    assert ttfm._TRANSFORMER_COVERAGE == jtfm._TRANSFORMER_COVERAGE
    for fused in (False, True):
        cfg = dataclasses.replace(ttfm.bert_base(), fused_qkv=fused)
        jcfg = dataclasses.replace(jtfm.TransformerConfig(), fused_qkv=fused)
        assert [r.pattern for r in ttfm.transformer_rules(cfg).rows] == [
            r.pattern for r in jtfm.transformer_rules(jcfg).rows]


@pytest.mark.parametrize("override", ["--mesh.seq=2", "--mesh.expert=2", "--mesh.pipe=2",
                                      "--model.num_experts=4"])
def test_later_parallelisms_still_name_item_6(override):
    """MoE names item 6; a seq axis (item 6a) and a pipe axis (item 6b)
    are ported, and where their ranks would only repeat each other — seq
    without ``model.seq_impl``, pipe together with seq (the stages run no
    sequence parallelism) — they are refused (ROADMAP Queue C's deliberate
    differences)."""
    tiny = ["--model.num_layers=1", "--model.d_model=32", "--model.num_heads=2",
            "--model.d_ff=64", "--model.vocab_size=64", "--data.vocab_size=64",
            "--model.max_len=16", "--data.seq_len=16", "--train.num_steps=1"]
    extra = {"--mesh.pipe=2": ["--mesh.seq=2", "--model.seq_impl=ring"]}.get(override, [])
    match = {"--mesh.seq=2": "seq_impl is unset.*repeat",
             "--mesh.pipe=2": "no sequence parallelism.*repeat"}.get(override, "item 6")
    with pytest.raises((ValueError, NotImplementedError), match=match):
        run_workload("gpt_lm", tiny + [override] + extra, device="cpu")


def test_stage_specs_and_expert_specs_are_refused_naming_item_6():
    """A stacked stage leaf's spec (``pipe`` on its leading dim, ``model``
    beside it under PP×TP) is admitted now (item 6b); ``pipe`` on another
    dim and an expert spec are not."""
    assert tsh.check_spec(("pipe", None, "model"), "w") == ("pipe", None, "model")
    with pytest.raises(ValueError, match="leading"):
        tsh.check_spec((None, "pipe"), "w")
    with pytest.raises(NotImplementedError, match="item 6"):
        tsh.check_spec(("expert", None, "model"), "w")
    with pytest.raises(ValueError, match="no parameter is sharded over 'seq'"):
        tsh.check_spec(("seq", None), "w")
    with pytest.raises(ValueError, match="item 6"):
        ttfm.transformer_rules(dataclasses.replace(ttfm.gpt_small(), num_experts=4))


def _ranks(monkeypatch, sizes):
    """For each rank of a mesh of ``sizes`` (in rank order), a context in
    which ``sharding.axis_index`` answers as that rank would: no process
    group is needed to cut a rank's shards."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import AXIS_NAMES

    shape = [sizes.get(a, 1) for a in AXIS_NAMES]
    for r in range(int(np.prod(shape))):
        coords = dict(zip(AXIS_NAMES, np.unravel_index(r, shape)))
        monkeypatch.setattr(tsh, "axis_index", lambda a, m, c=coords: int(c[a]))
        yield r


def test_per_rank_state_dicts_reassemble_to_the_flax_tree(monkeypatch):
    """``build(..., mesh=, specs=)`` cuts each rank's shards of a BERT tree
    with a vocab of 251 at fsdp=2 x model=2 (the token table's shards
    padded to 126 rows; ``pos_embed`` and ``mlm_transform``'s kernel over
    fsdp), and ``transformer_to_jax`` of the four ranks' state dicts gives
    the one-process tree, bitwise."""
    from distributed_tensorflow_tpu_torch.weights import transformer_to_jax

    sizes = dict(fsdp=2, model=2)
    cfg = H.port_cfg(H.jax_cfg(**dict(SIZES, vocab_size=251), **CONFIGS["bert"]))
    mesh = tmesh.Mesh(dict(tmesh.MeshSpec(**sizes).sizes()), torch.device("cpu"))
    specs = ttfm.transformer_specs(cfg, mesh)
    sd = ttfm.init_params(cfg, seed=0, device="cpu", trainable=True)
    ranks = [ttfm.build(cfg, sd, "cpu", trainable=True, mesh=mesh, specs=specs).state_dict()
             for _ in _ranks(monkeypatch, sizes)]
    assert tuple(ranks[0]["tok_embed.weight"].shape) == (126, 128)
    assert tuple(ranks[0]["pos_embed"].shape) == (64, 128)
    assert tuple(ranks[3]["mlm_transform.weight"].shape) == (128, 64)
    assert not ranks[1]["tok_embed.weight"][-1].any()  # the pad row
    got = transformer_to_jax(ranks, cfg, mesh_shape=sizes)
    want = transformer_to_jax(sd, cfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), got, want)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_state_from_jax_shards_the_moments_with_their_parameters(monkeypatch, name):
    """An optax state carried into a sharded port optimizer (data=2 x
    model=2 ranks): each rank's moments are its shards of the ones a
    one-process optimizer gets, adafactor's factored statistics by
    ``state_layout`` (the dim each averages over dropped)."""
    from distributed_tensorflow_tpu.train import optimizers as jopt
    from distributed_tensorflow_tpu_torch.train import optimizers as topt
    from distributed_tensorflow_tpu_torch.weights import (
        from_jax_params,
        optimizer_state_from_jax,
    )

    sizes = dict(data=2, model=2)
    jcfg = H.jax_cfg(**SIZES, **CONFIGS["decoder"])
    tcfg = H.port_cfg(jcfg)
    params = H.params_np(jcfg, seed=4)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(name=name, learning_rate=1e-2))
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    _, state = tx.update(grads, tx.init(params), params)
    opt_np = jax.tree.map(np.asarray, state)
    cfg = topt.OptimizerConfig(name=name, learning_rate=1e-2)
    whole = from_jax_params(params, tcfg, "cpu", trainable=True)
    wopt = topt.make_optimizer(cfg, whole.parameters())
    optimizer_state_from_jax(opt_np, whole, wopt)
    wstate = wopt.opt.state_dict()["state"]
    mesh = tmesh.Mesh(dict(tmesh.MeshSpec(**sizes).sizes()), torch.device("cpu"))
    sharded = 0
    for _ in _ranks(monkeypatch, sizes):
        model = from_jax_params(params, tcfg, "cpu", trainable=True, mesh=mesh)
        opt = topt.make_optimizer(cfg, model.parameters())
        opt.place(mesh, model.specs, model)
        optimizer_state_from_jax(opt_np, model, opt)
        assert opt.count == wopt.count == 1
        for i, st in opt.opt.state_dict()["state"].items():
            lay = opt.layouts[i]
            for k, v in st.items():
                want = wstate[i][k]
                if lay is not None and topt.state_layout(lay, k) is not None:
                    want = topt.state_layout(lay, k).shard(want)
                    sharded += tuple(want.shape) != tuple(wstate[i][k].shape)
                torch.testing.assert_close(v, want, rtol=0, atol=0)
    assert sharded > 0
