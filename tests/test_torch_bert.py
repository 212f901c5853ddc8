"""The port's BERT MLM path against the JAX package on the same weights
and the same batches: the MLM streams (bit-identical), the post-LN
encoder's logits with and without the gathered head, ``mlm_loss_fn``'s
loss and every gradient (gathered, dense labels, a padded
``attention_mask``), three adamw steps against optax, ``mlm_eval_fn``,
the parameter and FLOPs counts at ``bert_base()``, the LayerNorm
initialisation, the post-LN weight conversion, the config overrides and
``run_workload("bert_pretrain")`` on the CPU.

Tiny BERT (2 layers, d 32, 4 heads, d_ff 64, vocab 128, S 16, f32,
dropout 0) with ``torch_port_helpers.params_np`` weights; the JAX side
runs under ``jax.jit``. Tolerances, f32: the loss, every gradient and the
parameters after three adamw steps 1e-5 absolute + relative (the model
is narrow enough that other summation orders stay below it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from distributed_tensorflow_tpu.data import text as jtext
from distributed_tensorflow_tpu.models import transformer as jtfm
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu.utils import config as jconfig
from distributed_tensorflow_tpu.workloads import bert_pretrain as jbert
from distributed_tensorflow_tpu_torch.data import text as ttext
from distributed_tensorflow_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_tpu_torch.train import optimizers as topt
from distributed_tensorflow_tpu_torch.train import step as tstep
from distributed_tensorflow_tpu_torch.utils import config as tconfig
from distributed_tensorflow_tpu_torch.weights import _state_dict_from_jax, from_jax_params
from distributed_tensorflow_tpu_torch.workloads import bert_pretrain as tbert
from distributed_tensorflow_tpu_torch.workloads import run_workload

SEQ, BATCH, VOCAB = 16, 4, 128
TOL = dict(atol=1e-5, rtol=1e-5)
# the JAX package's converging tiny BERT (tests/test_transformer.py):
# vocab 48, [MASK] = 0, 64 sequences of 16 a step
TINY = ["--model.num_layers=2", "--model.d_model=32", "--model.num_heads=4",
        "--model.d_ff=64", "--model.vocab_size=48", "--data.vocab_size=48",
        "--data.mask_token=0", "--model.max_len=16", "--data.seq_len=16",
        "--model.dtype=float32", "--model.dropout=0.0", "--data.global_batch_size=64",
        "--train.log_every=1", "--optimizer.warmup_steps=0",
        "--optimizer.learning_rate=3e-3", "--optimizer.schedule=constant",
        "--train.eval_batches=2"]


def _jcfg(**kw):
    return H.jax_cfg(**{**dict(vocab_size=VOCAB, max_len=SEQ, d_model=32, num_heads=4,
                               d_ff=64, causal=False, pre_ln=False), **kw})


def _data_cfg(mod, max_predictions, **kw):
    return mod.TextDataConfig(**{**dict(dataset="synthetic_mlm", global_batch_size=BATCH,
                                        seq_len=SEQ, vocab_size=VOCAB, seed=3,
                                        max_predictions=max_predictions), **kw})


def _batch(max_predictions, index=0, padded=False):
    """A JAX SyntheticMLM batch; ``padded``: rows 1 and 3 keep 11 and 6
    tokens, their gathered positions moved into the valid prefix (a
    position in a padded tail is a data choice the streams never make)."""
    b = jtext.SyntheticMLM(_data_cfg(jtext, max_predictions)).batch(index)
    if padded:
        mask = np.ones((BATCH, SEQ), np.int32)
        mask[1, 11:] = 0
        mask[3, 6:] = 0
        b["attention_mask"] = mask
        if "masked_positions" in b:
            valid = mask.sum(1, keepdims=True)
            b["masked_positions"] = (b["masked_positions"] % valid).astype(np.int32)
        else:
            b["labels"] = np.where(mask > 0, b["labels"], ttext.IGNORE_INDEX).astype(np.int32)
    return b


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port(jcfg, params, **kw):
    return from_jax_params(params, H.port_cfg(jcfg, **kw), device="cpu", trainable=True)


@pytest.mark.parametrize("max_predictions", [0, 3, -1], ids=["dense", "k3", "auto"])
@pytest.mark.parametrize("index", [0, 1_000_000])
def test_synthetic_mlm_batch_is_bit_identical_to_jax(max_predictions, index):
    got = ttext.SyntheticMLM(_data_cfg(ttext, max_predictions)).batch(index)
    want = jtext.SyntheticMLM(_data_cfg(jtext, max_predictions)).batch(index)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_bert_shape_batch_has_77_gathered_positions_and_matches_jax():
    """The preset's stream: S=512, max_predictions=-1 gives K=77."""
    kw = dict(global_batch_size=2, seq_len=512, vocab_size=30528, seed=0)
    got = ttext.make_text_dataset(_data_cfg(ttext, -1, **kw), index_offset=10**6).batch(1)
    want = jtext.make_text_dataset(_data_cfg(jtext, -1, **kw), index_offset=10**6).batch(1)
    assert ttext.resolved_max_predictions(_data_cfg(ttext, -1, **kw)) == 77
    assert got["masked_positions"].shape == (2, 77)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("max_predictions", [0, 5])
def test_token_file_mlm_batches_match_jax(tmp_path, max_predictions):
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(0).integers(0, VOCAB, 4000).astype(np.int32))
    kw = dict(dataset=f"tokens_mlm:{path}")
    got = ttext.make_text_dataset(_data_cfg(ttext, max_predictions, **kw), index_offset=5)
    want = jtext.make_text_dataset(_data_cfg(jtext, max_predictions, **kw), index_offset=5)
    assert isinstance(got, ttext.TokenFileMLM)
    for (a, b, _) in zip(got, want, range(2)):
        assert a.keys() == b.keys()
        for k in b:
            assert np.array_equal(a[k], b[k]), k


def test_logits_with_positions_match_jax_and_the_dense_head():
    jcfg = _jcfg()
    params = H.params_np(jcfg, seed=1)
    batch = _batch(3, padded=True)
    model = jtfm.Transformer(jcfg)
    fwd = jax.jit(lambda p, ids, m, pos: model.apply({"params": p}, ids, m, positions=pos))
    jp = jax.tree.map(jnp.asarray, params)
    want = np.asarray(fwd(jp, batch["input_ids"], batch["attention_mask"],
                          batch["masked_positions"]))
    tmodel = _port(jcfg, params)
    ids, mask = torch.from_numpy(batch["input_ids"]), torch.from_numpy(batch["attention_mask"])
    pos = torch.from_numpy(batch["masked_positions"])
    with torch.no_grad():
        got = tmodel(ids, mask, positions=pos).numpy()
        dense = tmodel(ids, mask).numpy()
    assert got.shape == (BATCH, 3, VOCAB)
    np.testing.assert_allclose(got, want, **TOL)
    sliced = np.take_along_axis(dense, batch["masked_positions"][..., None], axis=1)
    np.testing.assert_allclose(got, sliced, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("max_predictions,padded", [(3, False), (0, False), (3, True),
                                                    (0, True)],
                         ids=["gathered", "dense", "gathered_padded", "dense_padded"])
def test_mlm_loss_and_every_gradient_match_jax(max_predictions, padded):
    jcfg = _jcfg()
    params = H.params_np(jcfg, seed=2)
    batch = _batch(max_predictions, padded=padded)
    loss_fn = jtfm.mlm_loss_fn(jtfm.Transformer(jcfg))
    (jloss, (_, jaux)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {}, batch, jax.random.PRNGKey(0)), has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    model = _port(jcfg, params)
    loss, aux = ttfm.mlm_loss_fn(model)(_tbatch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert float(aux["accuracy"]) == pytest.approx(float(jaux["accuracy"]), abs=1e-6)
    want = _state_dict_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg)
    assert sorted(want) == sorted(n for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **TOL, err_msg=name)


def test_three_adamw_steps_match_optax():
    """The preset's optimizer family (adamw, decoupled decay, a linear
    warmup whose first update has lr 0, linear decay) on gathered
    batches: the port's step + ``Optimizer`` against ``jax.grad`` + JAX
    ``make_optimizer``."""
    jcfg = _jcfg()
    params = H.params_np(jcfg, seed=3)
    ocfg = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01, warmup_steps=1,
                schedule="linear", total_steps=10)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg))
    loss_fn = jtfm.mlm_loss_fn(jtfm.Transformer(jcfg))
    grad_fn = jax.jit(jax.grad(lambda p, b: loss_fn(p, {}, b, jax.random.PRNGKey(0))[0]))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tx_update = jax.jit(tx.update)
    model = _port(jcfg, params)
    opt = topt.make_optimizer(topt.OptimizerConfig(**ocfg), model.parameters())
    ts = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(ttfm.mlm_loss_fn(model))
    for i in range(3):
        batch = _batch(3, index=10 + i)
        updates, state = tx_update(grad_fn(jp, batch), state, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)
        ts, _ = step(ts, _tbatch(batch))
    assert ts.step == 3
    want = _state_dict_from_jax(jax.tree.map(np.asarray, jp), model.cfg)
    init = _state_dict_from_jax(params, model.cfg)
    moved = 0.0
    for name, p in model.named_parameters():
        if name.endswith("attn.key.bias"):
            # its exact gradient is 0 (a constant shift of every logit of
            # a row), so both sides move it by Adam-normalised roundoff,
            # at most lr an update
            assert float((p.detach() - init[name]).abs().max()) <= 2.01e-3
            assert float((want[name] - init[name]).abs().max()) <= 2.01e-3
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), **TOL, err_msg=name)
        moved = max(moved, float((want[name] - init[name]).abs().max()))
    assert moved > 1e-4


@pytest.mark.parametrize("max_predictions", [3, 0], ids=["gathered", "dense"])
def test_mlm_eval_stats_match_jax(max_predictions):
    jcfg = _jcfg()
    params = H.params_np(jcfg, seed=4)
    batch = _batch(max_predictions, index=2, padded=True)
    want = jax.jit(jtfm.mlm_eval_fn(jtfm.Transformer(jcfg)))(
        jax.tree.map(jnp.asarray, params), {}, batch)
    got = ttfm.mlm_eval_fn(_port(jcfg, params))(_tbatch(batch))
    assert float(got["count"]) == float(want["count"]) > 0
    assert float(got["correct"]) == float(want["correct"])
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)


def test_counts_match_jax_at_bert_base():
    assert H.port_cfg(jtfm.bert_base()) == ttfm.bert_base()
    j, t = jtfm.bert_base(), ttfm.bert_base()
    assert ttfm.param_count(t) == jtfm.param_count(j)
    for n_pred in (None, 77):
        assert ttfm.flops_per_example(t, 512, n_predictions=n_pred) == \
            jtfm.flops_per_example(j, 512, n_predictions=n_pred)
    # and the analytic count is the model's
    model = ttfm.Transformer(t, device="meta")
    assert ttfm.param_count(t) == sum(p.numel() for p in model.parameters())


def test_init_params_layernorms_are_ones_and_zeros():
    """Every LayerNorm, the post-LN model's embed_ln and mlm_ln included,
    starts at scale 1 and bias 0, as flax initialises it."""
    cfg = H.port_cfg(_jcfg())
    sd = ttfm.init_params(cfg, seed=0, device="cpu", trainable=True)
    lns = [n for n in sd if "." in n and n.split(".")[-2] in ttfm.LN_NAMES]
    assert {n.split(".")[0] for n in lns} >= {"embed_ln", "mlm_ln", "layers"}
    assert not any(n.startswith("final_ln") for n in sd)
    for n in lns:
        want = torch.ones_like(sd[n]) if n.endswith("weight") else torch.zeros_like(sd[n])
        assert torch.equal(sd[n], want), n
    assert float(sd["mlm_transform.weight"].std()) == pytest.approx(0.02, rel=0.1)


def test_post_ln_weights_convert_both_ways():
    """``from_jax_params`` maps every leaf of the post-LN flax tree
    (embed_ln, mlm_transform, mlm_ln; no final_ln) to the port's state dict,
    and the converted gradient tree of the same layout comes back equal."""
    jcfg = _jcfg()
    params = H.params_np(jcfg, seed=5)
    model = _port(jcfg, params)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["embed_ln.weight"].numpy(), params["embed_ln"]["scale"])
    np.testing.assert_array_equal(sd["mlm_ln.bias"].numpy(), params["mlm_ln"]["bias"])
    np.testing.assert_array_equal(sd["mlm_transform.weight"].numpy(),
                                  params["mlm_transform"]["kernel"].T)
    n_leaves = len(jax.tree.leaves(params))
    assert len(sd) == n_leaves
    again = _state_dict_from_jax(params, model.cfg)
    for k, v in sd.items():
        assert torch.equal(v, again[k]), k


def test_post_ln_and_mlm_refusals_follow_jax():
    with pytest.raises(ValueError, match="pre_ln=True"):
        ttfm.Transformer(H.port_cfg(_jcfg(fused_ln_matmul=True)), device="meta")
    model = ttfm.Transformer(H.port_cfg(_jcfg()), device="meta")
    with pytest.raises(ValueError, match="causal=True"):
        model(torch.zeros(1, 4, dtype=torch.long, device="meta"), kv_cache=object(),
              decode_pos=torch.zeros(1, 4, dtype=torch.long, device="meta"))
    causal = _port(H.jax_cfg(), H.params_np(H.jax_cfg()))
    with pytest.raises(ValueError, match="positions gather"):
        causal(torch.zeros(1, 4, dtype=torch.long), positions=torch.zeros(1, 2, dtype=torch.long))


def test_bert_overrides_parse_to_the_same_config_as_jax():
    overrides = ["--train.num_steps=7", "--optimizer.learning_rate=2e-4",
                 "--data.global_batch_size=32", "--data.max_predictions=20",
                 "--model.attention_impl=flash", "--model.dropout=0.0",
                 "--train.eval_every=3", "--train.eval_batches=4", "--mesh.data=-1"]
    got = tconfig.to_dict(tconfig.apply_overrides(tbert.default_config(), overrides))
    want = jconfig.to_dict(jconfig.apply_overrides(jbert.default_config(), overrides))
    assert got["workload"] == want["workload"] == "bert_pretrain"
    for section in ("model", "data", "optimizer", "train", "mesh"):
        for key, value in got[section].items():
            assert value == want[section][key], (section, key)
    assert (got["model"]["causal"], got["model"]["pre_ln"]) == (False, False)
    assert got["data"]["max_predictions"] == 20 and got["train"]["eval_batches"] == 4


def test_run_workload_trains_and_evaluates_bert_pretrain_on_cpu():
    res = run_workload("bert_pretrain", TINY + ["--train.num_steps=10"], device="cpu")
    losses = [row["loss"] for row in res.history]
    assert res.state.step == 10 and res.device.type == "cpu"
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    m = res.eval_metrics
    assert m["count"] == 2 * 64 * 2  # eval_batches x global batch x K (round(0.15 x 16))
    assert np.isfinite(m["loss"]) and 0.0 <= m["accuracy"] <= 1.0
    assert m["loss"] == pytest.approx(m["loss_sum"] / m["count"])
