"""The port's transformer-training options against the JAX package:
``blockwise_attention`` and ``attention_impl="blockwise"``, ``remat``
(with the dropout generator replayed in the recompute) and ``fused_qkv``
(the head-major ``qkv`` Dense and its weight conversions both ways).

Inputs are seeded numpy arrays; the model is the tiny config of
``torch_port_helpers`` (2 layers, d=64, f32). Tolerances, f32: attention
outputs 2e-5 and their gradients 1e-4 (products of f32 sums in another
order); losses 1e-5 and gradients 1e-4 absolute + 1e-4 relative, as
``test_torch_train_step.py`` states them. Remat against no remat in the
port is bitwise: the same ops run on the same inputs.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from distributed_tensorflow_tpu.models import transformer as jtfm
from distributed_tensorflow_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_tpu_torch.train import optimizers as topt
from distributed_tensorflow_tpu_torch.train import step as tstep
from distributed_tensorflow_tpu_torch.weights import (
    _state_dict_from_jax,
    from_jax_params,
    fuse_qkv,
    split_qkv,
    transformer_to_jax,
)

jatt = importlib.import_module("distributed_tensorflow_tpu.ops.attention")
tatt = importlib.import_module("distributed_tensorflow_tpu_torch.ops.attention")

SEQ, BATCH = 32, 2


def _batch(seed=0, B=BATCH):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 256, size=(B, SEQ)).astype(np.int32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- blockwise attention ------------------------------------------------------


@pytest.mark.parametrize("sq,sk", [(100, 100), (40, 100)], ids=["ragged", "sq_lt_sk"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "kvmask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_blockwise_matches_jax_blockwise(causal, masked, sq, sk):
    """Output and gradients of (out*out).sum() against JAX's
    ``blockwise_attention`` at block_k 32: Sk=100 pads the last block (the
    padding masked), Sq < Sk aligns the causal order on the last original
    key, and a kv_mask row that attends nothing gives zeros."""
    rng = np.random.default_rng(sq + 7 * masked + 3 * causal)
    q = rng.standard_normal((2, 3, sq, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, 3, sk, 16), dtype=np.float32) for _ in range(2))
    mask = None
    if masked:
        mask = rng.random((2, sk)) > 0.3
        mask[1] = False

    def jloss(q, k, v):
        o = jatt.blockwise_attention(q, k, v, causal=causal, block_k=32,
                                     kv_mask=None if mask is None else jnp.asarray(mask))
        return (o * o).sum(), o

    (_, want_out), want = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tatt.blockwise_attention(*leaves, causal=causal, block_k=32,
                                   kv_mask=None if mask is None else torch.from_numpy(mask))
    (out * out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=2e-5, rtol=2e-5)
    if masked:
        assert not out[1].abs().sum()
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_blockwise_keeps_q_dtype_and_recomputes_each_block():
    """bf16 in, bf16 out; each key block runs under checkpoint, so the
    graph saves no [Sq, block_k] logits: the tensors kept for the
    backward total less than one block's f32 logits per block would."""
    q = torch.randn(1, 2, 256, 16, dtype=torch.bfloat16, requires_grad=True)
    kept = []

    def pack(t):
        kept.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tatt.blockwise_attention(q, q, q, causal=True, block_k=64)
    assert out.dtype == torch.bfloat16
    assert max(kept) < 2 * 256 * 64  # a block's logits: [1, 2, 256, 64]


def _jax_loss_and_grads(jcfg, params, batch, rng=jax.random.PRNGKey(0)):
    loss_fn = jtfm.lm_loss_fn(jtfm.Transformer(jcfg))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {}, batch, rng), has_aux=True))(jax.tree.map(jnp.asarray, params))
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(model, batch, generator=None):
    loss, _ = ttfm.lm_loss_fn(model)(_tbatch(batch), generator)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), dict(zip([n for n, _ in model.named_parameters()], grads))


def _assert_grads(got: dict, want_tree, cfg):
    want = _state_dict_from_jax(want_tree, cfg)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_blockwise_and_remat_models_match_jax(remat):
    """``attention_impl="blockwise"`` (and with ``remat``): the loss and
    every gradient against JAX's model of the same config."""
    jcfg = H.jax_cfg(attention_impl="blockwise", remat=remat)
    params = H.params_np(jcfg, seed=3)
    batch = _batch(1)
    jloss, jgrads = _jax_loss_and_grads(jcfg, params, batch)
    model = from_jax_params(params, H.port_cfg(jcfg), device="cpu", trainable=True)
    loss, grads = _port_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss, jloss, atol=1e-5, rtol=1e-5)
    _assert_grads(grads, jgrads, model.cfg)


# -- remat ---------------------------------------------------------------------


def _dropout_model(fused_ln=False, remat=False, dropout=0.2):
    jcfg = H.jax_cfg()
    cfg = H.port_cfg(jcfg, dropout=dropout, remat=remat, fused_ln_matmul=fused_ln)
    return from_jax_params(H.params_np(jcfg, seed=5), cfg, device="cpu", trainable=True)


@pytest.mark.parametrize("fused_ln", [False, True], ids=["unfused", "fused_ln"])
def test_remat_grads_equal_no_remat_with_dropout(fused_ln):
    """With dropout 0.2 from an explicit generator, remat's loss and
    every gradient equal the run without remat bit for bit (the recompute
    replays the generator), and the generator ends where it would without
    remat. Also with ``fused_ln_matmul``, whose forward then runs twice."""
    batch = _batch(2)
    want_gen = torch.Generator().manual_seed(9)
    want = _port_loss_and_grads(_dropout_model(fused_ln), batch, want_gen)
    gen = torch.Generator().manual_seed(9)
    got = _port_loss_and_grads(_dropout_model(fused_ln, remat=True), batch, gen)
    assert got[0] == want[0]
    for name, g in got[1].items():
        assert torch.equal(g, want[1][name]), name
    assert torch.equal(gen.get_state(), want_gen.get_state())


def test_remat_without_the_replay_gives_other_gradients(monkeypatch):
    """The control: with the generator snapshot removed, the recompute
    draws new masks, the forward's loss is unchanged but the gradients
    differ from the run without remat (the failure the replay prevents)."""
    batch = _batch(2)
    want = _port_loss_and_grads(_dropout_model(), batch, torch.Generator().manual_seed(9))
    monkeypatch.setattr(ttfm, "_generator_snapshot", lambda generator: None)
    got = _port_loss_and_grads(_dropout_model(remat=True), batch,
                               torch.Generator().manual_seed(9))
    assert got[0] == want[0]
    assert any(not torch.equal(g, want[1][n]) for n, g in got[1].items())


def test_remat_steps_with_grad_accumulation_equal_no_remat():
    """Two micro-batches a step and two steps of adamw: each micro-batch's
    masks come from where the last forward left the generator, so the
    remat run's losses and weights equal the plain run's bit for bit."""
    runs = []
    for remat in (False, True):
        model = _dropout_model(remat=remat)
        opt = topt.make_optimizer(topt.OptimizerConfig(name="adamw", learning_rate=1e-3),
                                  model.parameters())
        state = tstep.init_train_state(model, opt, seed=4)
        step = tstep.make_train_step(ttfm.lm_loss_fn(model), tstep.StepOptions(
            grad_accum_steps=2))
        losses = [float(step(state, _tbatch(_batch(20 + i, B=4)))[1]["loss"])
                  for i in range(2)]
        runs.append((losses, {k: v.clone() for k, v in model.state_dict().items()}))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


# -- fused QKV -----------------------------------------------------------------


def test_fused_qkv_model_matches_jax():
    """``fused_qkv=True``: the JAX model's ``qkv`` kernel [d, 3·H·D]
    (head-major columns) converted to the port's [3·H·D, d]; the loss and
    every gradient against JAX's, and ``transformer_to_jax`` gives JAX's
    tree back exactly."""
    jcfg = H.jax_cfg(fused_qkv=True)
    params = H.params_np(jcfg, seed=6)
    assert set(params["layer_0"]["attn"]) == {"qkv", "attn_out"}
    batch = _batch(3)
    jloss, jgrads = _jax_loss_and_grads(jcfg, params, batch)
    model = from_jax_params(params, H.port_cfg(jcfg), device="cpu", trainable=True)
    assert model.layers[0].attn.qkv.weight.shape == (3 * 64, 64)
    loss, grads = _port_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss, jloss, atol=1e-5, rtol=1e-5)
    _assert_grads(grads, jgrads, model.cfg)
    back = transformer_to_jax(model.state_dict(), model.cfg)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_fuse_qkv_keeps_the_function_and_splits_back():
    """``fuse_qkv`` of a split model's weights gives a ``fused_qkv`` model
    with the same logits; ``split_qkv`` inverts it exactly; the split
    model's ``transformer_to_jax`` is JAX's tree."""
    jcfg = H.jax_cfg()
    params = H.params_np(jcfg, seed=7)
    split = from_jax_params(params, H.port_cfg(jcfg), device="cpu")
    jax.tree.map(np.testing.assert_array_equal,
                 transformer_to_jax(split.state_dict(), split.cfg), params)
    fcfg = dataclasses.replace(split.cfg, fused_qkv=True)
    fused_sd = fuse_qkv(split.state_dict(), split.cfg)
    fused = ttfm.build(fcfg, fused_sd, "cpu")
    ids = torch.from_numpy(_batch(4)["input_ids"])
    np.testing.assert_allclose(fused(ids).numpy(), split(ids).numpy(), atol=1e-5, rtol=1e-5)
    back = split_qkv(fused_sd, fcfg)
    assert sorted(back) == sorted(split.state_dict())
    for k, v in split.state_dict().items():
        assert torch.equal(back[k], v), k


def test_fused_qkv_refuses_fused_ln_matmul():
    cfg = ttfm.TransformerConfig(fused_qkv=True, fused_ln_matmul=True, pre_ln=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ttfm.check_supported(cfg)
