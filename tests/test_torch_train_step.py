"""The port's training math against the JAX package on the same weights
and the same batches: the next-token losses and every gradient
(``lm_loss_fn``, ``chunked_lm_loss_fn``; dense attention and the flash
path — JAX's Pallas kernels in interpret mode, the port's plain
versions), three adamw steps against optax, gradient accumulation, the
no-update-on-nonfinite step, the refusal of what cannot train, and the
``fused_ln_matmul=True`` model (loss, gradients, adamw steps and eval)
against JAX's fused model.

Tiny config of ``torch_port_helpers`` (2 layers, d=64, f32, dropout 0),
weights from ``params_np`` converted by ``weights.from_jax_params(...,
trainable=True)``. Tolerances, f32: loss 1e-5 (a mean of 62 f32
log-softmaxes over 256 classes); gradients 1e-4 absolute + 1e-4
relative (two layers of f32 products summed in another order); params
after three adamw steps 1e-5 (lr 1e-3: an update is lr * m / sqrt(v), so
gradient noise of 1e-4 moves a parameter by at most ~1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from distributed_tensorflow_tpu.models import transformer as jtfm
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_tpu_torch.train import optimizers as topt
from distributed_tensorflow_tpu_torch.train import step as tstep
from distributed_tensorflow_tpu_torch.weights import _state_dict_from_jax, from_jax_params

SEQ, BATCH = 32, 2


def _batch(seed=0, B=BATCH):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 256, size=(B, SEQ)).astype(np.int32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_loss_fn(jcfg, chunked):
    model = jtfm.Transformer(jcfg)
    return jtfm.chunked_lm_loss_fn(model, 16) if chunked else jtfm.lm_loss_fn(model)


def _port(jcfg, params, impl):
    model = from_jax_params(params, H.port_cfg(jcfg, attention_impl=impl), device="cpu",
                            trainable=True)
    assert all(p.requires_grad and p.dtype == torch.float32 for p in model.parameters())
    return model


@pytest.mark.parametrize("chunked", [False, True], ids=["dense_xent", "chunked_xent"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_loss_and_every_gradient_match_jax(chunked, impl):
    jcfg = H.jax_cfg(attention_impl=impl)
    params = H.params_np(jcfg)
    batch = _batch()
    loss_fn = _jax_loss_fn(jcfg, chunked)
    (jloss, (_, jaux)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {}, batch, jax.random.PRNGKey(0)), has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    model = _port(jcfg, params, impl)
    tloss_fn = (ttfm.chunked_lm_loss_fn(model, 16) if chunked else ttfm.lm_loss_fn(model))
    loss, aux = tloss_fn(_tbatch(batch))
    loss.backward()
    loss = loss.detach()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux["accuracy"]), float(jaux["accuracy"]), atol=1e-6)
    want = _state_dict_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("chunk", [0, 16], ids=["dense_xent", "chunked_xent"])
def test_eval_stats_match_jax(chunk):
    """``lm_eval_fn``: the summed loss, correct and count of a batch with
    an attention_mask (the padded tail's targets are ignored), dense and
    chunked, against the JAX ``lm_eval_fn``."""
    jcfg = H.jax_cfg()
    params = H.params_np(jcfg, seed=4)
    batch = _batch(5)
    batch["attention_mask"] = np.ones_like(batch["input_ids"])
    batch["attention_mask"][1, 20:] = 0
    want = jax.jit(jtfm.lm_eval_fn(jtfm.Transformer(jcfg), chunk))(
        jax.tree.map(jnp.asarray, params), {}, batch)
    model = _port(jcfg, params, "dense")
    got = ttfm.lm_eval_fn(model, chunk)(_tbatch(batch))
    assert float(got["count"]) == float(want["count"]) == BATCH * (SEQ - 1) - 12
    assert float(got["correct"]) == float(want["correct"])
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)


def test_three_adamw_steps_match_optax():
    """adamw with warmup (the first update has lr 0) and cosine decay,
    decoupled decay on every parameter, global-norm clipping: the port's
    step + ``Optimizer`` against ``jax.grad`` + JAX ``make_optimizer``."""
    jcfg = H.jax_cfg()
    params = H.params_np(jcfg, seed=1)
    ocfg = dict(name="adamw", learning_rate=1e-3, weight_decay=0.1, warmup_steps=1,
                schedule="cosine", total_steps=10, clip_grad_norm=1.0)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg))
    loss_fn = _jax_loss_fn(jcfg, False)
    grad_fn = jax.jit(jax.grad(lambda p, b: loss_fn(p, {}, b, jax.random.PRNGKey(0))[0]))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tx_update = jax.jit(tx.update)
    model = _port(jcfg, params, "dense")
    opt = topt.make_optimizer(topt.OptimizerConfig(**ocfg), model.parameters())
    ts = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(ttfm.lm_loss_fn(model))
    for i in range(3):
        batch = _batch(10 + i)
        updates, state = tx_update(grad_fn(jp, batch), state, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)
        ts, _ = step(ts, _tbatch(batch))
    assert ts.step == 3 and opt.count == 3
    want = _state_dict_from_jax(jax.tree.map(np.asarray, jp), model.cfg)
    init = _state_dict_from_jax(params, model.cfg)
    moved = 0.0
    for name, p in model.named_parameters():
        if name.endswith("attn.key.bias"):
            # its exact gradient is 0 (adding q.b to every logit of a row
            # leaves the softmax unchanged), so each side's gradient is f32
            # roundoff that Adam normalises into steps of up to lr: both
            # sides move it by no more than lr per update
            assert float((p.detach() - init[name]).abs().max()) <= 3.01e-3
            assert float((want[name] - init[name]).abs().max()) <= 3.01e-3
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)
        moved = max(moved, float((want[name] - init[name]).abs().max()))
    assert moved > 1e-4  # the steps did move the parameters


def test_grad_accumulation_equals_one_full_batch():
    """grad_accum_steps=2: the mean of the two microbatch gradients —
    with equal token counts, the full batch's gradient; one sgd step
    lands on the same parameters (f32 sums in another order: 1e-6)."""
    jcfg = H.jax_cfg()
    params = H.params_np(jcfg, seed=2)
    batch = _tbatch(_batch(3, B=4))
    out = []
    for accum in (1, 2):
        model = _port(jcfg, params, "dense")
        opt = topt.make_optimizer(topt.OptimizerConfig(name="sgd", learning_rate=0.5),
                                  model.parameters())
        st = tstep.init_train_state(model, opt)
        st, metrics = tstep.make_train_step(
            ttfm.lm_loss_fn(model), tstep.StepOptions(grad_accum_steps=accum))(st, batch)
        out.append((float(metrics["loss"]), [p.detach().clone() for p in model.parameters()]))
    assert out[0][0] == pytest.approx(out[1][0], abs=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_skip_nonfinite_leaves_state_and_step_unchanged():
    jcfg = H.jax_cfg()
    model = _port(jcfg, H.params_np(jcfg, seed=3), "dense")
    opt = topt.make_optimizer(topt.OptimizerConfig(name="adam", learning_rate=1e-2),
                              model.parameters())
    st = tstep.init_train_state(model, opt)
    base = ttfm.lm_loss_fn(model)

    def loss_fn(batch, gen):  # a batch whose "scale" poisons the loss
        loss, aux = base(batch, gen)
        return loss * batch["scale"], aux

    step = tstep.make_train_step(loss_fn, tstep.StepOptions(skip_nonfinite=True))
    before = [p.detach().clone() for p in model.parameters()]
    bad = dict(_tbatch(_batch(4)), scale=torch.tensor(float("nan")))
    st, metrics = step(st, bad)
    assert float(metrics["nonfinite"]) == 1.0 and tstep.step_nonfinite(metrics)
    assert st.step == 0 and opt.count == 0 and not opt.opt.state
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    st, metrics = step(st, dict(bad, scale=torch.tensor(1.0)))
    assert float(metrics["nonfinite"]) == 0.0 and st.step == 1 and opt.count == 1
    assert not all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_forward_only_kernels_and_fused_ln_training_are_refused():
    """paged_flash_attention launches through raw pointers and has no
    backward (its training counterpart is flash attention), so on a device
    tensor that requires grad it would return a result with no grad_fn
    (silently zero gradients): it raises instead (shown on the meta device,
    where the check runs before the launch would). The name's fused-LN half
    is historical: ln_matmul no longer refuses a tensor that requires grad,
    so it reaches its device check; that the fused model trains is
    ``test_trainable_fused_ln_model_builds_and_steps``."""
    from distributed_tensorflow_tpu_torch.ops.fused_ln_matmul import ln_matmul
    from distributed_tensorflow_tpu_torch.ops.paged_attention import paged_flash_attention

    q = torch.zeros(1, 2, 1, 64, device="meta", requires_grad=True)
    pool = torch.zeros(4, 2, 16, 64, device="meta")
    table = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        paged_flash_attention(q, pool, pool, table, q_pos=table[:, :1])
    x = torch.zeros(4, 64, device="meta", requires_grad=True)
    g = torch.ones(64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):  # the device check, not a refusal
        ln_matmul(x, g, g, torch.zeros(64, 8, device="meta"))


def test_trainable_fused_ln_model_builds_and_steps():
    """Under autograd ln_matmul runs through ``LnMatmul``, so a trainable
    ``fused_ln_matmul=True`` model builds and takes a step that moves every
    parameter, and a serving model runs the uncached fused forward."""
    jcfg = H.jax_cfg(fused_ln_matmul=True)
    params = H.params_np(jcfg, seed=6)
    model = _port(jcfg, params, "dense")
    assert model.cfg.fused_ln_matmul
    opt = topt.make_optimizer(topt.OptimizerConfig(name="sgd", learning_rate=0.1),
                              model.parameters())
    before = [p.detach().clone() for p in model.parameters()]
    st, metrics = tstep.make_train_step(ttfm.lm_loss_fn(model))(
        tstep.init_train_state(model, opt), _tbatch(_batch(6)))
    assert st.step == 1 and np.isfinite(float(metrics["loss"]))
    for (name, p), b in zip(model.named_parameters(), before):
        if not name.endswith("attn.key.bias"):  # its exact gradient is 0
            assert not torch.equal(p.detach(), b), name
    serving = ttfm.build(model.cfg, model, "cpu")
    with torch.no_grad():
        assert torch.isfinite(serving(torch.zeros(1, 4, dtype=torch.long))).all()


# ---------------------------------------------------------------------------
# fused_ln_matmul=True: ln1->q/k/v and ln2->mlp_in through the LN+matmul op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bwd_impl", ["xla", "pallas"])
def test_fused_ln_loss_and_every_gradient_match_jax(bwd_impl, monkeypatch):
    """The fused model against JAX's fused model (its Pallas LN+matmul
    kernels in interpret mode) under the same ``DTF_FUSED_BWD``: loss and
    every gradient, from a flax tree that ``from_jax_params`` converts with
    no change (the fused branch has the unfused branch's parameter tree).
    The fused model is held to the fused reference, never to the unfused
    one: the kernel's two-pass variance differs from flax's fast variance
    by rounding."""
    monkeypatch.setenv("DTF_FUSED_BWD", bwd_impl)
    jcfg = H.jax_cfg(fused_ln_matmul=True)
    shapes = [jax.eval_shape(jtfm.make_init_fn(jtfm.Transformer(c), 8),
                             jax.random.PRNGKey(0))[0] for c in (jcfg, H.jax_cfg())]
    assert jax.tree.structure(shapes[0]) == jax.tree.structure(shapes[1])
    assert jax.tree.leaves(jax.tree.map(lambda a, b: a.shape == b.shape, *shapes)) \
        == [True] * len(jax.tree.leaves(shapes[0]))
    params = H.params_np(jcfg, seed=7)
    batch = _batch(8)
    loss_fn = _jax_loss_fn(jcfg, False)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {}, batch, jax.random.PRNGKey(0)), has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    model = _port(jcfg, params, "dense")
    loss, _ = ttfm.lm_loss_fn(model)(_tbatch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    want = _state_dict_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_fused_ln_three_adamw_steps_match_optax(monkeypatch):
    """Three adamw steps of the fused model (the ``pallas`` backward: the
    kernel wrappers' plain versions here) against ``jax.grad`` of JAX's
    fused model + JAX ``make_optimizer``, within 1e-5."""
    monkeypatch.setenv("DTF_FUSED_BWD", "pallas")
    jcfg = H.jax_cfg(fused_ln_matmul=True)
    params = H.params_np(jcfg, seed=9)
    ocfg = dict(name="adamw", learning_rate=1e-3, weight_decay=0.1, warmup_steps=1,
                schedule="cosine", total_steps=10, clip_grad_norm=1.0)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg))
    loss_fn = _jax_loss_fn(jcfg, False)
    grad_fn = jax.jit(jax.grad(lambda p, b: loss_fn(p, {}, b, jax.random.PRNGKey(0))[0]))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tx_update = jax.jit(tx.update)
    model = _port(jcfg, params, "dense")
    opt = topt.make_optimizer(topt.OptimizerConfig(**ocfg), model.parameters())
    ts = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(ttfm.lm_loss_fn(model))
    for i in range(3):
        batch = _batch(20 + i)
        updates, state = tx_update(grad_fn(jp, batch), state, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)
        ts, _ = step(ts, _tbatch(batch))
    want = _state_dict_from_jax(jax.tree.map(np.asarray, jp), model.cfg)
    init = _state_dict_from_jax(params, model.cfg)
    moved = 0.0
    for name, p in model.named_parameters():
        if name.endswith("attn.key.bias"):  # exact gradient 0: see the unfused test
            assert float((p.detach() - init[name]).abs().max()) <= 3.01e-3
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)
        moved = max(moved, float((want[name] - init[name]).abs().max()))
    assert moved > 1e-4


def test_fused_ln_eval_matches_jax_uncached_forward():
    """``lm_eval_fn`` of a fused model runs (it raised before the fused
    uncached forward existed) and matches JAX's ``lm_eval_fn`` of the
    fused model on a padded batch."""
    jcfg = H.jax_cfg(fused_ln_matmul=True)
    params = H.params_np(jcfg, seed=10)
    batch = _batch(11)
    batch["attention_mask"] = np.ones_like(batch["input_ids"])
    batch["attention_mask"][0, 24:] = 0
    want = jax.jit(jtfm.lm_eval_fn(jtfm.Transformer(jcfg), 0))(
        jax.tree.map(jnp.asarray, params), {}, batch)
    model = from_jax_params(params, H.port_cfg(jcfg), device="cpu")
    got = ttfm.lm_eval_fn(model, 0)(_tbatch(batch))
    assert float(got["count"]) == float(want["count"]) == BATCH * (SEQ - 1) - 8
    assert float(got["correct"]) == float(want["correct"])
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)
