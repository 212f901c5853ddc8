"""The port's ResNet against the JAX package's on the same weights and the
same batches: tiny configs (``stage_sizes=(1, 1)``, width 4 — every
parameter family of ResNet-50, the projection shortcut of a strided and
of an unstrided stage included — 16x16 images, f32), both stems and both
block impls (the fused one through the plain versions of the kernels;
JAX's Pallas kernels in interpret mode).

Params are perturbed away from the init (bn3's zero scale would silence
every residual branch and make the gradients of conv1-conv3 zero), the
running statistics too. Tolerances, f32: logits and loss 1e-5; every
gradient 1e-4 absolute + relative (f32 products summed in another order
through 2 bottlenecks and the stem); batch statistics 1e-5; parameters
after three momentum steps 1e-5 (lr 0.1: a gradient difference of 1e-5
moves a parameter by ~1e-6 a step).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import common as jcommon
from distributed_tensorflow_tpu.models import resnet as jresnet
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu.train import step as jstep
from distributed_tensorflow_tpu_torch.models import common as tcommon
from distributed_tensorflow_tpu_torch.models import resnet as tresnet
from distributed_tensorflow_tpu_torch.train import optimizers as topt
from distributed_tensorflow_tpu_torch.train import step as tstep
from distributed_tensorflow_tpu_torch.weights import resnet_from_jax, resnet_state_dict_from_jax

SIZE, BATCH, CLASSES = 16, 4, 10
CONFIGS = [("space_to_depth", "standard"), ("space_to_depth", "fused"),
           ("conv", "standard"), ("conv", "fused")]


def _cfgs(stem, impl):
    kw = dict(stage_sizes=(1, 1), width=4, num_classes=CLASSES, dtype="float32", stem=stem,
              block_impl=impl)
    return jresnet.ResNetConfig(**kw), tresnet.ResNetConfig(**kw)


@functools.lru_cache(maxsize=None)
def _variables(stem, seed=0):
    """Perturbed params and batch_stats of the tiny model (the standard
    and fused trees are the same) as numpy."""
    jcfg, _ = _cfgs(stem, "standard")
    variables = jresnet.ResNet(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
                          .astype(np.float32), variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(s) + (0.1 * rng.standard_normal(s.shape) if path[-1].key ==
                                         "mean" else 0.2 * rng.random(s.shape)).astype(np.float32),
        variables["batch_stats"])
    return params, stats


def _batch(seed):
    rng = np.random.default_rng(100 + seed)
    return {"image": rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32),
            "label": rng.integers(0, CLASSES, BATCH).astype(np.int32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(stem, impl):
    jcfg, _ = _cfgs(stem, impl)
    model = jresnet.ResNet(jcfg)
    loss_fn = jcommon.classification_loss_fn(model, label_smoothing=0.1)

    def f(params, stats, batch):
        (loss, (state, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, {"batch_stats": stats}, batch, jax.random.PRNGKey(0))
        logits, _ = model.apply({"params": params, "batch_stats": stats}, batch["image"],
                                train=True, mutable=["batch_stats"])
        return loss, aux["accuracy"], grads, state["batch_stats"], logits

    return jax.jit(f)


@pytest.mark.parametrize("stem,impl", CONFIGS)
def test_logits_loss_gradients_and_batch_stats_match_jax(stem, impl):
    params, stats = _variables(stem)
    batch = _batch(0)
    jloss, jacc, jgrads, jstats, jlogits = _jax_loss_and_grad(stem, impl)(params, stats, batch)
    jcfg, tcfg = _cfgs(stem, impl)
    model = resnet_from_jax(params, stats, tcfg, device="cpu")
    with torch.no_grad():
        logits = resnet_from_jax(params, stats, tcfg, device="cpu")(
            torch.from_numpy(batch["image"]), train=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    loss, aux = tcommon.classification_loss_fn(model, label_smoothing=0.1)(_tbatch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    assert float(aux["accuracy"]) == float(jacc)
    want = resnet_state_dict_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    want_sd = resnet_state_dict_from_jax(params, tcfg, jax.tree.map(np.asarray, jstats))
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_sd[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("stem,impl", CONFIGS[:2])
def test_eval_forward_matches_jax(stem, impl):
    """train=False: the running statistics normalise, nothing is updated."""
    params, stats = _variables(stem, seed=1)
    jcfg, tcfg = _cfgs(stem, impl)
    x = _batch(1)["image"]
    want = jax.jit(lambda p, s, x: jresnet.ResNet(jcfg).apply(
        {"params": p, "batch_stats": s}, x, train=False))(params, stats, x)
    model = resnet_from_jax(params, stats, tcfg, device="cpu")
    before = [b.clone() for b in model.buffers()]
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(before, model.buffers()))


@pytest.mark.parametrize("impl", ["standard", "fused"])
def test_three_momentum_steps_match_the_jax_step(impl):
    """momentum 0.9 with coupled L2 1e-4 on the kernels (the preset's
    optimizer at lr 0.1), label smoothing 0.1: three steps of the port's
    step against the JAX step — params and the threaded batch_stats."""
    stem = "space_to_depth"
    params, stats = _variables(stem, seed=2)
    jcfg, tcfg = _cfgs(stem, impl)
    ocfg = dict(name="momentum", learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg))
    loss_fn = jcommon.classification_loss_fn(jresnet.ResNet(jcfg), label_smoothing=0.1)
    jp = jax.tree.map(jnp.asarray, params)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=tx.init(jp),
                             model_state={"batch_stats": jax.tree.map(jnp.asarray, stats)},
                             rng=jax.random.PRNGKey(0))
    jtrain = jax.jit(jstep.make_train_step(loss_fn, tx))
    model = resnet_from_jax(params, stats, tcfg, device="cpu")
    opt = topt.make_optimizer(topt.OptimizerConfig(**ocfg), model.parameters())
    ts = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(tcommon.classification_loss_fn(model, label_smoothing=0.1))
    for i in range(3):
        batch = _batch(10 + i)
        state, jm = jtrain(state, batch)
        ts, tm = step(ts, _tbatch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-5)
    want = resnet_state_dict_from_jax(jax.tree.map(np.asarray, state.params), tcfg,
                                      jax.tree.map(np.asarray, state.model_state["batch_stats"]))
    init = resnet_state_dict_from_jax(params, tcfg, stats)
    got = dict(model.named_parameters(), **dict(model.named_buffers()))
    moved = 0.0
    for name, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        moved = max(moved, float((want[name] - init[name]).abs().max()))
    assert moved > 1e-3 and ts.step == 3


def test_skip_nonfinite_leaves_the_batch_stats_unchanged():
    """A poisoned step changes nothing: params, optimizer state, step and
    the BatchNorm buffers the forward had already updated."""
    _, tcfg = _cfgs("space_to_depth", "fused")
    params, stats = _variables("space_to_depth", seed=3)
    model = resnet_from_jax(params, stats, tcfg, device="cpu")
    opt = topt.make_optimizer(topt.OptimizerConfig(name="momentum", learning_rate=0.1),
                              model.parameters())
    st = tstep.init_train_state(model, opt)
    base = tcommon.classification_loss_fn(model)

    def loss_fn(batch, gen):
        loss, aux = base(batch, gen)
        return loss * batch["scale"], aux

    step = tstep.make_train_step(loss_fn, tstep.StepOptions(skip_nonfinite=True))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    bad = dict(_tbatch(_batch(4)), scale=torch.tensor(float("nan")))
    st, metrics = step(st, bad)
    assert float(metrics["nonfinite"]) == 1.0 and st.step == 0 and opt.count == 0
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    st, metrics = step(st, dict(bad, scale=torch.tensor(1.0)))
    assert float(metrics["nonfinite"]) == 0.0 and st.step == 1
    assert not torch.equal(model.stage0_block0.bn1.running_mean,
                           before["stage0_block0.bn1.running_mean"])


def test_grad_accumulation_threads_the_batch_stats():
    """grad_accum_steps=2: the running statistics go through both
    microbatches in turn, as the JAX scan threads model_state — equal to
    two forwards on the halves, one after the other."""
    _, tcfg = _cfgs("conv", "standard")
    params, stats = _variables("conv", seed=5)
    batch = _tbatch(_batch(6))
    model = resnet_from_jax(params, stats, tcfg, device="cpu")
    opt = topt.make_optimizer(topt.OptimizerConfig(name="sgd", learning_rate=0.0),
                              model.parameters())
    step = tstep.make_train_step(tcommon.classification_loss_fn(model),
                                 tstep.StepOptions(grad_accum_steps=2))
    step(tstep.init_train_state(model, opt), batch)
    ref = resnet_from_jax(params, stats, tcfg, device="cpu")
    with torch.no_grad():
        for half in (slice(0, 2), slice(2, 4)):
            ref(batch["image"][half], train=True)
    for (name, a), b in zip(model.named_buffers(), ref.buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_space_to_depth_and_same_padding_match_jax():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    got = tresnet.space_to_depth(torch.from_numpy(x), 2).numpy()
    assert np.array_equal(got, np.asarray(jresnet.space_to_depth(jnp.asarray(x), 2)))
    assert tresnet.same_pads(224, 7, 2) == (2, 3)
    assert tresnet.same_pads(112, 4, 1) == (1, 2)
    assert tresnet.same_pads(56, 3, 2) == (0, 1)
    assert tresnet.same_pads(112, 3, 2) == (0, 1)


def test_flops_and_param_count_match_jax():
    for stem in ("space_to_depth", "conv"):
        jcfg = jresnet.ResNetConfig(stem=stem)
        tcfg = tresnet.ResNetConfig(stem=stem)
        assert tresnet.flops_per_example(tcfg, 224) == jresnet.flops_per_example(jcfg, 224)
    jcfg, tcfg = _cfgs("space_to_depth", "standard")
    params, _ = _variables("space_to_depth")
    model = tresnet.ResNet(tcfg, device="meta")
    assert tcommon.param_count(model) == jcommon.param_count(params)
    full = tresnet.ResNet(dataclasses.replace(tcfg, stage_sizes=(3, 4, 6, 3), width=64,
                                              num_classes=1000), device="meta")
    # torchvision's ResNet-50 (25,557,032) with the 4x4x12 stem's 2,880 more weights
    assert tcommon.param_count(full) == 25_559_912


def test_init_params_follows_the_flax_initialisers():
    _, tcfg = _cfgs("space_to_depth", "fused")
    sd = tresnet.init_params(dataclasses.replace(tcfg, width=16), seed=0, device="cpu")
    assert (sd["stage0_block0.bn3.weight"] == 0).all() and (sd["stem_bn.weight"] == 1).all()
    assert (sd["stem_bn.running_var"] == 1).all() and (sd["head.bias"] == 0).all()
    w = sd["stage1_block0.conv2.weight"]  # 32 x 32 x 3 x 3: he_normal, fan_in 288
    std = (2.0 / 288) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.1 and float(w.abs().max()) <= 2 * std / 0.8796
    assert torch.equal(sd["stem_conv_s2d.weight"],
                       tresnet.init_params(dataclasses.replace(tcfg, width=16), seed=0,
                                           device="cpu")["stem_conv_s2d.weight"])
