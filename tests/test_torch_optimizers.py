"""The port's rmsprop, lamb and adafactor against optax as the JAX
package's ``make_optimizer`` builds them, on the same parameters and
gradients: N updates under a warm-up + cosine schedule with weight decay
(coupled L2 on kernels for rmsprop and adafactor, lamb's own decoupled
decay), over a leaf adafactor factors (256 x 128), one it does not
(64 x 32) and a vector; the optax state of a tiny Transformer carried
across by ``weights.optimizer_state_from_jax`` (adafactor's factored
statistics of square kernels, which the [out, in] layout transposes,
included) and continued; the checkpoint leaves of adafactor's per-leaf
state; the refusal of a shard for the whole-leaf norms.

Tolerance, f32: parameters 1e-6 absolute + 1e-6 relative after the
updates (each is lr times an O(1) normalised step; the two sides round
the same f32 operations in another order by an ulp or so).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_helpers as H
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.train import optimizers as topt
from distributed_tensorflow_tpu_torch.train import step as tstep
from distributed_tensorflow_tpu_torch.weights import (
    _state_dict_from_jax,
    from_jax_params,
    optimizer_state_from_jax,
)

NAMES = ("rmsprop", "lamb", "adafactor")
TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = {"factored": (256, 128), "unfactored": (64, 32), "vector": (200,)}


def _cfg(name, **kw):
    return dict(name=name, learning_rate=0.01, weight_decay=0.01, schedule="warmup_cosine",
                warmup_steps=1, total_steps=10, **kw)


@pytest.mark.parametrize("name", NAMES)
def test_updates_match_optax(name):
    """Four updates: the first at lr 0 (warm-up), then the cosine decay;
    every parameter moved, and equal to optax's."""
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(4)]
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**_cfg(name)))
    state, jp = tx.init(params), dict(params)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in SHAPES]
    opt = topt.make_optimizer(topt.OptimizerConfig(**_cfg(name)), tp)
    for g in grads:
        u, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, u)
        opt.update([torch.from_numpy(g[k]) for k in SHAPES])
    for k, t in zip(SHAPES, tp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]), **TOL, err_msg=k)
        assert np.abs(np.asarray(jp[k]) - params[k]).max() > 1e-4, k
    assert opt.count == 4


def test_coupled_l2_scope_and_state_keys():
    """Coupled L2 (kernels only, before clipping) for rmsprop and
    adafactor, not lamb (decoupled); the state each keeps per leaf."""
    ps = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()]
    opts = {n: topt.make_optimizer(topt.OptimizerConfig(name=n, weight_decay=0.1), ps)
            for n in NAMES}
    assert [opts[n].coupled_l2 for n in NAMES] == [True, False, True]
    assert opts["rmsprop"].param_state_keys() == [("momentum_buffer", "square_avg")] * 3
    assert opts["lamb"].param_state_keys() == [("exp_avg", "exp_avg_sq", "step")] * 3
    assert opts["adafactor"].param_state_keys() == [("v_col", "v_row"), ("v",), ("v",)]
    assert topt.factored_dims((128, 128)) == (0, 1)
    assert topt.factored_dims((256, 128)) == (1, 0)
    assert topt.factored_dims((127, 4096)) is None


def _tiny_transformer():
    """d 128 so that the square attention kernels, mlp_in/out and the
    token table are factored by adafactor, pos_embed (64 x 128) not."""
    jcfg = H.jax_cfg(d_model=128, d_ff=256, num_heads=4)
    return jcfg, H.params_np(jcfg, seed=8)


@pytest.mark.parametrize("name", NAMES)
def test_optax_state_carries_across_and_continues(name):
    """Two optax updates of a Transformer tree in JAX; its params and
    state into the port (``from_jax_params``, ``optimizer_state_from_jax``);
    a third update on both sides from the same gradients gives the same
    parameters."""
    jcfg, params = _tiny_transformer()
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
             for _ in range(3)]
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**_cfg(name)))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads[:2]:
        u, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, u)
    model = from_jax_params(jax.tree.map(np.asarray, jp), H.port_cfg(jcfg), device="cpu",
                            trainable=True)
    opt = topt.make_optimizer(topt.OptimizerConfig(**_cfg(name)), model.parameters())
    optimizer_state_from_jax(jax.tree.map(np.asarray, state), model, opt)
    assert opt.count == 2
    u, state = tx.update(grads[2], state, jp)
    jp = optax.apply_updates(jp, u)
    g_sd = _state_dict_from_jax(grads[2], model.cfg)
    opt.update([g_sd[n] for n, _ in model.named_parameters()])
    want = _state_dict_from_jax(jax.tree.map(np.asarray, jp), model.cfg)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), **TOL, err_msg=n)
    if name == "adafactor":
        kinds = {n: sorted(opt.opt.state[p]) for n, p in model.named_parameters()}
        assert kinds["layers.0.attn.query.weight"] == ["v_col", "v_row"]
        assert kinds["pos_embed"] == ["v"]


def test_adafactor_state_round_trips_through_the_checkpoint_leaves():
    """``state_leaves`` names adafactor's per-leaf state as ``leaf_names``
    does; loading the leaves into a fresh state and stepping gives the
    weights of the original stepping on, bit for bit."""
    jcfg, params = _tiny_transformer()
    cfg = H.port_cfg(jcfg)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 16)))
    states = []
    for _ in range(2):
        model = from_jax_params(params, cfg, device="cpu", trainable=True)
        opt = topt.make_optimizer(topt.OptimizerConfig(**_cfg("adafactor")),
                                  model.parameters())
        states.append(tstep.init_train_state(model, opt))
    step = [tstep.make_train_step(ttfm.lm_loss_fn(s.model)) for s in states]
    step[0](states[0], {"input_ids": ids})
    leaves = tstep.state_leaves(states[0])
    assert [n for n, _ in leaves] == tstep.leaf_names(states[0], 1)
    tstep.load_state_leaves(states[1], {n: v.detach().clone() for n, v in leaves})
    for s, f in zip(states, step):
        f(s, {"input_ids": ids})
    for (n, a), b in zip(states[0].model.state_dict().items(),
                         states[1].model.state_dict().values()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("name", ["lamb", "adafactor"])
def test_whole_leaf_norms_refuse_a_model_shard(name):
    """lamb and adafactor take a shard now: ``place`` gives the sharded
    leaf its ``Layout`` (the whole shape, the axis of each dim), which
    their per-parameter sums read; a replicated leaf keeps the one-process
    path (no layout). The sums over the ranks are the four-rank job's
    (``tests/test_torch_tensor_parallel.py``)."""
    model = torch.nn.Linear(4, 4)
    opt = topt.make_optimizer(topt.OptimizerConfig(name=name), model.parameters())
    mesh = tmesh.Mesh(dict(tmesh.MeshSpec(data=1, model=2).sizes()), torch.device("cpu"))
    opt.place(mesh, {"weight": ("model", None)}, model)
    lay = opt.layouts[0]
    assert lay.dims == ((8, "model"), (4, None)) and lay.axes == ("model",)
    assert lay.numel == 32 and opt.layouts[1] is None
    assert list(opt.opt.layouts) == [model.weight]
    opt.place(mesh, {}, model)  # nothing sharded
    assert opt.layouts == [None, None] and opt.opt.layouts == {}


def test_lamb_trust_ratio_is_exact_on_a_large_leaf():
    """A lamb update of a 4M-element leaf against the same formula in
    float64: the trust ratio's norms sum the squares (``torch.linalg.
    vector_norm`` on the CPU is off by ~1e-4 at this size and ~2e-3 at
    gpt_small's token table, which scales the whole leaf's update by as
    much). Relative L2 of the update 1e-5: f32 rounding of the elementwise
    math and of the parameter (an ulp of 0.02 against an update of 2e-3
    reads ~3e-7), where the CPU's vector_norm reads ~1e-4."""
    rng = np.random.default_rng(3)
    w = (0.02 * rng.standard_normal((2048, 2048))).astype(np.float32)
    g = rng.standard_normal((2048, 2048)).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(w.copy()))
    opt = topt.make_optimizer(topt.OptimizerConfig(name="lamb", learning_rate=0.1,
                                                   weight_decay=0.01), [p])
    opt.update([torch.from_numpy(g)])
    g64, w64 = g.astype(np.float64), w.astype(np.float64)
    u = g64 / (np.abs(g64) + 1e-8) + 0.01 * w64  # Adam's first step, bias-corrected
    want = -0.1 * np.linalg.norm(w64) / np.linalg.norm(u) * u
    got = p.detach().double().numpy() - w64
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
