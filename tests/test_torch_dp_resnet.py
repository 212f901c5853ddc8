"""Data-parallel ResNet training of the port against the JAX package's.

Two processes over gloo (``tests/torch_dp_worker.py``, launched with
torchrun's variables) train the tiny ResNet (``stage_sizes=(1, 1, 1, 1)``,
width 8, 32x32 images, f32, the ``space_to_depth`` stem) for two momentum
+ coupled-L2 steps (lr 0.1, label smoothing 0.1), each rank on its half of
the same two global batches of 8, with the standard blocks and the fused
ones (``DTF_FUSED_BWD=xla`` and ``pallas``: on the CPU the kernels' plain
versions). They are held against

- JAX's ``ResNet(cfg, build_mesh(MeshSpec(data=2)))`` through
  ``jit_train_step`` on two of the fake CPU devices (the batch sharded
  over ``data``: GSPMD's global BatchNorm statistics in the standard
  model, the shard_map psum of the column sums in the fused one), and
- the port's one-process step on the global batch,

on the same weights (flax's tree, perturbed away from the init) and the
same global batches: the losses, every parameter after the steps and the
running statistics. Tolerance, f32: 5e-5 absolute + relative everywhere.
Summation order alone moves this model's numbers by ~1e-5 after two
steps (the stem's weights, whose gradient crosses all four stages, the
most), where ``test_torch_resnet.py`` holds the shallower one-process
model to 1e-5; a rank whose BatchNorm statistics were its own half's is
off by ~1e-1 (a mutation check: the all-reduce removed). The same
job runs ``run_workload("resnet50_imagenet")`` at ``mesh.data=2`` (the
runner's cluster, mesh, replicated weights and Prefetcher) and checks that
both ranks end on the same weights.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from distributed_tensorflow_tpu.models import common as jcommon
from distributed_tensorflow_tpu.models import resnet as jresnet
from distributed_tensorflow_tpu.parallel import MeshSpec as JMeshSpec
from distributed_tensorflow_tpu.parallel import build_mesh as jbuild_mesh
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu.train import step as jstep
from distributed_tensorflow_tpu_torch.models import resnet as tresnet
from distributed_tensorflow_tpu_torch.weights import resnet_state_dict_from_jax

sys.path.insert(0, os.path.dirname(__file__))
import torch_dp_worker as worker  # noqa: E402

SIZE, GLOBAL, CLASSES, STEPS = 32, 8, 10, 2
CFG = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=CLASSES, dtype="float32",
           stem="space_to_depth")
IMPLS = [("standard", "xla"), ("fused", "xla"), ("fused", "pallas")]
TOL = dict(rtol=5e-5, atol=5e-5)
RUNNER = ["--model.stage_sizes=[1,1]", "--model.width=8", "--model.num_classes=10",
          "--model.dtype=float32", "--data.image_size=16", "--data.num_classes=10",
          "--data.global_batch_size=8", "--train.log_every=1", "--optimizer.warmup_steps=0",
          "--optimizer.schedule=constant", "--optimizer.learning_rate=0.05",
          "--train.num_steps=3", "--mesh.data=2", "--model.block_impl=fused"]


def _variables(seed=0):
    """flax params and batch_stats of the tiny model from a numpy
    generator (shapes by eval_shape: nothing compiled): convolutions
    N(0, 2/fan_in), the head N(0, 1/fan_in), BatchNorm scales 1 + N(0,
    0.05²) (bn3's too: a zero scale would silence the branches), biases
    N(0, 0.05²), running means N(0, 0.1²), variances 1 + U(0, 0.2)."""
    shapes = jax.eval_shape(lambda k: jresnet.ResNet(jresnet.ResNetConfig(**CFG)).init(
        k, jnp.zeros((1, SIZE, SIZE, 3)), train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        n = lambda std: (std * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
        if name == "kernel":
            return n((2.0 / np.prod(shape[:-1])) ** 0.5 if len(shape) == 4 else shape[0] ** -0.5)
        if name == "scale":
            return 1.0 + n(0.05)
        if name == "mean":
            return n(0.1)
        if name == "var":
            return (1.0 + 0.2 * rng.random(shape)).astype(np.float32)
        return n(0.05)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v["batch_stats"]


def _batches():
    rng = np.random.default_rng(7)
    return [{"image": rng.standard_normal((GLOBAL, SIZE, SIZE, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, GLOBAL).astype(np.int32)} for _ in range(STEPS)]


def _jax_steps(impl, params, stats, batches, devices):
    """STEPS steps of JAX's step on a data=2 mesh: losses and the state dict."""
    mesh = jbuild_mesh(JMeshSpec(data=2), devices[:2])
    jcfg = jresnet.ResNetConfig(**CFG, block_impl=impl)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**worker.OPTIMIZER))
    loss_fn = jcommon.classification_loss_fn(jresnet.ResNet(jcfg, mesh), label_smoothing=0.1)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=tx.init(params), model_state={"batch_stats": stats},
                             rng=jax.random.PRNGKey(0))
    specs = jstep.state_specs(jax.eval_shape(lambda: state), jsh.replicated_specs(params))
    state = jax.device_put(state, jsh.tree_shardings(mesh, specs))
    step = jstep.jit_train_step(jstep.make_train_step(loss_fn, tx), mesh, specs)
    losses = []
    for b in batches:
        b = {k: jax.device_put(v, NamedSharding(mesh, jsh.batch_spec(v.ndim)))
             for k, v in b.items()}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    sd = resnet_state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                                    tresnet.ResNetConfig(**CFG),
                                    jax.tree.map(np.asarray, state.model_state["batch_stats"]))
    return np.asarray(losses), {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices):
    """The dp2 job (started first, it runs while JAX compiles), JAX's
    data=2 steps and the port's one-process steps, for every impl."""
    out = str(tmp_path_factory.mktemp("dp_resnet"))
    params, stats = _variables()
    batches = _batches()
    sd = {k: v.numpy() for k, v in resnet_state_dict_from_jax(
        params, tresnet.ResNetConfig(**CFG), stats).items()}
    inputs = os.path.join(out, "inputs.npz")
    np.savez(inputs, **{f"sd/{k}": v for k, v in sd.items()},
             **{f"{k}{i}": b[k] for i, b in enumerate(batches) for k in b})
    procs = worker.launch({"job": "resnet", "device": "cpu", "out": out, "inputs": inputs,
                           "cfg": CFG, "impls": IMPLS, "runner": RUNNER})
    try:
        jax_runs = {impl: _jax_steps(impl, params, stats, batches, devices)
                    for impl in ("standard", "fused")}
        one = {f"{impl}/{bwd}": worker.train_steps(
            tresnet.ResNetConfig(**CFG, block_impl=impl), sd, batches, torch.device("cpu"),
            bwd=bwd) for impl, bwd in IMPLS}
    except BaseException:
        worker.stop(procs)
        raise
    ranks = worker.wait(procs, out, timeout=240)
    return {"ranks": ranks, "jax": jax_runs, "one": one, "init": sd}


def _rank_state(rank, tag):
    pre = f"{tag}/state/"
    return {k[len(pre):]: v for k, v in rank.items() if k.startswith(pre)}


@pytest.mark.parametrize("impl,bwd", IMPLS)
def test_dp2_step_matches_the_jax_data2_mesh_step(runs, impl, bwd):
    tag = f"{impl}/{bwd}"
    jlosses, jsd = runs["jax"][impl]
    rank0 = runs["ranks"][0]
    np.testing.assert_allclose(rank0[f"{tag}/losses"], jlosses, **TOL)
    got = _rank_state(rank0, tag)
    assert sorted(got) == sorted(jsd)
    moved = 0.0
    for name, want in jsd.items():
        np.testing.assert_allclose(got[name], want, **TOL, err_msg=name)
        moved = max(moved, float(np.abs(want - runs["init"][name]).max()))
    assert moved > 1e-2  # the steps moved the weights and statistics


@pytest.mark.parametrize("impl,bwd", IMPLS)
def test_dp2_step_matches_the_one_process_step_on_the_global_batch(runs, impl, bwd):
    tag = f"{impl}/{bwd}"
    one = runs["one"][tag]
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank[f"{tag}/losses"], one["losses"], **TOL)
        got = _rank_state(rank, tag)
        for name, want in one["state"].items():
            np.testing.assert_allclose(got[name], want, **TOL, err_msg=name)


def test_ranks_end_on_the_same_weights_and_log_the_same_loss(runs):
    """The ranks hold identical replicas: the averaged gradients and the
    global BatchNorm statistics are bitwise equal on both."""
    r0, r1 = runs["ranks"]
    for key in r0:
        if "/state/" in key or key.endswith("/losses"):
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


def test_run_workload_trains_data_parallel(runs):
    """``run_workload`` at mesh.data=2: both ranks end on the same weights
    (checked in the job by assert_same_across_hosts) and log the same
    finite losses."""
    r0, r1 = runs["ranks"]
    assert int(r0["runner/mesh_data"]) == 2
    losses = r0["runner/losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    np.testing.assert_array_equal(losses, r1["runner/losses"])
