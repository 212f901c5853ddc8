"""The port's MNIST MLP and CIFAR-10 CNN (``models/mlp.py``, ``models/cnn.py``,
``workloads/{mnist_mlp,cifar10_cnn}.py``) against the JAX package's on the
same weights and the same batches.

Tiny configs (MLP hidden (32, 16) over 8x8x1 images; CNN channels (4, 8),
dense 16 over 8x8x3 and 12x8x3 images), f32, weights from a numpy
generator converted by ``weights.mlp_from_jax``/``cnn_from_jax``, batches
from numpy. The JAX side runs under ``jax.jit``.

Tolerances, f32: logits, losses and BatchNorm statistics 1e-5 absolute +
relative (the same products, summed in another order); parameters after
five steps 2e-5 (a gradient difference of ~1e-6 moves a parameter by
lr x that a step, and momentum carries it).

Also: the presets field for field against the JAX ones, dropout through
the step's generator, the cifar10_cnn preset's refusal in one process
naming ``--mesh.data=-1``, the JAX ``test_mnist_mlp_converges``
counterpart with ``eval_workload`` from its checkpoint equal to the final
eval, and one spawn of two gloo ranks (``tests/torch_dp_worker.py``'s
``cnn`` job) against one process on the global batch.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import cnn as jcnn
from distributed_tensorflow_tpu.models import common as jcommon
from distributed_tensorflow_tpu.models import mlp as jmlp
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu.train import step as jstep
from distributed_tensorflow_tpu.utils import config as jconfig
from distributed_tensorflow_tpu.workloads import cifar10_cnn as jcifar
from distributed_tensorflow_tpu.workloads import mnist_mlp as jmnist
from distributed_tensorflow_tpu_torch.models import cnn as tcnn
from distributed_tensorflow_tpu_torch.models import common as tcommon
from distributed_tensorflow_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_tpu_torch.train import optimizers as topt
from distributed_tensorflow_tpu_torch.train import step as tstep
from distributed_tensorflow_tpu_torch.utils import config as tconfig
from distributed_tensorflow_tpu_torch.weights import (
    cnn_from_jax,
    cnn_state_dict_from_jax,
    cnn_to_jax,
    mlp_from_jax,
    mlp_state_dict_from_jax,
)
from distributed_tensorflow_tpu_torch.workloads import cifar10_cnn as tcifar
from distributed_tensorflow_tpu_torch.workloads import eval_workload, run_workload
from distributed_tensorflow_tpu_torch.workloads import mnist_mlp as tmnist

sys.path.insert(0, os.path.dirname(__file__))
import torch_dp_worker as worker  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-5, atol=2e-5)
BATCH, CLASSES = 8, 10
MLP_KW = dict(hidden_sizes=(32, 16), num_classes=CLASSES, dtype="float32")
CNN_KW = dict(channels=(4, 8), dense_size=16, num_classes=CLASSES, dtype="float32")


def _fill(shapes, seed):
    """A flax tree of ``shapes`` from a numpy generator: kernels N(0,
    2/fan_in), BatchNorm scales 1 + N(0, 0.1²), biases N(0, 0.1²), running
    means N(0, 0.1²), variances 1 + U(0, 0.2)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        n = lambda std: (std * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
        if name == "kernel":
            return n((2.0 / np.prod(shape[:-1])) ** 0.5)
        if name == "scale":
            return 1.0 + n(0.1)
        if name == "var":
            return (1.0 + 0.2 * rng.random(shape)).astype(np.float32)
        return n(0.1)  # biases, running means

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _mlp_params(seed=0, size=8):
    model = jmlp.MLP(jmlp.MLPConfig(**MLP_KW))
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, size, size, 1))),
                            jax.random.PRNGKey(0))
    return _fill(shapes, seed)["params"]


def _cnn_vars(seed=0, shape=(8, 8, 3)):
    model = jcnn.CNN(jcnn.CNNConfig(**CNN_KW))
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, *shape)), train=False),
                            jax.random.PRNGKey(0))
    v = _fill(shapes, seed)
    return v["params"], v["batch_stats"]


def _batch(seed, shape):
    rng = np.random.default_rng(100 + seed)
    return {"image": rng.standard_normal((BATCH, *shape)).astype(np.float32),
            "label": rng.integers(0, CLASSES, BATCH).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- presets -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["mnist_mlp", "cifar10_cnn"])
def test_presets_equal_the_jax_ones_field_for_field(name):
    tmod, jmod = {"mnist_mlp": (tmnist, jmnist), "cifar10_cnn": (tcifar, jcifar)}[name]
    got, want = tconfig.to_dict(tmod.default_config()), jconfig.to_dict(jmod.default_config())
    assert got["workload"] == want["workload"] == name
    assert got["model"] == want["model"]  # every field, the same set
    for section in ("data", "optimizer", "train", "mesh"):
        for key, value in got[section].items():
            assert value == want[section][key], (section, key)
    assert [f.name for f in dataclasses.fields(tmod.default_config().model)] == \
        [f.name for f in dataclasses.fields(jmod.default_config().model)]


def test_flops_per_example_match_jax():
    for size in (28, 32):
        assert tmlp.flops_per_example(tmlp.MLPConfig(), size * size) == \
            jmlp.flops_per_example(jmlp.MLPConfig(), size * size)
        assert tcnn.flops_per_example(tcnn.CNNConfig(), size) == \
            jcnn.flops_per_example(jcnn.CNNConfig(), size)


# -- forward passes ------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_mlp_forward_matches_jax(train):
    params = _mlp_params()
    x = _batch(0, (8, 8, 1))["image"]
    cfg = jmlp.MLPConfig(**MLP_KW)
    want = jax.jit(lambda p, x: jmlp.MLP(cfg).apply({"params": p}, x, train=train))(params, x)
    model = mlp_from_jax(params, tmlp.MLPConfig(**MLP_KW), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cnn_forward_and_batch_stats_match_jax(train):
    """Logits in both modes; after the train-mode pass the running
    statistics are flax's updated batch_stats, after the eval pass they
    are unchanged."""
    params, stats = _cnn_vars()
    x = _batch(1, (8, 8, 3))["image"]
    cfg = jcnn.CNNConfig(**CNN_KW)

    def f(p, s, x):
        if train:
            return jcnn.CNN(cfg).apply({"params": p, "batch_stats": s}, x, train=True,
                                       mutable=["batch_stats"])
        return jcnn.CNN(cfg).apply({"params": p, "batch_stats": s}, x, train=False), \
            {"batch_stats": s}

    want, new = jax.jit(f)(params, stats, x)
    tcfg = tcnn.CNNConfig(**CNN_KW)
    model = cnn_from_jax(params, stats, tcfg, device="cpu", input_shape=(8, 8, 3))
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_sd = cnn_state_dict_from_jax(params, tcfg, jax.tree.map(np.asarray, new["batch_stats"]))
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_sd[name].numpy(), **TOL, err_msg=name)
    if train:  # the pass moved them
        assert not np.allclose(want_sd["bn_0.running_mean"].numpy(), stats["bn_0"]["mean"])


def test_cnn_flattens_a_non_square_map_in_flax_order():
    """A 12x8 image leaves a 3x2x8 map: flax flattens it in (h, w, c)
    order, and so does the port (``dense``'s rows are flax's kernel rows
    as they are). The same weights read in (c, h, w) order — the NCHW
    flatten — give other logits, so this test fails for that order."""
    shape = (12, 8, 3)
    params, stats = _cnn_vars(seed=2, shape=shape)
    x = _batch(2, shape)["image"]
    cfg = jcnn.CNNConfig(**CNN_KW)
    want = np.asarray(jax.jit(lambda p, s, x: jcnn.CNN(cfg).apply(
        {"params": p, "batch_stats": s}, x, train=False))(params, stats, x))
    tcfg = tcnn.CNNConfig(**CNN_KW)
    model = cnn_from_jax(params, stats, tcfg, device="cpu", input_shape=shape)
    assert model.dense.weight.shape == (16, 3 * 2 * 8)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        # the NCHW flatten: dense's input columns taken in (c, h, w) order
        w = model.dense.weight.view(16, 3, 2, 8).permute(0, 3, 1, 2).reshape(16, 48).clone()
        model.dense.weight.copy_(w)
        wrong = model(torch.from_numpy(x), train=False).numpy()
    assert np.abs(wrong - want).max() > 1e-2


def test_dropout_draws_from_the_steps_generator():
    """At dropout_rate > 0 the train forward draws its masks from the
    generator the loss hands it (the step's; a data-parallel step's
    RowGenerator gives each rank its rows of the global draw); eval mode
    draws nothing, and train mode with no generator is refused."""
    cfg = tmlp.MLPConfig(hidden_sizes=(32,), num_classes=CLASSES, dropout_rate=0.5)
    model = tmlp.build(cfg, tmlp.init_params(cfg, 64, seed=0, device="cpu"), "cpu")
    x = torch.from_numpy(_batch(3, (8, 8, 1))["image"])
    with torch.no_grad():
        got = model(x, train=True, generator=torch.Generator().manual_seed(7))
        h = torch.relu(torch.nn.functional.linear(x.reshape(BATCH, -1), model.dense_0.weight,
                                                  model.dense_0.bias))
        keep = torch.rand(h.shape, generator=torch.Generator().manual_seed(7)) >= 0.5
        want = torch.nn.functional.linear(torch.where(keep, h / 0.5, 0.0), model.head.weight,
                                          model.head.bias)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert torch.equal(model(x), model(x, train=False))
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        model(x, train=True)
    loss_fn = tcommon.classification_loss_fn(model)
    a, _ = loss_fn({"image": x, "label": torch.zeros(BATCH, dtype=torch.long)},
                   torch.Generator().manual_seed(7))
    b, _ = loss_fn({"image": x, "label": torch.zeros(BATCH, dtype=torch.long)},
                   torch.Generator().manual_seed(8))
    assert a.item() != b.item()


# -- trajectories --------------------------------------------------------------


def _jax_steps(model, params, stats, ocfg, batches):
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg))
    jp = jax.tree.map(jnp.asarray, params)
    state = jstep.TrainState(
        step=jnp.zeros((), jnp.int32), params=jp, opt_state=tx.init(jp),
        model_state={"batch_stats": jax.tree.map(jnp.asarray, stats)} if stats else {},
        rng=jax.random.PRNGKey(0))
    train = jax.jit(jstep.make_train_step(jcommon.classification_loss_fn(model), tx))
    losses = []
    for b in batches:
        state, m = train(state, b)
        losses.append(float(m["loss"]))
    return state, losses


def _port_steps(model, ocfg, batches):
    opt = topt.make_optimizer(topt.OptimizerConfig(**ocfg), model.parameters())
    ts = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(tcommon.classification_loss_fn(model))
    return [float(step(ts, _t(b))[1]["loss"]) for b in batches]


def test_mnist_mlp_five_sgd_steps_match_the_jax_step():
    """The preset's optimizer (sgd, lr 0.1): five steps of the port's step
    against the JAX step on the same batches — losses and parameters."""
    ocfg = dict(name="sgd", learning_rate=0.1)
    params = _mlp_params(seed=4)
    batches = [_batch(10 + i, (8, 8, 1)) for i in range(5)]
    state, jlosses = _jax_steps(jmlp.MLP(jmlp.MLPConfig(**MLP_KW)), params, None, ocfg, batches)
    tcfg = tmlp.MLPConfig(**MLP_KW)
    model = mlp_from_jax(params, tcfg, device="cpu")
    losses = _port_steps(model, ocfg, batches)
    np.testing.assert_allclose(losses, jlosses, **TOL)
    want = mlp_state_dict_from_jax(jax.tree.map(np.asarray, state.params), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), **STEP_TOL,
                                   err_msg=name)
    moved = np.abs(np.asarray(state.params["head"]["kernel"]) - params["head"]["kernel"])
    assert moved.max() > 1e-3


def test_cifar10_cnn_five_momentum_cosine_steps_match_the_jax_step():
    """The preset's optimizer (momentum 0.9 at 0.05, cosine decay, here
    over the five steps): the port's step against the JAX step — losses,
    and the parameters and running statistics compared on the JAX side
    through ``cnn_to_jax``."""
    ocfg = dict(name="momentum", learning_rate=0.05, momentum=0.9, schedule="cosine",
                total_steps=5)
    params, stats = _cnn_vars(seed=5)
    batches = [_batch(20 + i, (8, 8, 3)) for i in range(5)]
    state, jlosses = _jax_steps(jcnn.CNN(jcnn.CNNConfig(**CNN_KW)), params, stats, ocfg, batches)
    tcfg = tcnn.CNNConfig(**CNN_KW)
    model = cnn_from_jax(params, stats, tcfg, device="cpu", input_shape=(8, 8, 3))
    losses = _port_steps(model, ocfg, batches)
    np.testing.assert_allclose(losses, jlosses, **TOL)
    got_p, got_s = cnn_to_jax(model.state_dict(), tcfg)
    for tree, want in ((got_p, state.params), (got_s, state.model_state["batch_stats"])):
        flat_got = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0])
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_got:
            np.testing.assert_allclose(leaf, flat_want[path], **STEP_TOL, err_msg=str(path))
    moved = np.abs(np.asarray(state.params["conv_0"]["kernel"]) - params["conv_0"]["kernel"])
    assert moved.max() > 1e-3


# -- the runner ---------------------------------------------------------------


def test_cifar10_cnn_preset_in_one_process_names_mesh_data_minus_one():
    """The preset keeps data=8 (eight replicas are the workload's
    identity); one process is told how to launch it or to pass
    --mesh.data=-1."""
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node=8.*--mesh\.data=-1"):
        run_workload("cifar10_cnn", ["--train.num_steps=1"], device="cpu")


def test_mnist_mlp_converges_and_eval_workload_reproduces_the_final_eval(tmp_path):
    """The JAX ``test_mnist_mlp_converges`` counterpart at the preset's
    widths: 60 steps at batch 256 and lr 0.3, then ``eval_workload`` from
    the checkpoint equal to the run's final eval."""
    common = ["--train.eval_batches=4", f"--checkpoint.directory={tmp_path}/ck"]
    result = run_workload("mnist_mlp", [
        "--train.num_steps=60", "--train.log_every=10", "--data.global_batch_size=256",
        "--optimizer.learning_rate=0.3", "--checkpoint.save_interval_steps=50",
        "--checkpoint.async_save=false", "--checkpoint.save_on_preemption=false", *common],
        device="cpu")
    hist = result.history
    assert hist[0]["loss"] > hist[-1]["loss"], "loss did not decrease"
    ev = result.eval_metrics
    assert ev["accuracy"] > 0.3 and ev["top5_accuracy"] >= ev["accuracy"]
    assert ev["top5_accuracy"] > 0.7 and int(result.state.step) == 60
    assert (tmp_path / "ck" / "config.json").exists()
    again = eval_workload("mnist_mlp", ["--data.global_batch_size=256", *common], device="cpu")
    assert again.pop("step") == 60
    assert again == ev


# -- data parallelism ----------------------------------------------------------


#: one step each of the workloads whose parts do not ask for fsdp, at
#: data=2 and at fsdp=2 (the cnn job's ``fsdp_runs``)
FSDP_RUNS = {
    "mnist_mlp": ["--model.hidden_sizes=[32,16]", "--data.global_batch_size=16",
                  "--train.num_steps=1", "--train.eval_batches=0"],
    "resnet50_imagenet": ["--model.stage_sizes=[1,1]", "--model.width=8",
                          "--model.num_classes=10", "--model.dtype=float32",
                          "--data.image_size=16", "--data.num_classes=10",
                          "--data.global_batch_size=8", "--train.num_steps=1",
                          "--train.eval_batches=0"],
}


@pytest.fixture(scope="module")
def cnn_ranks(tmp_path_factory):
    """One spawn of two gloo ranks of ``torch_dp_worker.py``'s ``cnn`` job
    (the CNN passes, its runner and ``FSDP_RUNS``) and what one process
    computes on the global batches."""
    tmp_path = tmp_path_factory.mktemp("cnn")
    params, stats = _cnn_vars(seed=6)
    sd = {k: v.numpy() for k, v in cnn_state_dict_from_jax(
        params, tcnn.CNNConfig(**CNN_KW), stats).items()}
    batches = [_batch(30 + i, (8, 8, 3)) for i in range(3)]
    np.savez(tmp_path / "inputs.npz", **{f"sd/{k}": v for k, v in sd.items()},
             **{f"{k}{i}": b[k] for i, b in enumerate(batches) for k in ("image", "label")})
    spec = {"job": "cnn", "device": "cpu", "out": str(tmp_path),
            "inputs": str(tmp_path / "inputs.npz"), "cfg": CNN_KW, "input_shape": [8, 8, 3],
            "runner": ["--model.channels=[4,8]", "--model.dense_size=16",
                       "--data.image_size=8", "--data.global_batch_size=8",
                       "--train.num_steps=2", "--train.log_every=1", "--train.eval_batches=1",
                       "--mesh.data=2"],
            "fsdp_runs": FSDP_RUNS}
    procs = worker.launch(spec)
    try:
        ref = worker.cnn_steps(tcnn.CNNConfig(**CNN_KW), sd, batches, torch.device("cpu"),
                               input_shape=(8, 8, 3))
    except BaseException:
        worker.stop(procs)
        raise
    return worker.wait(procs, str(tmp_path), timeout=240), ref


def test_cifar10_cnn_two_gloo_ranks_equal_one_process_on_the_global_batch(cnn_ranks):
    """Two ranks (one spawn of ``torch_dp_worker.py``'s ``cnn`` job,
    ``data=2``) each step the tiny CNN on its half of three global batches
    of 8 (momentum, cosine): the losses, every parameter and the running
    statistics equal one process stepping on the whole batches within
    ``TOL`` — the BatchNorm statistics are the global batch's (a mutation
    check, each rank normalising with its own half's: the losses 5.7e-2 and
    the state 3.6e-2 off, and the runner's ranks diverge) — and both ranks
    end alike. The same job runs ``run_workload("cifar10_cnn")`` at
    ``mesh.data=2``."""
    ranks, ref = cnn_ranks
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], **TOL)
        for k, v in ref["state"].items():
            np.testing.assert_allclose(r[f"state/{k}"], v, **TOL, err_msg=k)
    for k in ranks[0]:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    assert int(ranks[0]["runner/mesh_data"]) == 2 and np.isfinite(ranks[0]["runner/losses"]).all()


@pytest.mark.parametrize("workload", list(FSDP_RUNS))
def test_fsdp2_is_a_batch_axis_equal_to_data2(cnn_ranks, workload):
    """``mnist_mlp`` and ``resnet50_imagenet`` do not shard their
    parameters over fsdp (neither do the JAX package's); at data=1 x
    fsdp=2 the batch rides fsdp as JAX's ``batch_spec`` splits it: the
    same rows on the same ranks, the gradients and BatchNorm statistics
    summed over the same two ranks, so a step equals data=2 bitwise."""
    ranks, _ = cnn_ranks
    for r in ranks:
        assert r[f"{workload}/data2/mesh"].tolist() == [2, 1]
        assert r[f"{workload}/fsdp2/mesh"].tolist() == [1, 2]
        keys = [k[len(f"{workload}/data2/"):] for k in r if k.startswith(f"{workload}/data2/")
                and not k.endswith("/mesh")]
        assert any(k.startswith("state/") for k in keys) and "losses" in keys
        for k in keys:
            np.testing.assert_array_equal(r[f"{workload}/fsdp2/{k}"], r[f"{workload}/data2/{k}"],
                                          err_msg=k)
        assert np.isfinite(r[f"{workload}/fsdp2/losses"]).all()
