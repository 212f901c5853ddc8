"""Data-parallel ``gpt_lm`` in the port against the JAX package and
against itself, from one launch of two gloo ranks
(``tests/torch_dp_worker.py``'s ``gpt`` job):

- a tiny causal Transformer stepped with adamw and the chunked LM loss,
  each rank on its half of the global batches, against JAX's ``data=2``
  mesh step on two fake CPU devices: losses and every parameter;
- the same steps at dropout 0.1 with remat against one process on the
  global batches (each rank's masks are its rows of the global draw,
  replayed in the recompute);
- ``run_workload("gpt_lm", --mesh.data=2)`` against one process stepping
  the same model on the global batches the two ranks' streams make.

Each rank's loss is the mean over its own tokens; the mean of the two is
the global mean because both ranks score the same count (no LM stream
pads). Tolerance 5e-5 (f32, other summation orders over two ranks), as
the dp2 BERT test states it; the two ranks' weights are bitwise equal.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_port_helpers as H
from distributed_tensorflow_tpu.models import transformer as jtfm
from distributed_tensorflow_tpu.parallel import MeshSpec as JMeshSpec
from distributed_tensorflow_tpu.parallel import build_mesh as jbuild_mesh
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu.train import step as jstep
from distributed_tensorflow_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_tpu_torch.weights import _state_dict_from_jax

sys.path.insert(0, os.path.dirname(__file__))
import torch_dp_worker as worker  # noqa: E402
from test_torch_train_workload import TINY  # noqa: E402

SEQ, GLOBAL, VOCAB, CHUNK = 32, 8, 256, 16
TOL = dict(rtol=5e-5, atol=5e-5)
OPTIMIZER = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01)
DROPOUT = 0.1
RUNNER = TINY + ["--train.num_steps=3", "--train.eval_batches=0"]


def _jcfg():
    return H.jax_cfg(vocab_size=VOCAB, max_len=SEQ)


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, VOCAB, (GLOBAL, SEQ)).astype(np.int32)}
            for _ in range(n)]


def _jax_dp2_steps(params, batches, devices):
    mesh = jbuild_mesh(JMeshSpec(data=2), devices[:2])
    jcfg = _jcfg()
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**OPTIMIZER))
    loss_fn = jtfm.chunked_lm_loss_fn(jtfm.Transformer(jcfg, mesh), CHUNK)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=tx.init(params), model_state={},
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
    sd = _state_dict_from_jax(jax.tree.map(np.asarray, state.params), H.port_cfg(jcfg))
    return np.asarray(losses), {k: v.numpy() for k, v in sd.items()}


def _one_process_runner_steps():
    """What ``run_workload("gpt_lm", RUNNER + --mesh.data=2)`` computes, in
    one process: the workload's model, optimizer and step, fed each global
    batch as the two ranks' streams draw it (rank r's rows seeded with
    its process index), rank 0's rows first."""
    from distributed_tensorflow_tpu_torch.data import text
    from distributed_tensorflow_tpu_torch.parallel import cluster
    from distributed_tensorflow_tpu_torch.train import (
        init_train_state, make_optimizer, make_train_step)
    from distributed_tensorflow_tpu_torch.utils import config as tconfig
    from distributed_tensorflow_tpu_torch.workloads import gpt_lm

    cfg = tconfig.apply_overrides(gpt_lm.default_config(), RUNNER)
    parts = gpt_lm.build(cfg, torch.device("cpu"))
    state = init_train_state(parts.model, make_optimizer(cfg.optimizer,
                                                         parts.model.parameters()),
                             seed=cfg.train.seed)
    step = make_train_step(parts.loss_fn)
    losses = []
    for i in range(cfg.train.num_steps):
        rows = []
        for r in range(2):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(cluster, "process_index", lambda r=r: r)
                mp.setattr(cluster, "process_count", lambda: 2)
                rows.append(text.make_text_dataset(cfg.data).batch(i)["input_ids"])
        state, m = step(state, {"input_ids": torch.from_numpy(np.concatenate(rows))})
        losses.append(float(m["loss"]))
    return {"losses": np.asarray(losses), "state": {
        k: v.detach().float().numpy() for k, v in state.model.state_dict().items()}}


@pytest.fixture(scope="module")
def dp(tmp_path_factory, devices):
    """The dp2 job (started first: it runs while JAX compiles), JAX's
    data=2 steps, the one-process dropout steps and the one-process runner."""
    out = str(tmp_path_factory.mktemp("dp_gpt"))
    jcfg = _jcfg()
    params = H.params_np(jcfg, seed=11)
    sd = {k: v.numpy() for k, v in _state_dict_from_jax(params, H.port_cfg(jcfg)).items()}
    train = _batches(3, seed=12)
    inputs = os.path.join(out, "inputs.npz")
    np.savez(inputs, **{f"sd/{k}": v for k, v in sd.items()},
             **{f"train{i}/input_ids": b["input_ids"] for i, b in enumerate(train)})
    cfg = {k: v for k, v in vars(H.port_cfg(jcfg)).items()}
    procs = worker.launch({"job": "gpt", "device": "cpu", "out": out, "inputs": inputs,
                           "cfg": cfg, "optimizer": OPTIMIZER, "dropout": DROPOUT,
                           "chunk": CHUNK, "runner": RUNNER + ["--mesh.data=2"]})
    try:
        jax_run = _jax_dp2_steps(params, train, devices)
        one = worker.bert_steps(
            ttfm.TransformerConfig(**{**cfg, "dropout": DROPOUT, "remat": True}), sd, train,
            OPTIMIZER, torch.device("cpu"), lm_chunk=CHUNK)
        runner_one = _one_process_runner_steps()
    except BaseException:
        worker.stop(procs)
        raise
    return {"ranks": worker.wait(procs, out, timeout=240), "jax": jax_run, "init": sd,
            "one_process_dropout": one, "runner_one": runner_one}


def _same_on_both_ranks(ranks, prefix):
    r0, r1 = ranks
    names = [k for k in r0 if k.startswith(prefix)]
    assert names
    for k in names:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_dp2_gpt_step_matches_the_jax_data2_mesh_step(dp):
    jlosses, jsd = dp["jax"]
    r0 = dp["ranks"][0]
    np.testing.assert_allclose(r0["plain/losses"], jlosses, **TOL)
    _same_on_both_ranks(dp["ranks"], "plain/state/")
    moved = 0.0
    for name, want in jsd.items():
        got = r0[f"plain/state/{name}"]
        if name.endswith("attn.key.bias"):
            # its exact gradient is 0, so Adam moves it by normalised
            # roundoff, at most lr an update (test_torch_evaluation.py)
            for side in (got, want):
                assert float(np.abs(side - dp["init"][name]).max()) <= 3.01e-3
            continue
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
        moved = max(moved, float(np.abs(want - dp["init"][name]).max()))
    assert moved > 1e-3


def test_dp2_dropout_with_remat_equals_one_process(dp):
    """At dropout 0.1 under remat, the two ranks' steps equal one process
    stepping on the global batches (each rank draws the global batch's
    masks and keeps its rows), and dropout did change the steps."""
    one = dp["one_process_dropout"]
    r0 = dp["ranks"][0]
    np.testing.assert_allclose(r0["dropout/losses"], one["losses"], **TOL)
    assert not np.allclose(r0["dropout/losses"], r0["plain/losses"], rtol=1e-3, atol=0)
    _same_on_both_ranks(dp["ranks"], "dropout/state/")
    for name, want in one["state"].items():
        if name.endswith("attn.key.bias"):
            continue
        np.testing.assert_allclose(r0[f"dropout/state/{name}"], want, **TOL, err_msg=name)


def test_dp2_run_workload_equals_one_process(dp):
    """The runner over two ranks (cluster, mesh, replicated weights,
    Prefetcher) equals one process stepping on the global batches the two
    ranks' streams make."""
    one = dp["runner_one"]
    r0 = dp["ranks"][0]
    assert int(r0["runner/data_axis"]) == 2
    np.testing.assert_allclose(r0["runner/losses"], one["losses"], **TOL)
    _same_on_both_ranks(dp["ranks"], "runner/state/")
    for name, v in one["state"].items():
        if name.endswith("attn.key.bias"):
            continue
        np.testing.assert_allclose(r0[f"runner/state/{name}"], v, **TOL, err_msg=name)
