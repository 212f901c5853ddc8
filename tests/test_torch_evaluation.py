"""The port's evaluation against the JAX package and against itself.

- ``derive_metrics`` gives JAX's numbers on the same totals;
- ``classification_eval_fn`` on a tiny ResNet (BatchNorm on its running
  statistics) gives JAX's summed loss, top-1, top-5 and count;
- ``ShardedEvaluator`` in one process equals the serial evaluator bit for
  bit, counts its batches and records its pass in the flight recorder;
- two processes over gloo (``tests/torch_dp_worker.py``, one launch): a
  tiny BERT stepped data-parallel with adamw, each rank on its half of
  the global batches (one with a padded ``attention_mask``), against
  JAX's ``data=2`` mesh step on two fake CPU devices (losses and every
  parameter within 5e-5, f32: other summation orders over two ranks), the
  same steps at dropout 0.1 against one process on the global batches
  (each rank's masks are its rows of the global draw), and the
  ``ShardedEvaluator`` of the two ranks bitwise equal to one process
  evaluating the same chunks in rank order;
- the runner: a mid-train eval's wall time stays out of ``MetricsLogger``'s
  steps/s (``note_pause``), ``gpt_lm`` and ``resnet50_imagenet`` return
  ``eval_metrics``, and ``evaluate_from_checkpoint`` is refused naming
  ROADMAP item 2.3.
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
from distributed_tensorflow_tpu.models import common as jcommon
from distributed_tensorflow_tpu.models import resnet as jresnet
from distributed_tensorflow_tpu.models import transformer as jtfm
from distributed_tensorflow_tpu.parallel import MeshSpec as JMeshSpec
from distributed_tensorflow_tpu.parallel import build_mesh as jbuild_mesh
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu.train import evaluation as jeval
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu.train import step as jstep
from distributed_tensorflow_tpu_torch.models import common as tcommon
from distributed_tensorflow_tpu_torch.models import resnet as tresnet
from distributed_tensorflow_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_tpu_torch.obs import flightrec
from distributed_tensorflow_tpu_torch.obs.registry import Registry, default_registry
from distributed_tensorflow_tpu_torch.train import callbacks as tcb
from distributed_tensorflow_tpu_torch.train import evaluation as teval
from distributed_tensorflow_tpu_torch.train import step as tstep
from distributed_tensorflow_tpu_torch.weights import _state_dict_from_jax, from_jax_params
from distributed_tensorflow_tpu_torch.weights import resnet_from_jax
from distributed_tensorflow_tpu_torch.workloads import runner, run_workload

sys.path.insert(0, os.path.dirname(__file__))
import torch_dp_worker as worker  # noqa: E402

SEQ, GLOBAL, VOCAB, K = 16, 8, 128, 3
TOL = dict(rtol=5e-5, atol=5e-5)
OPTIMIZER = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01)
DROPOUT = 0.1


def _jcfg():
    return H.jax_cfg(vocab_size=VOCAB, max_len=SEQ, d_model=32, num_heads=4, d_ff=64,
                     causal=False, pre_ln=False)


def _mlm_batches(n, seed, padded=()):
    """``n`` global gathered-MLM batches of GLOBAL rows; the batches named
    in ``padded`` carry an attention_mask with rows of 5..16 tokens (one
    on each rank's half), their positions in the valid prefix."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = {"input_ids": rng.integers(0, VOCAB, (GLOBAL, SEQ)).astype(np.int32),
             "masked_positions": np.sort(np.stack([rng.choice(SEQ, K, replace=False)
                                                   for _ in range(GLOBAL)]), 1).astype(np.int32),
             "masked_labels": rng.integers(0, VOCAB, (GLOBAL, K)).astype(np.int32)}
        if i in padded:
            lens = np.full(GLOBAL, SEQ)
            lens[[1, 6]] = [5, 11]
            b["attention_mask"] = (np.arange(SEQ)[None] < lens[:, None]).astype(np.int32)
            b["masked_positions"] = np.sort(np.stack(
                [rng.choice(n_, K, replace=False) for n_ in lens]), 1).astype(np.int32)
        out.append(b)
    return out


# -- metrics ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["full", "no_top5", "empty"])
def test_derive_metrics_matches_jax(case):
    totals = {"loss_sum": np.float64(123.25), "correct": np.float64(17.0),
              "top5_correct": np.float64(40.0), "count": np.float64(64.0),
              "extra": np.float64(3.5)}
    if case == "no_top5":
        del totals["top5_correct"]
    if case == "empty":
        totals = {"count": np.float64(0.0), "correct": np.float64(0.0)}
    got = teval.derive_metrics(totals)
    assert got == jeval.derive_metrics(totals)
    assert ("loss" in got) == (case != "empty")
    assert ("top5_accuracy" in got) == (case == "full")
    if case != "empty":
        assert got["loss"] == 123.25 / 64 and got["accuracy"] == 17 / 64


@pytest.mark.parametrize("impl", ["standard", "fused"])
def test_classification_eval_fn_matches_jax(impl):
    kw = dict(stage_sizes=(1, 1), width=4, num_classes=10, dtype="float32", block_impl=impl)
    jcfg, tcfg = jresnet.ResNetConfig(**kw), tresnet.ResNetConfig(**kw)
    v = jresnet.ResNet(jresnet.ResNetConfig(**{**kw, "block_impl": "standard"})).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), train=False)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
                          .astype(np.float32), v["params"])
    stats = jax.tree.map(lambda s: np.asarray(s) + 0.2 * rng.random(s.shape).astype(np.float32),
                         v["batch_stats"])
    batch = {"image": rng.standard_normal((6, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 10, 6).astype(np.int32)}
    want = jax.jit(jcommon.classification_eval_fn(jresnet.ResNet(jcfg)))(
        params, {"batch_stats": stats}, batch)
    model = resnet_from_jax(params, stats, tcfg, device="cpu")
    before = [b.clone() for b in model.buffers()]
    got = tcommon.classification_eval_fn(model)({k: torch.from_numpy(x)
                                                 for k, x in batch.items()})
    assert sorted(got) == sorted(want) == ["correct", "count", "loss_sum", "top5_correct"]
    for k in ("correct", "top5_correct", "count"):
        assert float(got[k]) == float(want[k]), k
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(before, model.buffers()))


# -- the evaluator, one process --------------------------------------------------


def test_one_process_evaluator_is_the_serial_sum_and_is_instrumented():
    jcfg = _jcfg()
    model = from_jax_params(H.params_np(jcfg, seed=1), H.port_cfg(jcfg), device="cpu",
                            trainable=True)
    eval_fn = ttfm.mlm_eval_fn(model)
    batches = _mlm_batches(3, seed=1, padded=(1,))
    reg, rec = Registry(), flightrec.FlightRecorder()
    state = tstep.TrainState(step=5, model=model, optimizer=None, generator=None)
    assert model.training
    totals = teval.ShardedEvaluator(eval_fn, None, registry=reg, flightrec=rec).run(
        state, iter(batches), 2, step=5)
    assert model.training  # the train mode is restored
    serial: dict = {}
    for b in batches[:2]:
        for k, v in eval_fn({k: torch.from_numpy(x) for k, x in b.items()}).items():
            serial[k] = serial.get(k, 0.0) + np.asarray(v.numpy(), np.float64)
    assert sorted(totals) == sorted(serial)
    for k in serial:
        assert totals[k].tobytes() == serial[k].tobytes(), k
    assert totals["count"] == 2 * GLOBAL * K
    assert reg.counter(teval.EVAL_STEPS).value == 2
    kinds = [(e["kind"], e.get("step")) for e in rec.events()]
    assert kinds == [("eval_start", 5), ("eval_end", 5)]
    assert rec.events()[1]["batches"] == 2


# -- two processes over gloo ---------------------------------------------------


def _jax_dp2_steps(params, batches, devices):
    mesh = jbuild_mesh(JMeshSpec(data=2), devices[:2])
    jcfg = _jcfg()
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**OPTIMIZER))
    loss_fn = jtfm.mlm_loss_fn(jtfm.Transformer(jcfg, mesh))
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


@pytest.fixture(scope="module")
def dp(tmp_path_factory, devices):
    """The dp2 job (started first: it runs while JAX compiles) and JAX's
    data=2 steps on the same weights and global batches."""
    out = str(tmp_path_factory.mktemp("dp_bert"))
    jcfg = _jcfg()
    params = H.params_np(jcfg, seed=2)
    sd = {k: v.numpy() for k, v in _state_dict_from_jax(params, H.port_cfg(jcfg)).items()}
    train, evals = _mlm_batches(2, seed=3, padded=(1,)), _mlm_batches(3, seed=4, padded=(2,))
    inputs = os.path.join(out, "inputs.npz")
    np.savez(inputs, **{f"sd/{k}": v for k, v in sd.items()},
             **{f"train{i}/{k}": v for i, b in enumerate(train) for k, v in b.items()},
             **{f"eval{i}/{k}": v for i, b in enumerate(evals) for k, v in b.items()})
    cfg = {k: v for k, v in vars(H.port_cfg(jcfg)).items()}
    procs = worker.launch({"job": "bert", "device": "cpu", "out": out, "inputs": inputs,
                           "cfg": cfg, "optimizer": OPTIMIZER, "dropout": DROPOUT})
    try:
        jax_run = _jax_dp2_steps(params, train, devices)
        one = worker.bert_steps(ttfm.TransformerConfig(**{**cfg, "dropout": DROPOUT}), sd,
                                train, OPTIMIZER, torch.device("cpu"))
    except BaseException:
        worker.stop(procs)
        raise
    return {"ranks": worker.wait(procs, out, timeout=240), "jax": jax_run, "init": sd,
            "one_process_dropout": one}


def test_dp2_bert_step_matches_the_jax_data2_mesh_step(dp):
    jlosses, jsd = dp["jax"]
    r0, r1 = dp["ranks"]
    np.testing.assert_allclose(r0["losses"], jlosses, **TOL)
    moved = 0.0
    for name, want in jsd.items():
        got = r0[f"state/{name}"]
        np.testing.assert_array_equal(got, r1[f"state/{name}"], err_msg=name)
        if name.endswith("attn.key.bias"):
            # its exact gradient is 0 (a constant shift of every logit of a
            # row), so each side moves it by Adam-normalised roundoff, at
            # most lr an update
            for side in (got, want):
                assert float(np.abs(side - dp["init"][name]).max()) <= 2.01e-3
            continue
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
        moved = max(moved, float(np.abs(want - dp["init"][name]).max()))
    assert moved > 1e-3


def test_dp2_dropout_masks_are_the_rows_of_one_global_draw(dp):
    """At dropout 0.1 each rank's masks are its rows of the global batch's
    draw: the two ranks' steps equal one process stepping on the global
    batches (same seed), and dropout did change the steps."""
    one = dp["one_process_dropout"]
    r0, r1 = dp["ranks"]
    np.testing.assert_allclose(r0["dropout/losses"], one["losses"], **TOL)
    assert not np.allclose(r0["dropout/losses"], r0["losses"], rtol=1e-3, atol=0)
    for name, want in one["state"].items():
        np.testing.assert_array_equal(r0[f"dropout/state/{name}"],
                                      r1[f"dropout/state/{name}"], err_msg=name)
        if name.endswith("attn.key.bias"):  # roundoff-driven (see the test above)
            continue
        np.testing.assert_allclose(r0[f"dropout/state/{name}"], want, **TOL, err_msg=name)


def test_sharded_evaluator_over_two_ranks_is_bitwise_the_serial_one(dp):
    for rank in dp["ranks"]:
        sharded = {k[len("eval/sharded/"):]: v for k, v in rank.items()
                   if k.startswith("eval/sharded/")}
        serial = {k[len("eval/serial/"):]: v for k, v in rank.items()
                  if k.startswith("eval/serial/")}
        assert sorted(sharded) == sorted(serial) == ["correct", "count", "loss_sum"]
        for k in serial:
            assert sharded[k].dtype == np.float64
            assert sharded[k].tobytes() == serial[k].tobytes(), k
        assert float(sharded["count"]) == 3 * GLOBAL * K
    np.testing.assert_array_equal(dp["ranks"][0]["eval/sharded/loss_sum"],
                                  dp["ranks"][1]["eval/sharded/loss_sum"])


# -- the runner ------------------------------------------------------------------


def test_an_eval_pause_stays_out_of_the_step_rate(monkeypatch):
    """A 100 s eval between steps 2 and 3 (a fake clock): the steps/s of
    the interval that holds it is the train loop's, 1 step/s."""
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    logger = tcb.MetricsLogger(every_n=1, batch_size=4, clock=clock, history=True,
                               registry=Registry())

    def fake_evaluate(evaluator, state, parts, n):
        t[0] += 100.0
        return {}

    monkeypatch.setattr(runner, "evaluate", fake_evaluate)
    cfg = runner.RunConfig(train=runner.TrainSection(eval_every=2))
    ev = runner._EvalCallback(cfg, parts=None, evaluator=None, clock=clock)

    class Trainer:
        callbacks = [logger, ev]
        state = None

    logger.on_train_start(Trainer)
    for step in range(1, 5):
        t[0] += 1.0
        for c in Trainer.callbacks:
            c.on_step_end(Trainer, step, {"loss": torch.tensor(1.0)})
    rates = [row["steps_per_sec"] for row in logger.history[1:]]
    assert rates == [1.0, 1.0, 1.0]


def test_gpt_lm_evaluates_mid_train_and_at_the_end():
    from test_torch_train_workload import TINY

    before = default_registry().counter(teval.EVAL_STEPS).value
    res = run_workload("gpt_lm", TINY + ["--train.num_steps=4", "--train.eval_every=2",
                                         "--train.eval_batches=2"], device="cpu")
    assert default_registry().counter(teval.EVAL_STEPS).value - before == 3 * 2
    m = res.eval_metrics
    assert m["count"] == 2 * 4 * 31 and np.isfinite(m["loss"]) and 0 <= m["accuracy"] <= 1


def test_resnet50_imagenet_returns_eval_metrics():
    from test_torch_train_workload import RESNET_TINY

    res = run_workload("resnet50_imagenet", RESNET_TINY + [
        "--train.num_steps=2", "--train.eval_batches=2"], device="cpu")
    m = res.eval_metrics
    assert m["count"] == 16 and 0 <= m["accuracy"] <= m["top5_accuracy"] <= 1
    assert np.isfinite(m["loss"])


def test_evaluate_from_checkpoint_is_refused_naming_the_roadmap_item():
    from distributed_tensorflow_tpu_torch.workloads import bert_pretrain

    with pytest.raises(NotImplementedError, match="item 2.3"):
        runner.evaluate_from_checkpoint(bert_pretrain.default_config(), bert_pretrain.build)
