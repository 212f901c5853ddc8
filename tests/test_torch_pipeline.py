"""Pipeline parallelism in the port (``parallel/pipeline.py``, the
``pipe`` axis, ``models/transformer.PipelinedTransformer``), against the
JAX package's ``parallel/pipeline.py`` and pipelined family on its fake
CPU devices, with JAX's own gates (``tests/test_pipeline.py``).

From one launch of four gloo ranks (``tests/torch_dp_worker.py``'s
``pipe`` job, one thread a rank):

- ``pipeline_apply`` of a toy stage at pipe=4 and at data=2 x pipe=2 with
  two virtual chunks: outputs within atol 1e-6 of JAX's, the gradients
  of ``sum(out ** 2)`` within 1e-5;
- the pipelined decoder at pipe=4 and at data=2 x pipe=2 (V=2), the
  pipelined BERT at pipe=2 x model=2 (a padded mask, the gathered MLM
  head): logits within atol 2e-4 of JAX's ``pipelined_apply`` on the
  same mesh, every parameter's gradient of the mean squared logits within
  5e-4 of ``jax.grad``'s;
- three clipped adamw steps at data=2 x pipe=2 against JAX's dense data=2
  steps (losses and global norms rtol 2e-4; each parameter's three-step
  update within relative L2 1e-2, the key bias left out as in
  ``tests/test_torch_tensor_parallel.py``), the evaluator's totals
  counting each pipe rank once, the step dir restored bitwise at the
  mesh, at pipe=4 and in one process;
- dropout 0.1 at pipe=2 with one and two virtual chunks: the same losses
  (the masks are the schedule's independent of it), and not those of
  dropout 0; a ``grad_accum_steps=2`` step equal to one process's plain
  step; ``run_workload("gpt_lm")`` at data=2 x pipe=2 against one process
  fed the data shards' rows; the replicated ends bitwise alike on every
  rank after every step.

In this process: ``microbatch``, the tick algebra, the pipe=1 path,
``to/from_pipeline_params``, ``pipeline_param_specs``, the guards, the
``TrainSection`` fields and ``weights.pipelined_from_jax``.
"""

import dataclasses
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
from distributed_tensorflow_tpu.parallel import pipeline as jpl
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu.train import step as jstep
from distributed_tensorflow_tpu.workloads import runner as jrunner
from distributed_tensorflow_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import pipeline as tpl
from distributed_tensorflow_tpu_torch.train import checkpoint as tck
from distributed_tensorflow_tpu_torch.train import optimizers as topt
from distributed_tensorflow_tpu_torch.train import step as tstep
from distributed_tensorflow_tpu_torch.weights import _state_dict_from_jax, pipelined_from_jax
from distributed_tensorflow_tpu_torch.workloads import gpt_lm as tgpt
from distributed_tensorflow_tpu_torch.workloads import runner as trunner

sys.path.insert(0, os.path.dirname(__file__))
import torch_dp_worker as worker  # noqa: E402

SEQ, GLOBAL, VOCAB, K = 16, 8, 64, 4
SIZES = dict(vocab_size=VOCAB, max_len=SEQ, num_layers=4, d_model=32, num_heads=4, d_ff=64)
GPT = dict(causal=True, pre_ln=True)
BERT = dict(causal=False, pre_ln=False)
APPLY_TOL, APPLY_GRAD_TOL = dict(atol=1e-6, rtol=0), dict(atol=1e-5, rtol=0)
LOGIT_TOL, GRAD_TOL = dict(atol=2e-4, rtol=0), dict(atol=5e-4, rtol=0)
LOSS_TOL = dict(rtol=2e-4, atol=0.0)
UPDATE_TOL = 1e-2
CLIP = 0.5
D = 8
#: toy pipeline_apply: tag -> (mesh, virtual chunks, microbatches)
APPLY = {"toy_p4": (dict(pipe=4, data=1), 1, 4), "toy_d2p2v2": (dict(pipe=2, data=2), 2, 4)}
#: the pipelined transformer's forward: tag -> (family, mesh, virtual, microbatches)
FORWARD = {"gpt_p4": (GPT, dict(pipe=4, data=1), 1, 4),
           "gpt_d2p2v2": (GPT, dict(pipe=2, data=2), 2, 4),
           "bert_p2m2": (BERT, dict(pipe=2, data=1, model=2), 1, 4)}
D2P2 = dict(pipe=2, data=2)
ADAMW = dict(name="adamw", learning_rate=3e-3, weight_decay=0.01)
RUNNER = ["--model.num_layers=2", "--model.d_model=32", "--model.num_heads=4",
          "--model.d_ff=64", "--model.vocab_size=64", "--data.vocab_size=64",
          "--model.max_len=16", "--data.seq_len=16", "--model.dtype=float32",
          "--data.global_batch_size=8", "--train.num_steps=3", "--train.eval_batches=0",
          "--train.log_every=1", "--optimizer.warmup_steps=0",
          "--optimizer.learning_rate=3e-3", "--model.xent_chunk=16", "--model.dropout=0.0"]


def _jcfg(family, **kw):
    return H.jax_cfg(**SIZES, **family, **kw)


def _tcfg(family, **kw):
    return H.port_cfg(_jcfg(family, **kw))


def _toy(seed, S, V, M):
    """The toy stage's chunks laid ``[S, (V,) ...]`` (chunk v·S + d at
    [d, v]) and microbatches ``[M, 4, D]``."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((S * V, D, D)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((S * V, D)) * 0.1).astype(np.float32)
    lay = (lambda a: a) if V == 1 else (lambda a: a.reshape(V, S, *a.shape[1:]).swapaxes(0, 1))
    x = rng.standard_normal((M, 4, D)).astype(np.float32)
    return {"w": np.ascontiguousarray(lay(w)), "b": np.ascontiguousarray(lay(b)), "x": x}


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_apply(arrays, mesh_kw, V, devices):
    n = int(np.prod(list(mesh_kw.values())))
    mesh = jbuild_mesh(JMeshSpec(**mesh_kw), devices[:n])
    params = {k: jnp.asarray(arrays[k]) for k in "wb"}
    x = jnp.asarray(arrays["x"])

    def loss(p):
        y = jpl.pipeline_apply(_jstage, p, x, mesh, n_virtual=V)
        return (y ** 2).sum(), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return {"out": np.asarray(y), "dw": np.asarray(g["w"]), "db": np.asarray(g["b"])}


def _batch(rng, mlm):
    ids = rng.integers(0, VOCAB, (GLOBAL, SEQ)).astype(np.int32)
    if not mlm:
        return {"input_ids": ids}
    lengths = rng.integers(SEQ // 2, SEQ + 1, GLOBAL)
    mask = (np.arange(SEQ)[None] < lengths[:, None]).astype(np.int32)
    pos = np.stack([np.sort(rng.choice(n_, K, replace=False)) for n_ in lengths])
    return {"input_ids": ids, "attention_mask": mask, "masked_positions": pos.astype(np.int32),
            "masked_labels": np.take_along_axis(ids, pos, 1).astype(np.int32)}


def _jax_forward(tag, params, batch, devices):
    """JAX's ``pipelined_apply`` on the case's mesh: the logits and the
    gradients of their mean square as a port state dict."""
    family, mesh_kw, V, M = FORWARD[tag]
    jcfg = _jcfg(family)
    n = int(np.prod(list(mesh_kw.values())))
    mesh = jbuild_mesh(JMeshSpec(**mesh_kw), devices[:n])
    S = mesh_kw["pipe"]
    pp = jtfm.to_pipeline_params(jax.tree.map(jnp.asarray, params), jcfg, S, V)
    mask = jnp.asarray(batch["attention_mask"]) if "attention_mask" in batch else None
    pos = jnp.asarray(batch["masked_positions"]) if "masked_positions" in batch else None
    ids = jnp.asarray(batch["input_ids"])

    def loss(p):
        lg = jtfm.pipelined_apply(p, ids, mask, jcfg, mesh, M, V, positions=pos)
        return (lg ** 2).mean(), lg

    (_, lg), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(pp)
    dense = jtfm.from_pipeline_params(jax.tree.map(np.asarray, g), jcfg, n_virtual=V)
    sd = _state_dict_from_jax(dense, _tcfg(family))
    return {"logits": np.asarray(lg), "grads": {k: v.numpy() for k, v in sd.items()}}


def _jax_dense_data2(params, train, devices):
    """JAX's dense decoder stepped at data=2 with adamw and a clip that
    binds: losses, global norms and the final parameters (port names)."""
    mesh = jbuild_mesh(JMeshSpec(data=2), devices[:2])
    jcfg = _jcfg(GPT)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**ADAMW))
    loss_fn = jtfm.lm_loss_fn(jtfm.Transformer(jcfg, mesh))
    p = jax.tree.map(jnp.asarray, params)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tx.init(p),
                             model_state={}, rng=jax.random.PRNGKey(0))
    specs = jstep.state_specs(jax.eval_shape(lambda: state), jsh.replicated_specs(p))
    state = jax.device_put(state, jsh.tree_shardings(mesh, specs))
    step = jstep.jit_train_step(jstep.make_train_step(
        loss_fn, tx, jstep.StepOptions(clip_grad_norm=CLIP, compute_grad_norm=True)),
        mesh, specs)
    losses, norms = [], []
    for b in train:
        b = {k: jax.device_put(v, NamedSharding(mesh, jsh.batch_spec(v.ndim)))
             for k, v in b.items()}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    sd = _state_dict_from_jax(jax.tree.map(np.asarray, state.params), _tcfg(GPT))
    return {"losses": np.asarray(losses), "grad_norms": np.asarray(norms),
            "state": {k: v.numpy() for k, v in sd.items()}}


def _runner_one_process():
    """What the four ranks' ``run_workload("gpt_lm", RUNNER + data=2 x
    pipe=2)`` computes in one process: the same seed's dense model stepped
    on each global batch the two data shards' streams make."""
    from distributed_tensorflow_tpu_torch.data import text
    from distributed_tensorflow_tpu_torch.train import init_train_state, make_optimizer
    from distributed_tensorflow_tpu_torch.train import make_train_step
    from distributed_tensorflow_tpu_torch.utils import config as tconfig

    cfg = tconfig.apply_overrides(tgpt.default_config(), RUNNER + ["--mesh.data=1"])
    parts = tgpt.build(cfg, torch.device("cpu"))
    state = init_train_state(parts.model, make_optimizer(cfg.optimizer,
                                                         parts.model.parameters()),
                             seed=cfg.train.seed)
    step = make_train_step(parts.loss_fn)
    losses = []
    for i in range(cfg.train.num_steps):
        shards = [text.make_text_dataset(cfg.data, shard=(r, 2)).batch(i) for r in range(2)]
        b = {k: torch.from_numpy(np.concatenate([s[k] for s in shards])) for k in shards[0]}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return {"losses": np.asarray(losses), "state": {
        k: v.detach().float().numpy() for k, v in state.model.state_dict().items()}}


def _steps_case(tag, mesh, *, V=1, M=4, optimizer=ADAMW, options=None, dropout=0.0,
                save=False, restore=None):
    return dict(tag=tag, sd="sd", cfg=dataclasses.asdict(_tcfg(GPT, dropout=dropout)),
                mesh=mesh, optimizer=optimizer, options=options or {}, mlm=False,
                save=save, pipeline=dict(virtual=V, microbatches=M),
                **({"restore": restore} if restore else {}))


@pytest.fixture(scope="module")
def pp(tmp_path_factory, devices):
    """The four-rank job (started first: it runs while JAX compiles), JAX's
    references and the one-process ones."""
    out = str(tmp_path_factory.mktemp("pipe"))
    arrays, toys, fwd = {}, {}, {}
    for i, (tag, (mesh_kw, V, M)) in enumerate(APPLY.items()):
        toys[tag] = _toy(80 + i, mesh_kw["pipe"], V, M)
        arrays.update({f"{tag}/{k}": v for k, v in toys[tag].items()})
    for i, (tag, (family, _, _, _)) in enumerate(FORWARD.items()):
        params = H.params_np(_jcfg(family), seed=90 + i)
        batch = _batch(np.random.default_rng(95 + i), family is BERT)
        fwd[tag] = (params, batch)
        sd = _state_dict_from_jax(params, _tcfg(family))
        arrays.update({f"sd_{tag}/{k}": v.numpy() for k, v in sd.items()})
        arrays[f"{tag}/ids"] = batch["input_ids"]
        if family is BERT:
            arrays[f"{tag}/mask"] = batch["attention_mask"]
            arrays[f"{tag}/positions"] = batch["masked_positions"]
    params = H.params_np(_jcfg(GPT), seed=100)
    sd = {k: v.numpy() for k, v in _state_dict_from_jax(params, _tcfg(GPT)).items()}
    arrays.update({f"sd/{k}": v for k, v in sd.items()})
    rng = np.random.default_rng(101)
    train = [_batch(rng, False) for _ in range(3)]
    evals = [_batch(rng, False)]
    cases = [
        _steps_case("steps", D2P2, options=dict(clip_grad_norm=CLIP, compute_grad_norm=True),
                    save=True),
        _steps_case("restore_p4", dict(pipe=4, data=1), restore="ck_steps"),
        _steps_case("drop_v1", D2P2, dropout=0.1),
        _steps_case("drop_v2", D2P2, V=2, dropout=0.1),
        _steps_case("accum", D2P2, M=2, optimizer=dict(name="sgd", learning_rate=0.1),
                    options=dict(grad_accum_steps=2)),
    ]
    data = {"steps": (train, evals), "drop_v1": (train[:2], []), "drop_v2": (train[:2], []),
            "accum": (train[:1], [])}
    for tag, (tr, ev) in data.items():
        for prefix, bs in (("train", tr), ("eval", ev)):
            arrays.update({f"{tag}/{prefix}{j}/{k}": v for j, b in enumerate(bs)
                           for k, v in b.items()})
    inputs = os.path.join(out, "inputs.npz")
    np.savez(inputs, **arrays)
    procs = worker.launch({
        "job": "pipe", "device": "cpu", "out": out, "inputs": inputs,
        "apply": [dict(tag=t, mesh=m, virtual=V) for t, (m, V, _) in APPLY.items()],
        "forward": [dict(tag=t, mesh=m, virtual=V, microbatches=M,
                         cfg=dataclasses.asdict(_tcfg(f)))
                    for t, (f, m, V, M) in FORWARD.items()],
        "cases": cases,
        "runner": {"gpt_lm": RUNNER + ["--mesh.data=2", "--mesh.pipe=2"]}}, world=4)
    try:
        jax_apply = {t: _jax_apply(toys[t], m, V, devices) for t, (m, V, _) in APPLY.items()}
        jax_fwd = {t: _jax_forward(t, *fwd[t], devices) for t in FORWARD}
        dense = _jax_dense_data2(params, train, devices)
        accum_case = dict(cases[-1], pipeline=None, options={})
        one_accum = worker.tp_steps(accum_case, sd, train[:1], [], torch.device("cpu"))
        one_accum.pop("model")
        runner = _runner_one_process()
    except BaseException:
        worker.stop(procs)
        raise
    return {"ranks": worker.wait(procs, out, timeout=600), "toys": toys, "fwd": fwd,
            "jax_apply": jax_apply, "jax_fwd": jax_fwd, "dense": dense, "sd": sd,
            "one_accum": one_accum, "runner": runner, "out": out}


def _index(r, mesh_kw):
    sizes = [mesh_kw.get(a, 1) for a in tmesh.AXIS_NAMES]
    return dict(zip(tmesh.AXIS_NAMES, np.unravel_index(r, sizes)))


def _rows(r, mesh_kw, n):
    """Rank r's rows of a global batch of n (its data shard's)."""
    i, nb = _index(r, mesh_kw)["data"], mesh_kw.get("data", 1)
    return slice(i * n // nb, (i + 1) * n // nb)


def _prefixed(rank, head):
    return {k[len(head):]: v for k, v in rank.items() if k.startswith(head)}


# -- the four ranks -------------------------------------------------------------


@pytest.mark.parametrize("tag", list(APPLY))
def test_pipeline_apply_matches_jax(pp, tag):
    mesh_kw = APPLY[tag][0]
    want = pp["jax_apply"][tag]
    for r, rank in enumerate(pp["ranks"]):
        np.testing.assert_allclose(rank[f"{tag}/out"], want["out"][:, _rows(r, mesh_kw, 4)],
                                   **APPLY_TOL, err_msg=f"rank {r}")
        for n in ("dw", "db"):
            np.testing.assert_allclose(rank[f"{tag}/{n}"], want[n], **APPLY_GRAD_TOL,
                                       err_msg=f"{n} rank {r}")


@pytest.mark.parametrize("tag", list(FORWARD))
def test_pipelined_transformer_matches_jax(pp, tag):
    """Logits of each rank's rows (the same on every pipe and model rank),
    and each parameter's gradient from the rank that holds it: its own
    stage's Blocks and the replicated ends."""
    mesh_kw = FORWARD[tag][1]
    want = pp["jax_fwd"][tag]
    seen = set()
    for r, rank in enumerate(pp["ranks"]):
        np.testing.assert_allclose(rank[f"{tag}/logits"],
                                   want["logits"][_rows(r, mesh_kw, GLOBAL)], **LOGIT_TOL,
                                   err_msg=f"rank {r}")
        for name, g in _prefixed(rank, f"{tag}/grad/").items():
            np.testing.assert_allclose(g, want["grads"][name], **GRAD_TOL,
                                       err_msg=f"{name} rank {r}")
            seen.add(name)
    assert seen == set(want["grads"])


def _updates_close(got: dict, want: dict, init: dict) -> None:
    moved = 0.0
    for k, w in want.items():
        if k.endswith("attn.key.bias"):  # its exact gradient is 0 (module docstring)
            continue
        du, dw = got[k] - init[k], w - init[k]
        err = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
        assert err <= UPDATE_TOL, (k, err)
        moved = max(moved, float(np.abs(dw).max()))
    assert moved > 1e-3


def test_clipped_adamw_steps_at_data2_pipe2_match_jax_dense_data2(pp):
    """The global norm sums the stages' squares over pipe and counts the
    ends once: the clip that binds scales every rank's gradients alike."""
    want = pp["dense"]
    assert (want["grad_norms"] > CLIP).all()  # the clip binds
    for rank in pp["ranks"]:
        np.testing.assert_allclose(rank["steps/losses"], want["losses"], **LOSS_TOL)
        np.testing.assert_allclose(rank["steps/grad_norms"], want["grad_norms"], **LOSS_TOL)
        _updates_close(_prefixed(rank, "steps/whole/model/"), want["state"], pp["sd"])


def test_evaluator_counts_each_pipe_rank_once(pp):
    for rank in pp["ranks"]:
        assert float(rank["steps/eval/count"]) == GLOBAL * (SEQ - 1)
        np.testing.assert_array_equal(rank["steps/eval/loss_sum"],
                                      pp["ranks"][0]["steps/eval/loss_sum"])


def test_save_restores_bitwise_at_the_mesh_at_pipe4_and_in_one_process(pp):
    """The chief writes the dense layout: a fresh pipe=4 state and a dense
    one-process state restore it bitwise the ranks' gathered leaves."""
    saved = _prefixed(pp["ranks"][0], "steps/whole/")
    for rank in pp["ranks"]:
        assert bool(rank["steps/restored_equal"])
        got = _prefixed(rank, "restore_p4/whole/")
        assert sorted(got) == sorted(saved)
        for k, v in saved.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    cfg = _tcfg(GPT)
    model = ttfm.build(cfg, {k: torch.as_tensor(v) for k, v in pp["sd"].items()}, "cpu",
                       trainable=True)
    state = tstep.init_train_state(model, topt.make_optimizer(topt.OptimizerConfig(**ADAMW),
                                                              model.parameters()))
    ck = tck.Checkpointer(tck.CheckpointConfig(directory=os.path.join(pp["out"], "ck_steps"),
                                               async_save=False))
    try:
        ck.restore(state)
    finally:
        ck.close()
    mine = {k: v.detach().float().numpy() for k, v in tstep.state_leaves(state)}
    assert sorted(mine) == sorted(saved) and state.step == 3
    for k, v in saved.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


def test_dropout_is_independent_of_the_schedule(pp):
    """pipe=2 with one chunk a stage and with two (the interleaved
    schedule) draw the same masks: the same losses, unlike dropout 0's."""
    for rank in pp["ranks"]:
        np.testing.assert_allclose(rank["drop_v2/losses"], rank["drop_v1/losses"], **LOSS_TOL)
        assert abs(float(rank["drop_v1/losses"][0]) - float(rank["steps/losses"][0])) > 1e-3


def test_grad_accum_composes_with_the_pipeline(pp):
    """grad_accum_steps=2, each accumulated microbatch through the whole
    pipeline, equals one process's plain step (every causal row has the
    same valid-token count, so the mean of means is the mean)."""
    want = pp["one_accum"]
    for rank in pp["ranks"]:
        np.testing.assert_allclose(rank["accum/losses"], want["losses"], atol=1e-5, rtol=0)
        got = _prefixed(rank, "accum/whole/model/")
        for k, w in _prefixed(want, "whole/model/").items():
            np.testing.assert_allclose(got[k], w, atol=2e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("tag", ["steps", "drop_v1", "drop_v2", "accum"])
def test_replicated_ends_stay_bitwise_equal_across_all_ranks(pp, tag):
    for rank in pp["ranks"]:
        assert (rank[f"{tag}/drift"] == 0).all(), rank[f"{tag}/drift"]
        for k, v in _prefixed(rank, f"{tag}/whole/").items():
            np.testing.assert_array_equal(v, _prefixed(pp["ranks"][0], f"{tag}/whole/")[k],
                                          err_msg=k)


def test_runner_at_data2_pipe2_matches_one_process(pp):
    """``run_workload("gpt_lm")`` at data=2 x pipe=2: the pipe ranks of a
    data shard read its rows, and the steps equal one process on the
    global batches (``xent_chunk`` is not applied on the pipelined path:
    the same function; dropout 0, whose masks the pipeline draws by its
    own keys)."""
    want = pp["runner"]
    for rank in pp["ranks"]:
        assert rank["runner/gpt_lm/mesh"].tolist() == [2, 1, 1]
        assert int(rank["runner/gpt_lm/pipe"]) == 2
        np.testing.assert_allclose(rank["runner/gpt_lm/losses"], want["losses"], **LOSS_TOL)
    got = _prefixed(pp["ranks"][0], "runner/gpt_lm/whole/model/")
    assert sorted(got) == sorted(want["state"])
    for k, w in want["state"].items():
        np.testing.assert_allclose(got[k], w, rtol=2e-4, atol=2e-5, err_msg=k)


# -- one process ----------------------------------------------------------------


def _cpu_mesh(**kw):
    return tmesh.Mesh(dict(tmesh.MeshSpec(**dict(dict(data=1), **kw)).sizes()),
                      torch.device("cpu"))


def test_microbatch_is_bitwise_jax_strided_split():
    x = np.arange(24.0 * 3, dtype=np.float32).reshape(24, 3)
    for M in (1, 2, 4, 6):
        got = tpl.microbatch(torch.from_numpy(x), M)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jpl.microbatch(jnp.asarray(x), M)))
        np.testing.assert_array_equal(tpl.unmicrobatch(got).numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        tpl.microbatch(torch.from_numpy(x), 5)


@pytest.mark.parametrize("S,V,M", [(2, 1, 2), (2, 1, 5), (4, 1, 8), (2, 2, 4), (4, 2, 8),
                                   (3, 3, 6)])
def test_schedule_is_jax_tick_algebra(S, V, M):
    """``schedule`` against ``_pipeline_body``'s algebra in jnp, and the
    property it rests on: microbatch m meets chunk c at tick m·… + c on
    the rank that owns c, each (m, c) exactly once."""
    t = jnp.arange(M * V + S - 1)[:, None]
    d = jnp.arange(S)[None, :]
    lam = t - d
    g, r = jnp.divmod(jnp.maximum(lam, 0), S * V)
    v, j = jnp.divmod(r, S)
    m = jnp.clip(g * S + j, 0, M - 1)
    active = (lam >= 0) & (lam < M * V)
    want = [(int(tt), int(dd), int(vv), int(mm), bool(aa)) for tt, dd, vv, mm, aa in zip(
        *(np.broadcast_to(np.asarray(a), (M * V + S - 1, S)).ravel()
          for a in (t, d, v, m, active)))]
    got = tpl.schedule(S, V, M)
    assert got == want
    runs = {}
    for tt, dd, vv, mm, aa in got:
        if aa:
            assert (mm, vv * S + dd) not in runs
            runs[(mm, vv * S + dd)] = tt
    assert len(runs) == M * S * V
    for (mm, c), tt in runs.items():  # chunk c+1 runs m the tick after chunk c
        if c + 1 < S * V:
            assert runs[(mm, c + 1)] == tt + 1


@pytest.mark.parametrize("V", [1, 2])
def test_pipe1_runs_the_chunks_in_order_as_jax(devices, V):
    """At pipe=1 (JAX's degenerate path) every chunk runs in order on each
    microbatch: the output and the gradients as JAX's."""
    arrays = _toy(7, 2, V, 4)  # two rows, run in order as chunks s·V + v
    rows = [{k: arrays[k][s] for k in "wb"} for s in range(2)]
    stacked = tpl.stack_stages([{k: torch.from_numpy(v) for k, v in r.items()} for r in rows])
    for k, v in jpl.stack_stages([{k: jnp.asarray(v) for k, v in r.items()}
                                  for r in rows]).items():
        np.testing.assert_array_equal(stacked[k].numpy(), np.asarray(v))
    mesh = jbuild_mesh(JMeshSpec(data=1), devices[:1])
    params = {k: jnp.asarray(arrays[k]) for k in "wb"}
    x = jnp.asarray(arrays["x"])

    def loss(p):
        y = jpl.pipeline_apply(_jstage, p, x, mesh, n_virtual=V)
        return (y ** 2).sum(), y

    (_, want), g = jax.value_and_grad(loss, has_aux=True)(params)
    w, b = (torch.from_numpy(arrays[k]).requires_grad_() for k in "wb")
    got = tpl.pipeline_apply(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), {"w": w, "b": b},
                             torch.from_numpy(arrays["x"]), None, n_virtual=V)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **APPLY_TOL)
    dw, db = torch.autograd.grad((got ** 2).sum(), [w, b])
    np.testing.assert_allclose(dw.numpy(), np.asarray(g["w"]), **APPLY_GRAD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(g["b"]), **APPLY_GRAD_TOL)


@pytest.mark.parametrize("S,V", [(2, 1), (4, 1), (2, 2)])
def test_pipeline_params_round_trip_in_jax_layer_order(S, V):
    jcfg = _jcfg(GPT)
    params = H.params_np(jcfg, seed=3)
    sd = _state_dict_from_jax(params, _tcfg(GPT))
    got = ttfm.to_pipeline_params(sd, _tcfg(GPT), S, V)
    want = jtfm.to_pipeline_params(jax.tree.map(jnp.asarray, params), jcfg, S, V)
    k = 2 if V == 1 else 3
    # the stacking dims hold the same layers: each [s, (v,) i] is JAX's
    wq = np.asarray(want["blocks"]["attn"]["query"]["kernel"])
    gq = got["blocks"]["attn.query.weight"].numpy()
    assert gq.shape[:k] == wq.shape[:k]
    np.testing.assert_array_equal(gq, np.swapaxes(wq, -1, -2))
    np.testing.assert_array_equal(got["blocks"]["ln2.bias"].numpy(),
                                  np.asarray(want["blocks"]["ln2"]["bias"]))
    assert sorted(got["ends"]) == sorted(k_ for k_ in sd if not k_.startswith("layers."))
    back = ttfm.from_pipeline_params(got, _tcfg(GPT), V)
    assert sorted(back) == sorted(sd)
    for name, v in sd.items():
        assert torch.equal(back[name], v), name


@pytest.mark.parametrize("tp", [False, True])
@pytest.mark.parametrize("V", [1, 2])
def test_pipeline_param_specs_match_jax(tp, V):
    """The port's specs are JAX's with a Dense weight's last two entries
    swapped (``[out, in]``); ``check_spec`` admits them all."""
    jcfg, cfg = _jcfg(GPT), _tcfg(GPT)
    params = H.params_np(jcfg, seed=4)
    pp = ttfm.to_pipeline_params(_state_dict_from_jax(params, cfg), cfg, 2, V)
    want = jtfm.pipeline_param_specs(
        jtfm.to_pipeline_params(jax.tree.map(jnp.asarray, params), jcfg, 2, V), tp=tp)
    got = ttfm.pipeline_param_specs(pp, tp=tp)
    assert set(got["ends"].values()) == {()}
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): tuple(s) for path, s in
            jax.tree_util.tree_leaves_with_path(
                want["blocks"], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    assert len(flat) == len(got["blocks"])
    for rel, spec in got["blocks"].items():
        path, transposed = ttfm.flax_path(rel)
        w = flat[path] + (None,) * (len(pp["blocks"][rel].shape) - len(flat[path]))
        if transposed:
            w = w[:-2] + (w[-1], w[-2])
        assert spec == w, (rel, spec, w)
    if tp:
        assert got["blocks"]["attn.query.weight"][-2] == "model"
        assert got["blocks"]["attn.attn_out.weight"][-1] == "model"


def _guard(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_guards_refuse_what_jax_refuses():
    cfg = _tcfg(GPT)
    _guard(lambda: ttfm.check_pipelineable(dataclasses.replace(cfg, num_experts=4), 2),
           "homogeneous")
    _guard(lambda: ttfm.make_pipelined_init_fn(cfg, 3), "not divisible")
    _guard(lambda: ttfm.to_pipeline_params({}, cfg, 2, 4), "not divisible")
    x = torch.zeros(2, 1, D)
    toy = {"w": torch.zeros(4, D, D), "b": torch.zeros(4, D)}
    stage = lambda p, x: x  # noqa: E731
    _guard(lambda: tpl.pipeline_apply(stage, toy, x, _cpu_mesh(pipe=4)), "microbatches")
    two = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in toy.items()}
    _guard(lambda: tpl.pipeline_apply(stage, two, torch.zeros(3, 1, D), _cpu_mesh(pipe=2),
                                      n_virtual=2), "divisible")
    _guard(lambda: tpl.pipeline_apply(stage, toy, torch.zeros(4, 1, D), _cpu_mesh(pipe=2),
                                      n_virtual=2), r"\[S, V, ...\]")
    _guard(lambda: tpl.pipeline_apply(stage, toy, torch.zeros(4, 1, D), None,
                                      aux_mb=torch.zeros(3, 1)), "aux_mb")
    _guard(lambda: tpl.pipeline_apply(stage, toy, torch.zeros(4, 1, D), _cpu_mesh(),
                                      param_specs=tpl.stage_param_specs(toy)), "degenerate")
    tp = _cpu_mesh(pipe=2, model=2)
    for flag in ("fused_ln_matmul", "fused_qkv"):
        _guard(lambda: ttfm.PipelinedTransformer(dataclasses.replace(cfg, **{flag: True}),
                                                 "meta", mesh=tp), flag)  # noqa: B023
    _guard(lambda: ttfm.PipelinedTransformer(cfg, "meta", mesh=_cpu_mesh(model=2)),
           "model axis without a pipe axis")
    model = ttfm.build_pipelined(cfg, ttfm.init_params(cfg, device="cpu", trainable=True),
                                 "cpu", n_microbatches=3)
    _guard(lambda: model(torch.zeros(4, SEQ, dtype=torch.long)), "microbatches")


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("tp", [False, True])
def test_a_stage_is_made_from_its_own_layers_and_placed_by_its_specs(monkeypatch, tp, stage):
    """``init_pipelined`` makes only the ends and this stage's layers (of
    pipe=2 at V=2, stage d holds layers d and d + 2; the rank's coordinates
    set by hand in this one process), each bitwise the whole model's of
    the seed and the same stage built from the whole state or from the
    stacked tree; its Block parameters carry ``StageSpec``s, which the
    optimizer's placement turns into ``Layout.stage``, the ends none."""
    from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
    from distributed_tensorflow_tpu_torch.parallel.sharding import StageSpec

    coords = {"pipe": stage, "model": 1 if tp else 0}
    for mod in (ttfm, tsh):
        monkeypatch.setattr(mod, "axis_index", lambda axis, mesh: coords.get(axis, 0))
    cfg = _tcfg(GPT)
    mesh = _cpu_mesh(pipe=2, model=2 if tp else 1)
    whole = ttfm.init_params(cfg, seed=3, device="cpu", trainable=True)
    kept = ttfm.init_params(cfg, seed=3, device="cpu", trainable=True,
                            keep=lambda n: not n.startswith("layers.1."))
    assert sorted(kept) == sorted(k for k in whole if not k.startswith("layers.1."))
    assert all(torch.equal(kept[k], whole[k]) for k in kept)
    kw = dict(trainable=True, mesh=mesh, n_virtual=2, n_microbatches=2)
    model = ttfm.init_pipelined(cfg, 3, "cpu", **kw)
    layers = sorted({k.split(".")[1] for k in model.state_dict() if k.startswith("layers.")})
    assert layers == [str(stage), str(stage + 2)]
    for other in (ttfm.build_pipelined(cfg, whole, "cpu", **kw),
                  ttfm.build_pipelined(cfg, ttfm.to_pipeline_params(whole, cfg, 2, 2), "cpu",
                                       **kw)):
        got, want = model.state_dict(), other.state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in got)
    for name, p in model.named_parameters():
        if name.startswith("layers.") and name.endswith("attn.query.weight"):
            assert p.shape[0] == cfg.d_model // (2 if tp else 1)
    opt = topt.make_optimizer(topt.OptimizerConfig(name="adamw", learning_rate=1e-3),
                              model.parameters())
    opt.place(mesh, model.specs, model)
    for (name, _), lay in zip(model.named_parameters(), opt.layouts):
        staged = name.startswith("layers.")
        assert isinstance(model.specs.get(name), StageSpec) == staged, name
        assert (lay is not None and lay.stage == "pipe") == staged, name


def test_train_section_pipeline_fields_match_jax():
    names = ("pipeline_microbatches", "pipeline_virtual", "check_pipeline_memory")
    for n in names:
        assert getattr(trunner.TrainSection(), n) == getattr(jrunner.TrainSection(), n)
    assert {f.name for f in dataclasses.fields(trunner.TrainSection)} >= set(names)


def test_the_runner_refuses_pipe_where_jax_would_only_repeat_work():
    tiny = ["--model.num_layers=2", "--model.d_model=32", "--model.num_heads=2",
            "--model.d_ff=64", "--model.vocab_size=64", "--data.vocab_size=64",
            "--model.max_len=16", "--data.seq_len=16", "--train.num_steps=1"]
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    for workload in ("resnet50_imagenet", "mnist_mlp", "cifar10_cnn", "wide_deep"):
        with pytest.raises(ValueError, match="no pipelined family"):
            trunner.check_supported(dataclasses.replace(
                trunner.RunConfig(workload=workload), mesh=tmesh.MeshSpec(pipe=2)))
    with pytest.raises(ValueError, match="no sequence parallelism"):
        run_workload("gpt_lm", tiny + ["--mesh.pipe=2", "--mesh.seq=2",
                                       "--model.seq_impl=ring"], device="cpu")


@pytest.mark.parametrize("pipelined", [False, True])
def test_pipelined_from_jax_holds_the_dense_function(pipelined):
    """JAX's pipelined tree (V=2 over two stages) and its dense tree both
    load into the port's pipelined model (one stage here): the logits of
    the dense model from the same weights."""
    jcfg, cfg = _jcfg(BERT), _tcfg(BERT)
    params = H.params_np(jcfg, seed=5)
    tree = (jax.tree.map(np.asarray, jtfm.to_pipeline_params(
        jax.tree.map(jnp.asarray, params), jcfg, 2, 2)) if pipelined else params)
    model = pipelined_from_jax(tree, cfg, "cpu", n_virtual=2 if pipelined else 1,
                               n_microbatches=2)
    dense = ttfm.build(cfg, _state_dict_from_jax(params, cfg), "cpu")
    b = _batch(np.random.default_rng(6), True)
    ids, mask = torch.from_numpy(b["input_ids"]), torch.from_numpy(b["attention_mask"])
    pos = torch.from_numpy(b["masked_positions"])
    np.testing.assert_allclose(model(ids, mask, positions=pos).detach().numpy(),
                               dense(ids, mask, positions=pos).numpy(), atol=1e-5, rtol=0)
