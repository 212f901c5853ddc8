"""Sequence parallelism in the port (``parallel/ring_attention.py``, the
``seq`` axis of the mesh, ``model.seq_impl``), from one launch of four
gloo ranks (``tests/torch_dp_worker.py``'s ``seq`` job), against the JAX
package's ``sequence_parallel_attention`` on its fake CPU devices at the
same meshes (seq=4, data=2 x seq=2, seq=2 x model=2):

- every schedule (ring, Ulysses, all-gather), causal or not, with a
  padded ``kv_mask`` (lengths S and 77·S/128) or none: each rank's output
  (its batch rows and heads, the whole sequence) within atol and rtol 2e-5
  of JAX's (``tests/test_ring_attention.py``'s gate), and the q, k, v
  gradients of ``sum(out * cot)`` within 5e-5 (its ring-gradient gate);
- the ring with the permute emulated by all-reduces (the path of gloo
  ranks sharing one card) bitwise equal to the native verb;
- a tiny decoder (2 layers, d 32, 4 heads, S=32) at data=2 x seq=2 with
  the ring, with and without remat, 3 adamw steps against JAX's dense
  data=2 steps (losses rtol 2e-4, JAX's ``test_seq_parallel_training_step``
  gate; each parameter's update within relative L2 1e-2, the key bias
  left out as in ``tests/test_torch_tensor_parallel.py``); Ulysses at
  seq=2 x model=2 and a padded BERT all-gather step at seq=4 against one
  process; replicated parameters bitwise equal across all four ranks;
- ``run_workload("gpt_lm")`` at data=2 x seq=2 with the ring against one
  process fed the data shards' rows.

In this process: the guards (a sequence the ``seq`` size does not divide,
Ulysses' local heads), a ``seq`` axis of 1 degenerating to one local
attention, ``gpt_lm.long_context`` field for field JAX's, and a
``seq_impl`` model's parameters those of the dense model.
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
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu.parallel.ring_attention import (
    sequence_parallel_attention as jspa,
)
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu.train import step as jstep
from distributed_tensorflow_tpu.workloads import gpt_lm as jgpt
from distributed_tensorflow_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_tpu_torch.ops.attention import attention_reference
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    IMPLS,
    sequence_parallel_attention,
)
from distributed_tensorflow_tpu_torch.workloads import gpt_lm as tgpt
from distributed_tensorflow_tpu_torch.weights import _state_dict_from_jax

sys.path.insert(0, os.path.dirname(__file__))
import torch_dp_worker as worker  # noqa: E402

B, HEADS, S, D = 2, 4, 128, 16
LENS = (S, 77 * S // 128)
MESHES = {"s4": dict(seq=4), "d2s2": dict(data=2, seq=2), "s2m2": dict(seq=2, model=2)}
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
RUNS = [(impl, causal, masked) for impl in IMPLS for causal in (0, 1) for masked in (0, 1)]

SEQ_LEN, GLOBAL, VOCAB, CHUNK, K = 32, 8, 256, 16, 5
SIZES = dict(vocab_size=VOCAB, max_len=SEQ_LEN, num_layers=2, d_model=32, num_heads=4,
             d_ff=64)
GPT = dict(causal=True, pre_ln=True)
BERT = dict(causal=False, pre_ln=False)
OPTIMIZER = dict(name="adamw", learning_rate=3e-3, weight_decay=0.01)
LOSS_TOL = dict(rtol=2e-4, atol=0.0)
UPDATE_TOL = 1e-2
#: tag -> (JAX config, port overrides, mesh, mlm)
MODEL_CASES = {
    "gpt_ring_d2s2": (GPT, dict(seq_impl="ring", xent_chunk=CHUNK), dict(data=2, seq=2),
                      False),
    "gpt_ring_remat_d2s2": (GPT, dict(seq_impl="ring", remat=True, xent_chunk=CHUNK),
                            dict(data=2, seq=2), False),
    "gpt_ulysses_s2m2": (GPT, dict(seq_impl="ulysses", xent_chunk=CHUNK),
                         dict(seq=2, model=2), False),
    "bert_allgather_s4": (BERT, dict(seq_impl="allgather"), dict(seq=4), True),
}
JAX_CASES = ("gpt_ring_d2s2", "gpt_ring_remat_d2s2")
RUNNER = ["--model.num_layers=2", "--model.d_model=32", "--model.num_heads=4",
          "--model.d_ff=64", "--model.vocab_size=256", "--data.vocab_size=256",
          "--model.max_len=32", "--data.seq_len=32", "--model.dtype=float32",
          "--data.global_batch_size=8", "--train.num_steps=3", "--train.eval_batches=0",
          "--train.log_every=1", "--optimizer.warmup_steps=0",
          "--optimizer.learning_rate=3e-3", "--model.xent_chunk=16",
          "--model.seq_impl=ring"]


def _qkv(seed):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((B, HEADS, S, D)).astype(np.float32)
                    for _ in range(4))
    mask = np.arange(S)[None, :] < np.asarray(LENS)[:, None]
    return dict(q=q, k=k, v=v, cot=cot, mask=mask)


def _jax_attention(tag, arrays, devices):
    """JAX's schedules at ``MESHES[tag]``: each run's output and the
    gradients of ``sum(out * cot)``."""
    kw = MESHES[tag]
    mesh = jbuild_mesh(JMeshSpec(**dict(dict(data=1), **kw)), devices[:4])
    q, k, v, cot, mask = (jnp.asarray(arrays[n]) for n in ("q", "k", "v", "cot", "mask"))

    def runs(q, k, v, cot, mask):  # every run in one program: one compile
        out = []
        for impl, causal, masked in RUNS:
            o, vjp = jax.vjp(lambda q, k, v: jspa(  # noqa: B023
                q, k, v, mesh, impl=impl, causal=bool(causal),
                kv_mask=mask if masked else None), q, k, v)
            out.append((o, *vjp(cot)))
        return out

    got = jax.jit(runs)(q, k, v, cot, mask)
    return {run: [np.asarray(t) for t in ts] for run, ts in zip(RUNS, got)}


def _jcfg(tag):
    return H.jax_cfg(**SIZES, **MODEL_CASES[tag][0])


def _tcfg(tag):
    return H.port_cfg(_jcfg(tag), **MODEL_CASES[tag][1])


def _batches(n, seed, mlm):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, (GLOBAL, SEQ_LEN)).astype(np.int32)
        if not mlm:
            out.append({"input_ids": ids})
            continue
        lengths = rng.integers(SEQ_LEN // 2, SEQ_LEN + 1, GLOBAL)
        mask = (np.arange(SEQ_LEN)[None] < lengths[:, None]).astype(np.int32)
        pos = np.stack([np.sort(rng.choice(n_, K, replace=False)) for n_ in lengths])
        out.append({"input_ids": ids, "attention_mask": mask,
                    "masked_positions": pos.astype(np.int32),
                    "masked_labels": np.take_along_axis(ids, pos, 1).astype(np.int32)})
    return out


def _jax_dense_data2(tag, params, train, devices):
    """JAX's dense (no sequence parallelism) steps at data=2: losses and
    the final parameters as a port state dict."""
    mesh = jbuild_mesh(JMeshSpec(data=2), devices[:2])
    jcfg = _jcfg(tag)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**OPTIMIZER))
    loss_fn = jtfm.chunked_lm_loss_fn(jtfm.Transformer(jcfg, mesh), CHUNK)
    p = jax.tree.map(jnp.asarray, params)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tx.init(p),
                             model_state={}, rng=jax.random.PRNGKey(0))
    specs = jstep.state_specs(jax.eval_shape(lambda: state), jsh.replicated_specs(p))
    state = jax.device_put(state, jsh.tree_shardings(mesh, specs))
    step = jstep.jit_train_step(jstep.make_train_step(loss_fn, tx), mesh, specs)
    losses = []
    for b in train:
        b = {k: jax.device_put(v, NamedSharding(mesh, jsh.batch_spec(v.ndim)))
             for k, v in b.items()}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    sd = _state_dict_from_jax(jax.tree.map(np.asarray, state.params), _tcfg(tag))
    return {"losses": np.asarray(losses), "state": {k: v.numpy() for k, v in sd.items()}}


def _runner_one_process():
    """What the four ranks' ``run_workload("gpt_lm", RUNNER + data=2 x
    seq=2)`` computes, in one process: the workload's model stepped on
    each global batch the two data shards' streams make."""
    from distributed_tensorflow_tpu_torch.data import text
    from distributed_tensorflow_tpu_torch.train import (
        init_train_state, make_optimizer, make_train_step)
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


@pytest.fixture(scope="module")
def sp(tmp_path_factory, devices):
    """The four-rank job (started first: it runs while JAX compiles), JAX's
    schedules and dense steps, and the one-process references."""
    out = str(tmp_path_factory.mktemp("seq"))
    arrays, attn = {}, {}
    for i, tag in enumerate(MESHES):
        attn[tag] = _qkv(60 + i)
        arrays.update({f"{tag}/{k}": v for k, v in attn[tag].items()})
    cases, params, data = [], {}, {}
    for i, tag in enumerate(MODEL_CASES):
        # the two ring cases share their weights and batches (and JAX's run)
        seed = 70 + (i if tag not in JAX_CASES else 0)
        params[tag] = H.params_np(_jcfg(tag), seed=seed)
        sd = _state_dict_from_jax(params[tag], _tcfg(tag))
        mlm = MODEL_CASES[tag][3]
        data[tag] = (_batches(3, seed + 10, mlm), _batches(1, seed + 20, mlm))
        arrays.update({f"sd_{tag}/{k}": v.numpy() for k, v in sd.items()})
        for prefix, bs in zip(("train", "eval"), data[tag]):
            arrays.update({f"{tag}/{prefix}{j}/{k}": v for j, b in enumerate(bs)
                           for k, v in b.items()})
        cases.append(dict(tag=tag, sd=f"sd_{tag}", cfg=dataclasses.asdict(_tcfg(tag)),
                          mesh=MODEL_CASES[tag][2], optimizer=OPTIMIZER, mlm=mlm,
                          chunk=CHUNK, save=False))
    inputs = os.path.join(out, "inputs.npz")
    np.savez(inputs, **arrays)
    procs = worker.launch({
        "job": "seq", "device": "cpu", "out": out, "inputs": inputs,
        "attention": [dict(tag=tag, mesh=m, emulated=tag == "s2m2")
                      for tag, m in MESHES.items()],
        "cases": cases,
        "runner": {"gpt_lm": RUNNER + ["--mesh.data=2", "--mesh.seq=2"]}}, world=4)
    try:
        jax_attn = {tag: _jax_attention(tag, attn[tag], devices) for tag in MESHES}
        dense = _jax_dense_data2(JAX_CASES[0], params[JAX_CASES[0]], data[JAX_CASES[0]][0],
                                 devices)
        jax_steps = dict.fromkeys(JAX_CASES, dense)
        sds = {tag: {k[len(f"sd_{tag}/"):]: v for k, v in arrays.items()
                     if k.startswith(f"sd_{tag}/")} for tag in MODEL_CASES}
        one = {c["tag"]: worker.tp_steps(c, sds[c["tag"]], *data[c["tag"]],
                                         torch.device("cpu"))
               for c in cases if c["tag"] not in JAX_CASES}
        runner = _runner_one_process()
    except BaseException:
        worker.stop(procs)
        raise
    return {"ranks": worker.wait(procs, out, timeout=600), "attn": attn, "jax": jax_attn,
            "jax_steps": jax_steps, "one": one, "runner": runner, "sd": sds}


def _rank_slice(r, tag):
    """Rank r's batch rows and heads at ``MESHES[tag]`` (ranks flatten in
    AXIS_NAMES order: data, fsdp, seq, expert, model)."""
    kw = dict(MESHES[tag])
    sizes = [kw.get(a, 1) for a in tmesh.AXIS_NAMES]
    idx = dict(zip(tmesh.AXIS_NAMES, np.unravel_index(r, sizes)))
    nb, nm = kw.get("data", 1), kw.get("model", 1)
    return (slice(idx["data"] * B // nb, (idx["data"] + 1) * B // nb),
            slice(idx["model"] * HEADS // nm, (idx["model"] + 1) * HEADS // nm))


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("impl,causal,masked", RUNS)
def test_schedules_match_jax_sequence_parallel_attention(sp, tag, impl, causal, masked):
    want = sp["jax"][tag][(impl, causal, masked)][0]
    for r, rank in enumerate(sp["ranks"]):
        rows, heads = _rank_slice(r, tag)
        np.testing.assert_allclose(rank[f"{tag}/{impl}/{causal}{masked}/out"],
                                   want[rows, heads], **FWD_TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("impl", IMPLS)
def test_schedule_gradients_match_jax(sp, tag, impl):
    """Every seq rank holds the whole sequence's gradient of its rows and
    heads (the island's entry all-gathers the chunks' gradients)."""
    for causal in (0, 1):
        for masked in (0, 1):
            want = sp["jax"][tag][(impl, causal, masked)][1:]
            for r, rank in enumerate(sp["ranks"]):
                rows, heads = _rank_slice(r, tag)
                for name, w in zip(("dq", "dk", "dv"), want):
                    np.testing.assert_allclose(
                        rank[f"{tag}/{impl}/{causal}{masked}/{name}"], w[rows, heads],
                        **GRAD_TOL, err_msg=f"{name} rank {r} causal {causal} mask {masked}")


@pytest.mark.parametrize("causal,masked", [(1, 1), (0, 0)])
def test_emulated_permute_equals_the_native_verb(sp, causal, masked):
    """Under gloo on CUDA tensors the ring's permute is an all-reduce of a
    zero-filled buffer (a value plus zeros): bitwise the native verb,
    output and gradients."""
    for rank in sp["ranks"]:
        for name in ("out", "dq", "dk", "dv"):
            np.testing.assert_array_equal(rank[f"s2m2/emulated/{causal}{masked}/{name}"],
                                          rank[f"s2m2/ring/{causal}{masked}/{name}"],
                                          err_msg=name)


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


def _whole(rank, tag):
    head = f"{tag}/whole/model/"
    return {k[len(head):]: v for k, v in rank.items() if k.startswith(head)}


@pytest.mark.parametrize("tag", JAX_CASES)
def test_ring_decoder_at_data2_seq2_matches_jax_dense_data2(sp, tag):
    want = sp["jax_steps"][tag]
    for rank in sp["ranks"]:
        np.testing.assert_allclose(rank[f"{tag}/losses"], want["losses"], **LOSS_TOL)
        _updates_close(_whole(rank, tag), want["state"], sp["sd"][tag])


@pytest.mark.parametrize("tag", [t for t in MODEL_CASES if t not in JAX_CASES])
def test_ulysses_and_allgather_steps_match_one_process(sp, tag):
    """Ulysses at seq=2 x model=2 (with the megatron heads) and the padded
    BERT all-gather step at seq=4 against the same steps in one process:
    a seq rank's gradients are whole, so no sum over seq is needed."""
    want = sp["one"][tag]
    got = {k[len(f"{tag}/"):]: v for k, v in sp["ranks"][0].items()
           if k.startswith(f"{tag}/")}
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
    _updates_close(_whole(sp["ranks"][0], tag),
                   {k[len("whole/model/"):]: v for k, v in want.items()
                    if k.startswith("whole/model/")}, sp["sd"][tag])
    for k in ("count", "loss_sum"):
        if f"eval/{k}" in want:
            np.testing.assert_allclose(got[f"eval/{k}"], want[f"eval/{k}"], rtol=2e-4)


@pytest.mark.parametrize("tag", list(MODEL_CASES))
def test_replicated_parameters_stay_bitwise_equal_across_all_ranks(sp, tag):
    for rank in sp["ranks"]:
        assert (rank[f"{tag}/drift"] == 0).all(), rank[f"{tag}/drift"]
        for k, v in _whole(rank, tag).items():
            np.testing.assert_array_equal(v, _whole(sp["ranks"][0], tag)[k], err_msg=k)


def test_runner_at_data2_seq2_matches_one_process(sp):
    """``run_workload("gpt_lm")`` at data=2 x seq=2 with the ring: the seq
    ranks of a data shard read its rows, and the steps equal one process
    on the global batches."""
    want = sp["runner"]
    for rank in sp["ranks"]:
        assert rank["runner/gpt_lm/mesh"].tolist() == [2, 1, 1]
        assert int(rank["runner/gpt_lm/seq"]) == 2
        np.testing.assert_allclose(rank["runner/gpt_lm/losses"], want["losses"], **LOSS_TOL)
    head = "runner/gpt_lm/whole/model/"
    got = {k[len(head):]: v for k, v in sp["ranks"][0].items() if k.startswith(head)}
    for k, w in want["state"].items():
        np.testing.assert_allclose(got[k], w, rtol=2e-4, atol=2e-5, err_msg=k)


# -- one process ---------------------------------------------------------------


def _cpu_mesh(**kw):
    return tmesh.Mesh(dict(tmesh.MeshSpec(**dict(dict(data=1), **kw)).sizes()),
                      torch.device("cpu"))


def test_guards_refuse_an_indivisible_sequence_and_ulysses_local_heads():
    """As ``tests/test_ring_attention.py``: S=90 over seq=4; H=3 heads over
    seq=4 under Ulysses; 2 local heads (H=4 over model=2, the rank's q
    holds 2) over seq=4. The guards read the mesh alone: no collective."""
    q = torch.zeros(2, 4, 90, 8)
    with pytest.raises(ValueError, match="divisible"):
        sequence_parallel_attention(q, q, q, _cpu_mesh(seq=4))
    q = torch.zeros(2, 3, 128, 8)
    with pytest.raises(ValueError, match="ulysses"):
        sequence_parallel_attention(q, q, q, _cpu_mesh(seq=4), impl="ulysses")
    q = torch.zeros(2, 2, 128, 8)
    with pytest.raises(ValueError, match=r"local heads \(4//2\)"):
        sequence_parallel_attention(q, q, q, _cpu_mesh(seq=4, model=2), impl="ulysses")
    with pytest.raises(ValueError, match="seq_impl must be one of"):
        sequence_parallel_attention(q, q, q, _cpu_mesh(), impl="striped")


@pytest.mark.parametrize("impl", IMPLS)
def test_seq_axis_1_degenerates_to_one_local_attention(impl):
    a = _qkv(3)
    q, k, v = (torch.from_numpy(a[n]) for n in ("q", "k", "v"))
    mask = torch.from_numpy(a["mask"])
    mesh = tmesh.build_mesh(device="cpu")
    for causal in (False, True):
        got = sequence_parallel_attention(q, k, v, mesh, impl=impl, causal=causal,
                                          kv_mask=mask)
        want = attention_reference(q, k, v, causal=causal, kv_mask=mask)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


def test_long_context_preset_equals_jax_field_for_field():
    got, want = tgpt.long_context(), jgpt.long_context()
    assert got.model.seq_impl == "ring" and got.model.remat
    assert got.model.max_len == got.data.seq_len == 8192
    assert got.data.global_batch_size == 8
    assert got.mesh.sizes() == want.mesh.sizes() and got.mesh.seq == -1
    jm = dataclasses.asdict(want.model)
    for k, v in dataclasses.asdict(got.model).items():
        if k in jm:
            assert v == jm[k], k
    jd = dataclasses.asdict(want.data)
    for k, v in dataclasses.asdict(got.data).items():
        if k in jd:
            assert v == jd[k], k
    assert dataclasses.asdict(got.optimizer) == {
        k: v for k, v in dataclasses.asdict(want.optimizer).items()
        if k in dataclasses.asdict(got.optimizer)}
    assert tgpt.long_context(4096).model.max_len == 4096
    from distributed_tensorflow_tpu_torch.workloads import _config, presets

    assert presets("gpt_lm") == ["long_context"] and presets("mnist_mlp") == []
    assert _config("gpt_lm", ["--mesh.seq=2"], "long_context")[1].mesh.seq == 2
    with pytest.raises(ValueError, match="no preset 'long_context'"):
        _config("bert_pretrain", [], "long_context")


def test_seq_impl_model_has_the_dense_models_parameters():
    """JAX initialises a ``seq_impl`` model through its dense twin
    (``make_init_fn``); the port's ``seq_impl`` model has the same
    parameters, names and shapes, and a flax tree converts into it as into
    the dense one."""
    jcfg = H.jax_cfg(**SIZES, **GPT)
    twin = jax.eval_shape(jtfm.make_init_fn(jtfm.Transformer(
        dataclasses.replace(jcfg, seq_impl="ring")), SEQ_LEN), jax.random.PRNGKey(0))[0]
    dense = jax.eval_shape(jtfm.make_init_fn(jtfm.Transformer(jcfg), SEQ_LEN),
                           jax.random.PRNGKey(0))[0]
    assert jax.tree.map(lambda a: a.shape, twin) == jax.tree.map(lambda a: a.shape, dense)
    params = H.params_np(jcfg, seed=1)
    ring = _state_dict_from_jax(params, H.port_cfg(jcfg, seq_impl="ring"))
    plain = _state_dict_from_jax(params, H.port_cfg(jcfg))
    assert ring.keys() == plain.keys()
    model = ttfm.build(H.port_cfg(jcfg, seq_impl="ring"), ring, "cpu", trainable=True)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in plain.items()}
