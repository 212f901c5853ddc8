"""Tensor and fully-sharded data parallelism for ``gpt_lm`` and
``bert_pretrain`` in the port, from one launch of four gloo ranks
(``tests/torch_dp_worker.py``'s ``tp`` job), against the JAX package on
its fake CPU devices at the same meshes:

- a causal decoder with the fused LN+matmul path and the chunked loss at
  data=2 x model=2 with adamw and at fsdp=2 x model=2 with lamb (its
  ``pos_embed`` sharded over fsdp), both with a clip that binds;
- the BERT encoder (split QKV, a padded ``attention_mask``, the gathered
  MLM head) at fsdp=2 x model=2 with adamw (``pos_embed`` and
  ``mlm_transform``'s kernel over fsdp), and with fused QKV at data=2 x
  model=2 with lamb;
- the plain decoder at data=2 x model=2 with adafactor (factored
  statistics summed over the axis that shards their dim);
- the decoder at dropout 0.1 with remat, and at a vocabulary of 251
  (which 2 does not divide: the shards are padded, which JAX's
  ``device_put`` refuses), against one process on the global batches;
- ``run_workload`` of each workload at its mesh against one process fed
  the data shards' rows.

JAX runs the same function: its fused-LN cases run JAX's unfused model
(the same LayerNorm and matmul; the port's fused kernel differs from it
by the rounding of its two-pass variance). Tolerances (f32): losses and
grad norms rtol 2e-4 (JAX's own ``test_tp_matches_replicated``); each
gathered parameter's three-step update (final minus initial) within
relative L2 1e-2 of the reference's (one process of the port against
JAX reads up to 1.4e-3 on the token table: Adam-type updates normalise
the near-zero gradients of tokens absent from a batch, so their rounding
shows at the scale of the step); the attention's key bias is left out,
its gradient being zero in exact arithmetic (attention is invariant to
adding one vector to every key), so every implementation moves it by
normalised rounding noise alone (relative L2 ~1.2 between the port in
one process and JAX), and so is a fused ``qkv`` bias, whose key rows
enter lamb's per-leaf trust ratio and so scale all its rows; eval loss
sums rtol 2e-4, counts exact, correct
predictions within one.
Replicated parameters are bitwise equal across all four ranks after every
step, the ranks' gathered states bitwise equal, each case's step dir
(written whole by the chief) restores bitwise at the mesh and in one
process.
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
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu.train import step as jstep
from distributed_tensorflow_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_tpu_torch.train import checkpoint as tck
from distributed_tensorflow_tpu_torch.train import optimizers as topt
from distributed_tensorflow_tpu_torch.train import step as tstep
from distributed_tensorflow_tpu_torch.weights import _state_dict_from_jax

sys.path.insert(0, os.path.dirname(__file__))
import torch_dp_worker as worker  # noqa: E402

SEQ, GLOBAL, VOCAB, CHUNK, K = 32, 8, 256, 16, 5
SIZES = dict(vocab_size=VOCAB, max_len=128, num_layers=2, d_model=128, num_heads=4, d_ff=256)
LOSS_TOL = dict(rtol=2e-4, atol=0.0)
UPDATE_TOL = 1e-2
CLIP = 0.5
GPT = dict(causal=True, pre_ln=True)
BERT = dict(causal=False, pre_ln=False)
#: tag -> (JAX config, port-only overrides, mesh, optimizer, options, mlm)
CASES = {
    "gpt_d2m2_adamw": (GPT, dict(fused_ln_matmul=True), dict(data=2, model=2),
                       dict(name="adamw", learning_rate=3e-3, weight_decay=0.01),
                       dict(clip_grad_norm=CLIP, compute_grad_norm=True), False),
    "gpt_f2m2_lamb": (GPT, dict(fused_ln_matmul=True), dict(fsdp=2, model=2),
                      dict(name="lamb", learning_rate=1e-2, weight_decay=0.01),
                      dict(clip_grad_norm=CLIP, compute_grad_norm=True), False),
    "bert_f2m2_adamw": (BERT, {}, dict(fsdp=2, model=2),
                        dict(name="adamw", learning_rate=3e-3, weight_decay=0.01),
                        dict(clip_grad_norm=CLIP, compute_grad_norm=True), True),
    "bert_fused_d2m2_lamb": (dict(BERT, fused_qkv=True), {}, dict(data=2, model=2),
                             dict(name="lamb", learning_rate=1e-2), {}, True),
    "gpt_d2m2_adafactor": (GPT, {}, dict(data=2, model=2),
                           dict(name="adafactor", learning_rate=1e-2), {}, False),
}
DROPOUT_CASE = "gpt_dropout_d2m2"
ODD_CASE, ODD_VOCAB = "gpt_vocab251_d2m2", 251
#: the runner at each workload's mesh (tiny widths; a vocab of 251)
RUNNER_TINY = ["--model.num_layers=2", "--model.d_model=64", "--model.num_heads=4",
               "--model.d_ff=128", "--model.vocab_size=251", "--data.vocab_size=251",
               "--model.max_len=32", "--data.seq_len=32", "--model.dtype=float32",
               "--data.global_batch_size=8", "--train.num_steps=3", "--train.eval_batches=0",
               "--train.log_every=1", "--optimizer.warmup_steps=0",
               "--optimizer.learning_rate=3e-3"]
RUNNER = {"gpt_lm": RUNNER_TINY + ["--mesh.data=2", "--mesh.model=2", "--model.xent_chunk=16",
                                   "--model.fused_ln_matmul=true"],
          "bert_pretrain": RUNNER_TINY + ["--mesh.fsdp=2", "--mesh.model=2",
                                          "--model.dropout=0.0"]}


def _jcfg(tag):
    return H.jax_cfg(**SIZES, **CASES[tag][0])


def _tcfg(tag):
    extra = dict(CASES[tag][1])
    if not CASES[tag][5]:
        extra["xent_chunk"] = CHUNK
    return H.port_cfg(_jcfg(tag), **extra)


def _batches(n, seed, mlm, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (GLOBAL, SEQ)).astype(np.int32)
        if not mlm:
            out.append({"input_ids": ids})
            continue
        lengths = rng.integers(SEQ // 2, SEQ + 1, GLOBAL)
        mask = (np.arange(SEQ)[None] < lengths[:, None]).astype(np.int32)
        pos = np.stack([np.sort(rng.choice(n_, K, replace=False)) for n_ in lengths])
        out.append({"input_ids": ids, "attention_mask": mask,
                    "masked_positions": pos.astype(np.int32),
                    "masked_labels": np.take_along_axis(ids, pos, 1).astype(np.int32)})
    return out


def _jax_run(tag, params, train, evals, devices):
    """JAX's steps at the case's mesh: specs as ``init_train_state``
    computes them for the transformer workloads, the step jitted over
    them; the losses, norms, final parameters (as a port state dict) and
    the eval totals."""
    jcfg, _, mesh_kw, opt, options, mlm = CASES[tag]
    jcfg = _jcfg(tag)
    n = int(np.prod(list(mesh_kw.values())))
    mesh = jbuild_mesh(JMeshSpec(**mesh_kw), devices[:n])
    model = jtfm.Transformer(jcfg, mesh)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**opt))
    loss_fn = jtfm.mlm_loss_fn(model) if mlm else jtfm.chunked_lm_loss_fn(model, CHUNK)
    p = jax.tree.map(jnp.asarray, params)
    pspecs = jsh.merge_specs(jsh.specs_from_rules(p, jtfm.transformer_rules(jcfg)),
                             jsh.auto_fsdp_specs(p, mesh))
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tx.init(p),
                             model_state={}, rng=jax.random.PRNGKey(0))
    abstract = jax.eval_shape(lambda: state)
    specs = jstep.state_specs(abstract, pspecs)
    if opt["name"] == "adafactor":
        # JAX's opt_state_specs hands a factored statistic its parameter's
        # 2-D spec; GSPMD computes the same update with the state replicated
        specs = specs.replace(opt_state=jsh.replicated_specs(abstract.opt_state))
    state = jax.device_put(state, jsh.tree_shardings(mesh, specs))
    step = jstep.jit_train_step(jstep.make_train_step(
        loss_fn, tx, jstep.StepOptions(**options)), mesh, specs)
    put = lambda b: {k: jax.device_put(v, NamedSharding(mesh, jsh.batch_spec(v.ndim)))  # noqa
                     for k, v in b.items()}
    losses, norms = [], []
    for b in train:
        state, m = step(state, put(b))
        losses.append(float(m["loss"]))
        norms.append(float(m.get("grad_norm", np.nan)))
    efn = jax.jit(jtfm.mlm_eval_fn(model) if mlm else jtfm.lm_eval_fn(model, CHUNK))
    tot = {}
    for b in evals:
        for k, v in efn(state.params, {}, put(b)).items():
            tot[k] = tot.get(k, 0.0) + np.asarray(v, np.float64)
    sd = _state_dict_from_jax(jax.tree.map(np.asarray, state.params), _tcfg(tag))
    return {"losses": np.asarray(losses), "grad_norms": np.asarray(norms),
            "state": {k: v.numpy() for k, v in sd.items()}, "eval": tot}


def _runner_one_process(workload):
    """What the four ranks' ``run_workload`` computes, in one process: the
    workload's model (the same seed) stepped on each global batch the data
    shards' streams make (shard 0's rows first)."""
    from distributed_tensorflow_tpu_torch.data import text
    from distributed_tensorflow_tpu_torch.train import (
        init_train_state, make_optimizer, make_train_step)
    from distributed_tensorflow_tpu_torch.utils import config as tconfig
    from distributed_tensorflow_tpu_torch.workloads import get

    mod = get(workload)
    over = [o for o in RUNNER[workload] if not o.startswith("--mesh")]
    cfg = tconfig.apply_overrides(mod.default_config(), over + ["--mesh.data=1"])
    parts = mod.build(cfg, torch.device("cpu"))
    init = {k: v.detach().float().numpy().copy() for k, v in parts.model.state_dict().items()}
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
    return {"losses": np.asarray(losses), "init": init, "cfg": cfg.model, "state": {
        k: v.detach().float().numpy() for k, v in state.model.state_dict().items()}}


@pytest.fixture(scope="module")
def tp(tmp_path_factory, devices):
    """The four-rank job (started first: it runs while JAX compiles), JAX's
    runs, the one-process dropout run and the one-process runners."""
    out = str(tmp_path_factory.mktemp("tp"))
    arrays, cases, params, data = {}, [], {}, {}
    for i, tag in enumerate(CASES):
        params[tag] = H.params_np(_jcfg(tag), seed=20 + i)
        sd = _state_dict_from_jax(params[tag], _tcfg(tag))
        mlm = CASES[tag][5]
        data[tag] = (_batches(3, 30 + i, mlm), _batches(2, 40 + i, mlm))
        arrays.update({f"sd_{tag}/{k}": v.numpy() for k, v in sd.items()})
        for prefix, bs in zip(("train", "eval"), data[tag]):
            arrays.update({f"{tag}/{prefix}{j}/{k}": v for j, b in enumerate(bs)
                           for k, v in b.items()})
        cases.append(dict(tag=tag, sd=f"sd_{tag}", cfg=dataclasses.asdict(_tcfg(tag)),
                          mesh=CASES[tag][2], optimizer=CASES[tag][3],
                          options=CASES[tag][4], mlm=mlm, chunk=CHUNK))
    drop = dict(cases[0], tag=DROPOUT_CASE, sd="sd_gpt_d2m2_adamw", options={},
                cfg=dict(cases[0]["cfg"], dropout=0.1, remat=True))
    arrays.update({f"{DROPOUT_CASE}/{k.split('/', 1)[1]}": v for k, v in list(arrays.items())
                   if k.startswith("gpt_d2m2_adamw/")})
    ocfg = H.jax_cfg(**dict(SIZES, vocab_size=ODD_VOCAB), **GPT)
    osd = {k: v.numpy() for k, v in _state_dict_from_jax(
        H.params_np(ocfg, seed=50), H.port_cfg(ocfg, fused_ln_matmul=True)).items()}
    data[ODD_CASE] = (_batches(3, 51, False, ODD_VOCAB), _batches(2, 52, False, ODD_VOCAB))
    arrays.update({f"sd_{ODD_CASE}/{k}": v for k, v in osd.items()})
    for prefix, bs in zip(("train", "eval"), data[ODD_CASE]):
        arrays.update({f"{ODD_CASE}/{prefix}{j}/{k}": v for j, b in enumerate(bs)
                       for k, v in b.items()})
    odd = dict(cases[0], tag=ODD_CASE, sd=f"sd_{ODD_CASE}",
               cfg=dataclasses.asdict(H.port_cfg(ocfg, fused_ln_matmul=True,
                                                 xent_chunk=CHUNK)))
    cases += [drop, odd]
    inputs = os.path.join(out, "inputs.npz")
    np.savez(inputs, **arrays)
    procs = worker.launch({"job": "tp", "device": "cpu", "out": out, "inputs": inputs,
                           "cases": cases, "runner": RUNNER}, world=4)
    try:
        jax_runs = {tag: _jax_run(tag, params[tag], *data[tag], devices) for tag in CASES}
        sd0 = {k[len("sd_gpt_d2m2_adamw/"):]: v for k, v in arrays.items()
               if k.startswith("sd_gpt_d2m2_adamw/")}
        one = {tag: worker.tp_steps(case, sd, *data[src], torch.device("cpu"))
               for tag, case, sd, src in ((DROPOUT_CASE, drop, sd0, "gpt_d2m2_adamw"),
                                          (ODD_CASE, odd, osd, ODD_CASE))}
        runners = {w: _runner_one_process(w) for w in RUNNER}
    except BaseException:
        worker.stop(procs)
        raise
    return {"ranks": worker.wait(procs, out, timeout=600), "jax": jax_runs, "dropout": one,
            "runners": runners, "out": out, "cases": {c["tag"]: c for c in cases},
            "sd": {tag: {k[len(f"sd_{tag}/"):]: v for k, v in arrays.items()
                         if k.startswith(f"sd_{tag}/")} for tag in [*CASES, ODD_CASE]}}


def _assert_updates_close(got: dict, want: dict, init: dict, cfg) -> None:
    """Each leaf's update ``got - init`` within relative L2 ``UPDATE_TOL``
    of ``want - init`` (module docstring), the key bias's elements left
    out, and a fused qkv bias (its key rows); and the leaves moved."""
    moved = 0.0
    for k, w in want.items():
        du, dw = got[k] - init[k], w - init[k]
        if k.endswith(("attn.key.bias", "attn.qkv.bias")):
            continue
        err = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
        assert err <= UPDATE_TOL, (k, err)
        moved = max(moved, float(np.abs(dw).max()))
    assert moved > 1e-3


def _whole(rank, tag, prefix="model/"):
    head = f"{tag}/whole/{prefix}"
    return {k[len(head):]: v for k, v in rank.items() if k.startswith(head)}


@pytest.mark.parametrize("tag", list(CASES))
def test_losses_and_norms_match_jax_at_the_same_mesh(tp, tag):
    want = tp["jax"][tag]
    for rank in tp["ranks"]:
        np.testing.assert_allclose(rank[f"{tag}/losses"], want["losses"], **LOSS_TOL)
        if CASES[tag][4].get("compute_grad_norm"):
            assert (want["grad_norms"] > CLIP).all()  # the clip binds
            np.testing.assert_allclose(rank[f"{tag}/grad_norms"], want["grad_norms"],
                                       **LOSS_TOL)


@pytest.mark.parametrize("tag", list(CASES))
def test_gathered_parameters_match_jax(tp, tag):
    got, want = _whole(tp["ranks"][0], tag), tp["jax"][tag]["state"]
    assert sorted(got) == sorted(want)
    _assert_updates_close(got, want, tp["sd"][tag], _tcfg(tag))


@pytest.mark.parametrize("tag", [*CASES, DROPOUT_CASE, ODD_CASE])
def test_replicated_leaves_stay_bitwise_equal_and_ranks_agree(tp, tag):
    """After every step each replicated parameter is bitwise the same on
    all four ranks; the gathered states (parameters and optimizer state)
    are bitwise equal across ranks."""
    ranks = tp["ranks"]
    for rank in ranks:
        assert len(rank[f"{tag}/drift"]) == 3 and not rank[f"{tag}/drift"].any()
    for rank in ranks[1:]:
        for k, v in _whole(ranks[0], tag, "").items():
            np.testing.assert_array_equal(_whole(rank, tag, "")[k], v, err_msg=k)


@pytest.mark.parametrize("tag", list(CASES))
def test_eval_metrics_match_jax(tp, tag):
    want = tp["jax"][tag]["eval"]
    for rank in tp["ranks"]:
        tot = {k[len(f"{tag}/eval/"):]: v for k, v in rank.items()
               if k.startswith(f"{tag}/eval/")}
        assert float(tot["count"]) == float(want["count"]) > 0
        np.testing.assert_allclose(tot["loss_sum"], want["loss_sum"], **LOSS_TOL)
        assert abs(float(tot["correct"]) - float(want["correct"])) <= 1


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_save_restores_bitwise_at_the_mesh_and_in_one_process(tp, tag):
    """The chief wrote the gathered state: the four ranks restored it into
    fresh shards bitwise (``restored_equal``), and one process restores it
    whole, every leaf bitwise the ranks' gathered one."""
    for rank in tp["ranks"]:
        assert bool(rank[f"{tag}/restored_equal"])
    case = tp["cases"][tag]
    cfg = ttfm.TransformerConfig(**case["cfg"])
    model = ttfm.build(cfg, {k: torch.as_tensor(v) for k, v in tp["sd"][tag].items()},
                       "cpu", trainable=True)
    state = tstep.init_train_state(model, topt.make_optimizer(
        topt.OptimizerConfig(**case["optimizer"]), model.parameters()))
    ck = tck.Checkpointer(tck.CheckpointConfig(directory=os.path.join(tp["out"], f"ck_{tag}"),
                                               async_save=False))
    try:
        assert ck.restore(state) is state and state.step == 3
    finally:
        ck.close()
    whole = _whole(tp["ranks"][0], tag, "")
    leaves = dict(tstep.state_leaves(state))
    assert sorted(leaves) == sorted(whole)
    for k, v in leaves.items():
        np.testing.assert_array_equal(v.float().numpy(), whole[k], err_msg=k)


@pytest.mark.parametrize("tag", [DROPOUT_CASE, ODD_CASE])
def test_dropout_remat_and_a_padded_vocab_match_one_process(tp, tag):
    """Every model rank of a data shard draws its rows' masks of the global
    draw, so the tensor-parallel steps at dropout 0.1 with remat are the
    one-process steps on the global batch; a vocabulary of 251 over two
    vocab shards (126 rows each, one of padding masked to -inf in the head,
    zero in the table) gives the one-process losses, norms, eval and
    weights."""
    one = tp["dropout"][tag]
    if tag == DROPOUT_CASE:
        assert np.abs(one["losses"] - tp["jax"]["gpt_d2m2_adamw"]["losses"]).max() > 1e-3
    for rank in tp["ranks"]:
        np.testing.assert_allclose(rank[f"{tag}/losses"], one["losses"], **LOSS_TOL)
        np.testing.assert_allclose(rank[f"{tag}/eval/loss_sum"], one["eval/loss_sum"],
                                   **LOSS_TOL)
    got = _whole(tp["ranks"][0], tag)
    want = {k[len("whole/model/"):]: v for k, v in one.items() if k.startswith("whole/model/")}
    cfg = ttfm.TransformerConfig(**tp["cases"][tag]["cfg"])
    _assert_updates_close(got, want, tp["sd"][tp["cases"][tag]["sd"][3:]], cfg)


@pytest.mark.parametrize("workload", list(RUNNER))
def test_runner_at_the_mesh_matches_one_process_on_the_shards_rows(tp, workload):
    """``run_workload`` (the ``python -m ...train`` entry) at data=2 x
    model=2 (gpt_lm, fused LN, chunked loss) and fsdp=2 x model=2
    (bert_pretrain): every model rank of a data shard reads that shard's
    rows, and the steps are one process's on the global batches."""
    want = tp["runners"][workload]
    mesh = [2, 1, 2] if workload == "gpt_lm" else [1, 2, 2]
    for rank in tp["ranks"]:
        assert rank[f"runner/{workload}/mesh"].tolist() == mesh
        np.testing.assert_allclose(rank[f"runner/{workload}/losses"], want["losses"],
                                   **LOSS_TOL)
    head = f"runner/{workload}/whole/model/"
    got = {k[len(head):]: v for k, v in tp["ranks"][0].items() if k.startswith(head)}
    _assert_updates_close(got, want["state"], want["init"], want["cfg"])
