"""The port's Wide&Deep slice against the JAX package (CPU, f32).

- ``auc_histograms`` / ``auc_from_histograms``: bitwise JAX's, the
  one-class NaN included; ``derive_metrics`` folds them alike.
- ``SyntheticCTR`` batches (also as shard 1 of 2) and CTR records read
  back: bitwise JAX's; ``tools/make_ctr_records_torch.py`` writes the JAX
  tool's bytes from the same TSV.
- The rule table: its matches on the port's names equal JAX's
  ``match_partition_rules`` on the flax tree; the coverage fixture is the
  live model's; unmatched paths and dead rows raise alike.
- ``adagrad``, ``ftrl`` and the ``auto`` multi-optimizer over 5 steps
  against optax and the JAX package's ``ftrl`` (per-group clipping and a
  warmup step at lr 0 included), tolerance ``OPT_TOL``.
- The f32 forward at the default ``WideDeepConfig`` against flax's on the
  same weights (``FWD_TOL``); 5 train steps of the ``auto`` optimizer
  against JAX's ``make_train_step`` (losses and parameters, ``STEP_TOL``),
  the last 3 also from JAX's step-2 state carried across
  (``optimizer_state_from_jax`` of a ``multi_transform`` state).
- ``ctr_eval_fn`` + ``derive_metrics`` against JAX's on the eval stream of
  a ``ctr:`` file with no eval file (``train_auc``), and the runners'
  metric keys alike.
- The runner: ``wide_deep`` trains on the CPU, refuses a checkpoint
  directory at ``model=2`` and the other axes with their ROADMAP items,
  the other workloads refuse ``model=2`` at their placement,
  and at ``model=1`` 2 + 2 steps through a save and restore equal 4
  straight steps bitwise.
- One spawn of four gloo ranks, ``data=2, model=2``
  (``tests/torch_dp_worker.py``'s ``wide_deep`` job), against JAX on a
  2x2 mesh of virtual devices: the three sharded lookups (forward and
  table gradient), 3 steps (losses, the tables reassembled from their
  shards), the same 3 steps under both clips (the step's and the groups':
  norms over the whole tree) and the eval's AUC; the runner's steps on
  the four ranks, and its refusal of ``model=2`` for a workload that
  places nothing there.
"""

import dataclasses
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.data import recsys as jrecsys
from distributed_tensorflow_tpu.models import wide_deep as jwd
from distributed_tensorflow_tpu.ops import embedding as jemb
from distributed_tensorflow_tpu.parallel import MeshSpec as JMeshSpec
from distributed_tensorflow_tpu.parallel import build_mesh as jbuild_mesh
from distributed_tensorflow_tpu.parallel import sharding as jsh
from distributed_tensorflow_tpu.train import evaluation as jeval
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu.train import step as jstep
from distributed_tensorflow_tpu.utils import config as jconfig
from distributed_tensorflow_tpu.utils import metrics as jmetrics
from distributed_tensorflow_tpu.workloads import runner as jrunner
from distributed_tensorflow_tpu.workloads import wide_deep as jwl
from distributed_tensorflow_tpu_torch.data import recsys as trecsys
from distributed_tensorflow_tpu_torch.models import wide_deep as twd
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.train import evaluation as teval
from distributed_tensorflow_tpu_torch.train import optimizers as topt
from distributed_tensorflow_tpu_torch.train import step as tstep
from distributed_tensorflow_tpu_torch.utils import config as tconfig
from distributed_tensorflow_tpu_torch.utils import metrics as tmetrics
from distributed_tensorflow_tpu_torch.weights import (
    optimizer_state_from_jax,
    wide_deep_from_jax,
    wide_deep_state_dict_from_jax,
    wide_deep_to_jax,
)
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.workloads import get as get_workload
from distributed_tensorflow_tpu_torch.workloads import run_workload
from distributed_tensorflow_tpu_torch.workloads import runner as trunner
from distributed_tensorflow_tpu_torch.workloads import wide_deep as twl
from distributed_tensorflow_tpu_torch.workloads.runner import RunConfig as TRunConfig

sys.path.insert(0, os.path.dirname(__file__))
import torch_dp_worker as worker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_TOL = dict(rtol=1e-5, atol=1e-6)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-5, atol=2e-6)
#: the 2x2 job: other summation orders over four ranks
DP_TOL = dict(rtol=5e-5, atol=5e-6)
VOCABS = (64, 32, 16)
GLOBAL = 32
LR = 0.05
#: the 2x2 job's clipped steps: the whole tree's norm is 0.47-0.64 on
#: its batches and each group's 0.10-0.17 after the step's clip, so both bind
CLIP_OPTIONS = dict(clip_grad_norm=0.2, compute_grad_norm=True)
CLIP_GROUP = 0.05
#: the other workloads at a tiny size (tests/test_torch_train_workload.py)
OTHER_TINY = {
    "gpt_lm": ["--model.num_layers=2", "--model.d_model=64", "--model.num_heads=4",
               "--model.d_ff=128", "--model.vocab_size=256", "--data.vocab_size=256",
               "--model.max_len=32", "--data.seq_len=32", "--model.dtype=float32",
               "--data.global_batch_size=4"],
    "resnet50_imagenet": ["--model.stage_sizes=[1,1]", "--model.width=8",
                          "--model.num_classes=10", "--model.dtype=float32",
                          "--data.image_size=16", "--data.num_classes=10",
                          "--data.global_batch_size=8"],
}
#: the dp22 job's mesh with the batch over fsdp (Queue C's repaired case)
FSDP_MESH = {"data": 1, "fsdp": 2, "model": 2}
TINY = ["--model.vocab_sizes=[64,32,16]", "--model.embed_dim=8", "--model.dense_features=4",
        "--model.hidden_sizes=[32,16]", "--model.dtype=float32",
        "--data.global_batch_size=32", "--train.log_every=1", "--mesh.model=1"]


def _jcfg(**kw):
    base = dict(vocab_sizes=VOCABS, embed_dim=8, dense_features=4, hidden_sizes=(32, 16),
                dtype="float32")
    base.update(kw)
    return jwd.WideDeepConfig(**base)


def _tcfg(jcfg):
    return twd.WideDeepConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _batches(n, seed, cfg=None, b=GLOBAL):
    cfg = cfg or _jcfg()
    data = jrecsys.SyntheticCTR(jrecsys.RecsysConfig(
        vocab_sizes=cfg.vocab_sizes, dense_features=cfg.dense_features,
        global_batch_size=b, seed=seed))
    return [data.batch(i) for i in range(n)]


def _auto_tx(jcfg, lr=LR, **opt):
    return jwl._canonical_tx(jrunner.RunConfig(model=jcfg, optimizer=jopt.OptimizerConfig(
        name="auto", learning_rate=lr, **opt)))


# -- streaming AUC ---------------------------------------------------------------


def test_auc_histograms_and_finalizer_equal_jax_bitwise():
    rng = np.random.default_rng(0)
    logits = np.concatenate([rng.normal(0, 4, 500), [-15.0, 15.0, 14.99, -40.0, 40.0, 0.0],
                             np.linspace(-15, 15, 513)]).astype(np.float32)
    labels = (rng.random(len(logits)) > 0.4).astype(np.float32)
    got = tmetrics.auc_histograms(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jmetrics.auc_histograms(logits, labels)
    for k in ("auc_pos_hist", "auc_neg_hist"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    args = (got["auc_pos_hist"].numpy(), got["auc_neg_hist"].numpy())
    assert tmetrics.auc_from_histograms(*args) == jmetrics.auc_from_histograms(*args)
    one_class = tmetrics.auc_histograms(torch.from_numpy(logits), torch.ones(len(logits)))
    args = (one_class["auc_pos_hist"].numpy(), one_class["auc_neg_hist"].numpy())
    assert np.isnan(tmetrics.auc_from_histograms(*args))
    assert np.isnan(jmetrics.auc_from_histograms(*args))
    totals = {"loss_sum": 3.0, "count": 4.0, "correct": 2.0,
              "auc_pos_hist": got["auc_pos_hist"].numpy().astype(np.float64),
              "auc_neg_hist": got["auc_neg_hist"].numpy().astype(np.float64)}
    assert teval.derive_metrics(totals, "train_") == jeval.derive_metrics(totals, "train_")
    one = {**totals, "auc_pos_hist": args[0], "auc_neg_hist": args[1]}
    assert teval.derive_metrics(one) == jeval.derive_metrics(one)
    assert "auc" not in teval.derive_metrics(one)


# -- the CTR streams -------------------------------------------------------------


@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_synthetic_ctr_batches_equal_jax_bitwise(monkeypatch, shard):
    cfg = jrecsys.RecsysConfig(vocab_sizes=(50, 300, 7), dense_features=5,
                               global_batch_size=64, seed=3)
    if shard is not None:  # JAX's stream as process 1 of 2
        monkeypatch.setattr(jax, "process_index", lambda: shard[0])
        monkeypatch.setattr(jax, "process_count", lambda: shard[1])
    want = jrecsys.SyntheticCTR(cfg, index_offset=5)
    got = trecsys.SyntheticCTR(trecsys.RecsysConfig(**dataclasses.asdict(cfg)), index_offset=5,
                               shard=shard)
    assert got.local_bs == want.local_bs == 64 // (shard or (0, 1))[1]
    for i in (0, 1, 7):
        a, b = got.batch(i), want.batch(i)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), (i, k)


def _record_file(path, n=600, vocabs=(50, 30), dense=4, seed=0):
    r = np.random.RandomState(seed)
    label = (r.rand(n) > 0.5).astype(np.float32)
    dn = r.randn(n, dense).astype(np.float32)
    cat = np.stack([r.randint(-3, v + 20, n) for v in vocabs], -1)  # some out of range
    assert trecsys.make_ctr_record_file(str(path), label, dn, cat) == n
    jpath = str(path) + ".jax"
    jrecsys.make_ctr_record_file(jpath, label, dn, cat)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    return str(path)


@pytest.mark.parametrize("use_native", [False, True])
def test_ctr_records_read_back_equal_jax_bitwise(tmp_path, monkeypatch, use_native):
    from distributed_tensorflow_tpu_torch.runtime import native

    if use_native and not native.available():
        pytest.skip(f"native loader unavailable here: {native.failure}")
    monkeypatch.setattr(native, "available", lambda: use_native)
    path = _record_file(tmp_path / "ctr.dat")
    cfg = jrecsys.RecsysConfig(vocab_sizes=(50, 30), dense_features=4, global_batch_size=100,
                               seed=3)
    want = list(jrecsys.CTRRecordDataset(path, cfg, num_batches=8, index_offset=2,
                                         seed=104))
    got = list(trecsys.CTRRecordDataset(path, trecsys.RecsysConfig(**dataclasses.asdict(cfg)),
                                        num_batches=8, index_offset=2, seed=104))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        for k in ("cat", "dense", "label"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    assert got[0]["cat"].max() <= 49 and got[0]["cat"].min() >= 0
    with pytest.raises(ValueError, match="whole number"):
        trecsys.CTRRecordDataset(path, trecsys.RecsysConfig(vocab_sizes=(50, 30, 2, 2),
                                                            dense_features=4))


def test_ctr_record_converter_writes_the_jax_tools_bytes(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(1)
    lines = []
    for i in range(300):
        dense = [str(int(v)) if v > -1 else "" for v in rng.integers(-2, 50, 13)]
        cat = ["%08x" % int(v) if v % 7 else "" for v in rng.integers(0, 2**32, 26)]
        lines.append("\t".join([str(i % 2)] + dense + cat))
    lines.insert(5, "garbage line")
    tsv = tmp_path / "day.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    outs = {}
    for tool in ("make_ctr_records.py", "make_ctr_records_torch.py"):
        out = str(tmp_path / tool)
        monkeypatch.setattr(sys, "argv", [tool, out, str(tsv), "--vocab-size", "1009"])
        runpy.run_path(os.path.join(REPO, "tools", tool), run_name="__main__")
        outs[tool] = (open(out, "rb").read(), open(out + ".meta.json").read())
    assert "300 records" in capsys.readouterr().out
    assert outs["make_ctr_records.py"] == outs["make_ctr_records_torch.py"]
    assert len(outs["make_ctr_records.py"][0]) == 300 * (4 + 13 * 4 + 26 * 4)


# -- the rule table --------------------------------------------------------------


def _flax_path(port_name):
    return tsh.param_path(port_name).replace("/weight", "/kernel")


def test_rule_matches_on_port_names_equal_jax_on_the_flax_tree():
    jcfg = jwd.WideDeepConfig()
    params, _ = jax.eval_shape(jwd.make_init_fn(jcfg), jax.random.PRNGKey(0))
    jspecs = {jsh._path_str(p): s for p, s in
              jax.tree_util.tree_leaves_with_path(
                  jsh.match_partition_rules(jwd.WIDE_DEEP_RULES, params),
                  is_leaf=lambda x: isinstance(x, P))}
    model = twd.WideDeep(_tcfg(jcfg), device="meta")
    tspecs = tsh.match_partition_rules(twd.WIDE_DEEP_RULES, model)
    assert len(tspecs) == len(jspecs)
    for name, spec in tspecs.items():
        assert tuple(jspecs[_flax_path(name)]) == spec, name
    jm = jsh.attribute_partition_rules(jwd.WIDE_DEEP_RULES, params)
    tm = tsh.attribute_partition_rules(twd.WIDE_DEEP_RULES, model)
    assert ({_flax_path(m.path): m.rule_index for m in tm}
            == {m.path: m.rule_index for m in jm})
    # the coverage fixture is the live model's
    assert sorted(tsh.param_path(n) for n, _ in model.named_parameters()) == sorted(
        twd._WIDE_DEEP_COVERAGE)
    assert twd.embedding_rules() == [(p, tuple(s)) for p, s in jwd.embedding_rules()]
    assert tsh.format_attribution(twd.WIDE_DEEP_RULES, tm).count("\n") == len(tm)


def test_coverage_and_dead_rule_errors_are_raised_alike():
    rows_j = ((r"(^|/)table_\d+$", P("model", None)), (r"^nothing$", P()))
    rows_t = ((r"(^|/)table_\d+$", ("model", None)), (r"^nothing$", ()))
    paths = ["table_0", "deep_0/kernel"]
    with pytest.raises(jsh.PartitionCoverageError) as je:
        jsh.partition_rules("t", rows_j, coverage=paths)
    with pytest.raises(tsh.PartitionCoverageError) as te:
        tsh.partition_rules("t", rows_t, coverage=paths)
    for e in (je, te):
        assert "1 unmatched param(s), 1 dead rule(s)" in str(e.value)
        assert "deep_0/kernel  <-  UNMATCHED" in str(e.value)
    table_j = jsh.partition_rules("t", rows_j)
    table_t = tsh.partition_rules("t", rows_t)
    with pytest.raises(jsh.PartitionCoverageError, match="does not cover"):
        jsh.match_partition_rules(table_j, {"table_0": 0, "deep_0": {"kernel": 0}})
    with pytest.raises(tsh.PartitionCoverageError, match="does not cover"):
        tsh.match_partition_rules(table_t, ["table_0", "deep_0.kernel"])
    with pytest.raises(ValueError, match="does not compile"):
        tsh.partition_rules("bad", (("(", ()),))
    with pytest.raises(ValueError, match="tuple of mesh axis names"):
        tsh.partition_rules("bad", ((".*", "model"),))
    sel = tsh.partition_rules("v", ((r"a", (), "x"), (r"b", ()), (r"c", (), "y"))).select("x")
    assert [r.pattern for r in sel.rows] == ["a", "b"] and sel.name == "v[x]"
    assert sel.as_path_rules() == (("a", ()), ("b", ()))


def test_placement_refuses_what_the_port_cannot_place():
    """fsdp and tensor-parallel specs are placeable now (a dim over one of
    fsdp and model), and a stacked stage leaf's (pipe on its leading dim);
    the MoE axis names item 6, and pipe on another dim, the batch axis, the
    seq axis (no parameter lives on it), two axes on one dim or one axis on
    two dims raise."""
    assert tsh.check_spec(["model", None]) == ("model", None)
    assert tsh.check_spec(("fsdp", None), "w") == ("fsdp", None)
    assert tsh.check_spec((None, "model"), "w") == (None, "model")
    assert tsh.check_spec(("fsdp", "model"), "w") == ("fsdp", "model")
    assert tsh.check_spec(("pipe", None), "w") == ("pipe", None)
    with pytest.raises(ValueError, match="leading"):
        tsh.check_spec((None, "pipe"), "w")
    with pytest.raises(NotImplementedError, match="item 6"):
        tsh.check_spec(("expert", None), "w")
    with pytest.raises(ValueError, match="no parameter is sharded over 'seq'"):
        tsh.check_spec(("seq", None), "w")
    with pytest.raises(ValueError, match="batch axis"):
        tsh.check_spec(("data", None), "w")
    with pytest.raises(NotImplementedError, match="at most one"):
        tsh.check_spec((("fsdp", "model"), None), "w")
    with pytest.raises(NotImplementedError, match="at most one"):
        tsh.check_spec(("model", "model"), "w")


# -- optimizers ------------------------------------------------------------------


def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"table_0": (6, 3), "wide_table_0": (6, 1), "wide_dense.weight": (1, 4),
              "wide_dense.bias": (1,), "deep_0.weight": (5, 4), "deep_0.bias": (5,)}
    params = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 1, s) * (rng.random(s) > 0.3)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    return params, grads


def _port_steps(opt_fn, params, grads):
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = opt_fn(ps)
    for g in grads:
        opt.update([torch.from_numpy(g[k]) for k in ps])
    return {k: p.detach().numpy() for k, p in ps.items()}, opt


def _jax_steps(tx, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, upd)
    return _np(p)


@pytest.mark.parametrize("cfg", [
    dict(name="adagrad", learning_rate=0.1),
    dict(name="adagrad", learning_rate=0.1, weight_decay=0.01, clip_grad_norm=1.0),
    dict(name="ftrl", learning_rate=0.1, l1=0.05, l2=0.01),
    dict(name="ftrl", learning_rate=0.1, lr_power=-0.7, warmup_steps=2, schedule="linear",
         total_steps=5, clip_grad_norm=0.5),
])
def test_adagrad_and_ftrl_match_optax_and_the_jax_ftrl(cfg):
    params, grads = _opt_case()
    want = _jax_steps(jopt.make_optimizer(jopt.OptimizerConfig(**cfg)), params, grads)
    got, opt = _port_steps(lambda ps: topt.make_optimizer(topt.OptimizerConfig(**cfg),
                                                          ps.values()), params, grads)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], **OPT_TOL, err_msg=k)
    assert opt.count == 5
    keys = {"adagrad": ("sum",), "ftrl": ("n", "z")}[cfg["name"]]
    assert opt.state_keys() == keys
    assert all(sorted(st) == sorted(keys) for st in opt.opt.state_dict()["state"].values())


def test_torch_adagrad_would_not_do():
    """The trap the hand-written update avoids: torch's Adagrad starts
    its sum at 0 and divides by sqrt(sum) + eps."""
    params, grads = _opt_case()
    want = _jax_steps(optax.adagrad(0.1, eps=1e-8), params, grads)
    got, _ = _port_steps(lambda ps: topt.make_optimizer(
        topt.OptimizerConfig(name="adagrad", learning_rate=0.1), ps.values()), params, grads)
    lib, _ = _port_steps(lambda ps: topt.make_optimizer(
        topt.OptimizerConfig(name="sgd"), ps.values()), params, [])
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    torch_opt = torch.optim.Adagrad(ps.values(), lr=0.1, eps=1e-8)
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k])
        torch_opt.step()
    k = "deep_0.weight"
    np.testing.assert_allclose(got[k], want[k], **OPT_TOL)
    assert not np.allclose(ps[k].detach().numpy(), want[k], **OPT_TOL)
    np.testing.assert_array_equal(lib[k], params[k])


@pytest.mark.parametrize("opt", [dict(), dict(clip_grad_norm=0.3, weight_decay=0.01)])
def test_auto_multi_optimizer_matches_jax_multi_transform(opt):
    params, grads = _opt_case(1)
    jcfg = _jcfg()
    want = _jax_steps(_auto_tx(jcfg, lr=0.1, **opt), params, grads)
    tx = twl._canonical_tx(TRunConfig(model=_tcfg(jcfg), optimizer=topt.OptimizerConfig(
        name="auto", learning_rate=0.1, **opt)))

    class Named:
        def __init__(self, ps):
            self.ps = ps

        def named_parameters(self):
            return self.ps.items()

    got, multi = _port_steps(lambda ps: tx(Named(ps)), params, grads)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], **OPT_TOL, err_msg=k)
    assert multi.labels == ["default", "rule0", "rule0", "rule0", "default", "default"]
    assert multi.param_state_keys()[:2] == [("sum",), ("n", "z")]
    assert multi.count == 5
    sd = multi.opt.state_dict()["state"]
    assert sorted(sd) == list(range(6)) and sorted(sd[1]) == ["n", "z"]
    multi.opt.load_state_dict({"state": {i: {k: v * 0 + 1 for k, v in st.items()}
                                         for i, st in sd.items()}})
    assert float(multi.opt.state_dict()["state"][1]["z"].sum()) == 6.0


def test_make_multi_optimizer_first_match_wins_and_default():
    ps = [("a.weight", torch.nn.Parameter(torch.zeros(2))),
          ("wide_table_0", torch.nn.Parameter(torch.zeros(2))),
          ("b", torch.nn.Parameter(torch.zeros(2)))]
    sgd = topt.OptimizerConfig(name="sgd", learning_rate=1.0)
    multi = topt.make_multi_optimizer(((r"wide_", sgd), (r"^a/", sgd), (r"table", sgd)),
                                      topt.OptimizerConfig(name="adagrad"), ps)
    assert multi.labels == ["rule1", "rule0", "default"]
    assert sorted(multi.groups) == ["default", "rule0", "rule1"]  # rule2 matched nothing


# -- model and steps -------------------------------------------------------------


def test_default_config_f32_forward_matches_flax():
    jcfg = dataclasses.replace(jwd.WideDeepConfig(), dtype="float32")
    params = _np(jwd.make_init_fn(jcfg)(jax.random.PRNGKey(3))[0])
    rng = np.random.default_rng(0)
    for k in params:  # non-zero wide columns and biases, so every path counts
        if k.startswith("wide_table_"):
            params[k] = rng.normal(0, 0.5, params[k].shape).astype(np.float32)
    b = _batches(1, seed=1, cfg=jcfg, b=64)[0]
    want = np.asarray(jwd.WideDeep(jcfg).apply({"params": params}, b["cat"], b["dense"]))
    model = wide_deep_from_jax(params, _tcfg(jcfg), device="cpu")
    got = model(torch.from_numpy(b["cat"]), torch.from_numpy(b["dense"])).detach().numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    back = wide_deep_to_jax([model.state_dict()], _tcfg(jcfg))
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert twd.flops_per_example(_tcfg(jcfg)) == jwd.flops_per_example(jcfg)


def _jax_train(jcfg, batches, mesh, lr=LR):
    tx = _auto_tx(jcfg, lr)
    model = jwd.WideDeep(jcfg, mesh)
    state, specs = jstep.init_train_state(jwd.make_init_fn(jcfg, mesh), tx, mesh,
                                          jax.random.PRNGKey(0),
                                          param_rules=jwd.WIDE_DEEP_RULES)
    step = jstep.jit_train_step(jstep.make_train_step(jwd.ctr_loss_fn(model), tx), mesh,
                                specs)
    init = _np(state.params)
    losses, states = [], []
    for b in batches:
        b = {k: jax.device_put(v, NamedSharding(mesh, jsh.batch_spec(v.ndim)))
             for k, v in b.items()}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        states.append((_np(state.params), _np(state.opt_state)))
    return init, np.asarray(losses), states, model


def _close_tree(got_sd, want_params, tcfg, tol):
    want = wide_deep_state_dict_from_jax(want_params, tcfg)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got_sd[k]), v.numpy(), **tol, err_msg=k)


def test_five_model1_steps_match_jax_make_train_step(devices):
    jcfg = _jcfg()
    tcfg = _tcfg(jcfg)
    batches = _batches(5, seed=2)
    mesh = jbuild_mesh(JMeshSpec(data=1), devices[:1])
    init, jlosses, jstates, _ = _jax_train(jcfg, batches, mesh)
    sd = {k: v.numpy() for k, v in wide_deep_state_dict_from_jax(init, tcfg).items()}
    res = worker.wide_deep_steps(tcfg, sd, batches, dict(name="auto", learning_rate=LR),
                                 torch.device("cpu"))
    np.testing.assert_allclose(res["losses"], jlosses, **STEP_TOL)
    assert jlosses[-1] < jlosses[0]
    _close_tree(res["state"], jstates[-1][0], tcfg, STEP_TOL)
    moved = max(float(np.abs(jstates[-1][0][k] - init[k]).max()) for k in init
                if k.startswith("wide_table"))
    assert moved > 1e-3  # FTRL moved the wide columns
    # JAX's step-2 state (params and the multi_transform state) carried
    # across: the port's steps 3-5 continue JAX's
    model = wide_deep_from_jax(jstates[1][0], tcfg, device="cpu")
    opt = twl._canonical_tx(TRunConfig(model=tcfg, optimizer=topt.OptimizerConfig(
        name="auto", learning_rate=LR)))(model)
    optimizer_state_from_jax(jstates[1][1], model, opt)
    assert opt.count == 2
    state = tstep.init_train_state(model, opt)
    state.step = 2
    step = tstep.make_train_step(twd.ctr_loss_fn(model))
    losses = []
    for b in batches[2:]:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses[2:], **STEP_TOL)
    _close_tree(model.state_dict(), jstates[-1][0], tcfg, STEP_TOL)


def test_ctr_eval_and_train_auc_prefix_match_jax(tmp_path, devices):
    path = _record_file(tmp_path / "ctr.dat", n=512, vocabs=VOCABS, dense=4)
    jcfg = _jcfg()
    tcfg = _tcfg(jcfg)
    over = [f"--data.dataset=ctr:{path}", "--data.global_batch_size=64",
            "--model.vocab_sizes=[64,32,16]", "--model.dense_features=4",
            "--model.embed_dim=8", "--model.hidden_sizes=[32,16]", "--model.dtype=float32",
            "--train.num_steps=2", "--train.log_every=1", "--train.eval_batches=2"]
    jax_cfg = jconfig.apply_overrides(jwl.default_config(),
                                      over + ["--mesh.data=-1", "--mesh.model=1"])
    jres = jrunner.run(jax_cfg, jwl.build)
    tres = run_workload("wide_deep", over, device="cpu")
    assert sorted(tres.eval_metrics) == sorted(jres.eval_metrics)
    assert "train_auc" in tres.eval_metrics and "auc" not in tres.eval_metrics
    # the same eval batches, and the same totals on the same weights
    rcfg = jwl._recsys_cfg(jax_cfg)
    jbatches = list(jwl._eval_dataset_fn(jax_cfg, rcfg)[0](2))
    tres_cfg = tconfig.apply_overrides(twl.default_config(), over)
    tparts = twl.build(tres_cfg, torch.device("cpu"))
    tbatches = list(tparts.eval_dataset_fn(2))
    assert tres_cfg.data.dataset == jax_cfg.data.dataset
    for a, b in zip(tbatches, jbatches):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
    params = _np(jres.state.params)
    jfn = jax.jit(jwd.ctr_eval_fn(jwd.WideDeep(jcfg)))
    jtot, ttot = {}, {}
    model = wide_deep_from_jax(params, tcfg, device="cpu")
    tfn = twd.ctr_eval_fn(model)
    for b in jbatches:
        for k, v in jfn(params, {}, b).items():
            jtot[k] = jtot.get(k, 0.0) + np.asarray(v, np.float64)
        for k, v in tfn({k: torch.from_numpy(x) for k, x in b.items()}).items():
            ttot[k] = ttot.get(k, 0.0) + np.asarray(v.numpy(), np.float64)
    for k in ("correct", "count", "auc_pos_hist", "auc_neg_hist"):
        np.testing.assert_array_equal(ttot[k], jtot[k], err_msg=k)
    np.testing.assert_allclose(ttot["loss_sum"], jtot["loss_sum"], rtol=1e-6)
    got, want = teval.derive_metrics(ttot, "train_"), jeval.derive_metrics(jtot, "train_")
    assert sorted(got) == sorted(want)
    assert got["train_auc"] == want["train_auc"]


# -- the runner ------------------------------------------------------------------


def test_run_workload_trains_wide_deep_on_the_cpu():
    res = run_workload("wide_deep", TINY + ["--train.num_steps=40", "--train.eval_batches=4",
                                            "--optimizer.learning_rate=0.01"], device="cpu")
    losses = [r["loss"] for r in res.history]
    assert res.state.step == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert 0.5 < res.eval_metrics["auc"] <= 1.0
    assert isinstance(res.state.optimizer, topt.MultiOptimizer)


@pytest.mark.parametrize("override,match", [
    # admitted now (the sharded save; fsdp as a batch axis, the dp22 job):
    # one process is sent to torchrun; a seq axis would only repeat work
    ("--checkpoint.directory=/tmp/never", "spans more than one process.*torchrun"),
    ("--mesh.fsdp=2", "spans more than one process.*torchrun"),
    ("--mesh.seq=2", "no attention.*repeat"),
    ("--mesh.expert=2", "item 6"),
    ("--mesh.pipe=2", "item 6"),
    ("--data.eval_dataset=npz:/nonexistent.npz", "eval_dataset"),
    ("--fleet.dir=/tmp/fleet", "item 6"),
])
def test_wide_deep_refusals_name_their_roadmap_item(override, match):
    model2 = [] if override.startswith("--mesh") else ["--mesh.model=2"]
    over = TINY + ["--train.num_steps=1"] + model2 + [override]
    if override.startswith(("--data", "--optimizer")):
        over = TINY + ["--train.num_steps=1", override]
    with pytest.raises((ValueError, NotImplementedError), match=match):
        run_workload("wide_deep", over, device="cpu")


@pytest.mark.parametrize("workload", ["gpt_lm", "resnet50_imagenet"])
def test_other_workloads_refuse_the_model_axis(workload):
    """resnet's parts place nothing on ``model`` and do not ask for
    ``fsdp``: the runner's spec step refuses a model axis of 2 (here on a
    mesh of that shape, before any collective; the four-rank job below
    refuses it end to end) and keeps every parameter replicated at an fsdp
    axis of 2, which splits only its batch. gpt_lm shards over both now
    (megatron, ``auto_fsdp_specs``): its specs pass. One process is sent
    to torchrun first either way."""
    mod = get_workload(workload)
    cfg = tconfig.apply_overrides(mod.default_config(), OTHER_TINY[workload])
    parts = mod.build(cfg, torch.device("cpu"), tmesh.build_mesh(device="cpu"))
    cpu = torch.device("cpu")
    model2 = tmesh.Mesh(dict(tmesh.MeshSpec(data=1, model=2).sizes()), cpu)
    fsdp2 = tmesh.Mesh(dict(tmesh.MeshSpec(data=1, fsdp=2).sizes()), cpu)
    if workload == "gpt_lm":
        specs = trunner.param_specs(cfg, parts, model2)
        assert specs["layers.0.mlp_in.weight"] == ("model", None)
        assert specs["layers.0.mlp_out.weight"] == (None, "model")
        assert specs["tok_embed.weight"] == ("model", None)
        assert trunner.param_specs(cfg, parts, fsdp2) is specs
    else:
        with pytest.raises(ValueError, match="places nothing on the model axis"):
            trunner.prepare(cfg, parts, model2)
        specs = trunner.param_specs(cfg, parts, fsdp2)
        assert specs and all(s == () for s in specs.values())
    with pytest.raises(ValueError, match="torchrun"):
        run_workload(workload, ["--mesh.model=2"], device="cpu")


def test_model1_save_restore_equals_straight_steps_bitwise(tmp_path):
    over = TINY + ["--train.eval_batches=0"]
    straight = run_workload("wide_deep", over + ["--train.num_steps=4"], device="cpu")
    d = f"--checkpoint.directory={tmp_path}/ck"
    run_workload("wide_deep", over + ["--train.num_steps=2", d], device="cpu")
    resumed = run_workload("wide_deep", over + ["--train.num_steps=4", d], device="cpu")
    assert [r["step"] for r in resumed.history] == [3, 4]
    assert [r["loss"] for r in resumed.history] == [r["loss"] for r in straight.history[2:]]
    a, b = straight.state, resumed.state
    for (k, x), (_, y) in zip(tstep.state_leaves(a), tstep.state_leaves(b)):
        assert torch.equal(x, y), k
    names = [k for k, _ in tstep.state_leaves(b)]
    assert "optimizer/0/sum" in names and "optimizer/5/n" in names and "optimizer/5/z" in names


# -- four gloo ranks, data=2 x model=2, against JAX's 2x2 mesh ------------------


def _jax_lookups(ids, table, cot, mesh):
    tmod = jemb.to_mod_sharded(jnp.asarray(table), mesh)

    def grad_of(fn, t):
        return jax.jit(jax.value_and_grad(lambda t: (fn(ids, t) * cot).sum()))(t)

    out = {}
    for name, fn, t in (("mod", jemb.make_sharded_lookup(mesh), tmod),
                        ("range", jemb.make_range_sharded_lookup(mesh), jnp.asarray(table))):
        y = jax.jit(fn)(ids, t)
        out[name] = (np.asarray(y), np.asarray(grad_of(fn, t)[1]))
    both = P(("data", "model"))
    bfn = lambda i, t: jax.shard_map(  # noqa: E731
        lambda i, t: jemb.batch_sharded_lookup(i, t, "model"), mesh=mesh,
        in_specs=(both, P("model", None)), out_specs=P(("data", "model"), None),
        check_vma=False)(i, t)
    out["batch"] = (np.asarray(jax.jit(bfn)(ids, tmod)), np.asarray(grad_of(bfn, tmod)[1]))
    return out


@pytest.fixture(scope="module")
def dp22(tmp_path_factory, devices):
    out = str(tmp_path_factory.mktemp("wide_deep_22"))
    rng = np.random.default_rng(9)
    V, D = 23, 4  # 23 rows: the shards are padded
    look = {"ids": rng.integers(0, V, 16).astype(np.int64),
            "table": rng.normal(0, 1, (V, D)).astype(np.float32),
            "cot": rng.normal(0, 1, (16, D)).astype(np.float32)}
    np.savez(os.path.join(out, "look.npz"), **look)
    jcfg = _jcfg()
    tcfg = _tcfg(jcfg)
    mesh = jbuild_mesh(JMeshSpec(data=2, model=2), devices[:4])
    train, evals = _batches(3, seed=5), _batches(2, seed=6)
    params = _np(jwd.make_init_fn(jcfg, mesh)(jax.random.PRNGKey(0))[0])
    sd = {k: v.numpy() for k, v in wide_deep_state_dict_from_jax(params, tcfg).items()}
    inputs = os.path.join(out, "inputs.npz")
    np.savez(inputs, **{f"sd/{k}": v for k, v in sd.items()},
             **{f"train{i}/{k}": v for i, b in enumerate(train) for k, v in b.items()},
             **{f"eval{i}/{k}": v for i, b in enumerate(evals) for k, v in b.items()})
    ckpt = os.path.join(out, "ck")
    runner = TINY[:-1] + ["--mesh.model=2", "--mesh.data=2", "--train.num_steps=3",
                          "--train.eval_batches=1", "--optimizer.learning_rate=0.05",
                          f"--checkpoint.directory={ckpt}"]
    procs = worker.launch({"job": "wide_deep", "device": "cpu", "out": out,
                           "mesh": {"data": 2, "model": 2},
                           "lookups": os.path.join(out, "look.npz"), "inputs": inputs,
                           "cfg": dataclasses.asdict(tcfg),
                           "optimizer": dict(name="auto", learning_rate=LR),
                           "clip": {"options": CLIP_OPTIONS,
                                    "optimizer": dict(name="auto", learning_rate=LR,
                                                      clip_grad_norm=CLIP_GROUP)},
                           "runner": runner,
                           "fsdp_mesh": FSDP_MESH,
                           "refuse": {"resnet50_imagenet": OTHER_TINY["resnet50_imagenet"]
                                      + ["--mesh.model=2", "--mesh.data=2",
                                         "--train.num_steps=1"]}},
                          world=4)
    try:
        jlook = _jax_lookups(look["ids"], look["table"], look["cot"], mesh)
        _, jlosses, jstates, jmodel = _jax_train_from(params, jcfg, train, mesh)
        fmesh = jbuild_mesh(JMeshSpec(**FSDP_MESH), devices[:4])
        _, jflosses, jfstates, _ = _jax_train_from(params, jcfg, train, fmesh)
        jclip = _jax_train_from(params, jcfg, train, mesh, CLIP_OPTIONS,
                                clip_grad_norm=CLIP_GROUP)
        jfn = jax.jit(jwd.ctr_eval_fn(jmodel))
        jtot = {}
        for b in evals:
            b = {k: jax.device_put(v, NamedSharding(mesh, jsh.batch_spec(v.ndim)))
                 for k, v in b.items()}
            for k, v in jfn(jstates[-1], {}, b).items():
                jtot[k] = jtot.get(k, 0.0) + np.asarray(v, np.float64)
    except BaseException:
        worker.stop(procs)
        raise
    return {"ranks": worker.wait(procs, out, timeout=300), "look": look, "jlook": jlook,
            "ckpt": ckpt,
            "jlosses": jlosses, "jparams": jstates[-1], "jtot": jtot, "tcfg": tcfg,
            "jfsdp": (jflosses, jfstates[-1]),
            "init": params, "jclip": jclip}


def _jax_train_from(params, jcfg, batches, mesh, options=None, **opt):
    """JAX's 2x2 steps from ``params`` (the auto optimizer at ``opt``, the
    step's ``StepOptions(**options)``)."""
    tx = _auto_tx(jcfg, **opt)
    model = jwd.WideDeep(jcfg, mesh)
    _, specs = jstep.init_train_state(jwd.make_init_fn(jcfg, mesh), tx, mesh,
                                      jax.random.PRNGKey(0), param_rules=jwd.WIDE_DEEP_RULES)
    p = jax.tree.map(jnp.asarray, params)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tx.init(p),
                             model_state={}, rng=jax.random.PRNGKey(0))
    state = jax.device_put(state, jsh.tree_shardings(mesh, specs))
    step = jstep.jit_train_step(jstep.make_train_step(
        jwd.ctr_loss_fn(model), tx, jstep.StepOptions(**(options or {}))), mesh, specs)
    losses, states, norms = [], [], []
    for b in batches:
        b = {k: jax.device_put(v, NamedSharding(mesh, jsh.batch_spec(v.ndim)))
             for k, v in b.items()}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m.get("grad_norm", np.nan)))
        states.append(_np(state.params))
    return np.asarray(norms), np.asarray(losses), states, model


def _rank_rows(n_rows, rank, world):
    per = n_rows // world
    return slice(rank * per, (rank + 1) * per)


def test_dp22_lookups_and_table_gradients_match_jax(dp22):
    ranks, jl = dp22["ranks"], dp22["jlook"]
    V = dp22["look"]["table"].shape[0]
    rows = -(-V // 2)
    for name in ("mod", "range", "batch"):
        jout, jgrad = jl[name]
        for r, rank in enumerate(ranks):
            d, m = divmod(r, 2)
            want = jout[_rank_rows(16, r, 4)] if name == "batch" else jout[_rank_rows(16, d, 2)]
            np.testing.assert_allclose(rank[f"lookup/{name}/out"], want, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} rank {r}")
            g = rank[f"lookup/{name}/grad"]
            if name == "range":  # JAX's gradient is of the [V, D] table, unpadded
                want_g = np.concatenate([jgrad, np.zeros((2 * rows - V, jgrad.shape[1]),
                                                         np.float32)])[m * rows:(m + 1) * rows]
            else:  # the mod-sharded global array: shard m is rows [m*rows, (m+1)*rows)
                want_g = jgrad[m * rows:(m + 1) * rows]
            # exactly once: a model-fold backward would double it
            np.testing.assert_allclose(g, want_g, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} grad rank {r}")
        assert float(np.abs(jgrad).max()) > 0.1


def test_dp22_three_steps_match_the_jax_2x2_mesh(dp22):
    ranks, tcfg = dp22["ranks"], dp22["tcfg"]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], dp22["jlosses"], **DP_TOL)
    sds = [{k[len("state/"):]: v for k, v in r.items() if k.startswith("state/")}
           for r in ranks]
    # the data shards' copies agree, and the model ranks' replicated weights
    for k in sds[0]:
        np.testing.assert_array_equal(sds[0][k], sds[2][k], err_msg=k)
        if "table_" not in k:
            np.testing.assert_array_equal(sds[0][k], sds[1][k], err_msg=k)
    got = wide_deep_to_jax(sds[:2], tcfg)
    moved = 0.0
    for k, want in dp22["jparams"].items():
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **DP_TOL, err_msg=k),
                     got[k], want)
        moved = max(moved, max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                               for a, b in zip(jax.tree.leaves(want),
                                               jax.tree.leaves(dp22["init"][k]))))
    assert moved > 1e-3


def test_dp22_eval_auc_matches_jax(dp22):
    jtot = dp22["jtot"]
    want = jeval.derive_metrics(jtot)
    for rank in dp22["ranks"]:
        tot = {k[len("eval/"):]: v for k, v in rank.items() if k.startswith("eval/")}
        assert tot["count"] == jtot["count"] == 2 * GLOBAL
        got = teval.derive_metrics(tot)
        assert abs(got["auc"] - want["auc"]) <= 2e-3, (got["auc"], want["auc"])
        np.testing.assert_allclose(got["loss"], want["loss"], **DP_TOL)


def test_dp22_runner_ranks_of_a_data_shard_feed_the_same_rows(dp22):
    ranks = dp22["ranks"]
    losses = [r["runner/losses"] for r in ranks]
    assert all(int(r["runner/mesh_model"]) == 2 for r in ranks)
    for l_ in losses[1:]:
        np.testing.assert_array_equal(l_, losses[0])  # the loss is global
    for k in (k for k in ranks[0] if k.startswith("runner/state/") and "table_" not in k):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    assert np.isfinite(float(ranks[0]["runner/eval/auc"]))


def test_dp22_clipped_steps_match_the_jax_2x2_mesh(dp22):
    """``train.clip_grad_norm`` and the groups' ``optimizer.clip_grad_norm``
    at model=2: each norm is the whole tree's (the table shards' squares
    summed over ``model``), so the model ranks clip alike and match JAX's
    norms over its sharded arrays."""
    ranks, tcfg = dp22["ranks"], dp22["tcfg"]
    jnorms, jlosses, jstates, _ = dp22["jclip"]
    assert (jnorms > CLIP_OPTIONS["clip_grad_norm"]).all()  # the step's clip binds
    for rank in ranks:
        np.testing.assert_allclose(rank["clip/grad_norms"], jnorms, **DP_TOL)
        np.testing.assert_allclose(rank["clip/losses"], jlosses, **DP_TOL)
    sds = [{k[len("clip/state/"):]: v for k, v in r.items() if k.startswith("clip/state/")}
           for r in ranks]
    for k in sds[0]:
        np.testing.assert_array_equal(sds[0][k], sds[2][k], err_msg=k)
        if "table_" not in k:  # the model ranks' replicated weights
            np.testing.assert_array_equal(sds[0][k], sds[1][k], err_msg=k)
    got = wide_deep_to_jax(sds[:2], tcfg)
    for k, want in jstates[-1].items():
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **DP_TOL, err_msg=k),
                     got[k], want)
    # the clips changed the steps
    assert np.abs(jlosses[1:] - dp22["jlosses"][1:]).max() > 1e-4


def test_dp22_resnet_refuses_the_model_axis_on_four_ranks(dp22):
    for rank in dp22["ranks"]:
        msg = str(rank["refused/resnet50_imagenet"])
        assert "places nothing on the model axis" in msg and "no rule table" in msg, msg


def test_dp22_wide_deep_refuses_fsdp_on_four_ranks(dp22):
    """wide_deep's parts do not ask for fsdp (the JAX package's do not),
    which only keeps its parameters off fsdp: at data=1 x fsdp=2 x model=2
    the batch rides fsdp and the tables model, and three steps match JAX's
    ``init_train_state`` and steps on the same mesh (the tolerance of
    ``test_dp22_three_steps_match_the_jax_2x2_mesh``). No rank refuses it."""
    ranks, tcfg = dp22["ranks"], dp22["tcfg"]
    jlosses, jparams = dp22["jfsdp"]
    assert all("refused/wide_deep" not in r for r in ranks)
    for rank in ranks:
        np.testing.assert_allclose(rank["fsdp/losses"], jlosses, **DP_TOL)
    sds = [{k[len("fsdp/state/"):]: v for k, v in r.items() if k.startswith("fsdp/state/")}
           for r in ranks]
    for k in sds[0]:  # the fsdp ranks' copies agree, and the replicated weights
        np.testing.assert_array_equal(sds[0][k], sds[2][k], err_msg=k)
        if "table_" not in k:
            np.testing.assert_array_equal(sds[0][k], sds[1][k], err_msg=k)
    got = wide_deep_to_jax(sds[:2], tcfg)
    for k, want in jparams.items():
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **DP_TOL, err_msg=k),
                     got[k], want)
    # the same global batches as the data=2 x model=2 steps: the same steps
    np.testing.assert_allclose(jlosses, dp22["jlosses"], **DP_TOL)


def test_dp22_sharded_save_restores_bitwise_in_one_process_and_at_the_mesh(dp22, tmp_path):
    """The runner at data=2 x model=2 saved its final step with the tables
    gathered whole by the chief: one process restores it (model=1) with
    every parameter bitwise the ranks' reassembled ones and the optimizer
    state whole, and the four ranks resuming from it at their mesh hold
    their shards bitwise (``runner/resumed/``)."""
    ranks, tcfg = dp22["ranks"], dp22["tcfg"]
    over = TINY[:-1] + ["--mesh.model=1", "--train.num_steps=3", "--train.eval_batches=0",
                        "--optimizer.learning_rate=0.05",
                        f"--checkpoint.directory={dp22['ckpt']}"]
    res = run_workload("wide_deep", over, device="cpu")
    assert res.state.step == 3 and res.history == []
    sds = [{k[len("runner/state/"):]: torch.as_tensor(v) for k, v in r.items()
            if k.startswith("runner/state/")} for r in ranks[:2]]
    got = wide_deep_to_jax(sds, tcfg)
    want = wide_deep_to_jax([res.state.model.state_dict()], tcfg)
    for k in want:
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b, err_msg=k), got[k],
                     want[k])
    leaves = dict(tstep.state_leaves(res.state))
    assert leaves["optimizer/0/sum"].shape == (64, 8)  # table_0, whole
    for r in ranks:
        assert int(r["runner/resumed/step"]) == 3
        for k in (k for k in r if k.startswith("runner/state/")):
            np.testing.assert_array_equal(r["runner/resumed/" + k[len("runner/"):]], r[k],
                                          err_msg=k)
