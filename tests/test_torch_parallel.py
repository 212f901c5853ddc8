"""The port's mesh, cluster, collectives, sharding and divergence checks
(``distributed_tensorflow_tpu_torch/parallel``, ``utils/multihost.py``).

In this process: ``MeshSpec`` resolves and refuses as the JAX package's
does (the cases of ``tests/test_mesh.py``), a single process with none of
torchrun's variables starts no process group (``tests/test_cluster.py::
test_single_process_no_init``) and its one-device mesh makes every
collective the identity. In one job of two processes over gloo
(``tests/torch_dp_worker.py``): every verb against numpy (as
``tests/test_collectives.py``), the gradient of the differentiable
all-reduce and of reduce-scatter, the divergence check catching a rank
that differs, ``broadcast_from_chief``, ``replicate``, the batch rows of
each rank, the DeviceMesh's six axis names and the refusals of what is
not ported (a tensor-parallel spec, an fsdp mesh, the collectives').
Everything here is exact (small integers in f32).
"""

import os
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu_torch.parallel import cluster, collectives as col
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel.sharding import local_rows, shard_host_batch
from distributed_tensorflow_tpu_torch.utils import multihost

sys.path.insert(0, os.path.dirname(__file__))
import torch_dp_worker as worker  # noqa: E402


def test_axis_names_and_batch_axes_are_the_jax_packages():
    assert tmesh.AXIS_NAMES == jmesh.AXIS_NAMES
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES


@pytest.mark.parametrize("spec,n", [
    (dict(data=-1), 8), (dict(data=-1, model=2), 8), (dict(pipe=2, data=-1, model=2), 8),
    (dict(data=4, fsdp=2), 8), (dict(data=2, dcn_data=2), 2)])
def test_mesh_spec_resolves_as_jax(spec, n):
    got = tmesh.MeshSpec(**spec).resolve(n)
    want = jmesh.MeshSpec(**spec).resolve(n)
    assert got.sizes() == want.sizes() and got.num_slices == want.num_slices


@pytest.mark.parametrize("spec,n,match", [
    (dict(data=-1, model=3), 8, "not divisible"),
    (dict(data=-1, model=-1), 8, "At most one"),
    (dict(data=2, model=2), 8, "needs 4 devices"),
    (dict(data=3, dcn_data=2), 3, "DCN factor"),
])
def test_mesh_spec_errors(spec, n, match):
    with pytest.raises(ValueError, match=match):
        tmesh.MeshSpec(**spec).resolve(n)
    with pytest.raises(ValueError, match=match):
        jmesh.MeshSpec(**spec).resolve(n)


def test_mesh_spec_from_dict_and_rescale_for_world():
    assert tmesh.MeshSpec.from_dict({"data": 2, "model": 4}).sizes()["model"] == 4
    with pytest.raises(ValueError, match="Unknown mesh axes"):
        tmesh.MeshSpec.from_dict({"tensor": 2})
    for spec, old, new in [(dict(data=-1), 4, 2), (dict(data=4), 4, 2),
                           (dict(data=2, fsdp=4), 2, 4)]:
        got = tmesh.rescale_for_world(tmesh.MeshSpec(**spec), old, new)
        assert got.sizes() == jmesh.rescale_for_world(jmesh.MeshSpec(**spec), old, new).sizes()
    with pytest.raises(ValueError, match="neither batch axis"):
        tmesh.rescale_for_world(tmesh.MeshSpec(data=3), 2, 3)


def test_single_process_no_init(monkeypatch):
    """No torchrun variables, no coordinator: no process group, a
    one-device mesh, every collective the identity, the chief alone."""
    import torch.distributed as dist

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    dev = cluster.initialize(cluster.ClusterConfig(), "cpu")
    assert dev == torch.device("cpu") and not dist.is_initialized()
    assert cluster.process_index() == 0 and cluster.process_count() == 1 and cluster.is_chief()
    cluster.sync_hosts()
    mesh = tmesh.build_mesh(device="cpu")
    assert mesh.size == 1 and mesh.device_mesh is None and mesh.group("data") is None
    assert tmesh.describe(mesh) == "pipe=1 data=1 fsdp=1 seq=1 expert=1 model=1 (1 devices, cpu)"
    x = torch.arange(6.0).reshape(2, 3)
    for got in (col.all_reduce(x, "data", mesh), col.all_reduce_mean(x, tmesh.BATCH_AXES, mesh),
                col.all_gather(x, "data", mesh), col.reduce_scatter(x, "data", mesh),
                col.broadcast(x, "data", mesh)):
        assert torch.equal(got, x)
    assert col.barrier("data", mesh) == 1 and col.axis_index("data", mesh) == 0
    assert local_rows(8, mesh) == slice(0, 8)
    batch = {"image": np.zeros((8, 2)), "label": np.arange(8)}
    assert shard_host_batch(batch, mesh)["label"].tolist() == list(range(8))
    multihost.assert_same_across_hosts({"step": 1})  # no-op alone
    assert multihost.broadcast_from_chief({"run": "a"}) == {"run": "a"}


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cluster.initialize()
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.build_mesh()


def test_data_parallel_gpt_lm_needs_equal_token_counts():
    """Over a data axis of 2 the step averages the ranks' mean losses,
    the global mean only when every rank scores the same token count: a
    stream that may pad is refused, and so is a batch with an
    attention_mask (the data-parallel parity is tests/test_torch_dp_gpt.py)."""
    import dataclasses

    from distributed_tensorflow_tpu_torch.workloads import gpt_lm
    from distributed_tensorflow_tpu_torch.utils import config as tconfig
    from test_torch_train_workload import TINY

    cfg = tconfig.apply_overrides(gpt_lm.default_config(), TINY)
    mesh = tmesh.Mesh(dict(tmesh.MeshSpec(data=2).sizes()), torch.device("cpu"))
    parts = gpt_lm.build(cfg, torch.device("cpu"), mesh)
    ids = torch.zeros(2, 32, dtype=torch.long)
    with pytest.raises(ValueError, match="unequal token counts"):
        parts.loss_fn({"input_ids": ids, "attention_mask": torch.ones_like(ids)})
    assert torch.isfinite(parts.loss_fn({"input_ids": ids})[0])
    bad = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic_mlm"))
    with pytest.raises(ValueError, match="unpadded LM stream"):
        gpt_lm.build(bad, torch.device("cpu"), mesh)


def test_explicit_coordinator_needs_the_process_count_and_id():
    with pytest.raises(ValueError, match="num_processes and process_id"):
        cluster.initialize(cluster.ClusterConfig(coordinator_address="localhost:1"), "cpu")


def test_fingerprint_and_divergence_switch(monkeypatch):
    fp = multihost._fingerprint
    a = {"step": 3, "loss": torch.tensor(1.5), "ids": [1, 2]}
    assert np.array_equal(fp(a), fp({"ids": [1, 2], "loss": torch.tensor(1.5), "step": 3}))
    assert not np.array_equal(fp(a), fp(dict(a, step=4)))
    monkeypatch.setenv("DTF_TPU_CHECK_DIVERGENCE", "1")
    assert multihost.divergence_checks_enabled()
    monkeypatch.setenv("DTF_TPU_CHECK_DIVERGENCE", "0")
    assert not multihost.divergence_checks_enabled()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("parallel"))
    return worker.wait(worker.launch({"job": "parallel", "device": "cpu", "out": out}), out,
                       timeout=120)


def _xs(ranks):
    return [r["x"] for r in ranks]


def test_all_reduce_sum_and_mean(ranks):
    x0, x1 = _xs(ranks)
    for r in ranks:
        np.testing.assert_array_equal(r["sum"], x0 + x1)
        np.testing.assert_array_equal(r["sum_batch_axes"], x0 + x1)  # fsdp is 1
        np.testing.assert_array_equal(r["mean"], (x0 + x1) / 2)
        np.testing.assert_array_equal(r["x_after"], r["x"])  # inputs left as they were


def test_all_gather_tiles_in_rank_order(ranks):
    x0, x1 = _xs(ranks)
    for r in ranks:
        np.testing.assert_array_equal(r["gather0"], np.concatenate([x0, x1], 0))
        np.testing.assert_array_equal(r["gather1"], np.concatenate([x0, x1], 1))


def test_reduce_scatter_keeps_each_ranks_slice(ranks):
    s = sum(_xs(ranks))
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["scatter0"], np.split(s, 2, 0)[i])
        np.testing.assert_array_equal(r["scatter1"], np.split(s, 2, 1)[i])


def test_broadcast_barrier_index_size_and_rows(ranks):
    x1 = ranks[1]["x"]
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["bcast1"], x1)
        np.testing.assert_array_equal(r["model_identity"], r["x"])  # a size-1 axis
        assert int(r["barrier"]) == 2 and int(r["index"]) == i and int(r["size"]) == 2
        assert r["rows"].tolist() == [4 * i, 4 * i + 4]
        assert r["dim_names"].tolist() == list(tmesh.AXIS_NAMES)


def test_all_reduce_gradient_is_the_summed_cotangent(ranks):
    c = sum(r["c"] for r in ranks)
    for r in ranks:
        np.testing.assert_array_equal(r["grad"], c)
        # reduce_scatter's transpose: rank j's cotangent (j + 1) lands on its rows
        np.testing.assert_array_equal(r["scatter_grad"], np.repeat([[1.0], [2.0]], 4, 1))


def test_divergence_check_broadcast_from_chief_and_replicate(ranks):
    for r in ranks:
        assert bool(r["divergence_caught"])
        assert str(r["chief_run_id"]) == "run-0"
        np.testing.assert_array_equal(r["replicated"], [5.0] * 6 + [0.0] * 2)


def test_mesh_refuses_other_axes_and_collectives_not_ported(ranks):
    """fsdp and tensor-parallel specs, an fsdp mesh, a seq mesh with its
    verbs and a pipe mesh with its stage specs are admitted now: an expert
    spec, an expert axis, a multislice pipe mesh and the subgroup
    collectives (the all-reduce's, the all-to-all's) name item 6."""
    want = ["item 6", "item 6", "item 6", "item 6", "item 6"]
    for r in ranks:
        for msg, item in zip(r["refusals"].tolist(), want):
            assert item in msg and "ROADMAP" in msg, msg


def _sp_want(xs, r):
    """Each sequence-parallel verb's output and gradient on rank r of two,
    from the ranks' inputs ``xs`` (numpy; the cotangent of an output y is
    arange(y.size) * (rank + 1))."""
    cot = lambda shape, rank: np.arange(np.prod(shape), dtype=np.float32).reshape(  # noqa
        shape) * (rank + 1)
    o = 1 - r
    a2a = lambda rank: np.concatenate([xs[i][:, 2 * rank:2 * rank + 2] for i in (0, 1)])  # noqa
    grad_a2a = np.zeros((2, 4), np.float32)
    for j in (0, 1):  # rank r's chunk j went to rank j, rows 2r..2r+1 of its output
        grad_a2a[:, 2 * j:2 * j + 2] = cot((4, 2), j)[2 * r:2 * r + 2]
    scat_grad = np.concatenate([cot((2, 2), 0), cot((2, 2), 1)], 1)
    return {
        "permute": (xs[o], cot((2, 4), o)),
        "permute_back": (xs[o], cot((2, 4), o)),
        "a2a": (a2a(r), grad_a2a),
        "scatter": (xs[r][:, 2 * r:2 * r + 2], scat_grad),
        "gather": (np.concatenate(xs), cot((4, 4), r)[2 * r:2 * r + 2]),
        "all_gather": (np.concatenate(xs, 1), cot((2, 8), 0)[:, 4 * r:4 * r + 4]
                       + cot((2, 8), 1)[:, 4 * r:4 * r + 4]),
    }


@pytest.mark.parametrize("verb", ["permute", "permute_back", "a2a", "scatter", "gather",
                                  "all_gather"])
def test_sequence_parallel_verbs_and_their_transposes(ranks, verb):
    """On a seq=2 mesh of the two ranks: ``ring_permute`` (either way round:
    the ring of two), the tiled ``all_to_all`` (dim 1 split, dim 0
    gathered; the backward the inverse all-to-all), ``scatter_to_axis``
    (its backward all-gathers the chunks' cotangents),
    ``gather_from_axis`` (its backward keeps this rank's chunk) and
    ``all_gather`` (its backward reduce-scatters), each against numpy,
    and again with the permute emulated (gloo's path on CUDA tensors)."""
    xs = _xs(ranks)
    for r, rank in enumerate(ranks):
        want = _sp_want(xs, r)
        y, g = want[verb]
        np.testing.assert_array_equal(rank[f"sp/{verb}"], y)
        np.testing.assert_array_equal(rank[f"sp/{verb}_grad"], g)
        np.testing.assert_array_equal(rank[f"sp/emulated/{verb}"], y)
        np.testing.assert_array_equal(rank[f"sp/emulated/{verb}_grad"], g)


def test_reduce_from_model_sums_forward_and_passes_the_gradient(ranks):
    """``reduce_from_model``: the all-reduce forward, each rank's own
    cotangent backward (its partial product's gradient once)."""
    xs = _xs(ranks)
    for r in ranks:
        np.testing.assert_array_equal(r["reduce_from_model"], xs[0] + xs[1])
        np.testing.assert_array_equal(r["reduce_from_model_grad"], r["c"])


def test_copy_to_model_is_the_identity_with_a_summed_gradient(ranks):
    c = sum(r["c"] for r in ranks)
    for r in ranks:
        np.testing.assert_array_equal(r["copy_to_model_grad"], c)


def test_all_reduce_max_and_min_over_model(ranks):
    xs = _xs(ranks)
    for r in ranks:
        np.testing.assert_array_equal(r["max"], np.maximum(*xs))
        np.testing.assert_array_equal(r["min"], np.minimum(*xs))


def test_gather_fsdp_gathers_forward_and_reduce_scatters_backward(ranks):
    """``gather_fsdp`` along dim 1 (the gloo all-gather: an all-reduce of
    a zero-filled buffer): the ranks' shards side by side; the backward
    the cotangent summed over the two ranks, each rank its columns."""
    xs = _xs(ranks)
    cot = np.arange(16.0, dtype=np.float32).reshape(2, 8)
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["gather_fsdp"], np.concatenate(xs, 1))
        np.testing.assert_array_equal(r["gather_fsdp_grad"], 2 * cot[:, 4 * i:4 * (i + 1)])
