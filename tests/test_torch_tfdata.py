"""The port's tf.data adapter (``data/tfdata.py``) against the JAX
package's, in the setting of ``tests/test_data.py::
test_tfdata_adapter_host_stream``: numpy dict batches at the local batch
size, bitwise the JAX adapter's (in order, resumed by ``start_index``, and
shuffled from a seed); the per-process shard of two posed processes
(``parallel.cluster``'s index and count) is disjoint and covers the data;
a ``host_stream`` drives ``run_workload``'s tiny ResNet on the CPU.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from distributed_tensorflow_tpu.data import tfdata as jtfdata  # noqa: E402
from distributed_tensorflow_tpu_torch.data import tfdata as ttfdata  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel import cluster  # noqa: E402

N = 64
IMAGES = (np.arange(N)[:, None] * np.ones((1, 4))).astype(np.float32)
LABELS = (np.arange(N) % 3).astype(np.int32)


def make_ds():
    return tf.data.Dataset.from_tensor_slices({"image": IMAGES, "label": LABELS})


@pytest.mark.parametrize("kw", [dict(), dict(start_index=3), dict(shuffle_buffer=64, seed=7)],
                         ids=["in_order", "resumed", "shuffled"])
def test_host_stream_matches_jax(kw):
    got = list(ttfdata.host_stream(make_ds, 8, repeat=False, **kw))
    want = list(jtfdata.host_stream(make_ds, 8, repeat=False, **kw))
    assert len(got) == len(want) == 8 - kw.get("start_index", 0)
    for a, b in zip(got, want):
        assert a.keys() == b.keys() == {"image", "label"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert got[0]["image"].shape == (8, 4)
    if not kw:
        assert np.array_equal(got[0]["label"], LABELS[:8])


def test_host_shards_are_disjoint_and_cover_the_data(monkeypatch):
    rows = []
    for rank in range(2):
        monkeypatch.setattr(cluster, "process_index", lambda: rank)
        monkeypatch.setattr(cluster, "process_count", lambda: 2)
        batches = list(ttfdata.host_stream(make_ds, 8, repeat=False))
        assert len(batches) == 8 and batches[0]["image"].shape == (4, 4)
        rows.append(np.concatenate([b["image"][:, 0] for b in batches]))
    assert not set(rows[0]) & set(rows[1]) and sorted(set(rows[0]) | set(rows[1])) == list(
        range(N))


def test_host_stream_feeds_run_workload(monkeypatch):
    """A tiny ResNet's stream from tf.data through the runner's
    ``dataset_fn``: the steps take its batches, resumed at the step."""
    from test_torch_train_workload import RESNET_TINY

    from distributed_tensorflow_tpu_torch.workloads import resnet50_imagenet, run_workload

    rng = np.random.default_rng(0)
    images = rng.random((32, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 32).astype(np.int32)
    starts = []

    def stream(start):
        starts.append(start)
        return ttfdata.host_stream(lambda: tf.data.Dataset.from_tensor_slices(
            {"image": images, "label": labels}), 8, start_index=start)

    build = resnet50_imagenet.build

    def tf_build(cfg, device, mesh=None):
        parts = build(cfg, device, mesh)
        parts.dataset_fn = stream
        return parts

    monkeypatch.setattr(resnet50_imagenet, "build", tf_build)
    res = run_workload("resnet50_imagenet", RESNET_TINY + [
        "--train.num_steps=3", "--train.eval_batches=0"], device="cpu")
    losses = [h["loss"] for h in res.history]
    assert starts == [0] and len(losses) == 3 and np.isfinite(losses).all()
