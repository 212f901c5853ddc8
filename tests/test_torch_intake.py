"""The port's real-data intake against the JAX package, on the CPU at tiny
sizes: the record loader (``runtime/loader.py`` over the port's build of
``native/dtf_runtime.cpp``), flat records with and without crop_flip
(``data/records.py``), every augmentation (``data/augment.py``), JPEG
records through the native libjpeg decoder and PIL
(``data/jpeg_records.py``, ``data/native_jpeg.py``), ``make_dataset``'s
wiring and refusals, and the ImageFolder converter
(``tests/test_torch_intake_run.py`` trains a tiny ResNet from the files
against the JAX runner; ``tests/test_torch_bench.py`` runs the bench's
JPEG-fed window).

Inputs come from numpy generators with fixed seeds; every comparison is
bitwise unless a tolerance is stated beside it. The one deliberate
difference: the port's crop_flip seeds batch i's generator with i, where
the JAX loader hands its decode index 0 for every batch, so a port batch
is held to the JAX dataset's ``_decode(raw_i, i)``, and to the JAX stream
itself at batch 0.
"""

import json
import os

import numpy as np
import pytest

from distributed_tensorflow_tpu.data import augment as jaug
from distributed_tensorflow_tpu.data import jpeg_records as jjpeg
from distributed_tensorflow_tpu.data import pipeline as jpipe
from distributed_tensorflow_tpu.data import records as jrec
from distributed_tensorflow_tpu.runtime import loader as jloader
from distributed_tensorflow_tpu_torch.data import augment as taug
from distributed_tensorflow_tpu_torch.data import jpeg_records as tjpeg
from distributed_tensorflow_tpu_torch.data import native_jpeg
from distributed_tensorflow_tpu_torch.data import pipeline as tpipe
from distributed_tensorflow_tpu_torch.data import records as trec
from distributed_tensorflow_tpu_torch.parallel import cluster
from distributed_tensorflow_tpu_torch.runtime import loader as tloader
from distributed_tensorflow_tpu_torch.runtime import native

#: native against PIL: the same crops and flips, another resampling
#: filter (tests/test_jpeg_pipeline.py::test_native_decoder_matches_pil_policy)
NATIVE_VS_PIL = 0.08


def _eq(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.fixture
def as_rank(monkeypatch):
    """Pose as process ``rank`` of ``world`` (``parallel.cluster``'s index
    and count, no process group)."""
    def pose(rank: int, world: int):
        monkeypatch.setattr(cluster, "process_index", lambda: rank)
        monkeypatch.setattr(cluster, "process_count", lambda: world)
    return pose


# -- the record loader ---------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 5), (17, 3), (100, 2 ** 63 + 7), (513, 12345)])
def test_epoch_permutation_matches_jax_and_the_native_shuffle(n, seed):
    import ctypes

    want = jloader.epoch_permutation(n, seed)
    got = tloader.epoch_permutation(n, seed)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    out = np.empty(n, np.int64)
    native.load_library().dtf_epoch_permutation(
        n, seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    assert np.array_equal(out, want)


@pytest.fixture(scope="module")
def record_file(tmp_path_factory):
    """37 records of 6x6x3 uint8 + an int32 label: with 2 shards and 4
    records a batch, 4 batches an epoch (an epoch ends inside the file)."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (37, 6, 6, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 37).astype(np.int32)
    path = str(tmp_path_factory.mktemp("rec") / "train.rec")
    assert trec.make_record_file(path, images, labels) == 6 * 6 * 3 + 4
    want = str(tmp_path_factory.mktemp("rec") / "jax.rec")
    jrec.make_record_file(want, images, labels)
    assert open(path, "rb").read() == open(want, "rb").read()
    return path, images, labels


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("start", [0, 3])
def test_record_loader_stream_matches_jax(record_file, use_native, shard, start):
    """Two shards of two, 9 batches (over two epochs), from batch 0 and a
    resume at batch 3: the port's native and Python streams equal the JAX
    loader's Python path, and decode sees each batch's stream index."""
    path = record_file[0]
    kw = dict(seed=7, shard=shard, n_shards=2, start_batch=start, num_batches=9 - start)
    want = list(jloader.RecordFileLoader(path, 112, 4, use_native=False, **kw))
    got = list(tloader.RecordFileLoader(path, 112, 4, use_native=use_native, **kw))
    assert len(got) == len(want) == 9 - start
    assert all(g.dtype == np.uint8 and np.array_equal(g, w) for g, w in zip(got, want))
    seen = list(tloader.RecordFileLoader(path, 112, 4, use_native=use_native,
                                         decode=lambda raw, i: i, **kw))
    assert seen == list(range(start, 9))
    full = list(tloader.RecordFileLoader(path, 112, 4, use_native=use_native,
                                         **dict(kw, start_batch=0, num_batches=9)))
    assert all(np.array_equal(g, f) for g, f in zip(got, full[start:]))


def test_record_loader_refuses_a_file_too_short_for_one_batch(record_file):
    with pytest.raises(ValueError, match="can't fill one batch"):
        tloader.RecordFileLoader(record_file[0], 112, 19, n_shards=2)
    with pytest.raises(ValueError, match="shard"):
        tloader.RecordFileLoader(record_file[0], 112, 4, shard=2, n_shards=2)


# -- flat records --------------------------------------------------------------


def _jax_raw(path, shape, bs, seed, start, n):
    return list(jloader.RecordFileLoader(path, int(np.prod(shape)) + 4, bs, seed=seed,
                                         start_batch=start, num_batches=n, use_native=False))


@pytest.mark.parametrize("augment,flat", [("none", False), ("none", True),
                                          ("crop_flip", False)])
@pytest.mark.parametrize("use_native", [True, False])
def test_record_dataset_matches_jax(record_file, augment, flat, use_native):
    """Batches 2..5: with augment none the JAX stream itself; with
    crop_flip the JAX dataset's ``_decode`` of the same raw batch at its
    index, and the JAX stream at batch 0."""
    path = record_file[0]
    kw = dict(seed=3, index_offset=2, num_batches=4, flat=flat, augment=augment)
    got = list(trec.RecordClassificationDataset(path, (6, 6, 3), 4, use_native=use_native,
                                                **kw))
    jds = jrec.RecordClassificationDataset(path, (6, 6, 3), 4, use_native=False, **kw)
    if augment == "none":
        want = list(jds)
    else:
        want = [jds._decode(raw, i) for i, raw in
                enumerate(_jax_raw(path, (6, 6, 3), 4, 3, 2, 4), start=2)]
        first = next(iter(trec.RecordClassificationDataset(
            path, (6, 6, 3), 4, **dict(kw, index_offset=0))))
        _eq(first, next(iter(jrec.RecordClassificationDataset(
            path, (6, 6, 3), 4, **dict(kw, index_offset=0)))))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[0]["image"].shape == ((4, 108) if flat else (4, 6, 6, 3))


def test_crop_flip_resumes_bitwise_and_varies_by_batch(record_file):
    path = record_file[0]
    kw = dict(seed=1, augment="crop_flip")
    stream = list(trec.RecordClassificationDataset(path, (6, 6, 3), 4, num_batches=5, **kw))
    resumed = next(iter(trec.RecordClassificationDataset(path, (6, 6, 3), 4, index_offset=3,
                                                         **kw)))
    _eq(resumed, stream[3])
    # the same raw batch decoded at two stream indices: two draws
    raw = _jax_raw(path, (6, 6, 3), 4, 1, 3, 1)[0]
    ds = trec.RecordClassificationDataset(path, (6, 6, 3), 4, **kw)
    assert not np.array_equal(ds._decode(raw, 3)["image"], ds._decode(raw, 4)["image"])


def test_record_dataset_refusals(record_file):
    with pytest.raises(ValueError, match="Unknown augment"):
        trec.RecordClassificationDataset(record_file[0], (6, 6, 3), 4, augment="mixup")
    with pytest.raises(ValueError, match="crop_flip needs"):
        trec.RecordClassificationDataset(record_file[0], (6, 6, 3), 4, augment="crop_flip",
                                         flat=True)


def test_record_shards_are_disjoint_and_cover_the_epoch(record_file, as_rank):
    """Two processes (posed): each its stride of the epoch, 4 local rows
    of a global batch of 8, no record twice."""
    seen = []
    for rank in range(2):
        as_rank(rank, 2)
        ds = trec.RecordClassificationDataset(record_file[0], (6, 6, 3), 8, seed=2,
                                              num_batches=4)
        assert ds.loader.shard == rank and ds.loader.batch_records == 4
        seen.append(np.concatenate([ds.loader.batch_indices(i) for i in range(4)]))
    a, b = seen
    assert not set(a) & set(b) and len(set(a) | set(b)) == 32


# -- augmentation ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_crop_flip_matches_jax(seed):
    images = np.random.default_rng(seed).integers(0, 256, (6, 10, 12, 3), dtype=np.uint8)
    got = taug.random_crop_flip(images, np.random.RandomState(seed), padding=3)
    want = jaug.random_crop_flip(images, np.random.RandomState(seed), padding=3)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("h,w", [(1, 1), (8, 8), (24, 40), (300, 200)])
def test_sample_crop_rect_matches_jax(h, w):
    for seed in range(40):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        assert taug.sample_crop_rect(h, w, a) == jaug.sample_crop_rect(h, w, b)
        assert a.rand() == b.rand()  # the same draws consumed


@pytest.mark.parametrize("shape", [(40, 56, 3), (64, 30, 3)])
def test_resizing_crops_and_flip_match_jax(shape):
    img = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    for seed in range(6):
        assert np.array_equal(
            taug.random_resized_crop(img, np.random.RandomState(seed), 24),
            jaug.random_resized_crop(img, np.random.RandomState(seed), 24))
        assert np.array_equal(taug.hflip(img, np.random.RandomState(seed)),
                              jaug.hflip(img, np.random.RandomState(seed)))
    assert np.array_equal(taug.resize_center_crop(img, 24), jaug.resize_center_crop(img, 24))
    assert np.array_equal(taug.center_crop(img, 20), jaug.center_crop(img, 20))
    assert taug.center_crop(img, 20).shape == (20, 20, 3)


# -- JPEG records ------------------------------------------------------------------


def _images(n, h=48, w=40, seed=0):
    """Smooth gradients (they survive quality 90) with a per-image offset."""
    rng = np.random.RandomState(seed)
    base = np.linspace(0, 200, h * w * 3).reshape(h, w, 3)
    return np.stack([np.clip(base + rng.randint(0, 40), 0, 255).astype(np.uint8)
                     for _ in range(n)])


@pytest.fixture(scope="module")
def jpeg_pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jpeg") / "train")
    imgs = _images(24, h=64, w=56)
    assert tjpeg.make_jpeg_record_file(path, imgs, np.arange(24) % 7) == 24
    other = str(tmp_path_factory.mktemp("jpeg") / "jax")
    jjpeg.make_jpeg_record_file(other, imgs, np.arange(24) % 7)
    for ext in (".dat", ".idx"):
        assert open(path + ext, "rb").read() == open(other + ext, "rb").read()
    return path


def test_native_decoder_builds_from_the_ports_tree():
    assert native_jpeg.available(), native_jpeg.failure
    path = native_jpeg.library_path()
    assert os.path.exists(path) and os.sep + os.path.join(
        "distributed_tensorflow_tpu_torch", "runtime", "build") in path


@pytest.mark.parametrize("decoder", ["native", "pil"])
@pytest.mark.parametrize("train", [True, False])
def test_jpeg_dataset_matches_jax(jpeg_pair, decoder, train):
    kw = dict(seed=5, train=train, index_offset=1, decoder=decoder)
    got = tjpeg.JpegClassificationDataset(jpeg_pair, 32, 8, **kw)
    want = jjpeg.JpegClassificationDataset(jpeg_pair, 32, 8, **kw)
    assert got.decoder == want.decoder == decoder
    for i in (0, 2, 3):  # batch 3 is the second epoch's first
        _eq(got.batch(i), want.batch(i))


@pytest.mark.parametrize("train", [True, False])
def test_native_decode_is_close_to_pil_and_deterministic(jpeg_pair, train):
    dn = tjpeg.JpegClassificationDataset(jpeg_pair, 32, 8, train=train, decoder="native")
    dp = tjpeg.JpegClassificationDataset(jpeg_pair, 32, 8, train=train, decoder="pil")
    bn, bp = dn.batch(0), dp.batch(0)
    assert np.array_equal(bn["label"], bp["label"])
    assert np.abs(bn["image"] - bp["image"]).max() < NATIVE_VS_PIL
    _eq(dn.batch(1), dn.batch(1))


def test_decoder_choice_and_the_environment_override(jpeg_pair, monkeypatch):
    assert tjpeg.JpegClassificationDataset(jpeg_pair, 32, 8).decoder == "native"
    monkeypatch.setenv("DTF_JPEG_DECODER", "pil")
    assert tjpeg.JpegClassificationDataset(jpeg_pair, 32, 8, decoder="native").decoder == "pil"
    monkeypatch.setenv("DTF_JPEG_DECODER", "webp")
    with pytest.raises(ValueError, match="decoder"):
        tjpeg.JpegClassificationDataset(jpeg_pair, 32, 8)
    monkeypatch.delenv("DTF_JPEG_DECODER")
    monkeypatch.setattr(native_jpeg, "available", lambda: False)
    assert tjpeg.JpegClassificationDataset(jpeg_pair, 32, 8).decoder == "pil"
    with pytest.raises(RuntimeError, match="did not build"):
        tjpeg.JpegClassificationDataset(jpeg_pair, 32, 8, decoder="native")


def test_native_decoder_zero_fills_a_corrupt_stream(tmp_path):
    path = str(tmp_path / "rec")
    tjpeg.make_jpeg_record_file(path, _images(8, h=40, w=40), np.arange(8))
    entries = np.fromfile(path + ".idx", tjpeg._ENTRY)
    entries[3]["length"] = 10
    entries[5]["offset"] = 10 ** 12  # past the end: clamped, not read
    entries.tofile(path + ".idx")
    got = tjpeg.JpegClassificationDataset(path, 32, 8, train=False, decoder="native").batch(0)
    want = jjpeg.JpegClassificationDataset(path, 32, 8, train=False, decoder="native").batch(0)
    _eq(got, want)
    assert got["image"][3].max() == 0.0 and got["image"][5].max() == 0.0
    assert got["image"][0].max() > 0.0


def test_jpeg_shards_are_disjoint_and_cover_the_epoch(tmp_path, as_rank):
    """Two processes (posed), 4 local rows of a global batch of 8: each
    decodes its stride of the epoch's order, the union is the epoch."""
    path = str(tmp_path / "rec")
    tjpeg.make_jpeg_record_file(path, _images(24, h=32, w=32), np.arange(24))
    seen = []
    for rank in range(2):
        as_rank(rank, 2)
        ds = tjpeg.JpegClassificationDataset(path, 32, 8, seed=1)
        assert ds.local_bs == 4 and ds._batches_per_epoch() == 3
        seen.append(np.concatenate([ds.batch(i)["label"] for i in range(3)]))
    a, b = seen
    assert not set(a) & set(b) and sorted(set(a) | set(b)) == list(range(24))


# -- make_dataset and the converter ---------------------------------------------------


def test_make_dataset_wiring_matches_jax(record_file, jpeg_pair):
    rec = dict(dataset=f"records:{record_file[0]}", global_batch_size=4, image_size=6,
               channels=3, seed=2, augment="crop_flip")
    got = tpipe.make_dataset(tpipe.DataConfig(**rec))
    assert isinstance(got, trec.RecordClassificationDataset) and got.augment == "crop_flip"
    _eq(next(iter(got)), next(iter(jpipe.make_dataset(jpipe.DataConfig(**rec)))))
    ev = tpipe.make_dataset(tpipe.DataConfig(**rec), 2, index_offset=10 ** 6, train=False)
    assert ev.augment == "none"
    for a, b in zip(ev, jpipe.make_dataset(jpipe.DataConfig(**rec), 2, index_offset=10 ** 6,
                                           train=False)):
        _eq(a, b)
    jp = dict(dataset=f"jpeg:{jpeg_pair}", global_batch_size=8, image_size=16, channels=3,
              seed=4)
    for train in (True, False):
        got = tpipe.make_dataset(tpipe.DataConfig(**jp), 2, index_offset=1, train=train)
        assert isinstance(got, tjpeg.JpegClassificationDataset) and got.train == train
        want = jpipe.make_dataset(jpipe.DataConfig(**jp), 2, index_offset=1, train=train)
        for a, b in zip(got, want):
            _eq(a, b)


@pytest.mark.parametrize("dataset", ["synthetic", "npz:/nonexistent.npz"])
def test_make_dataset_refuses_augment_where_it_does_nothing(dataset):
    cfg = tpipe.DataConfig(dataset=dataset, augment="crop_flip")
    with pytest.raises(ValueError, match="augment"):
        tpipe.make_dataset(cfg)
    if dataset == "synthetic":  # eval streams never augment
        assert isinstance(tpipe.make_dataset(cfg, train=False), tpipe.SyntheticClassification)
    with pytest.raises(ValueError, match="Unknown dataset"):
        tpipe.make_dataset(tpipe.DataConfig(dataset="tfrecord:/x"))


def test_imagefolder_converter_copies_the_streams(tmp_path):
    import importlib.util
    import io

    from PIL import Image

    spec = importlib.util.spec_from_file_location(
        "make_jpeg_records_torch", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "make_jpeg_records_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src, streams = tmp_path / "src", {}
    for c, name in enumerate(["cat", "dog", "eel"]):
        (src / name).mkdir(parents=True)
        for k in range(2):
            buf = io.BytesIO()
            Image.fromarray(_images(1, 16, 16, seed=c * 2 + k)[0]).save(buf, "JPEG")
            (src / name / f"{k}.JPEG").write_bytes(buf.getvalue())
            streams[buf.getvalue()] = c
        (src / name / "notes.txt").write_text("not an image")
    out = str(tmp_path / "rec")
    assert tool.convert(str(src), out, shuffle_seed=0) == 6
    entries = np.fromfile(out + ".idx", tjpeg._ENTRY)
    data = open(out + ".dat", "rb").read()
    got = {data[e["offset"]:e["offset"] + e["length"]]: int(e["label"]) for e in entries}
    assert got == streams
    assert json.load(open(out + ".classes.json")) == ["cat", "dog", "eel"]
    ds = tjpeg.JpegClassificationDataset(out, 16, 6, train=False)
    assert ds.batch(0)["image"].shape == (6, 16, 16, 3)
