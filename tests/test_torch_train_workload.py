"""The port's workload layer against the JAX package: the text and image
streams are bit-identical for the same (seed, index), every LR schedule
kind gives JAX's values, the config overrides parse to the same tree, and
``run_workload`` trains tiny ``gpt_lm`` and ``resnet50_imagenet`` configs
on the CPU with a finite, falling loss (``gpt_lm`` also with
``fused_ln_matmul`` under both backward impls); what the port does not
have yet is refused with the ROADMAP item named."""

import numpy as np
import pytest

from distributed_tensorflow_tpu.data import pipeline as jpipe
from distributed_tensorflow_tpu.data import text as jtext
from distributed_tensorflow_tpu.train import optimizers as jopt
from distributed_tensorflow_tpu.utils import config as jconfig
from distributed_tensorflow_tpu.workloads import gpt_lm as jgpt
from distributed_tensorflow_tpu.workloads import resnet50_imagenet as jres
from distributed_tensorflow_tpu_torch.data import pipeline as tpipe
from distributed_tensorflow_tpu_torch.data import text as ttext
from distributed_tensorflow_tpu_torch.train import optimizers as topt
from distributed_tensorflow_tpu_torch.utils import config as tconfig
from distributed_tensorflow_tpu_torch.workloads import gpt_lm as tgpt
from distributed_tensorflow_tpu_torch.workloads import resnet50_imagenet as tres
from distributed_tensorflow_tpu_torch.workloads import run_workload

TINY = ["--model.num_layers=2", "--model.d_model=64", "--model.num_heads=4",
        "--model.d_ff=128", "--model.vocab_size=256", "--data.vocab_size=256",
        "--model.max_len=32", "--data.seq_len=32", "--model.xent_chunk=16",
        "--model.dtype=float32", "--model.dropout=0.0", "--data.global_batch_size=4",
        "--train.log_every=1", "--optimizer.warmup_steps=0",
        "--optimizer.learning_rate=3e-3", "--optimizer.schedule=constant"]


@pytest.mark.parametrize("index", [0, 7, 1_000_000])
def test_synthetic_lm_batch_is_bit_identical_to_jax(index):
    kw = dict(dataset="synthetic_lm", global_batch_size=4, seq_len=48, vocab_size=512, seed=3)
    got = ttext.SyntheticLM(ttext.TextDataConfig(**kw)).batch(index)
    want = jtext.SyntheticLM(jtext.TextDataConfig(**kw)).batch(index)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_token_file_batches_match_jax(tmp_path):
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(0).integers(0, 100, 5000).astype(np.int32))
    kw = dict(dataset=f"tokens:{path}", global_batch_size=3, seq_len=16, vocab_size=100)
    got = ttext.make_text_dataset(ttext.TextDataConfig(**kw), index_offset=5).batch(2)
    want = jtext.make_text_dataset(jtext.TextDataConfig(**kw), index_offset=5).batch(2)
    assert np.array_equal(got["input_ids"], want["input_ids"])


@pytest.mark.parametrize("kind", ["constant", "cosine", "warmup_cosine", "exponential",
                                  "linear"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_jax(kind, warmup):
    kw = dict(learning_rate=0.05, schedule=kind, warmup_steps=warmup, total_steps=12,
              end_lr_factor=0.1, decay_rate=0.5, decay_steps=4)
    if kind == "warmup_cosine" and warmup == 0:
        kw["warmup_steps"] = 1
    got = topt.make_schedule(topt.OptimizerConfig(**kw))
    want = jopt.make_schedule(jopt.OptimizerConfig(**kw))
    for step in range(16):
        assert got(step) == pytest.approx(float(want(step)), abs=1e-7), step
    if warmup:
        assert got(0) == 0.0  # the first update has lr 0


def test_overrides_parse_to_the_same_config_as_jax():
    """The same --section.key=value list on both default gpt_lm configs
    gives the same values in every section the port has (the port keeps
    a subset of the JAX sections' fields)."""
    overrides = ["--train.num_steps=7", "--optimizer.learning_rate=1e-3",
                 "--optimizer.schedule=warmup_cosine", "--model.xent_chunk=128",
                 "--data.global_batch_size=8", "--model.attention_impl=dense",
                 "--train.clip_grad_norm=1.0", "--model.head_dtype=bfloat16",
                 "--mesh.data=-1"]
    got = tconfig.to_dict(tconfig.apply_overrides(tgpt.default_config(), overrides))
    want = jconfig.to_dict(jconfig.apply_overrides(jgpt.default_config(), overrides))
    assert got["workload"] == want["workload"]
    for section in ("model", "data", "optimizer", "train", "mesh"):
        for key, value in got[section].items():
            assert value == want[section][key], (section, key)
    assert got["model"]["xent_chunk"] == 128 and got["train"]["num_steps"] == 7
    with pytest.raises(ValueError, match="Unknown config key"):
        tconfig.apply_overrides(tgpt.default_config(), ["--train.bogus=1"])


def test_run_workload_trains_gpt_lm_on_cpu():
    res = run_workload("gpt_lm", TINY + ["--train.num_steps=3"], device="cpu")
    losses = [row["loss"] for row in res.history]
    assert res.state.step == 3 and len(losses) == 3 and res.device.type == "cpu"
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert "steps_per_sec" in res.history[-1]


@pytest.mark.parametrize("bwd", ["xla", "pallas"])
def test_run_workload_trains_gpt_lm_fused_ln_on_cpu(bwd, monkeypatch):
    """``--model.fused_ln_matmul=true`` trains under both ``DTF_FUSED_BWD``
    values (on the CPU the ``pallas`` backward runs the kernel wrappers'
    plain versions): a finite, falling loss."""
    monkeypatch.setenv("DTF_FUSED_BWD", bwd)
    res = run_workload("gpt_lm", TINY + ["--train.num_steps=3", "--model.fused_ln_matmul=true"],
                       device="cpu")
    losses = [row["loss"] for row in res.history]
    assert res.state.step == 3 and res.state.model.cfg.fused_ln_matmul
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("override,match", [
    ("--checkpoint.directory=/tmp/ckpt", "checkpoint.py"),
    ("--mesh.data=2", "more than one"),
    ("--mesh.pipe=2", "pipeline"),
    ("--fleet.dir=/tmp/fleet", "fleet"),
    ("--train.anomaly_defense=true", "anomaly"),
    ("--model.seq_impl=ring", "ring_attention"),
    ("--model.num_experts=4", "moe"),
    ("--optimizer.name=lamb", "not ported"),
])
def test_unsupported_configs_raise_naming_the_roadmap_item(override, match):
    with pytest.raises((ValueError, NotImplementedError), match=match):
        run_workload("gpt_lm", TINY + ["--train.num_steps=1", override], device="cpu")



RESNET_TINY = ["--model.stage_sizes=[1,1]", "--model.width=8", "--model.num_classes=10",
               "--model.dtype=float32", "--data.image_size=16", "--data.num_classes=10",
               "--data.global_batch_size=8", "--train.log_every=1", "--optimizer.warmup_steps=0",
               "--optimizer.schedule=constant", "--optimizer.learning_rate=0.05"]


@pytest.mark.parametrize("index,flat", [(0, False), (9, True), (1_000_000, False)])
def test_synthetic_classification_batch_is_bit_identical_to_jax(index, flat):
    kw = dict(dataset="synthetic", global_batch_size=3, image_size=8, channels=3,
              num_classes=10, seed=2, flat=flat)
    got = tpipe.SyntheticClassification(tpipe.DataConfig(**kw), index_offset=4).batch(index)
    want = jpipe.SyntheticClassification(jpipe.DataConfig(**kw), index_offset=4).batch(index)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_npz_batches_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "images.npz"
    np.savez(path, image=rng.standard_normal((10, 4, 4, 3)).astype(np.float32),
             label=rng.integers(0, 5, 10).astype(np.int32))
    kw = dict(dataset=f"npz:{path}", global_batch_size=4, image_size=4, channels=3,
              num_classes=5, seed=1)
    got = tpipe.make_dataset(tpipe.DataConfig(**kw), index_offset=1)
    want = jpipe.make_dataset(jpipe.DataConfig(**kw), index_offset=1)
    for (a, b, _) in zip(got, want, range(5)):  # two epochs: reshuffled from seed + epoch
        assert np.array_equal(a["image"], b["image"]) and np.array_equal(a["label"], b["label"])


def test_resnet_overrides_parse_to_the_same_config_as_jax():
    overrides = ["--model.block_impl=fused", "--model.stem=conv", "--data.global_batch_size=256",
                 "--data.dataset=npz:/tmp/x.npz", "--optimizer.learning_rate=0.1",
                 "--optimizer.schedule=constant", "--train.num_steps=6", "--mesh.data=-1"]
    got = tconfig.to_dict(tconfig.apply_overrides(tres.default_config(), overrides))
    want = jconfig.to_dict(jconfig.apply_overrides(jres.default_config(), overrides))
    assert got["workload"] == want["workload"] == "resnet50_imagenet"
    for section in ("model", "data", "optimizer", "train", "mesh"):
        for key, value in got[section].items():
            assert value == want[section][key], (section, key)
    assert got["model"]["stem"] == "conv" and got["data"]["image_size"] == 224


@pytest.mark.parametrize("impl,bwd", [("standard", "xla"), ("fused", "pallas")])
def test_run_workload_trains_resnet50_imagenet_on_cpu(impl, bwd, monkeypatch):
    monkeypatch.setenv("DTF_FUSED_BWD", bwd)
    res = run_workload("resnet50_imagenet", RESNET_TINY + [
        "--train.num_steps=3", f"--model.block_impl={impl}"], device="cpu")
    losses = [row["loss"] for row in res.history]
    assert res.state.step == 3 and len(losses) == 3 and res.device.type == "cpu"
    assert np.isfinite(losses).all() and "accuracy" in res.history[-1]
    assert res.state.model.cfg.block_impl == impl


def test_run_workload_steps_with_deterministic_cudnn_and_restores_it(monkeypatch):
    """The steps run with cuDNN's deterministic algorithms (a bitwise
    repeatable step, as the JAX package's); the caller's setting returns."""
    import torch

    from distributed_tensorflow_tpu_torch.train import callbacks

    seen = []

    class Spy(callbacks.Callback):
        def on_step_end(self, trainer, step, metrics):
            seen.append(torch.backends.cudnn.deterministic)

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    run_workload("resnet50_imagenet", RESNET_TINY + ["--train.num_steps=2"], device="cpu",
                 extra_callbacks=[Spy()])
    assert seen == [True, True] and torch.backends.cudnn.deterministic is False


@pytest.mark.parametrize("override,match", [
    ("--data.dataset=records:/tmp/r", "records"),
    ("--data.dataset=jpeg:/tmp/j", "jpeg"),
    ("--data.augment=crop_flip", "augment"),
    ("--data.eval_dataset=synthetic", "does not support data.eval_dataset"),
    ("--data.channels=1", "3 channels"),
    ("--model.block_impl=pallas", "block_impl"),
    ("--mesh.fsdp=2", "more than one"),
])
def test_resnet_unsupported_configs_raise(override, match):
    with pytest.raises((ValueError, NotImplementedError), match=match):
        run_workload("resnet50_imagenet", RESNET_TINY + ["--train.num_steps=1", override],
                     device="cpu")
