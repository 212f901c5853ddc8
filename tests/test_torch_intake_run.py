"""A tiny ResNet trained 3 steps through the port's ``run_workload`` from
``records:`` (crop_flip) and from ``jpeg:`` (the native decoder), against
the JAX package's runner on the same files from the same initial weights:
per-step losses and the final eval's loss within ``RUN_TOL``. The JAX
loader is made to hand its decode the batch index, as the port's does
(``tests/test_torch_intake.py``'s deliberate difference); without that its
steps 2 and 3 see other crops.
"""

import numpy as np
import pytest

from distributed_tensorflow_tpu.runtime import loader as jloader
from distributed_tensorflow_tpu_torch.data import jpeg_records as tjpeg
from distributed_tensorflow_tpu_torch.data import records as trec

from test_torch_intake import _images

#: the loss tolerance of the port's data-parallel ResNet steps against the
#: JAX mesh step (tests/test_torch_dp_resnet.py): the JAX runner steps on 8
#: fake devices with synchronised BatchNorm, the port in one process
RUN_TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture
def same_initial_weights(monkeypatch):
    """Both runners start from one flax init of the tiny ResNet (as numpy)."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models import common as jcommon
    from distributed_tensorflow_tpu.workloads import resnet50_imagenet as jres
    from distributed_tensorflow_tpu_torch.models import resnet as tresnet
    from distributed_tensorflow_tpu_torch.weights import resnet_state_dict_from_jax

    make_init_fn = jcommon.make_init_fn
    held = {}

    def fixed_init_fn(model, input_shape, dtype=jnp.float32):
        init = make_init_fn(model, input_shape, dtype)
        if "params" not in held:
            params, state = init(jax.random.PRNGKey(0))
            held["params"] = jax.tree.map(np.asarray, params)
            held["stats"] = jax.tree.map(np.asarray, state["batch_stats"])
        return lambda rng: (jax.tree.map(jnp.asarray, held["params"]),
                            {"batch_stats": jax.tree.map(jnp.asarray, held["stats"])})

    monkeypatch.setattr(jres.common, "make_init_fn", fixed_init_fn)
    monkeypatch.setattr(tresnet, "init_params", lambda cfg, seed=0, device="cuda":
                        resnet_state_dict_from_jax(held["params"], cfg, held["stats"]))
    return held


def _indexed_jax_loader(monkeypatch):
    """The JAX loader handing its decode the stream index, as the port's
    does (the module docstring's deliberate difference)."""
    def it(self):
        raws = jloader.RecordFileLoader.__dict__["_iter_python"](self)
        return (self.decode(raw, self.start_batch + i) for i, raw in enumerate(raws))
    monkeypatch.setattr(jloader.RecordFileLoader, "__iter__", it)


@pytest.mark.parametrize("source", ["records", "jpeg"])
def test_tiny_resnet_trains_from_the_files_like_the_jax_runner(tmp_path, source, monkeypatch,
                                                              same_initial_weights):
    from test_torch_train_workload import RESNET_TINY

    from distributed_tensorflow_tpu.workloads import run_workload as j_run
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    rng = np.random.default_rng(9)
    if source == "records":
        path = str(tmp_path / "train.rec")
        trec.make_record_file(path, rng.integers(0, 256, (40, 16, 16, 3), dtype=np.uint8),
                              rng.integers(0, 10, 40).astype(np.int32))
        data = [f"--data.dataset=records:{path}", "--data.augment=crop_flip"]
        _indexed_jax_loader(monkeypatch)
    else:
        path = str(tmp_path / "train")
        tjpeg.make_jpeg_record_file(path, _images(24, h=24, w=20), np.arange(24) % 10)
        data = [f"--data.dataset=jpeg:{path}"]
    overrides = RESNET_TINY + data + ["--train.num_steps=3", "--train.eval_batches=2"]
    want = j_run("resnet50_imagenet", overrides)  # first: it draws the weights
    got = run_workload("resnet50_imagenet", overrides, device="cpu")
    losses = [h["loss"] for h in got.history]
    assert [h["step"] for h in got.history] == [1, 2, 3] and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, [h["loss"] for h in want.history], **RUN_TOL)
    assert got.eval_metrics.keys() >= {"loss", "accuracy"}
    np.testing.assert_allclose(got.eval_metrics["loss"], want.eval_metrics["loss"], **RUN_TOL)
