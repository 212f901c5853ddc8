"""The port's ``Prefetcher`` and ``DevicePut`` (``data/pipeline.py``) on the
CPU, with the JAX package's ``Prefetcher`` contract: items in order, at
most ``depth`` queued ahead, a worker's exception raised in the consumer,
and an early close that stops and drains the worker; and ``Trainer.
put_batch`` passing batches already on the device through. The side-stream
copies into pinned buffers are card tests (``test_torch_kernels_cuda.py``).
"""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.data.pipeline import Prefetcher as JPrefetcher
from distributed_tensorflow_tpu_torch.data.pipeline import DevicePut, Prefetcher, StagedBatch
from distributed_tensorflow_tpu_torch.train import Trainer
from distributed_tensorflow_tpu_torch.train import optimizers as topt
from distributed_tensorflow_tpu_torch.train import step as tstep


def test_items_come_in_order_through_the_transform_on_the_worker():
    threads = []

    def transform(x):
        threads.append(threading.current_thread().name)
        return x * 10

    got = list(Prefetcher(range(7), depth=2, transform=transform))
    assert got == [x * 10 for x in range(7)]
    assert got == list(JPrefetcher(range(7), depth=2, transform=lambda x: x * 10))
    assert set(threads) == {"prefetcher"}


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_at_most_depth_items_are_queued_ahead(depth):
    """With the consumer holding one item, the worker pulls ``depth`` more
    into the queue and one into its hand (blocked in put), no further."""
    pulled = []

    def source():
        for i in range(100):
            pulled.append(i)
            yield i

    it = iter(Prefetcher(source(), depth=depth))
    assert next(it) == 0
    deadline = time.monotonic() + 5
    while len(pulled) < depth + 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)  # room to overrun, were the bound broken
    assert len(pulled) == depth + 2
    it.close()


def test_worker_exception_is_raised_in_the_consumer_after_the_queued_items():
    def source():
        yield 1
        yield 2
        raise ValueError("boom in the source")

    it = iter(Prefetcher(source(), depth=4))
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(ValueError, match="boom in the source"):
        next(it)

    def bad(x):
        if x == 3:
            raise KeyError("boom in the transform")
        return x

    with pytest.raises(KeyError, match="boom in the transform"):
        list(Prefetcher(range(10), transform=bad))


def test_early_close_stops_and_drains_the_worker():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    for depth in (1, 2):
        p = Prefetcher(endless(), depth=depth)
        it = iter(p)
        assert next(it) == 0
        it.close()
        p.thread.join(timeout=5)
        assert not p.thread.is_alive()
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(range(3), depth=0)


def test_device_put_on_the_cpu_gives_the_host_batch_as_tensors(monkeypatch):
    rng = np.random.default_rng(0)
    host = [{"image": torch.randn(4, 8, 8, 3).to(torch.bfloat16),
             "label": rng.integers(0, 10, 4).astype(np.int32)} for _ in range(3)]
    out = [b.wait() for b in Prefetcher(host, transform=DevicePut("cpu"))]
    for got, want in zip(out, host):
        assert torch.equal(got["image"], want["image"]) and got["image"].dtype == torch.bfloat16
        assert np.array_equal(got["label"].numpy(), want["label"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DevicePut()  # on the card by default


def test_trainer_put_batch_passes_device_batches_through():
    model = torch.nn.Linear(3, 2)
    opt = topt.make_optimizer(topt.OptimizerConfig(name="sgd", learning_rate=0.1),
                              model.parameters())
    trainer = Trainer(lambda s, b: (s, {}), tstep.init_train_state(model, opt))
    t = {"x": torch.ones(2, 3)}
    assert trainer.put_batch(StagedBatch(t)) is t
    got = trainer.put_batch(t)
    assert got["x"] is t["x"]
    got = trainer.put_batch({"x": np.ones((2, 3), np.float32)})  # an unprefetched host batch
    assert torch.equal(got["x"], t["x"])
