"""Workload 1 — MNIST MLP, single-worker sync SGD (BASELINE.json:7): the
port's counterpart of ``distributed_tensorflow_tpu/workloads/mnist_mlp.py``.

The same preset field for field: hidden (512, 512), 10 classes, the
synthetic 28x28x1 stream at global batch 128, sgd at 0.1, 500 steps;
``mesh.data=-1``, so the data axis takes whatever processes there are.
The classification loss and eval of ``models/common.py``; the eval stream
is the train source at ``index_offset=10**6``. No kernel of the port on
this path (the JAX model reaches no Pallas kernel either)."""

from __future__ import annotations

import torch

from ..data.pipeline import DataConfig, make_dataset
from ..models import common, mlp
from ..parallel.mesh import MeshSpec
from ..train.optimizers import OptimizerConfig
from .runner import RunConfig, TrainSection, WorkloadParts


def default_config() -> RunConfig:
    return RunConfig(
        workload="mnist_mlp",
        model=mlp.MLPConfig(hidden_sizes=(512, 512), num_classes=10),
        mesh=MeshSpec(data=-1),
        data=DataConfig(
            dataset="synthetic", global_batch_size=128,
            image_size=28, channels=1, num_classes=10,
        ),
        optimizer=OptimizerConfig(name="sgd", learning_rate=0.1),
        train=TrainSection(num_steps=500, log_every=50),
    )


def build(cfg: RunConfig, device: torch.device, mesh=None) -> WorkloadParts:
    """An MLP with random weights from ``cfg.train.seed`` on ``device``,
    the classification loss and eval statistics, this process's stream
    (its rows of each global batch), its eval stream and the forward FLOPs
    per global step."""
    data: DataConfig = cfg.data
    input_dim = data.image_size ** 2 * data.channels
    model = mlp.build(cfg.model, mlp.init_params(cfg.model, input_dim, seed=cfg.train.seed,
                                                 device=device), device)
    return WorkloadParts(
        model=model,
        loss_fn=common.classification_loss_fn(model),
        eval_fn=common.classification_eval_fn(model),
        dataset_fn=lambda start: make_dataset(data, index_offset=start),
        eval_dataset_fn=lambda n: make_dataset(data, n, index_offset=10**6, train=False),
        flops_per_step=mlp.flops_per_example(cfg.model, input_dim) * data.global_batch_size,
        batch_size=data.global_batch_size,
    )
