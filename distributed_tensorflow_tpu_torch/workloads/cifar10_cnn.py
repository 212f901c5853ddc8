"""Workload 2 — CIFAR-10 CNN, sync data-parallel x8 (BASELINE.json:8): the
port's counterpart of ``distributed_tensorflow_tpu/workloads/cifar10_cnn.py``.

The same preset field for field: channels (32, 64, 128), the synthetic
32x32x3 stream at global batch 256, ``MeshSpec(data=8)`` — eight replicas
are the workload's identity: launch it under ``torchrun
--nproc_per_node=8``, or pass ``--mesh.data=-1`` to let the data axis
take the processes there are —, momentum 0.9 at 0.05 with a cosine decay
over 2000 steps. Under data parallelism each rank steps on its rows of
the global batch, gradients are averaged over the data axis and every
BatchNorm normalises with the global batch's statistics (``models/
cnn.py``). The eval stream is the train source at ``index_offset=10**6``,
augmentation off (``jpeg:``: the resize + centre-crop decode). No kernel
of the port on this path."""

from __future__ import annotations

import torch

from ..data.pipeline import DataConfig, make_dataset
from ..models import cnn, common
from ..parallel.mesh import MeshSpec
from ..train.optimizers import OptimizerConfig
from .runner import RunConfig, TrainSection, WorkloadParts


def default_config() -> RunConfig:
    return RunConfig(
        workload="cifar10_cnn",
        model=cnn.CNNConfig(channels=(32, 64, 128), num_classes=10),
        mesh=MeshSpec(data=8),
        data=DataConfig(
            dataset="synthetic", global_batch_size=256,
            image_size=32, channels=3, num_classes=10,
        ),
        optimizer=OptimizerConfig(
            name="momentum", learning_rate=0.05, momentum=0.9,
            schedule="cosine", total_steps=2000,
        ),
        train=TrainSection(num_steps=2000, log_every=100),
    )


def build(cfg: RunConfig, device: torch.device, mesh=None) -> WorkloadParts:
    """A CNN with random weights from ``cfg.train.seed`` on ``device``
    (sync BN over ``mesh``'s batch axes), the classification loss and eval
    statistics, this process's image stream, its eval stream and the
    forward FLOPs per global step."""
    data: DataConfig = cfg.data
    if data.flat:
        raise ValueError("cifar10_cnn takes NHWC images, got data.flat=True")
    shape = (data.image_size, data.image_size, data.channels)
    model = cnn.build(cfg.model, cnn.init_params(cfg.model, shape, seed=cfg.train.seed,
                                                 device=device), device, shape, mesh)
    return WorkloadParts(
        model=model,
        loss_fn=common.classification_loss_fn(model),
        eval_fn=common.classification_eval_fn(model),
        dataset_fn=lambda start: make_dataset(data, index_offset=start),
        eval_dataset_fn=lambda n: make_dataset(data, n, index_offset=10**6, train=False),
        flops_per_step=cnn.flops_per_example(cfg.model, data.image_size)
        * data.global_batch_size,
        batch_size=data.global_batch_size,
    )
