"""ResNet-50 / ImageNet — the port's counterpart of ``distributed_tensorflow_tpu/
workloads/resnet50_imagenet.py`` (the framework's primary metric,
images/sec/chip): the same preset, data-parallel over the processes of the
mesh (one per card, sync BN over the global batch). ``space_to_depth`` stem,
bf16 compute with f32 parameters and BatchNorm statistics, 224x224,
1000 classes; momentum 0.9 at lr 0.4 (0.1 x 1024/256) with a 5-epoch
warmup and cosine decay over 90 epochs at global batch 1024; coupled L2
1e-4 on the kernels in the optimizer; label smoothing 0.1. The stream is
``SyntheticClassification`` by default or an ``npz:`` file; real ImageNet
(``records:``/``jpeg:``) is ROADMAP Queue A item 3.2. The
``block_impl`` override picks the plain model (``standard``) or the fused
conv+BN kernels (``fused``). Evaluation (top-1, top-5, loss; BatchNorm on
its running statistics) runs on the same stream at a disjoint index
range; an explicit ``data.eval_dataset`` is refused, as in the JAX
package."""

from __future__ import annotations

import torch

from ..data.pipeline import DataConfig, make_dataset
from ..models import common, resnet
from ..train.optimizers import OptimizerConfig
from ..parallel.mesh import MeshSpec
from .runner import RunConfig, TrainSection, WorkloadParts


def default_config() -> RunConfig:
    return RunConfig(
        workload="resnet50_imagenet",
        model=resnet.ResNetConfig(stem="space_to_depth"),
        mesh=MeshSpec(data=-1),
        data=DataConfig(
            dataset="synthetic", global_batch_size=1024,
            image_size=224, channels=3, num_classes=1000,
        ),
        optimizer=OptimizerConfig(
            name="momentum", learning_rate=0.4, momentum=0.9,
            schedule="warmup_cosine", warmup_steps=6255, total_steps=112590,
            weight_decay=1e-4,
        ),
        train=TrainSection(num_steps=112590, log_every=100),
    )


def build(cfg: RunConfig, device: torch.device, mesh=None) -> WorkloadParts:
    """A trainable ResNet with random weights from ``cfg.train.seed`` on
    ``device`` (sync BN over ``mesh``'s batch axes), the label-smoothed
    classification loss and eval statistics, this process's image stream
    (its rows of each global batch), its eval stream and the forward FLOPs
    per global step."""
    mcfg: resnet.ResNetConfig = cfg.model
    data: DataConfig = cfg.data
    if not isinstance(data, DataConfig):
        raise ValueError(f"resnet50_imagenet takes an image DataConfig, got {type(data).__name__}")
    if data.flat or data.channels != 3 or data.image_size % 2:
        raise ValueError(f"the ResNet stem takes NHWC images of 3 channels and an even size, "
                         f"got flat={data.flat} channels={data.channels} "
                         f"image_size={data.image_size}")
    if data.num_classes > mcfg.num_classes:
        raise ValueError(f"data.num_classes={data.num_classes} exceeds "
                         f"model.num_classes={mcfg.num_classes}")
    model = resnet.build(mcfg, resnet.init_params(mcfg, seed=cfg.train.seed, device=device),
                         device, mesh)
    return WorkloadParts(
        model=model,
        loss_fn=common.classification_loss_fn(model, label_smoothing=0.1),
        eval_fn=common.classification_eval_fn(model),
        dataset_fn=lambda start: make_dataset(data, index_offset=start),
        eval_dataset_fn=lambda n: make_dataset(data, n, index_offset=10**6, train=False),
        flops_per_step=resnet.flops_per_example(mcfg, data.image_size) * data.global_batch_size,
        batch_size=data.global_batch_size,
    )
