"""BERT-base MLM pretraining (BASELINE.json:10) — the port's counterpart of
``distributed_tensorflow_tpu/workloads/bert_pretrain.py``: the same
preset (``bert_base()``, ``synthetic_mlm`` at S=512 with the gathered MLM
head, K = round(0.15 · 512) = 77, global batch 256, adamw at 1e-4 with a
linear warmup), data-parallel over the processes of the mesh (one per
card; the step's gradient all-reduce is generic). Attention runs through
the flash kernels, non-causal, with a ``kv_mask`` when a batch carries an
``attention_mask``. Sequence parallelism and the pipelined family are
ROADMAP Queue A item 6."""

from __future__ import annotations

import torch

from ..data.text import TextDataConfig
from ..models import transformer as tfm
from ..parallel.mesh import MeshSpec
from ..train.optimizers import OptimizerConfig
from ._transformer_common import transformer_parts
from .runner import RunConfig, TrainSection, WorkloadParts


def default_config() -> RunConfig:
    model = tfm.bert_base()
    return RunConfig(
        workload="bert_pretrain",
        model=model,
        mesh=MeshSpec(data=-1),
        data=TextDataConfig(
            dataset="synthetic_mlm", global_batch_size=256,
            seq_len=model.max_len, vocab_size=model.vocab_size,
            # the gathered MLM head: head and vocab projection on ~77
            # predicted positions, not all 512
            max_predictions=-1,
        ),
        optimizer=OptimizerConfig(
            name="adamw", learning_rate=1e-4, weight_decay=0.01,
            warmup_steps=1000, schedule="linear", total_steps=10000,
        ),
        train=TrainSection(num_steps=10000, log_every=100),
    )


def build(cfg: RunConfig, device: torch.device, mesh=None) -> WorkloadParts:
    return transformer_parts(cfg, device, mlm=True)
