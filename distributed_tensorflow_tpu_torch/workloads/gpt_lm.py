"""Decoder-only causal LM at GPT-2-small shape — the port's counterpart of
``distributed_tensorflow_tpu/workloads/gpt_lm.py`` (the default preset,
same values; ``long_context`` needs ring attention and remat, ROADMAP
Queue A items 2 and 6)."""

from __future__ import annotations

import dataclasses

import torch

from ..data.text import TextDataConfig
from ..models import transformer as tfm
from ..train.optimizers import OptimizerConfig
from ._transformer_common import transformer_parts
from .runner import RunConfig, TrainSection, WorkloadParts


def default_config() -> RunConfig:
    # xent_chunk: GPT-2's 50k vocab makes dense [B, S, vocab] loss logits
    # the dominant memory term; the chunked loss is the same math
    model = dataclasses.replace(tfm.gpt_small(causal_len=1024), xent_chunk=256)
    return RunConfig(
        workload="gpt_lm",
        model=model,
        data=TextDataConfig(
            dataset="synthetic_lm", global_batch_size=64,
            seq_len=model.max_len, vocab_size=model.vocab_size,
        ),
        optimizer=OptimizerConfig(
            name="adamw", learning_rate=3e-4, weight_decay=0.1,
            warmup_steps=2000, schedule="cosine", total_steps=100000,
        ),
        train=TrainSection(num_steps=100000, log_every=100),
    )


def build(cfg: RunConfig, device: torch.device) -> WorkloadParts:
    if not cfg.model.causal:
        raise ValueError("gpt_lm is a causal workload; set model.causal=True")
    return transformer_parts(cfg, device, mlm=False)
