"""Decoder-only causal LM at GPT-2-small shape — the port's counterpart of
``distributed_tensorflow_tpu/workloads/gpt_lm.py``: the default preset
(data-parallel over the processes there are) and ``long_context`` (ring
attention over the ``seq`` axis with remat at S=8192), same values.
``python -m distributed_tensorflow_tpu_torch.train gpt_lm
--preset=long_context`` picks the second (``PRESETS``). ``--mesh.pipe=S``
runs the pipelined family over S stages (with ``--mesh.model`` PP×TP;
``--train.pipeline_microbatches``, ``--train.pipeline_virtual``)."""

from __future__ import annotations

import dataclasses

import torch

from ..data.text import TextDataConfig
from ..models import transformer as tfm
from ..parallel.mesh import MeshSpec
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
        mesh=MeshSpec(data=-1),
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


def long_context(seq_len: int = 8192) -> RunConfig:
    """Ring attention + remat: run with ``--mesh.seq=K`` (K divides
    ``seq_len``; the preset's ``seq=-1`` takes every process) so the K/V
    chunks rotate around the ``seq`` axis (``parallel/ring_attention.py``);
    data stays at 1 unless overridden."""
    cfg = default_config()
    model = dataclasses.replace(cfg.model, max_len=seq_len, seq_impl="ring", remat=True)
    data = dataclasses.replace(cfg.data, seq_len=seq_len, global_batch_size=8)
    return dataclasses.replace(cfg, model=model, data=data, mesh=MeshSpec(data=1, seq=-1))


#: the presets by name (``default_config`` is the workload's default)
PRESETS = {"long_context": long_context}


def build(cfg: RunConfig, device: torch.device, mesh=None) -> WorkloadParts:
    if not cfg.model.causal:
        raise ValueError("gpt_lm is a causal workload; set model.causal=True")
    parts = transformer_parts(cfg, device, mlm=False, mesh=mesh)
    if mesh is None or mesh.size == 1:
        return parts
    # Data-parallel: the step averages each rank's loss, a mean over its own
    # tokens (the chunked loss included). That is the mean over the global
    # batch only because every rank scores the same count, rows x (S - 1):
    # the LM streams never pad (no attention_mask), and the rows split
    # evenly. A padded batch would weight the ranks unequally.
    if not (cfg.data.dataset == "synthetic_lm" or cfg.data.dataset.startswith("tokens:")):
        raise ValueError(f"data-parallel gpt_lm takes an unpadded LM stream (synthetic_lm, "
                         f"tokens:), got {cfg.data.dataset!r}")
    loss_fn = parts.loss_fn

    def equal_count_loss(batch, generator=None):
        if "attention_mask" in batch:
            raise ValueError("data-parallel gpt_lm: a padded batch gives the ranks unequal "
                             "token counts, and the mean of their means is not the global one")
        return loss_fn(batch, generator)

    parts.loss_fn = equal_count_loss
    return parts
