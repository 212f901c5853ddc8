"""Shared build logic for the transformer workloads — the non-pipelined
branch of ``distributed_tensorflow_tpu/workloads/_transformer_common.py``
(causal LM only; the MLM branch comes with ``bert_pretrain``, the
pipelined one with ROADMAP Queue A item 6)."""

from __future__ import annotations

import torch

from ..data.text import make_text_dataset
from ..models import transformer as tfm
from .runner import RunConfig, WorkloadParts


def transformer_parts(cfg: RunConfig, device: torch.device, *, mlm: bool) -> WorkloadParts:
    """WorkloadParts for a Transformer workload: a trainable model with
    random weights from ``cfg.train.seed`` on ``device``, the causal-LM
    loss (chunked when ``model.xent_chunk > 0``), the text stream and the
    forward FLOPs per step. Evaluation comes with ``train/evaluation.py``
    (ROADMAP Queue A item 2)."""
    if mlm:
        raise NotImplementedError("the masked-LM workload (bert_pretrain) is not ported "
                                  "yet (ROADMAP Queue A item 2)")
    mcfg: tfm.TransformerConfig = cfg.model
    if cfg.data.seq_len > mcfg.max_len:
        raise ValueError(f"data.seq_len={cfg.data.seq_len} exceeds "
                         f"model.max_len={mcfg.max_len}")
    if cfg.data.vocab_size != mcfg.vocab_size:
        raise ValueError(f"data.vocab_size={cfg.data.vocab_size} != "
                         f"model.vocab_size={mcfg.vocab_size}")
    tfm.check_supported(mcfg)
    params = tfm.init_params(mcfg, seed=cfg.train.seed, device=device, trainable=True)
    model = tfm.build(mcfg, params, device, trainable=True)
    return WorkloadParts(
        model=model,
        loss_fn=tfm.causal_lm_loss(model, mcfg.xent_chunk),
        dataset_fn=lambda start: make_text_dataset(cfg.data, index_offset=start),
        flops_per_step=tfm.flops_per_example(mcfg, cfg.data.seq_len)
        * cfg.data.global_batch_size,
        batch_size=cfg.data.global_batch_size,
    )
