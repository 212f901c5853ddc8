"""Shared build logic for the transformer workloads (bert_pretrain,
gpt_lm) — the port's ``distributed_tensorflow_tpu/workloads/
_transformer_common.py``: the dense model with the rule table
``transformer_rules`` and ``fsdp=True``, as there, so its parameters are
sharded over the mesh's ``model`` (megatron) and ``fsdp`` axes by
``transformer_specs``; and with ``mesh.pipe`` above 1 the pipelined
family (``PipelinedTransformer``, PP×TP with ``mesh.model``): this
stage's share of the same seed's weights (``init_pipelined``), its specs
(``pipeline_param_specs``', ``model`` placed where the mesh's exceeds 1),
``train.pipeline_microbatches`` microbatches (0: 2·pipe·V) of
``train.pipeline_virtual`` (V) chunks a stage, no fsdp sharding (JAX's
pipelined branch composes none), and the dense loss and eval statistics
(``model.xent_chunk`` is not applied there, as in JAX: logged at info)."""

from __future__ import annotations

import logging

import torch

from ..data.text import make_text_dataset, resolved_max_predictions
from ..models import transformer as tfm
from ..parallel.collectives import axis_index, axis_size
from ..parallel.mesh import BATCH_AXES, MODEL, PIPE, SEQ
from .runner import RunConfig, WorkloadParts

logger = logging.getLogger(__name__)


def transformer_parts(cfg: RunConfig, device: torch.device, *, mlm: bool,
                      mesh=None) -> WorkloadParts:
    """WorkloadParts for a Transformer workload: a trainable model with
    random weights from ``cfg.train.seed`` on ``device`` (this rank's
    shards on ``mesh``, by the specs ``init_train_state`` computes: the
    rules, then ``auto_fsdp_specs``; at ``pipe`` above 1 this rank's stage
    of the pipelined family; every rank of one data shard — its ``pipe``,
    ``model`` and ``seq`` ranks — reads that shard's rows of each batch);
    the masked-LM loss and eval (``mlm``, the encoder) or the next-token ones (the
    causal decoder, chunked when ``model.xent_chunk > 0`` on the dense
    path); the text stream, a held-out eval stream at a disjoint index
    range, and the forward FLOPs per step (the gathered MLM head's
    positions only)."""
    mcfg: tfm.TransformerConfig = cfg.model
    if cfg.data.seq_len > mcfg.max_len:
        raise ValueError(f"data.seq_len={cfg.data.seq_len} exceeds "
                         f"model.max_len={mcfg.max_len}")
    if cfg.data.vocab_size != mcfg.vocab_size:
        raise ValueError(f"data.vocab_size={cfg.data.vocab_size} != "
                         f"model.vocab_size={mcfg.vocab_size}")
    tfm.check_supported(mcfg)
    n_pred = resolved_max_predictions(cfg.data) if mlm else 0
    # every pipe, model and seq rank of a data shard reads its rows (where
    # all are 1 the process's rows are the data shard's)
    shard = None if mesh is None or mesh.shape[MODEL] == mesh.shape[SEQ] == \
        mesh.shape[PIPE] == 1 else (axis_index(BATCH_AXES, mesh), axis_size(BATCH_AXES, mesh))
    pipe = 1 if mesh is None else mesh.shape[PIPE]
    if pipe > 1:
        if not mlm and mcfg.xent_chunk > 0:
            logger.info("pipelined path: model.xent_chunk=%d not applied — the schedule's "
                        "per-microbatch logits already bound the logits tier at B/M",
                        mcfg.xent_chunk)
        n_virtual = cfg.train.pipeline_virtual
        model = tfm.init_pipelined(
            mcfg, cfg.train.seed, device, trainable=True, mesh=mesh, n_virtual=n_virtual,
            n_microbatches=cfg.train.pipeline_microbatches or 2 * pipe * n_virtual)
        loss_fn = tfm.mlm_loss_fn(model) if mlm else tfm.lm_loss_fn(model)
        eval_fn = tfm.transformer_eval_fn(model, mlm=mlm)
        extra = dict(param_specs=model.specs)
    else:
        specs = {} if mesh is None else tfm.transformer_specs(mcfg, mesh)
        params = tfm.init_params(mcfg, seed=cfg.train.seed, device=device, trainable=True)
        model = tfm.build(mcfg, params, device, trainable=True, mesh=mesh, specs=specs)
        loss_fn = (tfm.mlm_loss_fn(model) if mlm
                   else tfm.causal_lm_loss(model, mcfg.xent_chunk))
        eval_fn = (tfm.mlm_eval_fn(model) if mlm
                   else tfm.lm_eval_fn(model, mcfg.xent_chunk))
        extra = dict(param_rules=tfm.transformer_rules(mcfg), param_specs=specs, fsdp=True)
    return WorkloadParts(
        model=model,
        loss_fn=loss_fn,
        eval_fn=eval_fn,
        dataset_fn=lambda start: make_text_dataset(cfg.data, index_offset=start, shard=shard),
        # held out for the synthetic streams (generated by index); for a
        # token file, other windows of the same corpus
        eval_dataset_fn=lambda n: make_text_dataset(cfg.data, num_batches=n,
                                                    index_offset=10**6, shard=shard),
        flops_per_step=tfm.flops_per_example(mcfg, cfg.data.seq_len,
                                             n_predictions=n_pred or None)
        * cfg.data.global_batch_size,
        batch_size=cfg.data.global_batch_size,
        **extra,
    )
