"""The Transformer — the serve and training subsets of
``distributed_tensorflow_tpu/models/transformer.py`` in PyTorch: the
causal pre-LN decoder (``gpt_small``) and the post-LN encoder with its
MLM head (``bert_base``).

What is here: ``TransformerConfig``, ``gpt_small()``, ``bert_base()`` and
``Transformer`` with its two forwards — the paged decode path (causal
only: ``kv_cache`` block pool + ``block_table`` + ``decode_pos``: a
prefill chunk, a decode step and a speculative verify step are all this
one call) and the uncached training path (``train=``, dropout from an
explicit ``torch.Generator`` or a data-parallel step's ``RowGenerator``,
``return_hidden`` for the chunked loss, ``positions`` for the gathered
MLM head) — plus the losses (dense and
chunked next-token cross-entropy, masked-LM), the eval statistics and the
parameter and FLOPs counts. The cast points mirror the flax model exactly:

- token embedding (f32) + position embedding (f32), added in f32, then
  cast to ``cfg.dtype``;
- LayerNorm in f32, eps 1e-6, flax's fast variance (E[x²] − E[x]²),
  output cast to ``cfg.dtype``;
- Dense matmuls in ``cfg.dtype`` (weight and bias cast to it);
- GELU with the tanh approximation (flax ``nn.gelu``'s default);
- post-LN (``pre_ln=False``): ``x = LN1(x + attn(x))``, ``x = LN2(x +
  mlp(x))``, the residual added in ``cfg.dtype``, the LayerNorm in f32,
  the result cast back; ``embed_ln`` after the embeddings and no
  ``final_ln``;
- the MLM head of a non-causal model: the ``positions`` [B,K] gathered
  first (when given), then ``mlm_transform`` (Dense d→d in
  ``cfg.dtype``), GELU and ``mlm_ln`` in f32, cast to ``cfg.dtype``;
- dropout at flax's three sites (embeddings, attention output, MLP
  output): keep with probability ``1 - rate``, scale the kept by
  ``1 / (1 - rate)``;
- the tied head in ``head_dtype`` with f32 logits, plus ``mlm_bias``;
- ``fused_ln_matmul=True``: ln1→q/k/v and ln2→mlp_in run through
  ``ops.fused_ln_matmul.ln_matmul`` on the raw residual stream (f32 bias,
  the Dense weight cast to ``cfg.dtype`` at use, as the JAX branch does),
  in the paged and the uncached forward; it trains through the op's
  backward (``DTF_FUSED_BWD``, ``ops/_policy.py``). Its LayerNorm variance
  is the kernel's two-pass one, so fused and unfused passes differ by
  rounding.

Parameters follow the flax tree (``weights.from_jax_params`` converts
one). Biases, LayerNorm parameters and embeddings are f32. Dense weights
are stored ``[out, in]`` (``nn.Linear`` layout): in ``cfg.dtype`` for
serving, and as f32 masters cast to ``cfg.dtype`` at each use for
training (``trainable=True``) — flax's ``nn.Dense(dtype=bf16)`` keeps
``param_dtype=f32`` the same way.

``remat=True`` runs each Block of the uncached path under
``torch.utils.checkpoint`` (the JAX model's ``nn.remat``): its
activations are recomputed in the backward instead of kept. Dropout
draws from an explicit generator, whose state ``checkpoint`` does not
save, so each Block's generator state is snapshotted before its forward
and replayed in the recompute (``_remat_block``): the recompute draws the
same masks, and the caller's generator is left where a forward without
remat leaves it. ``fused_qkv=True`` projects q/k/v with one ``qkv`` Dense
``[3·H·D, d]`` whose rows are HEAD-major (``[H, 3, D]``), as the JAX
model's; refused with ``fused_ln_matmul``. MoE comes in a later slice
(ROADMAP Queue A item 6c); a config that asks for it is refused.

**Sequence parallelism** (``seq_impl`` = ``"ring"``, ``"ulysses"`` or
``"allgather"``, on a ``mesh`` whose ``seq`` axis exceeds 1): the
uncached attention runs ``parallel.ring_attention.
sequence_parallel_attention`` on this rank's rows and heads over the
whole sequence, as the JAX model's does at ``seq_shards > 1``; the rest
of the model, the cached and paged paths and the parameters are those of
one rank (no parameter is split over ``seq``: JAX initialises through a
dense twin). It composes with the megatron heads over ``model`` and with
``remat``. With ``seq`` at 1 the attention is ``attention_impl``'s.

**Tensor and fully-sharded data parallelism** (``mesh=``, ``specs=``): the
layout GSPMD gives the JAX model under ``transformer_rules`` written out
(``TRANSFORMER_RULES`` is the JAX table, its regexes read through
``jax_view``). Over ``model`` (n ranks): q, k, v (or the head-major
``qkv``, whose contiguous shard is whole heads) and ``mlp_in`` are
column-parallel, ``attn_out`` and ``mlp_out`` row-parallel — each rank's
partial product summed by ``reduce_from_model``, the bias added once
after the sum; attention runs on the rank's H/n heads; ``copy_to_model``
opens each parallel region on the replicated stream (the q/k/v and
``mlp_in`` inputs, and the tied head's), so the stream's gradient is
summed over ``model``. In the fused LN+matmul path the raw stream and
the LayerNorm's γ and β enter through ``copy_to_model``: the kernel's
backward gives this rank's columns' share of dx, dγ and dβ, which the
copy sums. The token table and ``mlm_bias`` are range-sharded over the
vocabulary (padded as ``ops/embedding.shard_vocab`` pads): the lookup is
``range_sharded_lookup``, the head gives this rank's vocab columns, and
the losses and statistics are vocab-parallel (``VocabShard``: the row max
all-reduced by MAX, the sum of exponentials and the target logit by a
sum, the arg-max by value then the lowest global index; padded columns
masked to -inf). Over ``fsdp``: a parameter that ``auto_fsdp_specs``
shards (gpt_small's ``pos_embed``, BERT's and its ``mlm_transform``
kernel) is all-gathered at each use by ``gather_fsdp``, whose backward
reduce-scatters its gradient. ``model=1`` and ``fsdp=1`` run the code
path of one process.

**Pipeline parallelism** (``PipelinedTransformer``, ``mesh`` with ``pipe``
S above 1; JAX's pipelined family): the same ``Block`` runs inside
``parallel/pipeline.py``'s schedule. The JAX package stacks every block
leaf ``[S, (V,) layers, ...]`` sharded over ``pipe``
(``to_pipeline_params``, ``pipeline_param_specs``); here that stacked tree
is the interchange layout, from which each rank's model takes its stage's
rows (``build_pipelined``): it holds the ends (embeddings, LayerNorms, the
MLM head, ``mlm_bias``, replicated) and only its own V chunks of ``L /
(S·V)`` Blocks, chunk c = v·S + d on rank d, each Block named by its
GLOBAL layer (``layers.<i>``), so that its names are the dense model's
(``jax_view``, the checkpoint, ``weights.py``). The embedding (and
``embed_ln`` and the embedding dropout) runs before the island, the final
LayerNorm, the MLM head on ``positions`` and the tied head after it; the
attention mask rides along as the schedule's aux input; ``seq_impl`` is
None inside the stages; the losses and eval statistics are the dense ones
(``lm_loss_fn`` — never chunked, as JAX's pipelined path ignores
``xent_chunk`` — ``mlm_loss_fn``, ``transformer_eval_fn``). Under PP×TP
(``model`` above 1 too) each rank holds its ``[pipe slice × model
slice]`` of every block leaf and the Blocks are the megatron ones above;
the ends stay replicated (JAX's ``pipeline_param_specs``), and
``fused_ln_matmul`` and ``fused_qkv`` are refused there, as JAX's manual
TP Block refuses them. Dropout draws from a generator seeded by (the
step's seed, microbatch, global layer, batch shard) — the embedding's by
(seed, ``num_layers``), over the global batch's rows — so any (S, V) at
one batch sharding draws the same masks, and the recompute replays them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.text import IGNORE_INDEX
from ..ops.attention import attention, paged_append_kv, paged_attention
from ..ops.embedding import range_sharded_lookup
from ..ops.fused_ln_matmul import ln_matmul
from ..parallel import sharding as sh
from ..parallel.collectives import (
    all_reduce_max,
    all_reduce_min,
    axis_index,
    copy_to_model,
    gather_fsdp,
    sum_over_axis,
)
from ..parallel.mesh import BATCH_AXES, EXPERT, FSDP, MODEL, PIPE, SEQ, Mesh, mesh_axis_size
from ..parallel.ring_attention import IMPLS as SEQ_IMPLS
from ..parallel.ring_attention import sequence_parallel_attention
from ..parallel.pipeline import microbatch, pipeline_apply, unmicrobatch
from ..parallel.sharding import RowGenerator, rand_rows
from ..utils import flops as flops_lib
from ..utils.device import resolve_device

LN_EPS = 1e-6  # flax nn.LayerNorm default
#: the module names of the model's LayerNorms (scale ones, bias zeros)
LN_NAMES = ("ln1", "ln2", "final_ln", "embed_ln", "mlm_ln")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30528
    max_len: int = 512
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    dropout: float = 0.1
    causal: bool = False
    pre_ln: bool = False
    dtype: str = "bfloat16"
    # training attention dispatch (ops.attention.attention impl=):
    # "auto" = the flash kernels on a CUDA tensor, "dense" on the CPU;
    # "dense" | "flash" | "blockwise" force one
    attention_impl: str = "auto"
    # paged attention dispatch (ops.attention.paged_attention impl=):
    # "auto" = the CUDA kernel on a CUDA tensor, "fused" on the CPU;
    # "gather" | "fused" | "cuda" force one
    paged_attention_impl: str = "auto"
    # sequence parallelism over the mesh's seq axis: None | "ring" |
    # "ulysses" | "allgather" (parallel/ring_attention.py)
    seq_impl: str | None = None
    # not ported yet (ROADMAP Queue A item 6c): above 0 is refused when the
    # model is built
    num_experts: int = 0
    # each Block recomputed in the backward (torch.utils.checkpoint): one
    # extra forward for O(1)-block activation memory
    remat: bool = False
    # q/k/v from one [3·d, d] Dense "qkv", rows head-major [H, 3, D]
    fused_qkv: bool = False
    # ln1->q/k/v and ln2->mlp_in through the fused LN+matmul kernels
    # (same parameter tree as the unfused path)
    fused_ln_matmul: bool = False
    # >0: the training loss projects and scores this many positions at a
    # time (chunked_lm_loss_fn), so [B, S, vocab] logits never exist
    xent_chunk: int = 0
    # input dtype of the tied-embedding vocab projection (f32 logits out)
    head_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model={self.d_model} not divisible by "
                             f"num_heads={self.num_heads}")
        return self.d_model // self.num_heads


def bert_base() -> TransformerConfig:
    """BERT-base/uncased shape (BASELINE.json:10): post-LN, bidirectional."""
    return TransformerConfig()


def gpt_small(causal_len: int = 1024) -> TransformerConfig:
    """Decoder-only LM, GPT-2-small shape — pre-LN, causal."""
    return TransformerConfig(
        vocab_size=50304, max_len=causal_len, num_layers=12, d_model=768,
        num_heads=12, d_ff=3072, causal=True, pre_ln=True,
    )


#: The JAX package's static path fixture of ``TRANSFORMER_RULES``: the
#: union of the BERT encoder, the fused-QKV causal decoder and the MoE
#: interleave at num_layers=2 (``jax_view`` paths)
_TRANSFORMER_COVERAGE = (
    "embed_ln/bias", "embed_ln/scale", "final_ln/bias", "final_ln/scale",
    "layer_0/attn/attn_out/bias", "layer_0/attn/attn_out/kernel",
    "layer_0/attn/key/bias", "layer_0/attn/key/kernel",
    "layer_0/attn/qkv/bias", "layer_0/attn/qkv/kernel",
    "layer_0/attn/query/bias", "layer_0/attn/query/kernel",
    "layer_0/attn/value/bias", "layer_0/attn/value/kernel",
    "layer_0/ln1/bias", "layer_0/ln1/scale", "layer_0/ln2/bias",
    "layer_0/ln2/scale", "layer_0/mlp_in/bias", "layer_0/mlp_in/kernel",
    "layer_0/mlp_out/bias", "layer_0/mlp_out/kernel",
    "layer_1/attn/attn_out/bias", "layer_1/attn/attn_out/kernel",
    "layer_1/attn/key/bias", "layer_1/attn/key/kernel",
    "layer_1/attn/qkv/bias", "layer_1/attn/qkv/kernel",
    "layer_1/attn/query/bias", "layer_1/attn/query/kernel",
    "layer_1/attn/value/bias", "layer_1/attn/value/kernel",
    "layer_1/ln1/bias", "layer_1/ln1/scale", "layer_1/ln2/bias",
    "layer_1/ln2/scale", "layer_1/mlp_in/bias", "layer_1/mlp_in/kernel",
    "layer_1/mlp_out/bias", "layer_1/mlp_out/kernel", "layer_1/moe/b_in",
    "layer_1/moe/b_out", "layer_1/moe/router/bias",
    "layer_1/moe/router/kernel", "layer_1/moe/w_in", "layer_1/moe/w_out",
    "mlm_bias", "mlm_ln/bias", "mlm_ln/scale", "mlm_transform/bias",
    "mlm_transform/kernel", "pos_embed", "tok_embed/embedding",
)

#: The JAX package's Transformer partition-rules table, row for row (specs
#: in the flax layout: a Dense kernel is [in, out]): column-parallel in
#: (output dim over ``model``), row-parallel out (input dim over
#: ``model``), the vocabulary over ``model``; variant rows tagged. The MoE
#: rows stay in the table and are never selected (``num_experts`` is
#: refused, ROADMAP item 6).
TRANSFORMER_RULES = sh.partition_rules(
    "transformer",
    (
        (r"(^|/)w_in$", (EXPERT, None, MODEL), "moe"),
        (r"(^|/)b_in$", (EXPERT, MODEL), "moe"),
        (r"(^|/)w_out$", (EXPERT, MODEL, None), "moe"),
        (r"(^|/)b_out$", (EXPERT, None), "moe"),
        (r"(query|key|value)/kernel", (None, MODEL), "split_qkv"),
        (r"(query|key|value)/bias", (MODEL,), "split_qkv"),
        (r"qkv/kernel", (None, MODEL), "fused_qkv"),
        (r"qkv/bias", (MODEL,), "fused_qkv"),
        (r"attn_out/kernel", (MODEL, None)),
        (r"mlp_in/kernel", (None, MODEL), "dense_mlp"),
        (r"mlp_in/bias", (MODEL,), "dense_mlp"),
        (r"mlp_out/kernel", (MODEL, None), "dense_mlp"),
        (r"tok_embed/embedding", (MODEL, None)),  # vocab-sharded
        (r"mlm_bias", (MODEL,)),
        (sh.CATCH_ALL, sh.REPLICATED),
    ),
    coverage=_TRANSFORMER_COVERAGE,
)


def transformer_rules(cfg: "TransformerConfig") -> sh.PartitionRules:
    """The exact table for ``cfg``'s parameter tree (split or fused QKV,
    the dense MLP), so that the strict match holds."""
    check_supported(cfg)  # num_experts: the MoE rows wait for item 6c
    return TRANSFORMER_RULES.select("fused_qkv" if cfg.fused_qkv else "split_qkv",
                                    "dense_mlp")


def tp_rules():
    """The soft form of ``TRANSFORMER_RULES``: every row as ``(pattern,
    spec)``."""
    return TRANSFORMER_RULES.as_path_rules()


def transformer_specs(cfg: "TransformerConfig", mesh: Mesh) -> dict[str, sh.Spec]:
    """Each parameter of ``Transformer(cfg)`` to its spec in the port's
    layout on ``mesh``: the rules, then ``auto_fsdp_specs`` merged, as the
    JAX workloads' ``init_train_state`` computes them (``fsdp=True``)."""
    return sh.param_specs(Transformer(cfg, device="meta", trainable=True),
                          transformer_rules(cfg), mesh)


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (config dtypes are strings,
    as in the JAX config)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _param(*shape, dtype=torch.float32, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device),
                        requires_grad=False)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | RowGenerator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: identity unless ``train`` and ``rate > 0``;
    else keep each element with probability ``1 - rate`` (uniform draws
    from ``generator``; a data-parallel step's ``RowGenerator`` gives this
    rank's rows of the global batch's draw) and scale the kept by
    ``1 / (1 - rate)``."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train=True with dropout > 0 needs a torch.Generator")
    keep = rand_rows(x.shape, generator, x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


def _full(module: nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name``, all-gathered over ``fsdp`` when it
    is an ``fsdp`` shard (``Transformer._shard``)."""
    t = getattr(module, name)
    dims = getattr(module, "fsdp_dims", None)
    return t if not dims or name not in dims else gather_fsdp(t, dims[name], module.fsdp_mesh)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 statistics with the fast
    variance, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = _param(features, device=device)  # flax "scale"
        self.bias = _param(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + LN_EPS) * _full(self, "weight")) \
            + _full(self, "bias")


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=cfg.dtype)``: weight ``[out, in]`` stored in
    ``param_dtype`` (the compute dtype for serving, f32 masters for
    training) and cast to the compute dtype at use; bias kept in f32 (the
    fused path adds it in f32, the plain path casts it as flax does)."""

    def __init__(self, in_features: int, out_features: int, dtype, device=None,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _param(out_features, in_features, dtype=param_dtype or dtype,
                             device=device)
        self.bias = _param(out_features, device=device)
        # a row-parallel Dense's mesh: the partial products summed over
        # model, then the bias added once (module docstring)
        self.row_parallel = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = _full(self, "weight").to(self.dtype), _full(self, "bias").to(self.dtype)
        if self.row_parallel is None:
            return F.linear(x, w, b)
        return sum_over_axis(F.linear(x, w), MODEL, self.row_parallel) + b


def _ln_dense(x2: torch.Tensor, ln: tuple, dense: Dense, dt) -> torch.Tensor:
    """``dense(ln(x2))`` through the fused LN+matmul op: x2 [M, d] is the raw
    residual stream, ``ln`` the LayerNorm's ``(gamma, beta)``; the weight is
    cast to the compute dtype at use (a no-op for serving weights) and
    passed as its ``[in, out]`` view."""
    return ln_matmul(x2, *ln, _full(dense, "weight").to(dt).t(), _full(dense, "bias"),
                     eps=LN_EPS, out_dtype=dt)


def _enter(x2: torch.Tensor, ln: LayerNorm, mesh) -> tuple[torch.Tensor, tuple]:
    """The raw stream and the LayerNorm's ``(gamma, beta)`` entering the
    fused LN+matmul's parallel region (module docstring)."""
    return copy_to_model(x2, mesh), tuple(copy_to_model(_full(ln, n), mesh)
                                          for n in ("weight", "bias"))


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        # this rank's heads and the mesh of its parallel region; the mesh
        # of the sequence-parallel attention (its seq axis above 1)
        self.heads, self.mesh, self.seq_mesh = cfg.num_heads, None, None
        dt, d = torch_dtype(cfg.dtype), cfg.d_model
        if cfg.fused_qkv:
            # rows head-major, [H, 3, D]: each head's q, k, v side by side
            self.qkv = Dense(d, 3 * d, dt, device, param_dtype)
        else:
            self.query = Dense(d, d, dt, device, param_dtype)
            self.key = Dense(d, d, dt, device, param_dtype)
            self.value = Dense(d, d, dt, device, param_dtype)
        self.attn_out = Dense(d, d, dt, device, param_dtype)

    def _qkv(self, x, ln=None):
        """q, k, v as [B,H,S,D] views of the [B,S,H*D] projections; with
        ``ln`` the raw residual ``x`` is normalised inside the fused
        kernel. With ``fused_qkv`` one ``[B,S,H,3,D]`` projection, each of
        q, k, v copied out contiguous (the kernels read no strided head
        dim)."""
        cfg = self.cfg
        B, S, d = x.shape
        H, D = self.heads, cfg.head_dim
        if ln is not None:
            x2, gb = _enter(x.reshape(B * S, d), ln, self.mesh)

            def proj(dense):
                return _ln_dense(x2, gb, dense, x.dtype)
        else:
            x = copy_to_model(x, self.mesh)

            def proj(dense):
                return dense(x)

        if cfg.fused_qkv:
            qkv = proj(self.qkv).reshape(B, S, H, 3, D)
            return tuple(qkv[..., i, :].transpose(1, 2).contiguous() for i in range(3))

        # [B,S,H*D] -> [B,H,S,D] (the ops layout)
        return tuple(proj(p).reshape(B, S, H, D).transpose(1, 2)
                     for p in (self.query, self.key, self.value))

    def _out(self, out):
        B, H, S, D = out.shape
        return self.attn_out(out.transpose(1, 2).reshape(B, S, H * D))

    def forward(self, x, k_pool, v_pool, block_table, pos, ln=None):
        """Paged: ``x`` [B,S,d] (the raw residual stream when ``ln`` is
        given — the fused path normalises inside the kernel); ``k_pool``/
        ``v_pool`` this layer's ``[NB+1,H,bs,D]`` pool, updated in place."""
        q, k, v = self._qkv(x, ln)
        paged_append_kv(k_pool, k, block_table, pos)
        paged_append_kv(v_pool, v, block_table, pos)
        NB = k_pool.shape[0] - 1
        out = paged_attention(
            q.contiguous(), k_pool[:NB], v_pool[:NB], block_table, q_pos=pos,
            impl=self.cfg.paged_attention_impl)
        return self._out(out)

    def forward_uncached(self, x, mask, *, train: bool, generator=None, ln=None):
        """Uncached (training) attention over the whole sequence: ``mask``
        [B,S] bool or None; dropout on the output projection; ``ln`` as in
        ``forward``."""
        cfg = self.cfg
        q, k, v = self._qkv(x, ln)
        if self.seq_mesh is not None:
            out = sequence_parallel_attention(q, k, v, self.seq_mesh, impl=cfg.seq_impl,
                                              causal=cfg.causal, kv_mask=mask)
        else:
            out = attention(q, k, v, causal=cfg.causal, kv_mask=mask,
                            impl=cfg.attention_impl)
        return dropout(self._out(out), cfg.dropout, train, generator)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = None  # the mesh of the MLP's parallel region
        dt = torch_dtype(cfg.dtype)
        self.ln1 = LayerNorm(cfg.d_model, device)
        self.attn = SelfAttention(cfg, device, param_dtype)
        self.ln2 = LayerNorm(cfg.d_model, device)
        self.mlp_in = Dense(cfg.d_model, cfg.d_ff, dt, device, param_dtype)
        self.mlp_out = Dense(cfg.d_ff, cfg.d_model, dt, device, param_dtype)

    def _mlp_tail(self, h, train=False, generator=None):
        # everything after the mlp_in matmul, shared by every path
        h = self.mlp_out(F.gelu(h, approximate="tanh"))
        return dropout(h, self.cfg.dropout, train, generator)

    def _mlp_in(self, x):
        """``mlp_in`` of the (normalised) stream, entering the MLP's
        parallel region."""
        return self.mlp_in(copy_to_model(x, self.mesh))

    def forward(self, x, k_pool, v_pool, block_table, pos):
        """Paged decode (see ``SelfAttention.forward``)."""
        dt = x.dtype
        if not self.cfg.pre_ln:
            x = self.ln1(x + self.attn(x, k_pool, v_pool, block_table, pos)).to(dt)
            return self.ln2(x + self._mlp_tail(self._mlp_in(x))).to(dt)
        if self.cfg.fused_ln_matmul:
            x = x + self.attn(x, k_pool, v_pool, block_table, pos, ln=self.ln1)
            return x + self._mlp_tail(self._fused_mlp_in(x))
        x = x + self.attn(self.ln1(x).to(dt), k_pool, v_pool, block_table, pos)
        return x + self._mlp_tail(self._mlp_in(self.ln2(x).to(dt)))

    def _fused_mlp_in(self, x):
        B, S, d = x.shape
        x2, gb = _enter(x.reshape(B * S, d), self.ln2, self.mesh)
        return _ln_dense(x2, gb, self.mlp_in, x.dtype).reshape(B, S, -1)

    def forward_uncached(self, x, mask, *, train: bool, generator=None):
        dt = x.dtype
        if not self.cfg.pre_ln:  # post-LN (BERT): the residual add in cfg.dtype
            x = self.ln1(x + self.attn.forward_uncached(
                x, mask, train=train, generator=generator)).to(dt)
            return self.ln2(x + self._mlp_tail(self._mlp_in(x), train, generator)).to(dt)
        if self.cfg.fused_ln_matmul:
            x = x + self.attn.forward_uncached(x, mask, train=train, generator=generator,
                                               ln=self.ln1)
            return x + self._mlp_tail(self._fused_mlp_in(x), train, generator)
        x = x + self.attn.forward_uncached(self.ln1(x).to(dt), mask, train=train,
                                           generator=generator)
        return x + self._mlp_tail(self._mlp_in(self.ln2(x).to(dt)), train, generator)


def flax_path(name: str) -> tuple[str, bool]:
    """The flax tree's path of the port's parameter ``name`` and whether
    its (last two) dims are the flax layout's reversed: ``layers.i`` is
    ``layer_i``, a LayerNorm's weight its ``scale``, a Dense weight its
    ``kernel`` ``[in, out]``, the token table ``tok_embed/embedding``."""
    if name == "tok_embed.weight":
        return "tok_embed/embedding", False
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layer_{parts[1]}", *parts[2:]]
    if len(parts) > 1 and parts[-2] in LN_NAMES:
        return "/".join(parts[:-1] + ["scale" if parts[-1] == "weight" else "bias"]), False
    if parts[-1] == "weight":
        return "/".join(parts[:-1] + ["kernel"]), True
    return "/".join(parts), False


def check_supported(cfg: TransformerConfig) -> None:
    """Refuse what the model cannot run (as the JAX model does) or the
    port does not have yet (naming the ROADMAP item)."""
    if cfg.fused_ln_matmul and not cfg.pre_ln:
        raise ValueError("fused_ln_matmul requires pre_ln=True (a post-LN LayerNorm "
                         "output is the residual stream itself and must materialize)")
    if cfg.fused_qkv and cfg.fused_ln_matmul:
        raise ValueError("fused_qkv and fused_ln_matmul are mutually exclusive (the "
                         "LN+matmul kernel owns its own per-projection path)")
    if cfg.seq_impl not in (None, *SEQ_IMPLS):
        raise ValueError(f"model.seq_impl must be None or one of {SEQ_IMPLS}, got "
                         f"{cfg.seq_impl!r}")
    if cfg.num_experts != 0:
        raise ValueError(f"model.num_experts={cfg.num_experts!r} is not ported yet "
                         f"(ROADMAP Queue A item 6c, ops/moe.py)")


class Transformer(nn.Module):
    """Token-in, logits-out transformer.

    Uncached (training, eval): ``forward(input_ids [B,S], attention_mask
    [B,S] or None, *, train, generator, positions, return_hidden)`` ->
    logits ``[B,S,vocab]`` f32, or ``[B,K,vocab]`` with ``positions``
    [B,K] (MLM models only: the K positions are gathered before the MLM
    head), or the final hidden states ``[B,S,d]`` in ``cfg.dtype`` with
    ``return_hidden``.

    Paged (causal models): ``forward(input_ids [B,S], kv_cache=,
    decode_pos=[B,S], block_table=[B,MB] int32)`` -> ``(logits
    [B,S,vocab] f32, kv_cache)``.
    The S tokens sit at the absolute positions ``decode_pos``; their K/V
    are written into the pool IN PLACE (the JAX version donates the pool
    and returns a new one — here the returned cache is the same object)
    and attention reads the pool through the table. ``kv_cache`` is a
    ``serve.kv_cache.PagedKVCache`` (duck-typed: ``k_buf``/``v_buf``
    ``[L, NB+1, H, bs, D]``).

    ``trainable=True`` stores Dense weights as f32 masters (see module
    docstring). ``mesh`` and ``specs`` (``transformer_specs``): this rank's
    shards of the parameters, the tensor- and fully-sharded-parallel
    forward (module docstring); the logits are then this rank's vocab
    columns (``vocab_shard``). ``layer_ids``: build only those global
    layers, named ``layers.<i>`` (a pipeline stage's, ``PipelinedTransformer``)."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False,
                 mesh: Mesh | None = None, specs: dict | None = None, layer_ids=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.mesh, self.specs = mesh, dict(specs or {})
        pdt = torch.float32 if trainable else None
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device,
                                      dtype=torch.float32)
        self.tok_embed.weight.requires_grad_(False)
        self.pos_embed = _param(cfg.max_len, cfg.d_model, device=device)
        if not cfg.pre_ln:
            self.embed_ln = LayerNorm(cfg.d_model, device)
        self.layers = (nn.ModuleList(Block(cfg, device, pdt) for _ in range(cfg.num_layers))
                       if layer_ids is None else
                       nn.ModuleDict({str(i): Block(cfg, device, pdt) for i in layer_ids}))
        if cfg.pre_ln:
            self.final_ln = LayerNorm(cfg.d_model, device)
        if not cfg.causal:
            self.mlm_transform = Dense(cfg.d_model, cfg.d_model, torch_dtype(cfg.dtype),
                                       device, pdt)
            self.mlm_ln = LayerNorm(cfg.d_model, device)
        self.mlm_bias = _param(cfg.vocab_size, device=device)
        #: the whole (unsharded) shape of every parameter
        self.global_shapes = {n: tuple(p.shape) for n, p in self.named_parameters()}
        if any(self.specs.values()):
            self._shard(mesh)
        if cfg.seq_impl is not None and mesh is not None and mesh.shape[SEQ] > 1:
            for block in self.blocks:
                block.attn.seq_mesh = mesh

    @property
    def blocks(self) -> list[Block]:
        """The Blocks this model holds, in layer order."""
        return list(self.layers.values() if isinstance(self.layers, nn.ModuleDict)
                    else self.layers)

    def _shard(self, mesh: Mesh) -> None:
        """Each parameter with a sharding spec replaced by this rank's
        (empty) shard; the row-parallel Denses, the attention's heads and
        the parallel regions told the mesh; ``fsdp`` shards noted for
        ``_full``."""
        cfg, n = self.cfg, mesh.shape[MODEL]
        for what, size in (("num_heads", cfg.num_heads), ("d_ff", cfg.d_ff)):
            if size % n:
                raise ValueError(f"model.{what}={size} does not divide over mesh.model={n}")
        for name, p in list(self.named_parameters()):
            spec = sh.check_spec(self.specs.get(name, sh.REPLICATED), name)
            owner, leaf = self._owner(name)
            shape = sh.local_shape(p.shape, spec, mesh)
            if shape != tuple(p.shape):
                setattr(owner, leaf, _param(*shape, dtype=p.dtype, device=p.device))
            for d, a in sh._dims(spec):
                if a == FSDP and mesh.shape[FSDP] > 1:
                    if not hasattr(owner, "fsdp_dims"):
                        owner.fsdp_dims, owner.fsdp_mesh = {}, mesh
                    owner.fsdp_dims[leaf] = d
        if n > 1:
            self.tp_mesh = mesh
            for block in self.blocks:
                block.mesh = block.attn.mesh = mesh
                block.attn.heads = cfg.num_heads // n
                block.attn.attn_out.row_parallel = block.mlp_out.row_parallel = mesh

    def _owner(self, name: str) -> tuple[nn.Module, str]:
        mod, _, leaf = name.rpartition(".")
        return (self.get_submodule(mod) if mod else self), leaf

    #: the mesh of the tensor-parallel forward (None: one rank's vocab)
    tp_mesh = None

    @property
    def vocab_shard(self) -> "VocabShard | None":
        """This rank's columns of the logits under tensor parallelism."""
        if self.tp_mesh is None:
            return None
        rows = self.tok_embed.weight.shape[0]
        return VocabShard(axis_index(MODEL, self.tp_mesh) * rows, self.cfg.vocab_size,
                          self.tp_mesh)

    def jax_view(self, name: str) -> tuple[str, tuple, bool]:
        """The flax tree's ``(path, shape, transposed)`` of parameter
        ``name`` (``parallel/sharding.param_specs``; ``flax_path``)."""
        shape = self.global_shapes[name]
        path, transposed = flax_path(name)
        return path, shape[::-1] if transposed else shape, transposed

    def embed(self, input_ids) -> torch.Tensor:
        """The token embeddings (f32), over the vocab shards when sharded."""
        if self.tp_mesh is not None:
            return range_sharded_lookup(input_ids, self.tok_embed.weight, self.tp_mesh)
        return F.embedding(input_ids, _full(self.tok_embed, "weight"))

    def head(self, x) -> torch.Tensor:
        """The tied head: f32 logits of this rank's vocab columns (all of
        them on one rank), plus ``mlm_bias``."""
        x = copy_to_model(x, self.tp_mesh)
        return head_projection(x, _full(self.tok_embed, "weight"), self.cfg.head_dtype) \
            + _full(self, "mlm_bias")

    def forward(self, input_ids, attention_mask=None, *, train: bool = False,
                generator: torch.Generator | None = None, positions=None,
                return_hidden: bool = False, kv_cache=None, decode_pos=None,
                block_table=None):
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        if kv_cache is not None:
            if not cfg.causal:
                raise ValueError("KV-cached decode requires causal=True")
            if attention_mask is not None or train or return_hidden or positions is not None:
                raise ValueError("the paged KV-cache path is inference-only and takes "
                                 "no attention_mask, positions or return_hidden")
            if any(self.specs.values()):
                raise NotImplementedError("the paged path of a sharded model: serving's "
                                          "cache sharding is ROADMAP Queue A item 1")
            pos = decode_pos.long().clamp(0, cfg.max_len - 1)
            x = (self.embed(input_ids) + self.pos_embed[pos]).to(dt)
            if not cfg.pre_ln:
                x = self.embed_ln(x).to(dt)
            for i, block in enumerate(self.layers):
                x = block(x, kv_cache.k_buf[i], kv_cache.v_buf[i], block_table,
                          decode_pos)
            if cfg.pre_ln:
                x = self.final_ln(x).to(dt)
            return self.head(x), kv_cache
        x = dropout(self._stream(input_ids), cfg.dropout, train, generator)
        mask = attention_mask.to(torch.bool) if attention_mask is not None else None
        for block in self.layers:
            if cfg.remat:
                x = _remat_block(block, x, mask, train, generator)
            else:
                x = block.forward_uncached(x, mask, train=train, generator=generator)
        if cfg.pre_ln:
            x = self.final_ln(x).to(dt)
        if return_hidden:
            # the chunked loss applies the same tied projection per chunk
            return x
        return self._logits(x, positions)

    def _stream(self, input_ids) -> torch.Tensor:
        """The uncached forward's residual stream before the Blocks: the
        embeddings summed in f32, cast to ``cfg.dtype``, and ``embed_ln``
        (post-LN)."""
        cfg = self.cfg
        S = input_ids.shape[1]
        if S > cfg.max_len:
            raise ValueError(f"sequence length {S} exceeds max_len={cfg.max_len}")
        x = (self.embed(input_ids) + _full(self, "pos_embed")[None, :S]).to(
            torch_dtype(cfg.dtype))
        return x if cfg.pre_ln else self.embed_ln(x).to(x.dtype)

    def _logits(self, x, positions) -> torch.Tensor:
        """The uncached forward after the final LayerNorm: the ``positions``
        gathered, the MLM head (non-causal models) and the tied head."""
        if positions is not None:
            if self.cfg.causal:
                raise ValueError("positions gather is the MLM head path; causal LMs "
                                 "predict every position")
            idx = positions.long()[..., None].expand(-1, -1, x.shape[-1])
            x = torch.gather(x, 1, idx)  # [B, K, d]
        if not self.cfg.causal:
            x = F.gelu(self.mlm_transform(x), approximate="tanh")
            x = self.mlm_ln(x).to(x.dtype)
        return self.head(x)


def _generator_snapshot(generator):
    """``(generator, state)`` of the explicit generator a Block draws its
    dropout from (a ``RowGenerator``'s underlying one), or None when it
    draws nothing."""
    if generator is None:
        return None
    gen = generator.generator if isinstance(generator, RowGenerator) else generator
    return gen, gen.get_state()


def _remat_block(block: Block, x, mask, train: bool, generator):
    """``block.forward_uncached`` under ``torch.utils.checkpoint``, with the
    dropout generator's state replayed in the recompute (module
    docstring): the forward starts from the snapshot and leaves the
    generator advanced, as without remat; each recompute sets the snapshot,
    draws the same masks and puts back the state it found."""
    snap = _generator_snapshot(generator) if train and block.cfg.dropout > 0 else None
    recompute = [False]

    def run(x, mask):
        if snap is None:
            return block.forward_uncached(x, mask, train=train, generator=generator)
        gen, state = snap
        found = gen.get_state()
        gen.set_state(state)
        try:
            return block.forward_uncached(x, mask, train=train, generator=generator)
        finally:
            if recompute[0]:
                gen.set_state(found)
            recompute[0] = True

    return checkpoint(run, x, mask, use_reentrant=False, preserve_rng_state=False)


def head_projection(x: torch.Tensor, embedding: torch.Tensor,
                    head_dtype: str) -> torch.Tensor:
    """The tied-embedding vocab projection with f32 logits: the operands
    rounded to ``head_dtype``, multiplied exactly and summed in f32 (the
    JAX head's ``preferred_element_type=float32``)."""
    hd = torch_dtype(head_dtype)
    return torch.matmul(x.to(hd).float(), embedding.to(hd).float().t())


def init_params(cfg: TransformerConfig, seed: int = 0, device="cuda",
                trainable: bool = False, keep=None) -> dict[str, torch.Tensor]:
    """Random weights as flax initialises them: normal(0.02) for Dense
    kernels and both embeddings, zeros for biases and ``mlm_bias``,
    ones/zeros for every LayerNorm (``LN_NAMES``) — drawn in f32 from a
    ``torch.Generator`` on ``device`` (the card by default; raises without one unless
    ``device="cpu"``) seeded with ``seed``, then cast to each parameter's
    dtype (Dense weights stay f32 with ``trainable``). Returns a state
    dict for ``Transformer(cfg)``. The numbers differ from
    ``jax.random``'s for the same seed. ``keep(name)`` False: that tensor
    is drawn and dropped (the stream moves past it, so the kept ones are
    the whole model's), and left out of the dict."""
    device = resolve_device(device)
    model = Transformer(cfg, device="meta", trainable=trainable)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, p in model.state_dict().items():
        parts = name.split(".")
        leaf = parts[-1]
        is_ln = len(parts) > 1 and parts[-2] in LN_NAMES
        if keep is not None and not keep(name):
            if not is_ln and leaf != "bias" and name != "mlm_bias":
                torch.empty(p.shape, device=device).normal_(0.0, 0.02, generator=gen)
            continue
        if is_ln and leaf == "weight":
            t = torch.ones(p.shape, device=device)
        elif leaf == "bias" or name == "mlm_bias":
            t = torch.zeros(p.shape, device=device)
        else:  # Dense weights, tok_embed.weight, pos_embed
            t = torch.empty(p.shape, device=device).normal_(
                0.0, 0.02, generator=gen)
        out[name] = t.to(p.dtype)
    return out


def build(cfg: TransformerConfig, params, device, trainable: bool = False,
          mesh: Mesh | None = None, specs: dict | None = None) -> Transformer:
    """``Transformer(cfg)`` on ``device`` holding ``params`` (a state dict
    or another ``Transformer``'s weights); with ``mesh`` and ``specs``
    (``transformer_specs``), this rank's shard of each of the whole
    tensors of ``params`` (``sharding.shard_tensor``).

    Serving (``trainable=False``): tensors already on ``device`` in the
    right dtype are shared, not copied — so engines built with different
    configs over one set of weights hold it once — and every parameter
    is frozen. Training (``trainable=True``): f32 masters, always copied
    (the optimizer updates them in place), every parameter requires
    grad."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    model = Transformer(cfg, device="meta", trainable=trainable, mesh=mesh, specs=specs)
    specs = model.specs
    return _load(model, {k: sh.shard_tensor(v, specs[k], mesh) if specs.get(k) else v
                         for k, v in params.items()}, device, trainable)


def _load(model: Transformer, state: dict, device, trainable: bool) -> Transformer:
    """``model`` (built on ``meta``) holding ``state`` (this rank's tensors
    by name) on ``device``, as ``build`` describes."""
    want = model.state_dict()
    missing = set(want) - set(state)
    extra = set(state) - set(want)
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    model.load_state_dict({k: state[k].to(device=device, dtype=v.dtype, copy=trainable)
                           for k, v in want.items()}, assign=True)
    for p in model.parameters():
        p.requires_grad_(trainable)
    return model


# ---------------------------------------------------------------------------
# The pipelined family (module docstring; JAX models/transformer.py:700-1024)
# ---------------------------------------------------------------------------


def check_pipelineable(cfg: TransformerConfig, n_stages: int, n_virtual: int = 1) -> None:
    """Refuse what the pipelined family cannot stack (JAX's
    ``_check_pipelineable``)."""
    if cfg.num_experts > 0:
        raise ValueError("pipelined Transformer requires homogeneous blocks; num_experts > 0 "
                         "interleaves MoE layers (stack would be ragged; MoE itself is ROADMAP "
                         "Queue A item 6c)")
    if cfg.num_layers % (n_stages * n_virtual):
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"n_stages*n_virtual={n_stages}*{n_virtual}")


def stage_layers(cfg: TransformerConfig, n_stages: int, n_virtual: int, stage: int
                 ) -> list[int]:
    """The global layers of stage ``stage``, in order: its chunks v·S +
    stage for v < V, each ``L / (S·V)`` consecutive layers."""
    lpc = cfg.num_layers // (n_stages * n_virtual)
    return [(v * n_stages + stage) * lpc + i for v in range(n_virtual) for i in range(lpc)]


def _stacking(n_virtual: int) -> int:
    """How many leading dims a stacked block leaf has: ``[S, layers]`` or
    ``[S, V, layers]``."""
    return 2 if n_virtual == 1 else 3


def to_pipeline_params(params: dict, cfg: TransformerConfig, n_stages: int,
                       n_virtual: int = 1) -> dict:
    """A dense state dict -> ``{"ends": the non-block tensors, "blocks":
    {a Block's parameter name: every layer's stacked [S, L/S, ...]}}``; with
    ``n_virtual`` > 1 ``[S, V, L/(S·V), ...]``, row d's v-th chunk the
    layers of global chunk v·S + d (JAX's ``to_pipeline_params``)."""
    check_pipelineable(cfg, n_stages, n_virtual)
    S, V, L = n_stages, n_virtual, cfg.num_layers
    lpc = L // (S * V)
    head = "layers.0."
    blocks = {}
    for rel in (k[len(head):] for k in params if k.startswith(head)):
        x = torch.stack([params[f"layers.{i}.{rel}"] for i in range(L)])
        blocks[rel] = (x.reshape(S, lpc, *x.shape[1:]) if V == 1 else
                       x.reshape(V, S, lpc, *x.shape[1:]).transpose(0, 1).contiguous())
    ends = {k: v for k, v in params.items() if not k.startswith("layers.")}
    return {"ends": ends, "blocks": blocks}


def from_pipeline_params(pparams: dict, cfg: TransformerConfig, n_virtual: int = 1) -> dict:
    """Inverse of :func:`to_pipeline_params`: the dense state dict."""
    out = dict(pparams["ends"])
    k = _stacking(n_virtual)
    for rel, x in pparams["blocks"].items():
        flat = (x if n_virtual == 1 else x.transpose(0, 1)).reshape(-1, *x.shape[k:])
        for i in range(cfg.num_layers):
            out[f"layers.{i}.{rel}"] = flat[i]
    return out


def pipeline_param_specs(pparams: dict, *, tp: bool = False) -> dict:
    """The specs of a pipelined tree in the port's layout: every block leaf
    over ``pipe`` on its leading dim, the ends replicated (JAX's
    ``pipeline_param_specs``). ``tp=True`` places ``model`` too, megatron's
    layout shifted past the stacking dims: q, k, v and ``mlp_in`` weights
    and biases column-parallel (their output dim), ``attn_out`` and
    ``mlp_out`` weights row-parallel (their input dim); the row-parallel
    biases and the LayerNorms replicated."""
    return {"ends": sh.replicated_specs(pparams["ends"]),
            "blocks": _stacked_specs({k: tuple(v.shape) for k, v in pparams["blocks"].items()},
                                     tp)}


def _stacked_specs(shapes: dict, tp: bool) -> dict:
    """``pipeline_param_specs``' specs of stacked block leaves by shape."""
    return sh.stacked_stage_specs(
        shapes, col=r"(query|key|value|mlp_in)/(kernel|bias)$" if tp else None,
        row=r"(attn_out|mlp_out)/kernel$" if tp else None, path=flax_path)


def make_pipelined_init_fn(cfg: TransformerConfig, n_stages: int, n_virtual: int = 1):
    """``init_fn(seed, device) -> the pipelined tree`` (``to_pipeline_params``
    of ``init_params``' trainable weights: the dense model's of the same
    seed)."""
    check_pipelineable(cfg, n_stages, n_virtual)

    def init_fn(seed: int = 0, device="cuda"):
        return to_pipeline_params(init_params(cfg, seed=seed, device=device, trainable=True),
                                  cfg, n_stages, n_virtual)

    return init_fn


def init_pipelined(cfg: TransformerConfig, seed: int = 0, device="cuda", *,
                   trainable: bool = False, mesh: Mesh | None = None, n_virtual: int = 1,
                   n_microbatches: int = 1) -> "PipelinedTransformer":
    """This rank's stage (``build_pipelined``) with the weights of the dense
    model of ``seed`` (``init_params``), of which only the ends and this
    stage's layers are made on ``device``: a stage never holds the whole
    model, as JAX's init straight into the shardings does not."""
    S = 1 if mesh is None else mesh.shape[PIPE]
    check_pipelineable(cfg, S, n_virtual)
    own = set(stage_layers(cfg, S, n_virtual, 0 if mesh is None else axis_index(PIPE, mesh)))
    params = init_params(cfg, seed=seed, device=device, trainable=trainable,
                         keep=lambda n: not n.startswith("layers.")
                         or int(n.split(".")[1]) in own)
    return build_pipelined(cfg, params, device, trainable=trainable, mesh=mesh,
                           n_virtual=n_virtual, n_microbatches=n_microbatches)


_M64 = (1 << 64) - 1


def _draw_seed(*parts: int) -> int:
    """A generator seed from a tuple of integers (splitmix64 folded over
    them): the pipelined dropout's (step seed, microbatch, global layer,
    batch shard) keys."""
    h = 0
    for x in parts:
        h = (h ^ (int(x) & _M64)) + 0x9E3779B97F4A7C15 & _M64
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & _M64
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _M64
        h ^= h >> 31
    return h & 0x7FFF_FFFF_FFFF_FFFF


def _seed_of(generator) -> int:
    """The seed a step set on its generator (``train/step.py``), or on a
    ``RowGenerator``'s underlying one."""
    gen = generator.generator if isinstance(generator, RowGenerator) else generator
    return gen.initial_seed()


class PipelinedTransformer(Transformer):
    """This rank's stage of the pipelined Transformer (module docstring):
    the ends and the Blocks of ``stage_layers``, run through
    ``parallel/pipeline.py``'s schedule over ``mesh``'s ``pipe`` axis (S
    stages; 1 without a mesh) in ``n_microbatches`` microbatches of this
    rank's rows, ``n_virtual`` chunks a stage. ``block_specs``: a Block
    parameter's name to its tensor-parallel spec (``pipeline_param_specs``
    past the stacking dims), under PP×TP. ``forward(input_ids,
    attention_mask, *, train, generator, positions)`` -> logits, the
    uncached forward of ``Transformer``; every rank returns the same.

    For the train step and the checkpoint: ``specs`` gives each of this
    stage's Block parameters a ``sharding.StageSpec`` (its own over
    ``pipe``, not replicated there: what ``sharding.place`` and the
    optimizer's ``Layout.stage`` read); ``dense_state_names`` /
    ``dense_param_names`` are the dense model's, in order;
    ``stage_of(layer)`` is the stage that holds a layer."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False,
                 mesh: Mesh | None = None, block_specs: dict | None = None, *,
                 n_virtual: int = 1, n_microbatches: int = 1):
        S = 1 if mesh is None else mesh.shape[PIPE]
        check_pipelineable(cfg, S, n_virtual)
        if mesh is not None and mesh.shape[MODEL] > 1:
            if S == 1:
                raise ValueError("model axis without a pipe axis: use the dense Transformer "
                                 "with transformer_specs (tensor parallelism) instead of the "
                                 "pipelined path")
            for flag in ("fused_ln_matmul", "fused_qkv"):
                if getattr(cfg, flag):
                    raise ValueError(f"{flag} inside a PP×TP stage: the JAX package's "
                                     f"manually tensor-parallel Block refuses it "
                                     f"(tp_shards > 1), so the pipelined path does too")
        cfg = dataclasses.replace(cfg, seq_impl=None)
        self_stage = 0 if mesh is None else axis_index(PIPE, mesh)
        ids = stage_layers(cfg, S, n_virtual, self_stage)
        specs = {f"layers.{i}.{rel}": tuple(spec) for i in ids
                 for rel, spec in (block_specs or {}).items() if any(spec)}
        super().__init__(cfg, device, trainable, mesh, specs, layer_ids=ids)
        self.tp_mesh = None  # the ends are replicated: every rank holds the whole vocab
        self.stages, self.stage, self.n_virtual = S, self_stage, n_virtual
        self.n_microbatches = n_microbatches
        self.layers_per_chunk = cfg.num_layers // (S * n_virtual)
        lpc, blocks = self.layers_per_chunk, self.blocks
        # the chunks the schedule runs, kept out of the module tree (their
        # Blocks are registered under ``layers``)
        self.__dict__["chunks"] = nn.ModuleList(
            nn.ModuleList(blocks[v * lpc:(v + 1) * lpc]) for v in range(n_virtual))
        self.specs.update({n: sh.StageSpec(self.specs.get(n, ()))
                           for n, _ in self.named_parameters() if n.startswith("layers.")})
        dense = Transformer(cfg, device="meta", trainable=trainable)
        self.dense_state_names = list(dense.state_dict())
        self.dense_param_names = [n for n, _ in dense.named_parameters()]

    def stage_of(self, layer: int) -> int:
        return (layer // self.layers_per_chunk) % self.stages

    def forward(self, input_ids, attention_mask=None, *, train: bool = False,
                generator=None, positions=None):
        cfg, mesh, M = self.cfg, self.mesh, self.n_microbatches
        B = input_ids.shape[0]
        if B % M:
            shards = 1 if mesh is None else mesh_axis_size(mesh, BATCH_AXES)
            raise ValueError(f"this rank's {B} rows of a global batch of {B * shards} (split "
                             f"over data×fsdp={shards}) do not make {M} microbatches; use "
                             f"fewer microbatches or a larger global batch")
        use_dropout = train and cfg.dropout > 0.0
        if use_dropout and generator is None:
            raise ValueError("train=True with dropout > 0 needs a torch.Generator")
        x = self._stream(input_ids)
        seed = None
        if use_dropout:
            seed = _seed_of(generator)
            x = dropout(x, cfg.dropout, True, self._rows(torch.Generator(
                device=x.device).manual_seed(_draw_seed(seed, cfg.num_layers))))
        mask = attention_mask.to(torch.bool) if attention_mask is not None else None
        y = pipeline_apply(self._stage_fn(seed, mask is not None), self.chunks,
                           microbatch(x, M), mesh,
                           aux_mb=None if mask is None else microbatch(mask, M),
                           n_virtual=self.n_virtual, generator=seed)
        y = unmicrobatch(y)
        if cfg.pre_ln:
            y = self.final_ln(y).to(y.dtype)
        return self._logits(y, positions)

    def _batch_shard(self) -> tuple[int, int]:
        mesh = self.mesh
        if mesh is None:
            return 0, 1
        return axis_index(BATCH_AXES, mesh), mesh_axis_size(mesh, BATCH_AXES)

    def _rows(self, gen: torch.Generator):
        """``gen`` drawing this rank's rows of the global batch's noise."""
        index, shards = self._batch_shard()
        return gen if shards == 1 else RowGenerator(gen, shards, index)

    def _stage_fn(self, seed, masked: bool):
        """The schedule's stage fn: a chunk's Blocks in order; with
        ``seed``, layer c·lpc + i of microbatch m drawing from a generator
        seeded by (seed, m, that global layer, the batch shard)."""
        lpc, shard = self.layers_per_chunk, self._batch_shard()[0]
        train = seed is not None

        def run(blocks, x, *rest):
            mask = rest[0] if masked else None
            for i, block in enumerate(blocks):
                gen = None
                if train:
                    m, c = rest[-2:]
                    gen = torch.Generator(device=x.device).manual_seed(
                        _draw_seed(seed, m, c * lpc + i, shard))
                x = block.forward_uncached(x, mask, train=train, generator=gen)
            return x

        return run


def build_pipelined(cfg: TransformerConfig, params: dict, device, *, trainable: bool = False,
                    mesh: Mesh | None = None, n_virtual: int = 1,
                    n_microbatches: int = 1) -> PipelinedTransformer:
    """This rank's ``PipelinedTransformer`` on ``device`` from ``params``:
    a dense state dict that holds the ends and at least this stage's
    layers (``init_pipelined``'s, or the whole model's), or the whole
    pipelined tree (``to_pipeline_params``). Each of this stage's Block
    tensors is its shard over ``model`` where the mesh's exceeds 1
    (PP×TP, ``pipeline_param_specs``), the ends whole. ``trainable`` as
    ``build``."""
    S = 1 if mesh is None else mesh.shape[PIPE]
    tp = mesh is not None and mesh.shape[MODEL] > 1
    ids = stage_layers(cfg, S, n_virtual, 0 if mesh is None else axis_index(PIPE, mesh))
    stacked = "blocks" in params
    if stacked:
        specs = pipeline_param_specs(params, tp=tp)
        k = _stacking(n_virtual)
        block_specs = {rel: spec[k:] for rel, spec in specs["blocks"].items()}
    else:  # one layer's specs, stacked [S, 1, ...] and the stacking dims dropped
        head = f"layers.{ids[0]}."
        block_specs = {rel: spec[2:] for rel, spec in _stacked_specs(
            {k[len(head):]: (S, 1, *v.shape) for k, v in params.items() if k.startswith(head)},
            tp).items()}
    model = PipelinedTransformer(cfg, "meta", trainable, mesh, block_specs=block_specs,
                                 n_virtual=n_virtual, n_microbatches=n_microbatches)
    if stacked:
        state = dict(params["ends"])
        lpc = model.layers_per_chunk
        for rel, x in params["blocks"].items():
            rows = (sh.shard_tensor(x, specs["blocks"][rel], mesh) if mesh is not None
                    else x)[0]
            if n_virtual == 1:
                rows = rows[None]
            for n, i in enumerate(ids):
                state[f"layers.{i}.{rel}"] = rows[n // lpc, n % lpc]
    else:
        own = set(ids)
        state = {k: v for k, v in params.items() if not k.startswith("layers.")}
        state.update({k: sh.shard_tensor(v, model.specs[k], mesh) if any(model.specs[k]) else v
                      for k, v in params.items()
                      if k.startswith("layers.") and int(k.split(".")[1]) in own})
    return _load(model, state, device, trainable)


# ---------------------------------------------------------------------------
# Losses and eval statistics (the train engine's loss contract:
# loss_fn(batch, generator) -> (loss, aux metrics))
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """This rank's vocab columns of tensor-parallel logits: they start at
    global id ``offset`` of a vocabulary of ``size`` ids (columns past it
    are padding), the shards spread over ``mesh``'s ``model`` axis."""

    offset: int
    size: int
    mesh: Mesh


def _xent_eval_stats(logits, labels, vs: VocabShard | None = None
                     ) -> dict[str, torch.Tensor]:
    """SUMMED per-token statistics over valid (non-IGNORE) positions:
    ``loss_sum``, ``correct``, ``count`` (f32 scalars). With ``vs`` the
    logits are this rank's vocab columns (``_vocab_parallel_xent``)."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    if vs is None:
        xent = -F.log_softmax(logits.float(), dim=-1)
        per_tok = torch.gather(xent, -1, safe[..., None])[..., 0]
        pred = logits.argmax(-1)
    else:
        per_tok, pred = _vocab_parallel_xent(logits, safe, vs)
    return {
        "loss_sum": torch.where(valid, per_tok, 0.0).sum(),
        "correct": (valid & (pred == safe)).sum().float(),
        "count": valid.sum().float(),
    }


def _vocab_parallel_xent(logits, safe, vs: VocabShard):
    """Per-token cross-entropy and the arg-max over the vocab shards:
    padded columns at -inf; the row max all-reduced by MAX (detached); the
    sum of exponentials and the target logit (its owner's) summed over
    ``model``, their gradients each rank's own; the arg-max the lowest
    global id holding the global max."""
    mesh = vs.mesh
    lg = logits.float()
    cols = vs.offset + torch.arange(lg.shape[-1], device=lg.device)
    lg = torch.where(cols < vs.size, lg, float("-inf"))
    m = all_reduce_max(lg.detach().amax(-1), MODEL, mesh)
    sumexp = sum_over_axis(torch.exp(lg - m[..., None]).sum(-1), MODEL, mesh)
    local = safe - vs.offset
    own = (local >= 0) & (local < lg.shape[-1])
    tgt = torch.gather(lg, -1, local.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
    tgt = sum_over_axis(torch.where(own, tgt, 0.0), MODEL, mesh)
    lmax, larg = lg.detach().max(-1)
    cand = torch.where(lmax == m, larg + vs.offset, torch.iinfo(torch.int64).max)
    return torch.log(sumexp) + m - tgt, all_reduce_min(cand, MODEL, mesh)


def _shifted_lm_labels(ids, attention_mask=None):
    """Next-token labels: position t predicts ids[t+1]; the final
    position (and positions whose TARGET is padding) are IGNOREd."""
    labels = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], IGNORE_INDEX)], dim=1)
    if attention_mask is not None:
        label_valid = torch.cat(
            [attention_mask[:, 1:] > 0,
             torch.zeros_like(attention_mask[:, :1], dtype=torch.bool)], dim=1)
        labels = torch.where(label_valid, labels, IGNORE_INDEX)
    return labels


def _masked_xent(logits, labels, vs: VocabShard | None = None):
    """Mean cross-entropy and accuracy over positions whose label is not
    IGNORE_INDEX (the ratio form of ``_xent_eval_stats``)."""
    s = _xent_eval_stats(logits, labels, vs)
    count = s["count"].clamp_min(1.0)
    return s["loss_sum"] / count, s["correct"] / count


def _chunk_stats(hc, lc, head, vs):
    s = _xent_eval_stats(head(hc), lc, vs)
    return s["loss_sum"], s["correct"], s["count"]


def _chunked_xent_stats(h, labels, head, chunk_size: int,
                        vs: VocabShard | None = None) -> dict[str, torch.Tensor]:
    """Summed xent stats from hidden states ``h`` [B,S,d], the tied head
    (``head``: ``Transformer.head``) applied per sequence chunk of
    ``chunk_size``. Each chunk runs under ``torch.utils.checkpoint`` (the
    JAX version's per-chunk ``jax.checkpoint``): its ``[B, chunk, vocab]``
    logits are recomputed in the backward, so the whole ``[B, S, vocab]``
    never exists."""
    B, S, _ = h.shape
    C = min(chunk_size, S)
    if S % C:
        raise ValueError(
            f"seq len {S} not divisible by xent chunk size {C} — set "
            f"model.xent_chunk to a divisor of the sequence length, or 0 "
            f"for the dense loss")
    loss_sum = correct = count = h.new_zeros((), dtype=torch.float32)
    for i in range(S // C):
        sl = slice(i * C, (i + 1) * C)
        ls, cr, ct = checkpoint(_chunk_stats, h[:, sl], labels[:, sl], head, vs,
                                use_reentrant=False)
        loss_sum, correct, count = loss_sum + ls, correct + cr, count + ct
    return {"loss_sum": loss_sum, "correct": correct, "count": count}


def _mlm_targets(batch):
    """(positions, labels) for the MLM head: the gathered-head format
    ``masked_positions`` / ``masked_labels`` [B,K] when the stream gives
    it (``TextDataConfig.max_predictions != 0``), else (None, the dense
    [B,S] labels with IGNORE_INDEX on unmasked positions)."""
    if "masked_positions" in batch:
        return batch["masked_positions"], batch["masked_labels"]
    return None, batch["labels"]


def mlm_loss_fn(model: Transformer):
    """Masked-LM loss. Batch: {"input_ids" [B,S], "masked_positions" and
    "masked_labels" [B,K] or "labels" [B,S] with IGNORE_INDEX on
    unmasked positions, optional "attention_mask" [B,S]}."""

    def loss_fn(batch, generator=None):
        positions, labels = _mlm_targets(batch)
        logits = model(batch["input_ids"], batch.get("attention_mask"), train=True,
                       generator=generator, positions=positions)
        loss, acc = _masked_xent(logits, labels, model.vocab_shard)
        return loss, {"accuracy": acc}

    return loss_fn


def lm_loss_fn(model: Transformer):
    """Next-token loss for causal models. Batch: {"input_ids" [B,S],
    optional "attention_mask" [B,S]}; position t predicts token t+1."""

    def loss_fn(batch, generator=None):
        ids = batch["input_ids"]
        logits = model(ids, batch.get("attention_mask"), train=True, generator=generator)
        labels = _shifted_lm_labels(ids, batch.get("attention_mask"))
        loss, acc = _masked_xent(logits, labels, model.vocab_shard)
        return loss, {"accuracy": acc}

    return loss_fn


def chunked_lm_loss_fn(model: Transformer, chunk_size: int):
    """Next-token loss that never materialises the full ``[B, S, vocab]``
    logits: the block stack runs once (``return_hidden=True``), then the
    tied projection and the masked cross-entropy run per sequence chunk
    (``_chunked_xent_stats``). The same math as :func:`lm_loss_fn`."""

    def loss_fn(batch, generator=None):
        ids = batch["input_ids"]
        h = model(ids, batch.get("attention_mask"), train=True, generator=generator,
                  return_hidden=True)
        labels = _shifted_lm_labels(ids, batch.get("attention_mask"))
        s = _chunked_xent_stats(h, labels, model.head, chunk_size, model.vocab_shard)
        count = s["count"].clamp_min(1.0)
        return s["loss_sum"] / count, {"accuracy": s["correct"] / count}

    return loss_fn


def causal_lm_loss(model: Transformer, xent_chunk: int = 0):
    """The causal-LM loss selector: chunked when ``xent_chunk > 0``,
    dense otherwise."""
    return (chunked_lm_loss_fn(model, xent_chunk) if xent_chunk > 0
            else lm_loss_fn(model))


def transformer_eval_fn(model: Transformer, *, mlm: bool):
    """``eval_fn(batch) -> {"loss_sum", "correct", "count"}``: summed
    masked-LM (``mlm``) or next-token statistics, no dropout, no
    gradient."""

    @torch.no_grad()
    def eval_fn(batch):
        ids = batch["input_ids"]
        positions, labels = (
            _mlm_targets(batch) if mlm
            else (None, _shifted_lm_labels(ids, batch.get("attention_mask"))))
        logits = model(ids, batch.get("attention_mask"), train=False, positions=positions)
        return _xent_eval_stats(logits, labels, model.vocab_shard)

    return eval_fn


def mlm_eval_fn(model: Transformer):
    return transformer_eval_fn(model, mlm=True)


def lm_eval_fn(model: Transformer, xent_chunk: int = 0):
    """Next-token ``transformer_eval_fn``; with ``xent_chunk > 0`` the
    statistics are summed per sequence chunk from the hidden states (the
    chunking of ``chunked_lm_loss_fn``)."""
    if xent_chunk <= 0:
        return transformer_eval_fn(model, mlm=False)

    @torch.no_grad()
    def eval_fn(batch):
        ids = batch["input_ids"]
        labels = _shifted_lm_labels(ids, batch.get("attention_mask"))
        h = model(ids, batch.get("attention_mask"), train=False, return_hidden=True)
        return _chunked_xent_stats(h, labels, model.head, xent_chunk, model.vocab_shard)

    return eval_fn


def param_count(cfg: TransformerConfig) -> int:
    """Analytic parameter count (embeddings + blocks + heads + bias)."""
    d, L = cfg.d_model, cfg.num_layers
    embed = cfg.vocab_size * d + cfg.max_len * d
    embed += 2 * d  # embed_ln (post-LN) or final_ln (pre-LN)
    attn = 4 * d * d + 4 * d  # fused_qkv: the same, one [3d, d] Dense for three
    ln = 4 * d
    ffn = 2 * d * cfg.d_ff + cfg.d_ff + d
    head = 0 if cfg.causal else d * d + 3 * d  # mlm_transform + mlm_ln
    return embed + L * (attn + ln + ffn) + head + cfg.vocab_size


def flops_per_example(cfg: TransformerConfig, seq_len: int,
                      n_predictions: int | None = None) -> float:
    """Forward FLOPs per example at ``seq_len`` (×3 for training, applied
    once in ``obs.goodput.train_mfu``). ``n_predictions``: the gathered
    MLM head runs on that many positions, not ``seq_len``; the skipped
    positions' head FLOPs (``mlm_transform`` and the tied projection) are
    taken off."""
    base = seq_len * flops_lib.transformer_flops_per_token(
        param_count(cfg), seq_len, cfg.num_layers, cfg.d_model)
    if n_predictions is not None and not cfg.causal:
        per_pos_head = 2.0 * (cfg.vocab_size * cfg.d_model + cfg.d_model * cfg.d_model)
        base -= (seq_len - n_predictions) * per_pos_head
    return base
