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
``param_dtype=f32`` the same way. Later slices bring remat, MoE, TP,
``fused_qkv``, sequence parallelism and pipelining; a config that asks
for one of them is refused.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.text import IGNORE_INDEX
from ..ops.attention import attention, paged_append_kv, paged_attention
from ..ops.fused_ln_matmul import ln_matmul
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
    # "dense" | "flash" force one
    attention_impl: str = "auto"
    # paged attention dispatch (ops.attention.paged_attention impl=):
    # "auto" = the CUDA kernel on a CUDA tensor, "fused" on the CPU;
    # "gather" | "fused" | "cuda" force one
    paged_attention_impl: str = "auto"
    # not ported yet (ROADMAP Queue A): a value other than the default
    # is refused when the model is built
    seq_impl: str | None = None
    num_experts: int = 0
    remat: bool = False
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
        return (x - mean) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(self.dtype), self.bias.to(self.dtype))


def _ln_dense(x2: torch.Tensor, ln: "LayerNorm", dense: Dense, dt) -> torch.Tensor:
    """``dense(ln(x2))`` through the fused LN+matmul op: x2 [M, d] is the raw
    residual stream; the weight is cast to the compute dtype at use (a no-op
    for serving weights) and passed as its ``[in, out]`` view."""
    return ln_matmul(x2, ln.weight, ln.bias, dense.weight.to(dt).t(), dense.bias,
                     eps=LN_EPS, out_dtype=dt)


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        dt, d = torch_dtype(cfg.dtype), cfg.d_model
        self.query = Dense(d, d, dt, device, param_dtype)
        self.key = Dense(d, d, dt, device, param_dtype)
        self.value = Dense(d, d, dt, device, param_dtype)
        self.attn_out = Dense(d, d, dt, device, param_dtype)

    def _qkv(self, x, ln=None):
        """q, k, v as [B,H,S,D] views of the [B,S,H*D] projections; with
        ``ln`` the raw residual ``x`` is normalised inside the fused
        kernel."""
        cfg = self.cfg
        B, S, d = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        if ln is not None:
            x2 = x.reshape(B * S, d)

            def proj(dense):
                return _ln_dense(x2, ln, dense, x.dtype)
        else:
            def proj(dense):
                return dense(x)

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
        out = attention(q, k, v, causal=cfg.causal, kv_mask=mask,
                        impl=cfg.attention_impl)
        return dropout(self._out(out), cfg.dropout, train, generator)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
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

    def forward(self, x, k_pool, v_pool, block_table, pos):
        """Paged decode (see ``SelfAttention.forward``)."""
        dt = x.dtype
        if not self.cfg.pre_ln:
            x = self.ln1(x + self.attn(x, k_pool, v_pool, block_table, pos)).to(dt)
            return self.ln2(x + self._mlp_tail(self.mlp_in(x))).to(dt)
        if self.cfg.fused_ln_matmul:
            x = x + self.attn(x, k_pool, v_pool, block_table, pos, ln=self.ln1)
            return x + self._mlp_tail(self._fused_mlp_in(x))
        x = x + self.attn(self.ln1(x).to(dt), k_pool, v_pool, block_table, pos)
        return x + self._mlp_tail(self.mlp_in(self.ln2(x).to(dt)))

    def _fused_mlp_in(self, x):
        B, S, d = x.shape
        return _ln_dense(x.reshape(B * S, d), self.ln2, self.mlp_in, x.dtype).reshape(B, S, -1)

    def forward_uncached(self, x, mask, *, train: bool, generator=None):
        dt = x.dtype
        if not self.cfg.pre_ln:  # post-LN (BERT): the residual add in cfg.dtype
            x = self.ln1(x + self.attn.forward_uncached(
                x, mask, train=train, generator=generator)).to(dt)
            return self.ln2(x + self._mlp_tail(self.mlp_in(x), train, generator)).to(dt)
        if self.cfg.fused_ln_matmul:
            x = x + self.attn.forward_uncached(x, mask, train=train, generator=generator,
                                               ln=self.ln1)
            return x + self._mlp_tail(self._fused_mlp_in(x), train, generator)
        x = x + self.attn.forward_uncached(self.ln1(x).to(dt), mask, train=train,
                                           generator=generator)
        return x + self._mlp_tail(self.mlp_in(self.ln2(x).to(dt)), train, generator)


def check_supported(cfg: TransformerConfig) -> None:
    """Refuse what the model cannot run (as the JAX model does) or the
    port does not have yet (naming the ROADMAP item)."""
    if cfg.fused_ln_matmul and not cfg.pre_ln:
        raise ValueError("fused_ln_matmul requires pre_ln=True (a post-LN LayerNorm "
                         "output is the residual stream itself and must materialize)")
    for name, default, item in (
            ("seq_impl", None, "item 6, parallel/ring_attention.py"),
            ("num_experts", 0, "item 6, ops/moe.py"),
            ("remat", False, "item 2.5"), ("fused_qkv", False, "item 2.5")):
        if getattr(cfg, name) != default:
            raise ValueError(f"model.{name}={getattr(cfg, name)!r} is not ported yet "
                             f"(ROADMAP Queue A {item})")


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
    docstring)."""

    def __init__(self, cfg: TransformerConfig, device=None, trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        pdt = torch.float32 if trainable else None
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device,
                                      dtype=torch.float32)
        self.tok_embed.weight.requires_grad_(False)
        self.pos_embed = _param(cfg.max_len, cfg.d_model, device=device)
        if not cfg.pre_ln:
            self.embed_ln = LayerNorm(cfg.d_model, device)
        self.layers = nn.ModuleList(Block(cfg, device, pdt) for _ in range(cfg.num_layers))
        if cfg.pre_ln:
            self.final_ln = LayerNorm(cfg.d_model, device)
        if not cfg.causal:
            self.mlm_transform = Dense(cfg.d_model, cfg.d_model, torch_dtype(cfg.dtype),
                                       device, pdt)
            self.mlm_ln = LayerNorm(cfg.d_model, device)
        self.mlm_bias = _param(cfg.vocab_size, device=device)

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
            pos = decode_pos.long().clamp(0, cfg.max_len - 1)
            x = (self.tok_embed(input_ids) + self.pos_embed[pos]).to(dt)
            if not cfg.pre_ln:
                x = self.embed_ln(x).to(dt)
            for i, block in enumerate(self.layers):
                x = block(x, kv_cache.k_buf[i], kv_cache.v_buf[i], block_table,
                          decode_pos)
            if cfg.pre_ln:
                x = self.final_ln(x).to(dt)
            return head_projection(x, self.tok_embed.weight, cfg.head_dtype) \
                + self.mlm_bias, kv_cache
        S = input_ids.shape[1]
        if S > cfg.max_len:
            raise ValueError(f"sequence length {S} exceeds max_len={cfg.max_len}")
        x = (self.tok_embed(input_ids) + self.pos_embed[None, :S]).to(dt)
        if not cfg.pre_ln:
            x = self.embed_ln(x).to(dt)
        x = dropout(x, cfg.dropout, train, generator)
        mask = attention_mask.to(torch.bool) if attention_mask is not None else None
        for block in self.layers:
            x = block.forward_uncached(x, mask, train=train, generator=generator)
        if cfg.pre_ln:
            x = self.final_ln(x).to(dt)
        if return_hidden:
            # the chunked loss applies the same tied projection per chunk
            return x
        if positions is not None:
            if cfg.causal:
                raise ValueError("positions gather is the MLM head path; causal LMs "
                                 "predict every position")
            idx = positions.long()[..., None].expand(-1, -1, x.shape[-1])
            x = torch.gather(x, 1, idx)  # [B, K, d]
        if not cfg.causal:
            x = F.gelu(self.mlm_transform(x), approximate="tanh")
            x = self.mlm_ln(x).to(dt)
        return head_projection(x, self.tok_embed.weight, cfg.head_dtype) + self.mlm_bias


def head_projection(x: torch.Tensor, embedding: torch.Tensor,
                    head_dtype: str) -> torch.Tensor:
    """The tied-embedding vocab projection with f32 logits: the operands
    rounded to ``head_dtype``, multiplied exactly and summed in f32 (the
    JAX head's ``preferred_element_type=float32``)."""
    hd = torch_dtype(head_dtype)
    return torch.matmul(x.to(hd).float(), embedding.to(hd).float().t())


def init_params(cfg: TransformerConfig, seed: int = 0, device="cuda",
                trainable: bool = False) -> dict[str, torch.Tensor]:
    """Random weights as flax initialises them: normal(0.02) for Dense
    kernels and both embeddings, zeros for biases and ``mlm_bias``,
    ones/zeros for every LayerNorm (``LN_NAMES``) — drawn in f32 from a
    ``torch.Generator`` on ``device`` (the card by default; raises without one unless
    ``device="cpu"``) seeded with ``seed``, then cast to each parameter's
    dtype (Dense weights stay f32 with ``trainable``). Returns a state
    dict for ``Transformer(cfg)``. The numbers differ from
    ``jax.random``'s for the same seed."""
    device = resolve_device(device)
    model = Transformer(cfg, device="meta", trainable=trainable)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, p in model.state_dict().items():
        parts = name.split(".")
        leaf = parts[-1]
        is_ln = len(parts) > 1 and parts[-2] in LN_NAMES
        if is_ln and leaf == "weight":
            t = torch.ones(p.shape, device=device)
        elif leaf == "bias" or name == "mlm_bias":
            t = torch.zeros(p.shape, device=device)
        else:  # Dense weights, tok_embed.weight, pos_embed
            t = torch.empty(p.shape, device=device).normal_(
                0.0, 0.02, generator=gen)
        out[name] = t.to(p.dtype)
    return out


def build(cfg: TransformerConfig, params, device, trainable: bool = False) -> Transformer:
    """``Transformer(cfg)`` on ``device`` holding ``params`` (a state dict
    or another ``Transformer``'s weights).

    Serving (``trainable=False``): tensors already on ``device`` in the
    right dtype are shared, not copied — so engines built with different
    configs over one set of weights hold it once — and every parameter
    is frozen. Training (``trainable=True``): f32 masters, always copied
    (the optimizer updates them in place), every parameter requires
    grad."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    model = Transformer(cfg, device="meta", trainable=trainable)
    want = model.state_dict()
    missing = set(want) - set(params)
    extra = set(params) - set(want)
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    state = {k: params[k].to(device=device, dtype=v.dtype, copy=trainable)
             for k, v in want.items()}
    model.load_state_dict(state, assign=True)
    for p in model.parameters():
        p.requires_grad_(trainable)
    return model


# ---------------------------------------------------------------------------
# Losses and eval statistics (the train engine's loss contract:
# loss_fn(batch, generator) -> (loss, aux metrics))
# ---------------------------------------------------------------------------


def _xent_eval_stats(logits, labels) -> dict[str, torch.Tensor]:
    """SUMMED per-token statistics over valid (non-IGNORE) positions:
    ``loss_sum``, ``correct``, ``count`` (f32 scalars)."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    xent = -F.log_softmax(logits.float(), dim=-1)
    per_tok = torch.gather(xent, -1, safe[..., None])[..., 0]
    return {
        "loss_sum": torch.where(valid, per_tok, 0.0).sum(),
        "correct": (valid & (logits.argmax(-1) == safe)).sum().float(),
        "count": valid.sum().float(),
    }


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


def _masked_xent(logits, labels):
    """Mean cross-entropy and accuracy over positions whose label is not
    IGNORE_INDEX (the ratio form of ``_xent_eval_stats``)."""
    s = _xent_eval_stats(logits, labels)
    count = s["count"].clamp_min(1.0)
    return s["loss_sum"] / count, s["correct"] / count


def _chunk_stats(hc, lc, emb, bias, head_dtype):
    s = _xent_eval_stats(head_projection(hc, emb, head_dtype) + bias, lc)
    return s["loss_sum"], s["correct"], s["count"]


def _chunked_xent_stats(h, labels, emb, bias, chunk_size: int,
                        head_dtype: str = "float32") -> dict[str, torch.Tensor]:
    """Summed xent stats from hidden states ``h`` [B,S,d], the tied head
    applied per sequence chunk of ``chunk_size``. Each chunk runs under
    ``torch.utils.checkpoint`` (the JAX version's per-chunk
    ``jax.checkpoint``): its ``[B, chunk, vocab]`` logits are recomputed
    in the backward, so the whole ``[B, S, vocab]`` never exists."""
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
        ls, cr, ct = checkpoint(_chunk_stats, h[:, sl], labels[:, sl], emb, bias,
                                head_dtype, use_reentrant=False)
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
        loss, acc = _masked_xent(logits, labels)
        return loss, {"accuracy": acc}

    return loss_fn


def lm_loss_fn(model: Transformer):
    """Next-token loss for causal models. Batch: {"input_ids" [B,S],
    optional "attention_mask" [B,S]}; position t predicts token t+1."""

    def loss_fn(batch, generator=None):
        ids = batch["input_ids"]
        logits = model(ids, batch.get("attention_mask"), train=True, generator=generator)
        labels = _shifted_lm_labels(ids, batch.get("attention_mask"))
        loss, acc = _masked_xent(logits, labels)
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
        s = _chunked_xent_stats(h, labels, model.tok_embed.weight, model.mlm_bias,
                                chunk_size, model.cfg.head_dtype)
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
        return _xent_eval_stats(logits, labels)

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
        return _chunked_xent_stats(h, labels, model.tok_embed.weight, model.mlm_bias,
                                   xent_chunk, model.cfg.head_dtype)

    return eval_fn


def param_count(cfg: TransformerConfig) -> int:
    """Analytic parameter count (embeddings + blocks + heads + bias)."""
    d, L = cfg.d_model, cfg.num_layers
    embed = cfg.vocab_size * d + cfg.max_len * d
    embed += 2 * d  # embed_ln (post-LN) or final_ln (pre-LN)
    attn = 4 * d * d + 4 * d
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
