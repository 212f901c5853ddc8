"""Causal pre-LN Transformer decoder — the serve subset of
``distributed_tensorflow_tpu/models/transformer.py`` in PyTorch.

What is here: ``TransformerConfig`` with the fields the serve path reads,
``gpt_small()``, and ``Transformer``, whose forward is the paged decode
path (``kv_cache`` block pool + ``block_table`` + ``decode_pos``): a
prefill chunk, a decode step and a speculative verify step are all this
one call. The cast points mirror the flax model exactly:

- token embedding (f32) + position embedding (f32), added in f32, then
  cast to ``cfg.dtype``;
- LayerNorm in f32, eps 1e-6, flax's fast variance (E[x²] − E[x]²),
  output cast to ``cfg.dtype``;
- Dense matmuls in ``cfg.dtype`` (weight and bias cast to it);
- GELU with the tanh approximation (flax ``nn.gelu``'s default);
- the tied head in ``head_dtype`` with f32 logits, plus ``mlm_bias``;
- ``fused_ln_matmul=True``: ln1→q/k/v and ln2→mlp_in run through
  ``ops.fused_ln_matmul.ln_matmul`` (f32 bias, as the JAX branch does).

Parameters follow the flax tree (``weights.from_jax_params`` converts
one); Dense weights are stored ``[out, in]`` (``nn.Linear`` layout) in
``cfg.dtype``, biases, LayerNorm parameters and embeddings in f32. Later
slices bring post-LN/BERT, dropout, remat, MoE, TP, ``fused_qkv`` and
pipelining.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import paged_append_kv, paged_attention
from ..ops.fused_ln_matmul import ln_matmul

LN_EPS = 1e-6  # flax nn.LayerNorm default


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30528
    max_len: int = 512
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    causal: bool = False
    pre_ln: bool = False
    dtype: str = "bfloat16"
    # paged attention dispatch (ops.attention.paged_attention impl=):
    # "auto" = the CUDA kernel on a CUDA tensor, "fused" on the CPU;
    # "gather" | "fused" | "cuda" force one
    paged_attention_impl: str = "auto"
    # ln1->q/k/v and ln2->mlp_in through the fused LN+matmul kernel
    fused_ln_matmul: bool = False
    # input dtype of the tied-embedding vocab projection (f32 logits out)
    head_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model={self.d_model} not divisible by "
                             f"num_heads={self.num_heads}")
        return self.d_model // self.num_heads


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
    the compute dtype, bias kept in f32 (the fused path adds it in f32,
    the plain path casts it to the compute dtype as flax does)."""

    def __init__(self, in_features: int, out_features: int, dtype, device=None):
        super().__init__()
        self.weight = _param(out_features, in_features, dtype=dtype, device=device)
        self.bias = _param(out_features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias.to(self.weight.dtype))


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt, d = torch_dtype(cfg.dtype), cfg.d_model
        self.query = Dense(d, d, dt, device)
        self.key = Dense(d, d, dt, device)
        self.value = Dense(d, d, dt, device)
        self.attn_out = Dense(d, d, dt, device)

    def forward(self, x, k_pool, v_pool, block_table, pos, ln=None):
        """``x`` [B,S,d] (the raw residual stream when ``ln`` is given —
        the fused path normalises inside the kernel); ``k_pool``/
        ``v_pool`` this layer's ``[NB+1,H,bs,D]`` pool, updated in place."""
        cfg = self.cfg
        B, S, d = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        if ln is not None:
            x2 = x.reshape(B * S, d)

            def proj(dense):
                return ln_matmul(x2, ln.weight, ln.bias, dense.weight.t(),
                                 dense.bias, eps=LN_EPS, out_dtype=x.dtype)
        else:
            def proj(dense):
                return dense(x)

        # [B,S,H*D] -> [B,H,S,D] (the ops layout)
        q, k, v = (proj(p).reshape(B, S, H, D).transpose(1, 2)
                   for p in (self.query, self.key, self.value))
        paged_append_kv(k_pool, k, block_table, pos)
        paged_append_kv(v_pool, v, block_table, pos)
        NB = k_pool.shape[0] - 1
        out = paged_attention(
            q.contiguous(), k_pool[:NB], v_pool[:NB], block_table, q_pos=pos,
            impl=cfg.paged_attention_impl)
        return self.attn_out(out.transpose(1, 2).reshape(B, S, H * D))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        self.ln1 = LayerNorm(cfg.d_model, device)
        self.attn = SelfAttention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, device)
        self.mlp_in = Dense(cfg.d_model, cfg.d_ff, dt, device)
        self.mlp_out = Dense(cfg.d_ff, cfg.d_model, dt, device)

    def _mlp_tail(self, h):
        # everything after the mlp_in matmul, shared by both paths
        return self.mlp_out(F.gelu(h, approximate="tanh"))

    def forward(self, x, k_pool, v_pool, block_table, pos):
        dt = x.dtype
        if self.cfg.fused_ln_matmul:
            x = x + self.attn(x, k_pool, v_pool, block_table, pos, ln=self.ln1)
            B, S, d = x.shape
            h = ln_matmul(x.reshape(B * S, d), self.ln2.weight, self.ln2.bias,
                          self.mlp_in.weight.t(), self.mlp_in.bias, eps=LN_EPS,
                          out_dtype=dt).reshape(B, S, -1)
            return x + self._mlp_tail(h)
        x = x + self.attn(self.ln1(x).to(dt), k_pool, v_pool, block_table, pos)
        return x + self._mlp_tail(self.mlp_in(self.ln2(x).to(dt)))


class Transformer(nn.Module):
    """Token-in, logits-out causal decoder over the paged KV pool.

    ``forward(input_ids [B,S] int, kv_cache=, decode_pos=[B,S],
    block_table=[B,MB] int32)`` -> ``(logits [B,S,vocab] f32, kv_cache)``.
    The S tokens sit at the absolute positions ``decode_pos``; their K/V
    are written into the pool IN PLACE (the JAX version donates the pool
    and returns a new one — here the returned cache is the same object)
    and attention reads the pool through the table. ``kv_cache`` is a
    ``serve.kv_cache.PagedKVCache`` (duck-typed: ``k_buf``/``v_buf``
    ``[L, NB+1, H, bs, D]``)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        if not (cfg.causal and cfg.pre_ln):
            raise ValueError(
                "the port has the causal pre-LN decoder only (post-LN/BERT "
                "comes with a later slice)")
        self.cfg = cfg
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device,
                                      dtype=torch.float32)
        self.tok_embed.weight.requires_grad_(False)
        self.pos_embed = _param(cfg.max_len, cfg.d_model, device=device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(cfg.d_model, device)
        self.mlm_bias = _param(cfg.vocab_size, device=device)

    def forward(self, input_ids, *, kv_cache, decode_pos, block_table):
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        pos = decode_pos.long().clamp(0, cfg.max_len - 1)
        x = (self.tok_embed(input_ids) + self.pos_embed[pos]).to(dt)
        for i, block in enumerate(self.layers):
            x = block(x, kv_cache.k_buf[i], kv_cache.v_buf[i], block_table,
                      decode_pos)
        x = self.final_ln(x).to(dt)
        return head_projection(x, self.tok_embed.weight, cfg.head_dtype) \
            + self.mlm_bias, kv_cache


def head_projection(x: torch.Tensor, embedding: torch.Tensor,
                    head_dtype: str) -> torch.Tensor:
    """The tied-embedding vocab projection with f32 logits: the operands
    rounded to ``head_dtype``, multiplied exactly and summed in f32 (the
    JAX head's ``preferred_element_type=float32``)."""
    hd = torch_dtype(head_dtype)
    return torch.matmul(x.to(hd).float(), embedding.to(hd).float().t())


def init_params(cfg: TransformerConfig, seed: int = 0,
                device="cpu") -> dict[str, torch.Tensor]:
    """Random weights as flax initialises them: normal(0.02) for Dense
    kernels and both embeddings, zeros for biases and ``mlm_bias``,
    ones/zeros for LayerNorm — drawn in f32 from a ``torch.Generator``
    on ``device`` seeded with ``seed``, then cast to each parameter's
    dtype. Returns a state dict for ``Transformer(cfg)``. The numbers
    differ from ``jax.random``'s for the same seed."""
    model = Transformer(cfg, device="meta")
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, p in model.state_dict().items():
        parts = name.split(".")
        leaf = parts[-1]
        is_ln = len(parts) > 1 and parts[-2] in ("ln1", "ln2", "final_ln")
        if is_ln and leaf == "weight":
            t = torch.ones(p.shape, device=device)
        elif leaf == "bias" or name == "mlm_bias":
            t = torch.zeros(p.shape, device=device)
        else:  # Dense weights, tok_embed.weight, pos_embed
            t = torch.empty(p.shape, device=device).normal_(
                0.0, 0.02, generator=gen)
        out[name] = t.to(p.dtype)
    return out


def build(cfg: TransformerConfig, params, device) -> Transformer:
    """``Transformer(cfg)`` on ``device`` holding ``params`` (a state dict
    or another ``Transformer``'s weights): tensors already on ``device``
    in the right dtype are shared, not copied — so engines built with
    different configs over one set of weights hold it once."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    model = Transformer(cfg, device="meta")
    want = model.state_dict()
    missing = set(want) - set(params)
    extra = set(params) - set(want)
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    state = {k: params[k].to(device=device, dtype=v.dtype) for k, v in want.items()}
    model.load_state_dict(state, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model
