"""Shared fixtures of the ``test_torch_*`` parity tests: one tiny causal
pre-LN decoder configured alike in the JAX package and the port, and
its weights as numpy arrays from a seed (the same numbers go to both)."""

import dataclasses

import jax
import numpy as np

from distributed_tensorflow_tpu.models import transformer as jtfm
from distributed_tensorflow_tpu_torch.models import transformer as ttfm


def jax_cfg(**kw) -> jtfm.TransformerConfig:
    base = dict(vocab_size=256, max_len=64, num_layers=2, d_model=64,
                num_heads=4, d_ff=128, dropout=0.0, dtype="float32",
                causal=True, pre_ln=True)
    base.update(kw)
    return jtfm.TransformerConfig(**base)


def port_cfg(jcfg: jtfm.TransformerConfig, **kw) -> ttfm.TransformerConfig:
    """The port's config with the JAX config's values (the JAX-only
    impl names map to the port's: "pallas" has no counterpart here)."""
    names = {f.name for f in dataclasses.fields(ttfm.TransformerConfig)}
    vals = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in names}
    if vals.get("paged_attention_impl") == "pallas":
        vals["paged_attention_impl"] = "cuda"
    vals.update(kw)
    return ttfm.TransformerConfig(**vals)


def params_np(jcfg: jtfm.TransformerConfig, seed: int = 0) -> dict:
    """The flax tree of ``jcfg``'s model filled from a numpy generator at
    a scale where the blocks, not the tied token embedding, steer the
    logits: Dense kernels N(0, 4/fan_in), token embeddings N(0, 0.09),
    positions N(0, 0.25), biases and LayerNorm offsets N(0, 0.01),
    LayerNorm scales 1 + that. At flax's own normal(0.02) init (and with
    embeddings that dominate the residual stream) every greedy stream of
    this model just repeats its last prompt token, which would prove
    nothing."""
    shapes = jax.eval_shape(
        jtfm.make_init_fn(jtfm.Transformer(jcfg), 8), jax.random.PRNGKey(0))[0]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = [getattr(p, "key", str(p)) for p in path]
        shape = leaf.shape
        n = lambda std: (std * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
        if name[-1] == "kernel":
            return n(2.0 * shape[0] ** -0.5)
        if name[-1] == "embedding":
            return n(0.3)
        if name[-1] == "pos_embed":
            return n(0.5)
        if name[-1] == "scale":
            return 1.0 + n(0.1)
        return n(0.1)  # biases, LayerNorm offsets, mlm_bias

    return jax.tree_util.tree_map_with_path(fill, shapes)
