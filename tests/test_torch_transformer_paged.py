"""The port's paged decoder forward (models/transformer.py via
weights.from_jax_params) against JAX ``Transformer.apply`` on the same
weights: two prefill chunks, a second sequence's chunk, decode steps
with an idle slot, and a speculative-verify-shaped step, through the
paged pool at trimmed and full table widths. Logits of every row and
the whole pool after every step agree in f32 to atol 1e-4 (same math,
other summation order), for ``fused_ln_matmul`` False and True, for a
causal post-LN model (``embed_ln``, the post-LN blocks, no ``final_ln``),
and for each of the port's attention paths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from distributed_tensorflow_tpu.models import transformer as jtfm
from distributed_tensorflow_tpu.serve import kv_cache as jkv
from distributed_tensorflow_tpu_torch.serve import kv_cache as tkv
from distributed_tensorflow_tpu_torch.weights import from_jax_params

NB, BS = 16, 8
MB_FULL = 8          # max_len 64 / block_size 8
OOB = MB_FULL * BS   # the engine's idle sentinel uses the FULL width
ATOL = 1e-4


def _steps():
    """(tokens [B,S], positions [B,S], table [B,MB]) per call."""
    rng = np.random.default_rng(1)
    tok = lambda *s: rng.integers(0, 256, size=s).astype(np.int32)  # noqa: E731
    a = np.array([3, 11, 6, 9], np.int32)
    b = np.array([0, 5], np.int32)

    def table(rows, width):
        t = np.full((len(rows), width), NB, np.int32)
        for i, r in enumerate(rows):
            t[i, :len(r)] = r
        return t

    chunk = lambda lo, n, c=16, w=4: np.where(  # noqa: E731
        np.arange(c) < n, lo + np.arange(c), w * BS).astype(np.int32)[None]
    idle = np.full(4, OOB, np.int32)
    return [
        (tok(1, 16), chunk(0, 13), table([a[:2]], 4)),     # A: chunk 1 (3 padded)
        (tok(1, 16), chunk(13, 8), table([a[:3]], 4)),     # A: chunk 2
        (tok(1, 16), chunk(0, 10), table([b[:2]], 2)),     # B: one chunk
        (tok(3, 1), np.array([[21], [10], [OOB]], np.int32),
         table([a[:3], b[:2], []], 4)),                     # decode, C idle
        (tok(3, 4), np.stack([np.arange(22, 26), [11, 12, 13, OOB], idle]).astype(np.int32),
         table([a, b[:2], []], 4)),                         # verify K=3
        (tok(3, 1), np.array([[26], [14], [OOB]], np.int32),
         table([a, b[:2], []], MB_FULL)),                   # decode, full width
    ]


@pytest.fixture(scope="module", params=[dict(fused_ln_matmul=False),
                                        dict(fused_ln_matmul=True),
                                        dict(pre_ln=False)],
                ids=["plain_ln", "fused_ln", "post_ln"])
def jax_run(request):
    jcfg = H.jax_cfg(paged_attention_impl="gather", **request.param)
    params = H.params_np(jcfg)
    model = jtfm.Transformer(jcfg)
    apply = jax_apply(model)
    cache = jkv.init_paged_cache(jcfg, NB, BS, dtype="float32")
    outs = []
    for tokens, pos, table in _steps():
        logits, cache = apply(params, jnp.asarray(tokens), cache, jnp.asarray(pos),
                              jnp.asarray(table))
        outs.append((np.asarray(logits), np.asarray(cache.k), np.asarray(cache.v)))
    return jcfg, params, outs


def jax_apply(model):
    import jax

    @jax.jit
    def apply(params, tokens, cache, pos, table):
        return model.apply({"params": params}, tokens, kv_cache=cache,
                           decode_pos=pos, block_table=table)
    return apply


@pytest.mark.parametrize("impl", ["gather", "fused", "cuda"])
def test_paged_forward_matches_jax(jax_run, impl):
    jcfg, params, outs = jax_run
    cfg = H.port_cfg(jcfg, paged_attention_impl=impl)
    model = from_jax_params(params, cfg, device="cpu")
    cache = tkv.init_paged_cache(cfg, NB, BS, dtype="float32", device="cpu")
    for i, ((tokens, pos, table), (jl, jk, jv)) in enumerate(zip(_steps(), outs)):
        with torch.no_grad():
            logits, same = model(torch.from_numpy(tokens), kv_cache=cache,
                                 decode_pos=torch.from_numpy(pos),
                                 block_table=torch.from_numpy(table))
        assert same is cache and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), jl, atol=ATOL, rtol=ATOL,
                                   err_msg=f"step {i} logits")
        np.testing.assert_allclose(cache.k.numpy(), jk, atol=ATOL, rtol=ATOL,
                                   err_msg=f"step {i} k pool")
        np.testing.assert_allclose(cache.v.numpy(), jv, atol=ATOL, rtol=ATOL,
                                   err_msg=f"step {i} v pool")


def test_port_config_and_weights_contract():
    """gpt_small has the published shape; the converter transposes flax
    [in, out] kernels into [out, in] weights; a post-LN model has an
    embed_ln and no final_ln, and the fused LN+matmul refuses it."""
    from distributed_tensorflow_tpu_torch.models import transformer as ttfm

    g = ttfm.gpt_small()
    assert (g.num_layers, g.d_model, g.num_heads, g.d_ff, g.vocab_size, g.max_len,
            g.dtype) == (12, 768, 12, 3072, 50304, 1024, "bfloat16")
    assert H.port_cfg(jtfm.gpt_small()) == g
    jcfg = H.jax_cfg(d_ff=96)
    params = H.params_np(jcfg)
    model = from_jax_params(params, H.port_cfg(jcfg), device="cpu")
    np.testing.assert_array_equal(model.layers[1].mlp_in.weight.numpy(),
                                  params["layer_1"]["mlp_in"]["kernel"].T)
    post = ttfm.Transformer(H.port_cfg(H.jax_cfg(pre_ln=False)), device="meta")
    assert hasattr(post, "embed_ln") and not hasattr(post, "final_ln")
    with pytest.raises(ValueError, match="pre_ln=True"):
        ttfm.Transformer(H.port_cfg(H.jax_cfg(pre_ln=False, fused_ln_matmul=True)))
