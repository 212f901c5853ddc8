"""Card-only tests of the port's CUDA kernels (marked ``cuda``; they skip
with a reason where ``torch.cuda.is_available()`` is False — a CUDA
kernel has no CPU mode). This file imports neither jax nor the JAX
package, so it runs on a machine with the card and no JAX::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest configures JAX.) Tolerances:
f32 kernel vs plain version — same math, other summation order; bf16 —
both round one f32 result to bf16, so one ulp (atol 1e-2, rtol 2^-7).
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.models import transformer as tfm
from distributed_tensorflow_tpu_torch.ops.fused_ln_matmul import ln_matmul, ln_matmul_plain
from distributed_tensorflow_tpu_torch.ops.paged_attention import (
    paged_attention_plain,
    paged_flash_attention,
)

TOLS = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (1e-2, 2 ** -7)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_inputs(rng, S, B=3, H=2, D=64, bs=16, NB=48, MB=20):
    """Row 0 spans 17 non-contiguous blocks (several splits of the
    kernel's key axis, the last one ragged), row 1 one block, row 2 is
    idle (all-sentinel table, past-the-table q_pos)."""
    oob = MB * bs
    table = np.full((B, MB), NB, np.int32)
    table[0, :17] = rng.permutation(np.arange(1, NB))[:17]
    table[1, :1] = [0]
    q_pos = np.empty((B, S), np.int32)
    q_pos[0] = 250 + np.arange(S)
    q_pos[1] = np.arange(S)
    q_pos[2] = oob  # idle row
    if S > 1:
        q_pos[0, -1] = -1  # padded rows
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return f(B, H, S, D), f(NB, H, bs, D), f(NB, H, bs, D), table, q_pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_kernel_matches_plain_on_card(card, dtype):
    rng = np.random.default_rng(0)
    for S in (1, 5, 32):
        q, k, v, table, q_pos = (torch.from_numpy(a).to(card) for a in _paged_inputs(rng, S))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        before = paged_flash_attention.launches
        got = paged_flash_attention(q, k, v, table, q_pos=q_pos)
        assert paged_flash_attention.launches == before + 1
        want = paged_attention_plain(q, k, v, table, q_pos=q_pos)
        atol, rtol = TOLS[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        if S > 1:
            assert not got[0, :, -1].float().abs().sum()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ln_matmul_kernel_matches_plain_on_card(card, dtype):
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(card)  # noqa: E731
    for M, d, n in ((5, 64, 96), (40, 768, 128), (64, 100, 200)):
        x, g, b = f(M, d).to(dtype), 1 + 0.1 * f(d), 0.1 * f(d)
        w, bias = (f(n, d) / d ** 0.5).to(dtype), 0.1 * f(n)
        want = ln_matmul_plain(x, g, b, w.t(), bias)
        for wv in (w.t(), w.t().contiguous()):  # nn.Linear view and [d, n]
            got = ln_matmul(x, g, b, wv, bias)
            atol, rtol = TOLS[dtype]
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=max(atol, 1e-4), rtol=max(rtol, 1e-4))


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    x = torch.zeros(4, 64, device=card, dtype=torch.float16)
    g = torch.ones(64, device=card)
    with pytest.raises(TypeError):
        ln_matmul(x, g, g, torch.zeros(64, 8, device=card, dtype=torch.float16))
    q = torch.zeros(1, 2, 1, 256, device=card)
    pool = torch.zeros(4, 2, 16, 256, device=card)
    table = torch.zeros(1, 2, dtype=torch.int32, device=card)
    pos = torch.zeros(1, 1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        paged_flash_attention(q, pool, pool, table, q_pos=pos)
    with pytest.raises(TypeError):
        paged_flash_attention(q[..., :64], pool[..., :64].contiguous(),
                              pool[..., :64].contiguous(), table.long(), q_pos=pos)


@pytest.mark.cuda
def test_engine_on_card_matches_engine_on_cpu(card):
    """A tiny f32 engine on the card (both kernels on the path) against
    the same engine on the CPU (their plain versions): equal greedy
    streams."""
    from distributed_tensorflow_tpu_torch.serve import ServeEngine

    cfg = tfm.TransformerConfig(vocab_size=128, max_len=64, num_layers=2, d_model=64,
                                num_heads=4, d_ff=128, dtype="float32", causal=True,
                                pre_ln=True, fused_ln_matmul=True)
    params = tfm.init_params(cfg, seed=0, device="cpu")
    for name, p in params.items():  # far from the init, so the streams vary
        if name.endswith("weight") and p.dim() == 2 and "embed" not in name:
            p.mul_(12.5)
    outs = []
    for device in ("cpu", card):
        eng = ServeEngine(cfg, params, device=device, num_slots=2, block_size=8,
                          prefill_chunk=8, spec_k=2)
        uids = [eng.submit([5 + i, 17, 3, 9] * 3, max_new_tokens=10) for i in range(3)]
        done = eng.run()
        eng.drain()
        outs.append([done[u].generated for u in uids])
        assert eng.alloc.blocks_free == eng.cache.num_blocks
    assert outs[0] == outs[1]
