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
from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
from distributed_tensorflow_tpu_torch.ops import fused_ln_matmul as fln
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


def _paged_inputs(rng, S, B=3, H=2, D=64, bs=16, NB=48, MB=20, n0=17, pos0=250):
    """Row 0 spans ``n0`` non-contiguous blocks (several chunks of the
    kernel's key axis, the last one ragged) at positions ``pos0``..,
    row 1 one block, row 2 is idle (all-sentinel table, past-the-table
    q_pos); at S > 1 row 0's last row is padded (q_pos = -1)."""
    oob = MB * bs
    table = np.full((B, MB), NB, np.int32)
    table[0, :n0] = rng.permutation(np.arange(1, NB))[:n0]
    table[1, :1] = [0]
    q_pos = np.empty((B, S), np.int32)
    q_pos[0] = pos0 + np.arange(S)
    q_pos[1] = np.arange(S)
    q_pos[2] = oob  # idle row
    if S > 1:
        q_pos[0, -1] = -1  # padded rows
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return f(B, H, S, D), f(NB, H, bs, D), f(NB, H, bs, D), table, q_pos


#: the paged kernel's card cases (``_paged_inputs`` keywords): decode,
#: verify and a 32-row chunk; a 64-row prefill chunk (one tile of 4 row
#: groups); 96- and 128-row chunks (two tiles, each its own cluster; the
#: second of the 96 half empty); head dims 32 and 128, and 8 and 16 (one
#: 16-column mma tile, D=8 zero-padded); blocks of 8 and 32 keys; a
#: 2048-key context (MB=128 at bs=16: 32 chunks, more than the 8 ranks)
PAGED_CASES = [dict(S=1), dict(S=5), dict(S=32), dict(S=64, n0=20),
               dict(S=96, n0=22, MB=22), dict(S=128, n0=24, MB=24),
               dict(S=5, D=32), dict(S=64, D=128, n0=20),
               dict(S=1, D=8), dict(S=5, D=8), dict(S=1, D=16), dict(S=5, D=16),
               dict(S=5, bs=8, NB=96, MB=48, n0=36), dict(S=32, bs=32, NB=24, MB=12, n0=9),
               dict(S=5, NB=160, MB=128, n0=128, pos0=2040)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_kernel_matches_plain_on_card(card, dtype):
    rng = np.random.default_rng(0)
    for case in PAGED_CASES:
        q, k, v, table, q_pos = (torch.from_numpy(a).to(card)
                                 for a in _paged_inputs(rng, **case))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        before = paged_flash_attention.launches
        got = paged_flash_attention(q, k, v, table, q_pos=q_pos)
        assert paged_flash_attention.launches == before + 1
        want = paged_attention_plain(q, k, v, table, q_pos=q_pos)
        atol, rtol = TOLS[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol,
                                   msg=lambda m, case=case: f"{case}: {m}")
        if case["S"] > 1:
            assert not got[0, :, -1].float().abs().sum(), case


@pytest.mark.cuda
def test_paged_attention_is_bitwise_repeatable(card):
    """Two calls on the same inputs are bitwise equal at decode (S=1) and at
    64- and 128-row prefill chunks, both dtypes: the ranks' partials are
    merged in rank order inside the launch, no float atomics."""
    rng = np.random.default_rng(17)
    for case in (dict(S=1, NB=160, MB=128, n0=128, pos0=2000), dict(S=64, n0=20),
                 dict(S=128, n0=24, MB=24)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, table, q_pos = (torch.from_numpy(a).to(card)
                                     for a in _paged_inputs(rng, **case))
            q, k, v = (t.to(dtype) for t in (q, k, v))
            a, b = (paged_flash_attention(q, k, v, table, q_pos=q_pos) for _ in range(2))
            assert torch.equal(a, b), (case, dtype)


#: (M, d, n) of the serving forward (``ln_matmul_kernel``, below
#: ``LN_TILED_MIN_M`` rows): ragged d and n (no multiple of the 16-byte
#: vector, so the element-wise loads; d = 100 splits into a short last
#: slice; at M = 200 too, a shape the tiled pair does not take), then the
#: decode and prefill rows of gpt_small's q/k/v (n=768), fused qkv (2304)
#: and mlp_in (3072) widths — M = 1 and 4 under one 16-row tile, 20 over
#: it, 255 over several
LN_ROWS_CASES = [(5, 64, 96), (40, 768, 128), (64, 100, 200), (200, 100, 200)] + [
    (M, 768, n) for M in (1, 4, 20, 255) for n in (768, 2304, 3072)]
#: the serving forward's three entries, (x dtype, out dtype), and their
#: tolerances: f32 — the same math in another summation order (the ranks'
#: partials of d summed in rank order); bf16 out — both round h and y to
#: bf16 once (one ulp); bf16 -> f32 — an h on a rounding tie may fall the
#: other way, one bf16 ulp of one term
LN_ROWS_TOLS = {(torch.float32, torch.float32): (1e-4, 1e-4),
                (torch.bfloat16, torch.bfloat16): TOLS[torch.bfloat16],
                (torch.bfloat16, torch.float32): TOLS[torch.bfloat16]}


def _ln_rows(x, g, b, w, bias, out_dtype):
    """The serving forward as ``ln_matmul`` routes it below
    ``LN_TILED_MIN_M`` rows, and directly from there up, so every case
    holds the serving kernel whatever the threshold."""
    if x.shape[0] < fln.LN_TILED_MIN_M:
        return ln_matmul(x, g, b, w, bias, out_dtype=out_dtype)
    return fln._launch_fwd_rows(x, g, b, w, bias, 1e-6, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", list(LN_ROWS_TOLS), ids=["f32", "bf16", "bf16_f32"])
def test_ln_matmul_kernel_matches_plain_on_card(card, dtypes):
    """The serving forward against the plain version in both w layouts
    and all three entries, one launch a call, no tiled launch."""
    dtype, out_dtype = dtypes
    atol, rtol = LN_ROWS_TOLS[dtypes]
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(card)  # noqa: E731
    for M, d, n in LN_ROWS_CASES:
        x, g, b = f(M, d).to(dtype), 1 + 0.1 * f(d), 0.1 * f(d)
        w, bias = (f(n, d) / d ** 0.5).to(dtype), 0.1 * f(n)
        want = ln_matmul_plain(x, g, b, w.t(), bias, out_dtype=out_dtype)
        for wv in (w.t(), w.t().contiguous()):  # nn.Linear view and [d, n]
            before = (ln_matmul.launches, ln_matmul.tiled_launches)
            got = _ln_rows(x, g, b, wv, bias, out_dtype)
            torch.cuda.synchronize()
            assert (ln_matmul.launches, ln_matmul.tiled_launches) == (before[0] + 1, before[1])
            assert got.dtype == out_dtype and got.shape == (M, n)
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol,
                                       msg=lambda m: f"{(M, d, n, wv.stride())}: {m}")


@pytest.mark.cuda
def test_ln_matmul_serving_fwd_is_bitwise_repeatable(card):
    """Two calls of the serving forward on the same bf16 inputs are bitwise
    equal at decode (M=4) and prefill (M=64) rows, n=3072, both layouts:
    the ranks' partials of d are summed in one order, no float atomics."""
    rng = np.random.default_rng(14)
    for M in (4, 64):
        x, g, b, w_nd, bias = _ln_fwd_inputs(rng, card, torch.bfloat16, M, 768, 3072)
        for wv in (w_nd.t(), w_nd.t().contiguous()):
            a, c = (_ln_rows(x, g, b, wv, bias, torch.bfloat16) for _ in range(2))
            assert torch.equal(a, c), (M, wv.stride())


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


#: (B, H, Sq, Sk, D, causal, masked): square, ragged (no 64-multiple),
#: Sq < Sk (causal q_offset > 0), Sq > Sk (causal rows that attend
#: nothing), and the 128 head dim; then the edges of the bf16 dK/dV
#: kernel (64-key CTAs at D=64, 128-key at D=128, 64-row q tiles through a
#: 3-stage ring): a ring that wraps three times, Sk no multiple of the key
#: tile (D=64 and D=128), whole key tiles with kv_mask all False
#: (masked="tiles": keys 128..255), Sq > Sk over several q tiles, and
#: D=128 over several key and q tiles; then the edges of the bf16 forward
#: (128-row CTAs at D=64, 64-row at D=128, 64-key tiles through a 2- or
#: 3-stage ring): a non-causal Sk that wraps the ring several times with a
#: ragged last tile and a kv_mask, the same with no mask (no tile masked),
#: an Sq smaller than one CTA's rows (causal, q_offset > 0), and D=128 with
#: Sq no multiple of the row tile; the bf16 dQ kernel (the forward's row
#: tiles, 32-key tiles through a 3- or 2-stage ring) meets the same edges;
#: last, BERT's attention: S=512, non-causal, the kv_mask of a padded batch
#: (each row a valid prefix of 384-512 keys, the last row none)
FLASH_CASES = [
    (2, 3, 128, 128, 64, True, False),
    (2, 3, 128, 128, 64, False, True),
    (1, 2, 100, 100, 64, True, True),
    (1, 2, 37, 130, 64, True, False),
    (2, 2, 200, 70, 64, True, True),
    (1, 2, 96, 96, 128, True, True),
    (1, 2, 640, 640, 64, True, False),
    (2, 2, 200, 200, 64, False, True),
    (2, 2, 150, 200, 128, True, True),
    (2, 2, 320, 320, 64, True, "tiles"),
    (2, 2, 300, 130, 64, True, False),
    (2, 3, 384, 384, 128, True, False),
    (1, 2, 64, 700, 64, False, True),
    (1, 2, 96, 512, 64, False, False),
    (2, 3, 20, 300, 64, True, True),
    (1, 3, 333, 333, 128, True, True),
    (2, 2, 512, 512, 64, False, "padded"),
]

#: relative L2 error of dq, dk, dv against the plain version, beside the
#: elementwise gate (whose atol passes a dk 30% off where |dk| is small):
#: on an H100 the kernels read at most ~1.4e-4 (bf16: p and ds rounded on
#: either side of a tie) and ~2e-7 (f32: another summation order); a dk
#: scaled by 1.01 reads 1e-2 (PERF.md)
FLASH_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-3}

#: relative L2 error of the forward's out against the plain version (the
#: elementwise atol passes an out far off where |out| is small, as in late
#: causal rows): ``TOL["flash/fwd/rel_l2/*"]`` of chip_smoke.py, with the
#: readings behind it there
FLASH_FWD_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 3e-3}


def _flash_inputs(rng, card, dtype, B, H, Sq, Sk, D, masked):
    """q/k/v as the model makes them — [B,S,H,D] viewed as [B,H,S,D] — and
    a kv_mask whose last batch row attends nothing (with masked="tiles",
    keys 128..255 attend in no row either; with masked="padded", each
    other row attends a valid prefix of 384-512 keys)."""
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(card)  # noqa: E731
    q, k, v, dout = (t.to(dtype).transpose(1, 2) for t in
                     (f(B, Sq, H, D), f(B, Sk, H, D), f(B, Sk, H, D), f(B, Sq, H, D)))
    mask = None
    if masked == "padded":
        lens = rng.integers(min(384, Sk), Sk + 1, B)
        lens[-1] = 0
        mask = torch.from_numpy(np.arange(Sk)[None, :] < lens[:, None]).to(card)
    elif masked:
        mask = torch.from_numpy(rng.random((B, Sk)) > 0.25).to(card)
        mask[-1] = False
        if masked == "tiles":
            mask[:, 128:256] = False
    return q, k, v, mask, dout


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernels_match_plain_on_card(card, dtype):
    """The three kernels against the plain versions: out, LSE, dq, dk, dv.
    f32: same math, other order (1e-4); bf16: both round p and ds to bf16
    before their products and the result once, so one ulp (1e-2, 2^-7)."""
    rng = np.random.default_rng(2)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else TOLS[dtype]
    for B, H, Sq, Sk, D, causal, masked in FLASH_CASES:
        q, k, v, mask, dout = _flash_inputs(rng, card, dtype, B, H, Sq, Sk, D, masked)
        counts = (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
        out, lse = fa.flash_fwd(q, k, v, mask, causal=causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, mask, out, lse, dout, causal=causal)
        dq = fa.flash_bwd_dq(q, k, v, mask, out, lse, dout, causal=causal)
        torch.cuda.synchronize()
        assert (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches,
                fa.flash_bwd_dq.launches) == tuple(c + 1 for c in counts)
        want_out, want_lse = fa.flash_attention_plain(q, k, v, mask, causal=causal)
        want = fa.flash_attention_bwd_plain(q, k, v, mask, out, lse, dout, causal=causal)
        case = (B, H, Sq, Sk, D, causal, masked)
        torch.testing.assert_close(out.float(), want_out.float(), atol=atol, rtol=rtol,
                                   msg=lambda m: f"out {case}: {m}")
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5,
                                   msg=lambda m: f"lse {case}: {m}")
        assert _rel_l2(out, want_out) <= FLASH_FWD_REL_L2[dtype], (
            "out", case, _rel_l2(out, want_out))
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            torch.testing.assert_close(got.float(), w.float(), atol=atol, rtol=rtol,
                                       msg=lambda m: f"{name} {case}: {m}")
            assert _rel_l2(got, w) <= FLASH_REL_L2[dtype], (name, case, _rel_l2(got, w))
        if masked:  # the last batch row attends nothing: 0 out, NEG_INF, 0 grads
            assert not out[-1].float().abs().sum() and not dq[-1].float().abs().sum()
            assert not dk[-1].float().abs().sum() and not dv[-1].float().abs().sum()
            assert (lse[-1] == fa.NEG_INF).all()
        if masked == "tiles":  # keys no row attends get zero gradients
            assert not dk[:, :, 128:256].float().abs().sum()
            assert not dv[:, :, 128:256].float().abs().sum()


@pytest.mark.cuda
def test_flash_autograd_on_card_is_deterministic(card):
    """The autograd.Function launches fwd, then dK/dV and dQ; two backward
    passes give bitwise-equal gradients (no float atomics)."""
    rng = np.random.default_rng(3)
    q, k, v, mask, dout = _flash_inputs(rng, card, torch.bfloat16, 2, 4, 256, 256, 64, True)
    grads = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=True, kv_mask=mask)
        out.backward(dout)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    want = fa.flash_attention_bwd_plain(q, k, v, mask, *fa.flash_attention_plain(
        q, k, v, mask, causal=True), dout, causal=True)
    for got, w in zip(grads[0], want):
        torch.testing.assert_close(got.float(), w.float(), atol=1e-2, rtol=2 ** -7)


@pytest.mark.cuda
def test_flash_bwd_dkv_on_card_is_bitwise_repeatable(card):
    """The dK/dV kernel alone at the training shape (B=8 H=12 S=1024 D=64,
    causal, bf16): no atomics, so two launches give the same bits."""
    rng = np.random.default_rng(4)
    q, k, v, _, dout = _flash_inputs(rng, card, torch.bfloat16, 8, 12, 1024, 1024, 64, False)
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    first = fa.flash_bwd_dkv(q, k, v, None, out, lse, dout, causal=True)
    second = fa.flash_bwd_dkv(q, k, v, None, out, lse, dout, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert first[0].abs().sum() and first[1].abs().sum()


@pytest.mark.cuda
def test_flash_fwd_on_card_is_bitwise_repeatable(card):
    """The forward alone at the training shape (B=8 H=12 S=1024 D=64,
    causal, bf16): two launches give the same bits, out and LSE."""
    rng = np.random.default_rng(5)
    q, k, v, _, _ = _flash_inputs(rng, card, torch.bfloat16, 8, 12, 1024, 1024, 64, False)
    first = fa.flash_fwd(q, k, v, causal=True)
    second = fa.flash_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert first[0].abs().sum() and torch.isfinite(first[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_fwd_on_card_takes_any_scale(card, dtype):
    """A negative scale (the bf16 kernel negates Q's fragments so that the
    row max of the raw products stays the max of the logits) and a zero
    scale (uniform weights) against the plain version."""
    rng = np.random.default_rng(6)
    q, k, v, mask, _ = _flash_inputs(rng, card, dtype, 2, 2, 150, 150, 64, True)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else TOLS[dtype]
    for scale in (-0.3, 0.0):
        out, lse = fa.flash_fwd(q, k, v, mask, causal=True, sm_scale=scale)
        want_out, want_lse = fa.flash_attention_plain(q, k, v, mask, causal=True,
                                                      sm_scale=scale)
        torch.testing.assert_close(out.float(), want_out.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
        assert _rel_l2(out, want_out) <= FLASH_FWD_REL_L2[dtype], (scale, _rel_l2(out, want_out))


@pytest.mark.cuda
def test_flash_bwd_dq_on_card_is_bitwise_repeatable(card):
    """The dQ kernel alone at the training shape (B=8 H=12 S=1024 D=64,
    causal, bf16): no atomics, so two launches give the same bits."""
    rng = np.random.default_rng(7)
    q, k, v, _, dout = _flash_inputs(rng, card, torch.bfloat16, 8, 12, 1024, 1024, 64, False)
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    first = fa.flash_bwd_dq(q, k, v, None, out, lse, dout, causal=True)
    second = fa.flash_bwd_dq(q, k, v, None, out, lse, dout, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert first.abs().sum()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_bwd_on_card_takes_any_scale(card, dtype):
    """dq, dk and dv at a negative and a zero scale (p from an LSE that is
    final, so no max to keep) against the plain version, elementwise and
    by relative L2 error."""
    rng = np.random.default_rng(8)
    q, k, v, mask, dout = _flash_inputs(rng, card, dtype, 2, 2, 150, 150, 64, True)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else TOLS[dtype]
    for scale in (-0.3, 0.0):
        out, lse = fa.flash_fwd(q, k, v, mask, causal=True, sm_scale=scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, mask, out, lse, dout, causal=True, sm_scale=scale)
        dq = fa.flash_bwd_dq(q, k, v, mask, out, lse, dout, causal=True, sm_scale=scale)
        want = fa.flash_attention_bwd_plain(q, k, v, mask, out, lse, dout, causal=True,
                                            sm_scale=scale)
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            torch.testing.assert_close(got.float(), w.float(), atol=atol, rtol=rtol,
                                       msg=lambda m: f"{name} scale {scale}: {m}")
            assert _rel_l2(got, w) <= FLASH_REL_L2[dtype], (name, scale, _rel_l2(got, w))


@pytest.mark.cuda
def test_flash_wrappers_raise_on_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 2, 64, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_fwd(q, q, q)
    q = torch.zeros(1, 2, 64, 32, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, q, q)
    buf = torch.zeros(1 * 2 * 64 * 64 + 1, device=card, dtype=torch.bfloat16)
    q = buf[1:].view(1, 2, 64, 64)  # 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_fwd(q, q, q)
    # the backward kernels stage out with 16-byte copies too
    q = torch.zeros(1, 2, 64, 64, device=card, dtype=torch.bfloat16)
    out = buf[1:].view(1, 2, 64, 64)
    lse = torch.zeros(1, 2, 64, device=card)
    for bwd in (fa.flash_bwd_dkv, fa.flash_bwd_dq):
        with pytest.raises(ValueError, match="out: the flash kernels load rows 16 bytes"):
            bwd(q, q, q, None, out, lse, q)


@pytest.mark.cuda
def test_training_steps_on_card_match_the_cpu(card):
    """Two adamw steps of a tiny f32 causal LM (head_dim 64, so the flash
    kernels take it) on the card — forward, dK/dV and dQ kernels at every
    layer — against the same steps on the CPU (their plain versions), from
    the same weights and batches: the same losses and parameters (f32,
    other summation order: 1e-4)."""
    from distributed_tensorflow_tpu_torch.data.text import SyntheticLM, TextDataConfig
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.train import (
        OptimizerConfig, init_train_state, make_optimizer, make_train_step)

    cfg = tfm.TransformerConfig(vocab_size=256, max_len=96, num_layers=2, d_model=128,
                                num_heads=2, d_ff=256, dropout=0.0, dtype="float32",
                                causal=True, pre_ln=True, attention_impl="flash")
    params = tfm.init_params(cfg, seed=0, device="cpu", trainable=True)
    data = SyntheticLM(TextDataConfig(dataset="synthetic_lm", global_batch_size=4,
                                      seq_len=96, vocab_size=256))
    runs = []
    for device in (card, torch.device("cpu")):
        model = tfm.build(cfg, params, device, trainable=True)
        state = init_train_state(model, make_optimizer(
            OptimizerConfig(name="adamw", learning_rate=1e-3, weight_decay=0.1),
            model.parameters()))
        step = make_train_step(tfm.causal_lm_loss(model, 32))
        before = fa.flash_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches
        losses = []
        for i in range(2):
            batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        after = fa.flash_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches
        runs.append((losses, model, [a - b for a, b in zip(after, before)]))
    (got, gmodel, glaunch), (want, wmodel, wlaunch) = runs
    assert glaunch == [4, 4, 4] and wlaunch == [0, 0, 0]  # 2 layers x 2 steps on the card
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for (name, p), q in zip(gmodel.named_parameters(), wmodel.parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), atol=1e-4, rtol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
def test_bert_step_on_card_flash_matches_dense(card):
    """One adamw step of a tiny f32 post-LN BERT (head_dim 64, the gathered
    MLM head) on a padded batch — each row a valid prefix of 40-96 tokens,
    the last row none and its labels out of the loss — with the flash
    kernels (non-causal, with the kv_mask) and with dense attention, from
    the same weights: the same loss and parameters (f32, other summation
    order: 1e-4); the flash step launched each kernel once a layer."""
    from distributed_tensorflow_tpu_torch.data.text import (
        IGNORE_INDEX, SyntheticMLM, TextDataConfig)
    from distributed_tensorflow_tpu_torch.train import (
        OptimizerConfig, init_train_state, make_optimizer, make_train_step)

    base = dict(vocab_size=256, max_len=96, num_layers=2, d_model=128, num_heads=2,
                d_ff=256, dropout=0.0, dtype="float32", causal=False, pre_ln=False)
    params = tfm.init_params(tfm.TransformerConfig(**base), seed=0, device="cpu",
                             trainable=True)
    batch = SyntheticMLM(TextDataConfig(global_batch_size=4, seq_len=96, vocab_size=256,
                                        max_predictions=8)).batch(0)
    rng = np.random.default_rng(0)
    lens = np.array([96, 40, 71, 0])
    batch["attention_mask"] = (np.arange(96)[None] < lens[:, None]).astype(np.int32)
    batch["masked_positions"] = np.stack([np.sort(rng.choice(max(n, 8), 8, replace=False))
                                          for n in lens]).astype(np.int32)
    batch["masked_labels"][-1] = IGNORE_INDEX
    runs = []
    for impl in ("flash", "dense"):
        cfg = tfm.TransformerConfig(**base, attention_impl=impl)
        model = tfm.build(cfg, params, card, trainable=True)
        state = init_train_state(model, make_optimizer(
            OptimizerConfig(name="adamw", learning_rate=1e-3, weight_decay=0.01),
            model.parameters()))
        step = make_train_step(tfm.mlm_loss_fn(model))
        before = fa.flash_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches
        state, metrics = step(state, {k: torch.from_numpy(v).to(card) for k, v in batch.items()})
        after = fa.flash_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches
        runs.append((float(metrics["loss"]), model, [a - b for a, b in zip(after, before)]))
    (got, gmodel, glaunch), (want, wmodel, wlaunch) = runs
    assert glaunch == [2, 2, 2] and wlaunch == [0, 0, 0]
    assert np.isfinite(got) and abs(got - want) <= 1e-4
    for (name, p), q in zip(gmodel.named_parameters(), wmodel.parameters()):
        torch.testing.assert_close(p.detach(), q.detach(), atol=1e-4, rtol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


# ---------------------------------------------------------------------------
# fused 1x1 conv + BatchNorm (rows 8-11 of the kernel table)
# ---------------------------------------------------------------------------

#: (M, cin, cout, w layout): ragged M, channels that are not tile
#: multiples, the single-pass shapes of ResNet-50's stage 0, a two-pass
#: shape, one whose M is no multiple of the dx tile's 128 rows and whose cin
#: spans two 128-wide dx tiles (the second ragged), and the two-pass shape
#: with w a contiguous [cin, cout] array instead of the OIHW weight's view;
#: then single-pass cases: M spanning three waves of 132 CTAs of 64-row
#: tiles and 37 rows more (a ragged last tile), the rule's square corner
#: 128->128, 64->256 with a contiguous w, and M spanning five and four waves
#: at 64->64 and 256->64, so each CTA's tiles wrap its 4- and 3-stage ring;
#: then two-pass dw cases: cout 128 (the 128-wide dw tile) with cin spanning
#: two tiles, and 512->1024 (128 x 256 tiles, 16 of them; G = 3 on 132 SMs,
#: capped by the partials) at M = 3109, so each chunk spans 16-17 blocks of
#: 64 rows, past the 2-stage ring, the last one ragged; then forward cases:
#: cin 1000 (sixteen 64-deep stages, the last ragged) into cout 136 (the
#: 64-wide tile, the third of them ragged) in both w layouts, and M spanning
#: three and two waves of 132 CTAs of 128-row tiles and 37 rows more (a
#: ragged last tile, each CTA's tiles wrapping the ring) at the 256-wide tile
#: with a contiguous w and at the 128-wide one (cin four stages deep) in both
#: layouts. Over all cases the forward takes each width: 64 (cout 24, 40, 64,
#: 136), 128 (cout 128) and 256 (cout 256 and up)
CONV_BN_CASES = [(37, 16, 24, "oihw"), (200, 64, 256, "oihw"), (130, 256, 64, "oihw"),
                 (300, 128, 512, "oihw"), (100, 72, 40, "oihw"), (333, 200, 136, "oihw"),
                 (300, 128, 512, "contiguous"), (3 * 132 * 64 + 37, 64, 256, "oihw"),
                 (300, 128, 128, "oihw"), (200, 64, 256, "contiguous"),
                 (5 * 132 * 64 + 37, 64, 64, "oihw"), (4 * 132 * 64 + 37, 256, 64, "oihw"),
                 (300, 256, 128, "oihw"), (3109, 512, 1024, "oihw"),
                 (333, 1000, 136, "oihw"), (333, 1000, 136, "contiguous"),
                 (3 * 132 * 128 + 37, 64, 256, "contiguous"),
                 (2 * 132 * 128 + 37, 256, 128, "oihw"),
                 (2 * 132 * 128 + 37, 256, 128, "contiguous")]
#: (prologue, relu, emit_stats)
CONV_BN_VARIANTS = [(False, False, True), (False, False, False), (True, True, True),
                    (True, False, True), (True, True, False)]


def _conv_bn_inputs(rng, card, dtype, M, cin, cout, prologue, layout="oihw"):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(card)  # noqa: E731
    x = f(M, cin).to(dtype)
    w = (f(cout, cin) / cin ** 0.5).to(dtype).t()  # the OIHW weight's [cin, cout] view
    if layout == "contiguous":
        w = w.contiguous()
    scale = 1 + 0.2 * f(cin) if prologue else None
    shift = 0.2 * f(cin) if prologue else None
    return x, w, scale, shift, f(M, cout).to(dtype), 0.1 * f(cout), 0.01 * f(cout)


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv_bn_kernels_match_plain_on_card(card, dtype):
    """Rows 8-11 against their plain versions at every prologue/relu/stats
    variant. Elementwise outputs (y, dx): f32 same math in another order
    (1e-4); bf16 one ulp (1e-2, 2^-7). Reductions over M (statistics, dw,
    dscale, dshift): relative L2 error 1e-5 in f32; 2e-3 in bf16, where an
    operand rounded to bf16 on the other side of a tie moves a sum by one
    ulp of one term."""
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    rng = np.random.default_rng(5)
    tol = TOLS[dtype] if dtype == torch.bfloat16 else (1e-4, 1e-4)
    red_tol = 2e-3 if dtype == torch.bfloat16 else 1e-5
    for M, cin, cout, layout in CONV_BN_CASES:
        for prologue, relu, stats in CONV_BN_VARIANTS:
            x, w, sc, sh, dy, dsum, dssq = _conv_bn_inputs(rng, card, dtype, M, cin, cout,
                                                           prologue, layout)
            case = (M, cin, cout, layout, prologue, relu, stats)
            kw = dict(relu=relu, emit_stats=stats)
            before = {n: k.launches for n, k in fcb.KERNELS.items()}
            y, s, q = fcb.conv1x1_bn_fwd(x, w, sc, sh, **kw)
            want = fcb.conv1x1_bn_act_plain(x, w, sc, sh, **kw)
            want_y = want[0] if stats else want
            torch.testing.assert_close(y.float(), want_y.float(), atol=tol[0], rtol=tol[1],
                                       msg=lambda m: f"y {case}: {m}")
            if stats:
                assert _rel_l2(s, want[1]) < red_tol and _rel_l2(q, want[2]) < red_tol, case
            bwd = (x, y, dy, w, sc, sh, dsum if stats else None, dssq if stats else None)
            dx, dsc, dsh = fcb.conv1x1_bn_bwd_dx(*bwd, **kw)
            dw = fcb.conv1x1_bn_bwd_dw(x, y, dy, sc, sh, *bwd[6:], **kw)
            ref = fcb.conv1x1_bn_bwd_plain(*bwd, **kw)
            got = [(dx, dw, dsc, dsh)]
            if fcb.single_pass(cin, cout):
                got.append(fcb.conv1x1_bn_bwd_single(*bwd, **kw))
            torch.cuda.synchronize()
            for kernel, g in zip(("dx + dw", "single-pass"), got):
                torch.testing.assert_close(g[0].float(), ref[0].float(), atol=tol[0],
                                           rtol=tol[1], msg=lambda m: f"{kernel} dx {case}: {m}")
                assert _rel_l2(g[1], ref[1]) < red_tol, ("dw", case, _rel_l2(g[1], ref[1]))
                if prologue:
                    assert _rel_l2(g[2], ref[2]) < red_tol, ("dscale", case)
                    assert _rel_l2(g[3], ref[3]) < red_tol, ("dshift", case)
                else:
                    assert g[2] is None and g[3] is None
            after = {n: k.launches for n, k in fcb.KERNELS.items()}
            assert after["conv_bn_fwd"] == before["conv_bn_fwd"] + 1
            assert after["conv_bn_bwd_dx"] == before["conv_bn_bwd_dx"] + 1
            assert after["conv_bn_bwd_single"] == before["conv_bn_bwd_single"] + (len(got) - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("bwd_impl", ["xla", "pallas"])
def test_conv_bn_autograd_on_card_matches_cpu(card, bwd_impl):
    """conv1x1_bn_act through autograd on the card (the kernels, or the
    xla backward's torch.mm) against the same call on the CPU (plain
    versions), f32: outputs, statistics and all four gradients (1e-4;
    same math, other summation order)."""
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    rng = np.random.default_rng(6)
    for M, cin, cout in ((150, 64, 128), (90, 256, 512)):
        x, w, sc, sh, dy, dsum, dssq = _conv_bn_inputs(rng, card, torch.float32, M, cin, cout,
                                                       True)
        outs = []
        for dev in (card, torch.device("cpu")):
            leaves = [t.detach().to(dev).clone().requires_grad_() for t in (x, w, sc, sh)]
            y, s, q = fcb.conv1x1_bn_act(*leaves, relu=True, bwd_impl=bwd_impl)
            torch.autograd.backward((y, s, q), (dy.to(dev), dsum.to(dev), dssq.to(dev)))
            outs.append([t.detach().cpu() for t in (y, s, q)] + [t.grad.cpu() for t in leaves])
        for name, a, b in zip(("y", "sum", "sumsq", "dx", "dw", "dscale", "dshift"), *outs):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4,
                                       msg=lambda m: f"{name} {(M, cin, cout)}: {m}")


@pytest.mark.cuda
def test_conv_bn_kernels_are_deterministic(card):
    """Two calls of every kernel on the same bf16 inputs give bitwise-equal
    results: the reductions over M use per-chunk partials summed in a
    fixed order, no float atomics. The two-pass shapes take the dw
    kernel's 128-wide tile (3000, 256->128) and its 256-wide one (2000,
    384->256; 6000, 128->512)."""
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    rng = np.random.default_rng(7)
    for M, cin, cout in ((5000, 64, 256), (3000, 256, 128), (2000, 384, 256), (6000, 128, 512)):
        x, w, sc, sh, dy, dsum, dssq = _conv_bn_inputs(rng, card, torch.bfloat16, M, cin, cout,
                                                       True)
        runs = []
        for _ in range(2):
            y, s, q = fcb.conv1x1_bn_fwd(x, w, sc, sh)
            out = [y, s, q, *fcb.conv1x1_bn_bwd_dx(x, y, dy, w, sc, sh, dsum, dssq),
                   fcb.conv1x1_bn_bwd_dw(x, y, dy, sc, sh, dsum, dssq)]
            if fcb.single_pass(cin, cout):
                out += list(fcb.conv1x1_bn_bwd_single(x, y, dy, w, sc, sh, dsum, dssq))
            runs.append(out)
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["oihw", "contiguous"])
def test_conv_bn_fwd_is_bitwise_repeatable_at_each_width(card, layout):
    """Two calls of the forward kernel on the same bf16 inputs give
    bitwise-equal y and statistics at each tile width of ``fwd_plan`` (64,
    128, 256), with and without the prologue, with M over a wave of CTAs so
    each CTA sums several tiles: the statistics' partials are summed in a
    fixed order, no float atomics."""
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    rng = np.random.default_rng(10)
    M = 2 * 132 * 128 + 37
    for cin, cout, bn in ((64, 64, 64), (256, 128, 128), (200, 512, 256)):
        plan = fcb.fwd_plan(M, cin, cout, fcb._sms(card), fcb.fwd_tile())
        assert plan["tile"][1] == bn, plan
        for prologue in (True, False):
            x, w, sc, sh, _, _, _ = _conv_bn_inputs(rng, card, torch.bfloat16, M, cin, cout,
                                                    prologue, layout)
            a = fcb.conv1x1_bn_fwd(x, w, sc, sh)
            b = fcb.conv1x1_bn_fwd(x, w, sc, sh)
            for name, u, v in zip(("y", "sum", "sumsq"), a, b):
                assert torch.equal(u, v), (name, cin, cout, prologue)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv_bn_prologue_rounds_the_product_before_the_shift(card, dtype):
    """One column of x holds a single value x0, with a scale s0 such that
    x0*s0 is inexact in f32 and lies above its rounding, and shift =
    -fl(x0*s0): the plain version's h = relu(fl(x0*s0) + shift) is exactly
    0 there, where an fma would keep the rounding error. Every other
    column's shift gives h = 0, and that column's w row is large. So y, its
    statistics, dx, dscale, dshift and dw (the two-pass pair at 256->128,
    the single-pass kernel too at 64->64) must equal the plain version's
    exactly: all zero."""
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    rng = np.random.default_rng(9)
    # x0 exact in bf16, s0 in f32, their exact product (float64 holds it)
    # above its f32 rounding
    for _ in range(1000):
        x0 = float(torch.tensor(rng.uniform(1, 2)).to(torch.bfloat16))
        s0 = np.float32(rng.uniform(0.5, 2))
        if x0 * float(s0) > float(np.float32(x0) * s0):
            break
    else:
        raise AssertionError("no inexact x0 * s0 above its rounding")
    for M, cin, cout, col in ((1000, 256, 128, 133), (1000, 64, 64, 33)):
        x, w, _, _, dy, dsum, dssq = _conv_bn_inputs(rng, card, dtype, M, cin, cout, False)
        x[:, col] = x0
        w = w.contiguous()
        w[col] = 1e3
        scale = torch.ones(cin, device=card)
        scale[col] = float(s0)
        shift = torch.full((cin,), -100.0, device=card)
        shift[col] = -float(np.float32(x0) * s0)
        y, s, q = fcb.conv1x1_bn_fwd(x, w, scale, shift)
        want = fcb.conv1x1_bn_act_plain(x, w, scale, shift)
        bwd = (x, y, dy, w, scale, shift, dsum, dssq)
        dx, dsc, dsh = fcb.conv1x1_bn_bwd_dx(*bwd)
        dw = fcb.conv1x1_bn_bwd_dw(x, y, dy, scale, shift, dsum, dssq)
        ref = fcb.conv1x1_bn_bwd_plain(*bwd)
        got = {"y": y, "sum": s, "sumsq": q, "dx": dx, "dscale": dsc, "dshift": dsh, "dw": dw}
        if fcb.single_pass(cin, cout):
            got.update(zip(("single dx", "single dw", "single dscale", "single dshift"),
                           fcb.conv1x1_bn_bwd_single(*bwd)))
        torch.cuda.synchronize()
        assert not want[0].any() and not any(r.any() for r in ref)
        for name, t in got.items():
            assert not t.any(), (name, (M, cin, cout), float(t.abs().max()))


@pytest.mark.cuda
def test_conv_bn_single_pass_is_bitwise_repeatable(card):
    """Two calls of the single-pass kernel on the same bf16 inputs give
    bitwise-equal dx, dw, dscale and dshift at each of the rule's channel
    pairs that ResNet-50 runs, with and without the prologue and the
    statistics: its partials are summed in a fixed order."""
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    rng = np.random.default_rng(8)
    for M, cin, cout in ((9000, 64, 256), (9000, 256, 64), (5000, 64, 64), (4000, 128, 128)):
        for prologue, stats in ((True, True), (False, True), (True, False)):
            x, w, sc, sh, dy, dsum, dssq = _conv_bn_inputs(rng, card, torch.bfloat16, M, cin,
                                                           cout, prologue)
            y = fcb.conv1x1_bn_fwd(x, w, sc, sh, emit_stats=stats)[0]
            bwd = (x, y, dy, w, sc, sh, dsum if stats else None, dssq if stats else None)
            a = fcb.conv1x1_bn_bwd_single(*bwd, emit_stats=stats)
            b = fcb.conv1x1_bn_bwd_single(*bwd, emit_stats=stats)
            case = (M, cin, cout, prologue, stats)
            for name, u, v in zip(("dx", "dw", "dscale", "dshift"), a, b):
                assert (u is None) == (v is None) == (name in ("dscale", "dshift")
                                                      and not prologue), (name, case)
                assert u is None or torch.equal(u, v), (name, case)


@pytest.mark.cuda
def test_conv_bn_wrappers_raise_on_what_the_kernels_do_not_take(card):
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    x = torch.zeros(16, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        fcb.conv1x1_bn_fwd(x, torch.zeros(64, 64, device=card, dtype=torch.float16))
    x = torch.zeros(16, 60, device=card)
    with pytest.raises(ValueError, match="multiples of 8"):
        fcb.conv1x1_bn_fwd(x, torch.zeros(60, 64, device=card))
    x = torch.zeros(16, 64, device=card)
    with pytest.raises(TypeError, match="out_dtype"):
        fcb.conv1x1_bn_fwd(x, torch.zeros(64, 64, device=card), out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="single-pass budget"):
        y = torch.zeros(16, 512, device=card)
        fcb.conv1x1_bn_bwd_single(torch.zeros(16, 256, device=card), y, y,
                                  torch.zeros(256, 512, device=card))


@pytest.mark.cuda
def test_resnet_fused_steps_on_card_match_the_cpu(card, monkeypatch):
    """Two momentum steps of a tiny f32 fused ResNet (width 64, one block a
    stage: stage 0's three 1x1 convs take the single-pass backward, stage
    1's the dx + dw pair) on the card against the same steps on the CPU (the plain
    versions), after a poisoned step that skip_nonfinite turns into a
    no-op on both: losses within 1e-4, parameters and BatchNorm buffers
    within atol 2e-4, rtol 1e-4 (f32, other summation order; a ReLU input
    within rounding of 0 fell on the other side on an H100 and moved seven
    elements of one ``stage1_block0.proj_conv`` column by up to 1.52e-4).
    cuDNN is deterministic here, as in ``run()``, so the card's side
    repeats."""
    from distributed_tensorflow_tpu_torch.data.pipeline import DataConfig, SyntheticClassification
    from distributed_tensorflow_tpu_torch.models import common, resnet
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb
    from distributed_tensorflow_tpu_torch.train import (
        OptimizerConfig, StepOptions, init_train_state, make_optimizer, make_train_step)

    monkeypatch.setenv("DTF_FUSED_BWD", "pallas")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # f32 stem and 3x3 convs
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = resnet.ResNetConfig(stage_sizes=(1, 1), width=64, num_classes=10, dtype="float32",
                              stem="space_to_depth", block_impl="fused")
    params = resnet.init_params(cfg, seed=0, device="cpu")
    params["stage0_block0.bn3.weight"].fill_(0.5)  # let the branch carry a gradient at step 1
    params["stage1_block0.bn3.weight"].fill_(0.5)
    data = SyntheticClassification(DataConfig(global_batch_size=8, image_size=16, channels=3,
                                              num_classes=10))
    runs = []
    for device in (card, torch.device("cpu")):
        model = resnet.build(cfg, params, device)
        state = init_train_state(model, make_optimizer(
            OptimizerConfig(name="momentum", learning_rate=0.1, weight_decay=1e-4),
            model.parameters()))
        base = common.classification_loss_fn(model, label_smoothing=0.1)

        def loss_fn(batch, gen, base=base):
            loss, aux = base(batch, gen)
            return loss * batch["scale"], aux

        step = make_train_step(loss_fn, StepOptions(skip_nonfinite=True))
        before = {n: k.launches for n, k in fcb.KERNELS.items()}
        losses = []
        for i, scale in enumerate((float("nan"), 1.0, 1.0)):
            batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}
            state, metrics = step(state, dict(batch, scale=torch.tensor(scale, device=device)))
            losses.append(float(metrics["loss"]))
            if i == 0:
                assert state.step == 0 and all(torch.equal(b.cpu(), params[n]) for n, b in
                                               model.named_buffers())
        runs.append((losses, model, {n: k.launches - before[n]
                                     for n, k in fcb.KERNELS.items()}))
    (got, gmodel, glaunch), (want, wmodel, wlaunch) = runs
    # 3 forwards (the poisoned step runs its forward and backward too), 6 convs
    assert glaunch == {"conv_bn_fwd": 18, "conv_bn_bwd_dx": 9, "conv_bn_bwd_dw": 9,
                       "conv_bn_bwd_single": 9}
    assert not any(wlaunch.values())
    np.testing.assert_allclose(got[1:], want[1:], atol=1e-4, rtol=1e-4)
    bad = {name: float((a.cpu() - b).abs().max()) for (name, a), b in
           zip(gmodel.state_dict().items(), wmodel.state_dict().values())
           if not torch.allclose(a.cpu(), b, atol=2e-4, rtol=1e-4)}
    assert bad == {}


@pytest.mark.cuda
def test_resnet_run_on_card_is_bitwise_repeatable(card, monkeypatch):
    """Two ``run_workload("resnet50_imagenet")`` runs of a small fused
    ResNet with the backward kernels, from the same seed and data, end in
    bitwise equal parameters and BatchNorm buffers: the conv+BN kernels
    reduce without float atomics and the runner has cuDNN pick
    deterministic algorithms for the stem and 3x3 convolutions."""
    from distributed_tensorflow_tpu_torch.workloads import run_workload

    monkeypatch.setenv("DTF_FUSED_BWD", "pallas")
    overrides = ["--model.stage_sizes=[1,1]", "--model.width=64", "--model.num_classes=10",
                 "--data.image_size=64", "--data.num_classes=10", "--data.global_batch_size=32",
                 "--model.block_impl=fused", "--train.num_steps=3", "--train.log_every=1",
                 "--optimizer.warmup_steps=0", "--optimizer.schedule=constant",
                 "--optimizer.learning_rate=0.1"]
    a, b = (run_workload("resnet50_imagenet", overrides, device=card).state.model.state_dict()
            for _ in range(2))
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


# ---------------------------------------------------------------------------
# fused LayerNorm + matmul backward (rows 6-7 of the kernel table)
# ---------------------------------------------------------------------------

#: (M, d, n): ragged M, d and n against every tile — smaller than one
#: 32-row tile of the dx row pass, no multiple of the dx product's 128 x 128
#: tiles and its 64-byte depth steps, nor of dw's 64 — and gpt_small's two
#: widths
LN_BWD_CASES = {torch.float32: [(37, 64, 96), (300, 768, 3072)],
                torch.bfloat16: [(75, 200, 136), (200, 136, 200), (1000, 768, 768),
                                 (4100, 392, 520)]}


def _ln_bwd_inputs(rng, card, dtype, M, d, n, linear_layout):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(card)  # noqa: E731
    w_nd = (f(n, d) / d ** 0.5).to(dtype)  # nn.Linear weight [n, d]
    return (2 * f(M, d).to(dtype) + 0.5, 1 + 0.1 * f(d), 0.1 * f(d),
            w_nd.t() if linear_layout else w_nd.t().contiguous(), f(M, n).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ln_matmul_bwd_kernels_match_plain_on_card(card, dtype):
    """Rows 6-7 against the plain backward, both w layouts. dx: f32 same
    math in another order (1e-4); bf16 one ulp (1e-2, 2^-7). The sums over
    M (dgamma, dbeta, dbias, dw), relative L2: 1e-5 in f32; 2e-3 in bf16,
    where dw is rounded to bf16 once from sums taken in another order and
    an h on a rounding tie may fall the other way. The dw kernel reads the
    row statistics the dx kernel writes."""
    rng = np.random.default_rng(8)
    tol = TOLS[dtype] if dtype == torch.bfloat16 else (1e-4, 1e-4)
    red_tol = 2e-3 if dtype == torch.bfloat16 else 1e-5
    for M, d, n in LN_BWD_CASES[dtype]:
        for linear_layout in (True, False):
            x, g, b, w, dy = _ln_bwd_inputs(rng, card, dtype, M, d, n, linear_layout)
            case = (M, d, n, linear_layout)
            before = {k: f.launches for k, f in fln.KERNELS.items()}
            dx, dg, db, dbias, mean, rstd = fln.ln_matmul_bwd_dx(x, g, w, dy)
            dw = fln.ln_matmul_bwd_dw(x, g, b, dy, mean, rstd)
            torch.cuda.synchronize()
            after = {k: f.launches for k, f in fln.KERNELS.items()}
            assert after["ln_matmul_bwd_dx"] == before["ln_matmul_bwd_dx"] + 1
            assert after["ln_matmul_bwd_dw"] == before["ln_matmul_bwd_dw"] + 1
            want = fln.ln_matmul_bwd_plain(x, g, b, w, dy)
            torch.testing.assert_close(dx.float(), want[0].float(), atol=tol[0], rtol=tol[1],
                                       msg=lambda m: f"dx {case}: {m}")
            for name, got, ref in (("dgamma", dg, want[1]), ("dbeta", db, want[2]),
                                   ("dw", dw, want[3]), ("dbias", dbias, want[4])):
                assert got.dtype == ref.dtype and got.shape == ref.shape, (name, case)
                assert _rel_l2(got, ref) < red_tol, (name, case, _rel_l2(got, ref))
            x32 = x.float()
            torch.testing.assert_close(mean, x32.mean(-1), atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(
                rstd, torch.rsqrt(x32.var(-1, unbiased=False) + 1e-6), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_ln_matmul_bwd_kernels_are_deterministic(card):
    """Two calls of each backward kernel on the same bf16 inputs give
    bitwise-equal results: the sums over M are per-chunk partials reduced
    in a fixed order, no float atomics."""
    rng = np.random.default_rng(9)
    x, g, b, w, dy = _ln_bwd_inputs(rng, card, torch.bfloat16, 4100, 768, 3072, True)
    runs = []
    for _ in range(2):
        out = fln.ln_matmul_bwd_dx(x, g, w, dy)
        runs.append([*out, fln.ln_matmul_bwd_dw(x, g, b, dy, *out[4:])])
    for a, c in zip(*runs):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_ln_matmul_bwd_wrappers_raise_on_what_the_kernels_do_not_take(card):
    g = torch.ones(64, device=card)
    st = torch.zeros(16, device=card)
    x = torch.zeros(16, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        fln.ln_matmul_bwd_dx(x, g, torch.zeros(64, 32, device=card, dtype=torch.float16),
                             torch.zeros(16, 32, device=card, dtype=torch.float16))
    x = torch.zeros(16, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):  # dy f32 with x bf16
        fln.ln_matmul_bwd_dw(x, g, g, torch.zeros(16, 32, device=card), st, st)
    with pytest.raises(TypeError, match="w must be"):
        fln.ln_matmul_bwd_dx(x, g, torch.zeros(64, 32, device=card),
                             torch.zeros(16, 32, device=card, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiples of 8"):
        fln.ln_matmul_bwd_dw(torch.zeros(16, 60, device=card), torch.ones(60, device=card),
                             torch.ones(60, device=card), torch.zeros(16, 32, device=card),
                             st, st)
    with pytest.raises(ValueError, match="contiguous"):
        fln.ln_matmul_bwd_dw(x, g, g, torch.zeros(32, 16, device=card,
                                                 dtype=torch.bfloat16).t(), st, st)
    with pytest.raises(ValueError, match="rstd must be"):
        fln.ln_matmul_bwd_dw(x, g, g, torch.zeros(16, 32, device=card, dtype=torch.bfloat16),
                             st, st[:8])
    # d=1024, n=8192 in f32 — refused while a dx CTA held whole rows of dh in
    # shared memory — now runs and matches the plain backward (f32: 1e-4 on
    # dx, 1e-5 relative L2 on the sums over M)
    rng = np.random.default_rng(10)
    x, g, b, w, dy = _ln_bwd_inputs(rng, card, torch.float32, 16, 1024, 8192, True)
    got = fln.ln_matmul_bwd_dx(x, g, w, dy)
    want = fln.ln_matmul_bwd_plain(x, g, b, w, dy)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=1e-4)
    for i, j in ((1, 1), (2, 2), (3, 4)):
        assert _rel_l2(got[i], want[j]) < 1e-5, (i, _rel_l2(got[i], want[j]))


@pytest.mark.cuda
def test_fused_ln_training_steps_on_card_match_the_cpu(card, monkeypatch):
    """Two adamw steps of a tiny f32 ``fused_ln_matmul=True`` causal LM with
    the pallas backward on the card — the LN+matmul forward, dx and dw
    kernels at q/k/v and mlp_in of every layer, with w the transposed view
    of each Dense weight — against the same steps on the CPU (the plain
    versions), from the same weights and batches: losses and parameters
    within 1e-4 (f32, other summation order)."""
    from distributed_tensorflow_tpu_torch.data.text import SyntheticLM, TextDataConfig
    from distributed_tensorflow_tpu_torch.ops import fused_ln_matmul as fln
    from distributed_tensorflow_tpu_torch.train import (
        OptimizerConfig, init_train_state, make_optimizer, make_train_step)

    monkeypatch.setenv("DTF_FUSED_BWD", "pallas")
    cfg = tfm.TransformerConfig(vocab_size=256, max_len=96, num_layers=2, d_model=128,
                                num_heads=2, d_ff=256, dropout=0.0, dtype="float32",
                                causal=True, pre_ln=True, attention_impl="dense",
                                fused_ln_matmul=True)
    params = tfm.init_params(cfg, seed=0, device="cpu", trainable=True)
    data = SyntheticLM(TextDataConfig(dataset="synthetic_lm", global_batch_size=4,
                                      seq_len=96, vocab_size=256))
    runs = []
    for device in (card, torch.device("cpu")):
        model = tfm.build(cfg, params, device, trainable=True)
        state = init_train_state(model, make_optimizer(
            OptimizerConfig(name="adamw", learning_rate=1e-3, weight_decay=0.1),
            model.parameters()))
        step = make_train_step(tfm.causal_lm_loss(model, 32))
        before = {k: f.launches for k, f in fln.KERNELS.items()}
        losses = []
        for i in range(2):
            batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        runs.append((losses, model, {k: f.launches - before[k] for k, f in fln.KERNELS.items()}))
    (got, gmodel, glaunch), (want, wmodel, wlaunch) = runs
    # 4 projections (q, k, v, mlp_in) x 2 layers x 2 steps on the card
    assert glaunch == {k: 16 for k in fln.KERNELS} and not any(wlaunch.values())
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for (name, p), q in zip(gmodel.named_parameters(), wmodel.parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), atol=1e-4, rtol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


# ---------------------------------------------------------------------------
# the tiled LN+matmul forward at training M (row 5): statistics + product
# ---------------------------------------------------------------------------

#: (M, d, n): M at and past the tiled threshold, ragged against its 128-row
#: tiles; d ragged against 128-byte stages; n against 128-column tiles
LN_TILED_CASES = [(fln.LN_TILED_MIN_M, 200, 136), (1000, 136, 264), (8192 - 56, 768, 768)]
#: the forward's three entries: (x dtype, out dtype) -> (atol, rtol). f32 —
#: the same math in another summation order; bf16 out — both round h and y
#: to bf16 once (one ulp); bf16 -> f32 — an h on a rounding tie may fall
#: the other way (the kernel fuses its affine into one FMA), one bf16 ulp
#: of one term
LN_TILED_TOLS = {(torch.float32, torch.float32): (1e-4, 1e-4),
                 (torch.bfloat16, torch.bfloat16): TOLS[torch.bfloat16],
                 (torch.bfloat16, torch.float32): TOLS[torch.bfloat16]}


def _ln_fwd_inputs(rng, card, dtype, M, d, n):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(card)  # noqa: E731
    w_nd = (f(n, d) / d ** 0.5).to(dtype)  # nn.Linear weight [n, d]
    return 2 * f(M, d).to(dtype) + 0.5, 1 + 0.1 * f(d), 0.1 * f(d), w_nd, 0.1 * f(n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", list(LN_TILED_TOLS), ids=["f32", "bf16", "bf16_f32"])
def test_ln_matmul_tiled_forward_matches_plain_on_card(card, dtypes):
    """From ``LN_TILED_MIN_M`` rows up ``ln_matmul`` launches the statistics
    pass and the tiled product (one launch, also counted in
    ``tiled_launches``) and matches the plain version in both w layouts;
    one row fewer takes the row-tile kernel."""
    dtype, out_dtype = dtypes
    atol, rtol = LN_TILED_TOLS[dtypes]
    rng = np.random.default_rng(11)
    for M, d, n in LN_TILED_CASES:
        x, g, b, w_nd, bias = _ln_fwd_inputs(rng, card, dtype, M, d, n)
        want = ln_matmul_plain(x, g, b, w_nd.t(), bias, out_dtype=out_dtype)
        for wv in (w_nd.t(), w_nd.t().contiguous()):  # nn.Linear view and [d, n]
            before = (ln_matmul.launches, ln_matmul.tiled_launches)
            got = ln_matmul(x, g, b, wv, bias, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert (ln_matmul.launches, ln_matmul.tiled_launches) == (before[0] + 1,
                                                                      before[1] + 1)
            assert got.dtype == out_dtype and got.shape == (M, n)
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol,
                                       msg=lambda m: f"{(M, d, n, wv.stride())}: {m}")
    x, g, b, w_nd, bias = _ln_fwd_inputs(rng, card, dtype, fln.LN_TILED_MIN_M - 1, 136, 264)
    before = ln_matmul.tiled_launches
    got = ln_matmul(x, g, b, w_nd.t(), bias, out_dtype=out_dtype)
    assert ln_matmul.tiled_launches == before
    torch.testing.assert_close(got.float(), ln_matmul_plain(
        x, g, b, w_nd.t(), bias, out_dtype=out_dtype).float(), atol=max(atol, 1e-4),
        rtol=max(rtol, 1e-4))


@pytest.mark.cuda
def test_ln_matmul_tiled_forward_is_deterministic(card):
    """Two calls of the tiled forward on the same bf16 inputs are bitwise
    equal: every output sums d in one fixed order."""
    rng = np.random.default_rng(12)
    x, g, b, w_nd, bias = _ln_fwd_inputs(rng, card, torch.bfloat16, 4100, 768, 3072)
    a, c = (ln_matmul(x, g, b, w_nd.t(), bias) for _ in range(2))
    assert torch.equal(a, c)


@pytest.mark.cuda
def test_ln_matmul_tiled_forward_raises_on_what_it_does_not_take(card):
    """The tiled path takes d and n multiples of 8 and raises on anything
    else — it never hands the call to the row-tile kernel, which takes any d
    below the threshold."""
    rng = np.random.default_rng(13)
    M = fln.LN_TILED_MIN_M
    x, g, b, w_nd, bias = _ln_fwd_inputs(rng, card, torch.bfloat16, M, 100, 64)
    before = (ln_matmul.launches, ln_matmul.tiled_launches)
    with pytest.raises(ValueError, match="multiples of 8"):
        ln_matmul(x, g, b, w_nd.t(), bias)
    x2, g2, b2, w2, bias2 = _ln_fwd_inputs(rng, card, torch.bfloat16, M, 64, 60)
    with pytest.raises(ValueError, match="multiples of 8"):
        ln_matmul(x2, g2, b2, w2.t(), bias2)
    assert (ln_matmul.launches, ln_matmul.tiled_launches) == before
    got = ln_matmul(x[:M - 1], g, b, w_nd.t(), bias)  # the row-tile kernel takes d = 100
    torch.testing.assert_close(got.float(), ln_matmul_plain(x[:M - 1], g, b, w_nd.t(),
                                                            bias).float(),
                               atol=TOLS[torch.bfloat16][0], rtol=TOLS[torch.bfloat16][1])


# ---------------------------------------------------------------------------
# the launch device: every kernel family on a card that is not the current
# one
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_every_kernel_family_launches_on_its_tensors_device(card):
    """With ``cuda:0`` current, each kernel family launched on tensors that
    lie on ``cuda:1`` runs there (``_build.launch`` enters the tensors'
    device; a C entry launches on the current one): paged attention, the
    LN+matmul forward (serving and tiled) and its dx and dw kernels, the
    three flash kernels and the four conv+BN kernels, f32, each within
    relative L2 1e-5 of its plain version on that card (the same math in
    another summation order), each counted once, and ``cuda:0`` is still
    current after. Skips on a machine with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (launches on a card that is not the current one)")
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    dev, f32 = torch.device("cuda:1"), torch.float32
    rng = np.random.default_rng(15)
    checks = []
    with torch.cuda.device(0):
        counts = [paged_flash_attention.launches, ln_matmul.launches,
                  ln_matmul.tiled_launches, fa.flash_fwd.launches, fcb.conv1x1_bn_fwd.launches]
        q, k, v, table, q_pos = (torch.from_numpy(a).to(dev) for a in _paged_inputs(rng, 5))
        checks.append(("paged attention", paged_flash_attention(q, k, v, table, q_pos=q_pos),
                       paged_attention_plain(q, k, v, table, q_pos=q_pos)))
        for M in (8, fln.LN_TILED_MIN_M):
            x, g, b, w_nd, bias = _ln_fwd_inputs(rng, dev, f32, M, 768, 256)
            checks.append((f"ln_matmul M={M}", ln_matmul(x, g, b, w_nd.t(), bias),
                           ln_matmul_plain(x, g, b, w_nd.t(), bias)))
        x, g, b, w, dy = _ln_bwd_inputs(rng, dev, f32, 300, 256, 128, True)
        dx, dg, db, dbias, mean, rstd = fln.ln_matmul_bwd_dx(x, g, w, dy)
        want = fln.ln_matmul_bwd_plain(x, g, b, w, dy)
        checks += [("ln_matmul_bwd_dx", dx, want[0]),
                   ("ln_matmul_bwd_dw", fln.ln_matmul_bwd_dw(x, g, b, dy, mean, rstd), want[3])]
        q, k, v, _, dout = _flash_inputs(rng, dev, f32, 1, 2, 128, 128, 64, False)
        out, lse = fa.flash_fwd(q, k, v, None, causal=True)
        ref = fa.flash_attention_bwd_plain(q, k, v, None, out, lse, dout, causal=True)
        checks += [("flash_fwd", out, fa.flash_attention_plain(q, k, v, None, causal=True)[0]),
                   ("flash_bwd_dkv", fa.flash_bwd_dkv(q, k, v, None, out, lse, dout,
                                                      causal=True)[0], ref[1]),
                   ("flash_bwd_dq", fa.flash_bwd_dq(q, k, v, None, out, lse, dout, causal=True),
                    ref[0])]
        x, w, sc, sh, dy, dsum, dssq = _conv_bn_inputs(rng, dev, f32, 150, 64, 128, True)
        y, _, _ = fcb.conv1x1_bn_fwd(x, w, sc, sh)
        ref = fcb.conv1x1_bn_bwd_plain(x, y, dy, w, sc, sh, dsum, dssq)
        assert fcb.single_pass(64, 128)
        checks += [("conv1x1_bn_fwd", y, fcb.conv1x1_bn_act_plain(x, w, sc, sh)[0]),
                   ("conv1x1_bn_bwd_dx", fcb.conv1x1_bn_bwd_dx(x, y, dy, w, sc, sh, dsum,
                                                               dssq)[0], ref[0]),
                   ("conv1x1_bn_bwd_dw", fcb.conv1x1_bn_bwd_dw(x, y, dy, sc, sh, dsum, dssq),
                    ref[1]),
                   ("conv1x1_bn_bwd_single", fcb.conv1x1_bn_bwd_single(
                       x, y, dy, w, sc, sh, dsum, dssq)[1], ref[1])]
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0
        assert [paged_flash_attention.launches, ln_matmul.launches, ln_matmul.tiled_launches,
                fa.flash_fwd.launches, fcb.conv1x1_bn_fwd.launches] == [
                    counts[0] + 1, counts[1] + 2, counts[2] + 1, counts[3] + 1, counts[4] + 1]
    for name, got, want in checks:
        assert got.device == dev, name
        assert _rel_l2(got, want) < 1e-5, (name, _rel_l2(got, want))


@pytest.mark.cuda
def test_prefetcher_side_stream_copies_are_bitwise_the_host_batches(card):
    """50 host batches through ``Prefetcher(depth=2)`` and ``DevicePut`` (a
    ring of 2 pinned slots, each refilled 25 times): the consumer's stream
    sleeps, then snapshots each device batch and drops it, so a slot
    refilled before its copy completed, or device memory handed back to
    the side stream before the consumer read it, would show in the
    snapshots; every one equals its host batch bit for bit."""
    from distributed_tensorflow_tpu_torch.data.pipeline import DevicePut, Prefetcher

    gen = torch.Generator().manual_seed(0)
    host = [{"image": torch.randn(16, 64, 64, 3, generator=gen).to(torch.bfloat16),
             "label": torch.randint(0, 1000, (16,), generator=gen, dtype=torch.int32)}
            for _ in range(50)]
    put = DevicePut(card)
    snaps = []
    for staged in Prefetcher(host, depth=2, transform=put):
        got = staged.wait()
        torch.cuda._sleep(2_000_000)  # the consumer stream busy while copies proceed
        snaps.append({k: v.clone() for k, v in got.items()})
        del got, staged
    torch.cuda.synchronize()
    assert len(snaps) == 50 and put.stream is not None
    for want, got in zip(host, snaps):
        assert got["image"].device.type == "cuda"
        assert torch.equal(got["image"].cpu(), want["image"])
        assert torch.equal(got["label"].cpu(), want["label"])


@pytest.mark.cuda
@pytest.mark.parametrize("backend,cards,world", [("gloo", 1, 2), ("nccl", 2, 2),
                                                 ("nccl", 4, 4)])
def test_dp_resnet_steps_on_card_equal_one_process(card, tmp_path, backend, cards, world):
    """Two (or four) processes (``tests/torch_dp_worker.py``) step a small
    ResNet (one block a stage, width 16, 32x32, f32, fused with the pallas
    backward and standard) twice on their shares of two global batches of
    16: over gloo two on card 0, over NCCL one card each. Against the
    one-process steps on the global batch: the losses within 1e-4 (f32,
    summation order), the change of each parameter and running statistic
    over the two steps within 1e-1 relative L2 (worst) and 2.5e-2
    (median; ``chip_smoke.py``'s f32 step gate). In f32 a ReLU input
    within rounding of 0 may fall on the other side in one run and not in
    the other, and BatchNorm over the 8-16 rows of stage 3 amplifies it:
    on an H100 the worst tensor, ``stage1_block0.bn1.bias`` (32
    elements), read 4.87e-2 at world 2. The control: one process stepped
    on rank 0's rows alone must fall outside the same parameter limits
    (on the CPU it reads median 1.29 at world 2 and 2.58 at world 4, and
    the ranks with the BN all-reduce removed read median 0.74 and 1.38).
    Both ranks bitwise alike; every rank launched the conv+BN kernels the
    one process launched. The ranks' ``ShardedEvaluator`` (the gather of
    host partials: gloo with two ranks on one card, NCCL) is bitwise one
    process evaluating every rank's rows in rank order."""
    import os
    import sys

    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} cards")
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_dp_worker as worker

    from distributed_tensorflow_tpu_torch.models import resnet

    cfg = dict(stage_sizes=(1, 1, 1, 1), width=16, num_classes=10, dtype="float32",
               stem="space_to_depth")
    sd = resnet.init_params(resnet.ResNetConfig(**cfg), seed=0, device="cpu")
    sd = {k: (v + 0.25 if k.endswith("bn3.weight") else v).numpy() for k, v in sd.items()}
    rng = np.random.default_rng(1)
    batches = [{"image": rng.standard_normal((16, 32, 32, 3)).astype(np.float32),
                "label": rng.integers(0, 10, 16).astype(np.int32)} for _ in range(2)]
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, **{f"sd/{k}": v for k, v in sd.items()},
             **{f"{k}{i}": b[k] for i, b in enumerate(batches) for k in b})
    impls = [["fused", "pallas"], ["standard", "xla"]]
    procs = worker.launch({"job": "resnet", "device": "cuda", "out": str(tmp_path),
                           "inputs": inputs, "cfg": cfg, "impls": impls,
                           "backend": backend, "eval": True}, world=world)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    rank0 = [{k: v[:16 // world] for k, v in b.items()} for b in batches]
    try:
        one = {"/".join(e): worker.train_steps(resnet.ResNetConfig(**cfg, block_impl=e[0]),
                                               sd, batches, card, bwd=e[1]) for e in impls}
        control = {"/".join(e): worker.train_steps(resnet.ResNetConfig(**cfg, block_impl=e[0]),
                                                   sd, rank0, card, bwd=e[1]) for e in impls}
    except BaseException:
        worker.stop(procs)
        raise
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = flags
    ranks = worker.wait(procs, str(tmp_path), timeout=300)

    def update_rels(state, ref):
        """(worst, median) relative L2 of each tensor's change, and the
        five worst with their names."""
        rels = sorted(((float(np.linalg.norm(state[name] - want)
                              / max(np.linalg.norm(want - sd[name]), 1e-30)), name)
                       for name, want in ref.items()), reverse=True)
        return rels[0][0], rels[len(rels) // 2][0], rels[:5]

    for tag, ref in one.items():
        worst, median, top = update_rels(control[tag]["state"], ref["state"])
        assert worst > 1e-1 or median > 2.5e-2, ("control within the limits", tag, top, median)
        for rank in ranks:
            np.testing.assert_allclose(rank[f"{tag}/losses"], ref["losses"], rtol=1e-4,
                                       atol=1e-4)
            worst, median, top = update_rels(
                {name: rank[f"{tag}/state/{name}"] for name in ref["state"]}, ref["state"])
            assert worst <= 1e-1 and median <= 2.5e-2, (tag, top, median)
            for name, n in ref["launches"].items():
                assert int(rank[f"{tag}/launches/{name}"]) == n, (tag, name)
        for rank in ranks[1:]:
            for key in ranks[0]:
                np.testing.assert_array_equal(ranks[0][key], rank[key], err_msg=key)
    assert one["fused/pallas"]["launches"]["conv_bn_fwd"] == 2 * 12
    # the sharded evaluator on the ranks (the fused model from the initial
    # weights, the two global batches) is bitwise one process evaluating
    # every rank's rows in rank order
    for rank in ranks:
        keys = [k[len("eval/serial/"):] for k in rank if k.startswith("eval/serial/")]
        assert sorted(keys) == ["correct", "count", "loss_sum", "top5_correct"]
        for k in keys:
            assert rank[f"eval/sharded/{k}"].tobytes() == rank[f"eval/serial/{k}"].tobytes(), k
        assert float(rank["eval/sharded/count"]) == 2 * 16
