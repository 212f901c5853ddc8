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


#: (B, H, Sq, Sk, D, causal, masked): square, ragged (no 64-multiple),
#: Sq < Sk (causal q_offset > 0), Sq > Sk (causal rows that attend
#: nothing), and the 128 head dim
FLASH_CASES = [
    (2, 3, 128, 128, 64, True, False),
    (2, 3, 128, 128, 64, False, True),
    (1, 2, 100, 100, 64, True, True),
    (1, 2, 37, 130, 64, True, False),
    (2, 2, 200, 70, 64, True, True),
    (1, 2, 96, 96, 128, True, True),
]


def _flash_inputs(rng, card, dtype, B, H, Sq, Sk, D, masked):
    """q/k/v as the model makes them — [B,S,H,D] viewed as [B,H,S,D] — and
    a kv_mask whose last batch row attends nothing."""
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(card)  # noqa: E731
    q, k, v, dout = (t.to(dtype).transpose(1, 2) for t in
                     (f(B, Sq, H, D), f(B, Sk, H, D), f(B, Sk, H, D), f(B, Sq, H, D)))
    mask = None
    if masked:
        mask = torch.from_numpy(rng.random((B, Sk)) > 0.25).to(card)
        mask[-1] = False
    return q, k, v, mask, dout


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
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            torch.testing.assert_close(got.float(), w.float(), atol=atol, rtol=rtol,
                                       msg=lambda m: f"{name} {case}: {m}")
        if masked:  # the last batch row attends nothing: 0 out, NEG_INF, 0 grads
            assert not out[-1].float().abs().sum() and not dq[-1].float().abs().sum()
            assert not dk[-1].float().abs().sum() and not dv[-1].float().abs().sum()
            assert (lse[-1] == fa.NEG_INF).all()


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
