"""The port's flash attention (``distributed_tensorflow_tpu_torch/ops/
flash_attention.py``) against the JAX package's ``flash_attention`` run as
its own tests run it off the TPU: the Pallas kernels in interpret mode.
On the CPU the port's wrappers compute their plain versions, so these
tests hold the arithmetic of the three CUDA kernels (forward, dK/dV, dQ)
against the reference; ``test_torch_kernels_cuda.py`` holds the kernels
against the plain versions on the card.

Inputs come from numpy with a seed and go to both sides. Tolerances (f32
throughout): forward 2e-5, as the JAX package's own flash test states;
gradients 1e-4 (three products of 128-term f32 sums, other order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules, by path: both ops packages re-export a function of the
# same name as the module
jfa = importlib.import_module("distributed_tensorflow_tpu.ops.flash_attention")
tatt = importlib.import_module("distributed_tensorflow_tpu_torch.ops.attention")
tfa = importlib.import_module("distributed_tensorflow_tpu_torch.ops.flash_attention")

B, H, S, D = 2, 2, 128, 32
BLOCK = 64


def _inputs(seed, S_q=S, S_k=S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S_q, D), dtype=np.float32)
    k = rng.standard_normal((B, H, S_k, D), dtype=np.float32)
    v = rng.standard_normal((B, H, S_k, D), dtype=np.float32)
    mask = rng.random((B, S_k)) > 0.3
    mask[:, 0] = True
    return q, k, v, mask


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "kvmask"])
def test_plain_forward_and_lse_match_jax(causal, masked):
    q, k, v, mask = _inputs(0)
    mask = mask if masked else None
    out, lse = tfa.flash_attention_plain(*_t(q, k, v, mask), causal=causal)
    # the forward flash_attention runs: out, and the LSE it stores in lane 0
    # of its [B,H,S,8] stat
    want, jlse = jfa._fwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        (jnp.ones((B, 1, S), jnp.int32) if mask is None
         else jnp.asarray(mask).astype(jnp.int32)[:, None, :]),
        sm_scale=D ** -0.5, causal=causal, q_offset=0, block_q=BLOCK, block_k=BLOCK,
        interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_backward_matches_jax_grad(causal):
    """dq/dk/dv of loss (out*out).sum(): ``flash_attention_bwd_plain`` on
    the plain forward's out/LSE against jax.grad through the Pallas
    custom VJP (its dK/dV and dQ kernels)."""
    q, k, v, mask = _inputs(1)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, kv_mask=jnp.asarray(mask),
                                block_q=BLOCK, block_k=BLOCK, interpret=True)
        return (o * o).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tm = _t(q, k, v, mask)
    out, lse = tfa.flash_attention_plain(tq, tk, tv, tm, causal=causal)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, tm, out, lse, 2 * out, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_ragged_length_matches_jax_padded_path():
    """S=100 needs no padding in the port (the kernel masks the ragged
    edge); the JAX model pads to the block and masks the padded keys.
    Both give the same rows and the same gradients."""
    Sr, pad = 100, 28
    q, k, v, _ = _inputs(2, Sr, Sr)

    def jax_loss(q, k, v):
        padded = [jnp.pad(t, ((0, 0), (0, 0), (0, pad), (0, 0))) for t in (q, k, v)]
        pmask = jnp.pad(jnp.ones((B, Sr), bool), ((0, 0), (0, pad)))
        o = jfa.flash_attention(*padded, causal=True, kv_mask=pmask, interpret=True)[:, :, :Sr]
        return (o * o).sum(), o

    (_, want_out), want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out = tfa.flash_attention(*leaves, causal=True)
    (out * out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=2e-5, rtol=2e-5)
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_fully_masked_rows_give_zero_output_and_zero_grads():
    """A batch row whose kv_mask is all False, and causal query rows that
    precede every key (Sq > Sk): output 0, LSE NEG_INF, gradients 0 —
    the kernel's semantics, not the dense reference's uniform softmax."""
    q, k, v, mask = _inputs(3, S_q=96, S_k=64)
    mask[1] = False
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    tm = torch.from_numpy(mask)
    out, lse = tfa.flash_attention_plain(*leaves, tm, causal=True)
    assert not out[1].abs().sum() and (lse[1] == tatt.NEG_INF).all()
    assert not out[0, :, :32].abs().sum()  # rows 0..31 come before key 0 (q_offset -32)
    (out * out).sum().backward()
    assert not leaves[0].grad[1].abs().sum()
    assert not leaves[1].grad[1].abs().sum() and not leaves[2].grad[1].abs().sum()
    assert not leaves[0].grad[0, :, :32].abs().sum()
    # the dense reference spreads such a row uniformly instead (the JAX contract)
    dense = tatt.attention_reference(*[t.detach() for t in leaves], causal=True, kv_mask=tm)
    np.testing.assert_allclose(dense[1].numpy(), leaves[2].detach()[1].mean(1, keepdim=True)
                               .expand(-1, 96, -1).numpy(), atol=1e-5)


def test_autograd_function_on_cpu_gives_the_plain_grads():
    """``flash_attention`` (the autograd.Function) on CPU tensors: the
    plain forward, and in the backward the plain backward on the saved
    out/LSE — equal to calling the plain functions by hand. No kernel
    launch is counted on the CPU."""
    q, k, v, mask = _inputs(4)
    rng = np.random.default_rng(5)
    dout = torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    tm = torch.from_numpy(mask)
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dkv.launches, tfa.flash_bwd_dq.launches)
    out = tfa.flash_attention(*leaves, causal=True, kv_mask=tm)
    out.backward(dout)
    plain_out, lse = tfa.flash_attention_plain(*_t(q, k, v), tm, causal=True)
    want = tfa.flash_attention_bwd_plain(*_t(q, k, v), tm, plain_out, lse, dout, causal=True)
    assert torch.equal(out.detach(), plain_out)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dkv.launches,
            tfa.flash_bwd_dq.launches) == before
    # the wrappers alone compute the same plain parts on the CPU
    dk, dv = tfa.flash_bwd_dkv(*_t(q, k, v), tm, plain_out, lse, dout, causal=True)
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])
    assert torch.equal(tfa.flash_bwd_dq(*_t(q, k, v), tm, plain_out, lse, dout, causal=True),
                       want[0])


def test_attention_dispatch_matches_jax_reference():
    """``ops.attention.attention``: "dense" is the JAX
    ``attention_reference``; "auto" is dense on the CPU; "flash" the
    plain flash math; "blockwise" the online softmax over key blocks; an
    unknown impl is refused."""
    jref = importlib.import_module("distributed_tensorflow_tpu.ops.attention").attention_reference

    q, k, v, mask = _inputs(6)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                           kv_mask=jnp.asarray(mask)))
    args = _t(q, k, v)
    tm = torch.from_numpy(mask)
    for impl in ("dense", "auto", "flash", "blockwise"):
        got = tatt.attention(*args, causal=True, kv_mask=tm, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5, err_msg=impl)
    with pytest.raises(ValueError, match="blockwise"):
        tatt.attention(*args, impl="ring")


def test_backward_wrappers_pass_out_through_its_strides():
    """``_bwd_args``, the backward kernels' arguments: q, k, v, out and
    dout each as (pointer, stride_b, stride_h, stride_s), so the model's
    ``[B,S,H,D] -> [B,H,S,D]`` view of out goes uncopied; an out whose rows
    are not 16-byte aligned is refused (the dK/dV kernel stages it with
    16-byte copies), as q, k, v and dout are."""
    rng = np.random.default_rng(6)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
    q, k, v, out, dout = (f(2, 40, 3, 64).transpose(1, 2) for _ in range(5))
    lse = torch.zeros(2, 3, 40)
    args, _alive = tfa._bwd_args(q, k, v, None, out, lse, dout)
    for i, t in enumerate((q, k, v, out, dout)):
        assert args[4 * i:4 * i + 4] == [t.data_ptr(), *t.stride()[:3]]
    assert args[20:] == [None, lse.data_ptr()]
    buf = torch.zeros(2 * 3 * 40 * 64 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="out: the flash kernels load rows 16 bytes"):
        tfa._bwd_args(q, k, v, None, buf[1:].view(2, 3, 40, 64), lse, dout)


def test_kernels_take_head_dims_32_64_128_and_name_queue_c_for_others():
    """The kernels are instantiated at ``HEAD_DIMS`` (32 — the MLM/LM
    demos' d_model 128 over 4 heads — 64, 128 and 256, Gemma's), in bf16
    and in f32 (the f32 check kernels at 256 on 32-row tiles), and the
    wrappers' argument check lets only those through.
    ``flash_attention`` takes any head dim up to 256: 8 and 16 (the JAX
    package's tools' shapes) are zero-padded to 32, 48 to 64, 192 to 256;
    above 256 it refuses, naming ROADMAP Queue C, rather than falling back
    to dense."""
    assert tfa.HEAD_DIMS == (32, 64, 128, 256)
    assert tfa.F32_HEAD_DIMS == tfa.HEAD_DIMS
    for d in tfa.HEAD_DIMS:
        for dt in (torch.bfloat16, torch.float32):
            q = torch.zeros(1, 2, 8, d, dtype=dt)
            assert tfa._check(q, q, q, None) is None
        assert tfa.padded_head_dim(d) == d
    assert [tfa.padded_head_dim(d) for d in (8, 16, 24, 48, 100, 129, 192, 255)] == [
        32, 32, 32, 64, 128, 256, 256, 256]
    for d in (8, 16):
        q = torch.zeros(1, 2, 8, d)
        with pytest.raises(ValueError, match=f"head_dim {d}.*zero-pads"):
            tfa._check(q, q, q, None)
        assert tfa.flash_attention(q, q, q).shape == (1, 2, 8, d)
    q = torch.zeros(1, 2, 8, 257)
    with pytest.raises(ValueError, match="head_dim 257.*ROADMAP Queue C"):
        tfa._check(q, q, q, None)
    q = torch.zeros(1, 2, 8, 256)
    assert tfa.flash_attention(q, q, q).shape == (1, 2, 8, 256)  # the CPU's plain path
    for d in (257, 320):
        q = torch.zeros(1, 2, 8, d)
        with pytest.raises(ValueError, match=f"head_dim {d}.*ROADMAP Queue C.*no public"):
            tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("d", [8, 16, 192, 256])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_padded_head_dims_match_jax_flash(d, causal):
    """Head dims 8 and 16 through ``flash_attention`` (zero-padded to 32,
    192 to 256, 256 as it is; the softmax scale of the original D, the
    output sliced back) against
    JAX's flash in interpret mode at that D: the output and the gradients
    of (out*out).sum() with a kv_mask, f32 (forward 2e-5, gradients 1e-4,
    the tolerances above). The launches would be counted at D=32 for a
    caller asking D=d (none on the CPU)."""
    rng = np.random.default_rng(10 + d)
    q, k, v = (rng.standard_normal((B, H, 64, d), dtype=np.float32) for _ in range(3))
    mask = rng.random((B, 64)) > 0.3
    mask[:, 0] = True

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, kv_mask=jnp.asarray(mask),
                                block_q=BLOCK, block_k=BLOCK, interpret=True)
        return (o * o).sum(), o

    (_, want_out), want = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, kv_mask=torch.from_numpy(mask))
    assert out.shape == (B, H, 64, d)
    (out * out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=2e-5, rtol=2e-5)
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        assert t.grad.shape == (B, H, 64, d)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
