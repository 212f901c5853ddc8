"""The port's fused 1x1-conv + BatchNorm op against the JAX package's.

``ops.fused_conv_bn.conv1x1_bn_act`` on CPU tensors (the plain versions
of the four kernels) against the JAX op with its Pallas kernels in
interpret mode: the forward (y and the column statistics) and the VJP
under both backward impls (``"xla"``, and ``"pallas"``, which on the CPU
runs the kernels' plain versions through the single-pass / two-pass
dispatch), for every prologue / ReLU / statistics variant, at an M that
is no multiple of any tile and at one where JAX picks its single-pass
kernel. Tolerance, f32: 1e-5 absolute + relative on y and the gradients
(the same f32 products summed in another order over at most 128 rows or
24 channels), 1e-4 relative on the statistics (sums of squares of up to
128 rows). Also: the port's single-pass rule at ResNet-50's shapes, the
backward-impl policy, and the [C]-sized BatchNorm helpers.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import _policy
from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as tfcb

jfcb = importlib.import_module("distributed_tensorflow_tpu.ops.fused_conv_bn")

#: (prologue, relu, emit_stats)
VARIANTS = [(False, False, True), (False, False, False), (True, True, True),
            (True, False, True), (True, True, False), (True, False, False)]


def _ids(v):
    prologue, relu, stats = v
    return (("relu" if relu else "affine") if prologue else "plain") + ("+stats" if stats else "")


@functools.lru_cache(maxsize=None)
def _jax_op(prologue, relu, stats, impl):
    """jit of (forward, VJP) of the JAX op for one variant and impl."""

    def f(x, w, scale, shift, dy, dsum, dssq):
        def op(x, w, scale, shift):
            return jfcb.conv1x1_bn_act(
                x, w, scale if prologue else None, shift if prologue else None, relu=relu,
                emit_stats=stats, interpret=True, bwd_impl=impl)

        out, vjp = jax.vjp(op, x, w, scale, shift)
        return out, vjp((dy, dsum, dssq) if stats else dy)

    return jax.jit(f)


def _inputs(M, cin, cout, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(M, cin), w=f(cin, cout) / cin ** 0.5, scale=1 + 0.2 * f(cin),
                shift=0.2 * f(cin), dy=f(M, cout), dsum=0.1 * f(cout), dssq=0.01 * f(cout))


def _check(prologue, relu, stats, impl, M, cin, cout, seed):
    a = _inputs(M, cin, cout, seed)
    out, (jdx, jdw, jdsc, jdsh) = _jax_op(prologue, relu, stats, impl)(
        *(jnp.asarray(a[k]) for k in ("x", "w", "scale", "shift", "dy", "dsum", "dssq")))
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in ("x", "w", "scale", "shift")]
    x, w, sc, sh = leaves
    got = tfcb.conv1x1_bn_act(x, w, sc if prologue else None, sh if prologue else None,
                              relu=relu, emit_stats=stats, bwd_impl=impl)
    if stats:
        torch.autograd.backward(got, [torch.from_numpy(a[k]) for k in ("dy", "dsum", "dssq")])
        y, want_y = got[0], out[0]
        for g, wnt in zip(got[1:], out[1:]):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(wnt), rtol=1e-4, atol=1e-4)
    else:
        got.backward(torch.from_numpy(a["dy"]))
        y, want_y = got, out
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-5)
    if prologue:
        np.testing.assert_allclose(sc.grad.numpy(), np.asarray(jdsc), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sh.grad.numpy(), np.asarray(jdsh), rtol=1e-5, atol=1e-5)
    else:
        assert sc.grad is None and sh.grad is None


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_op_forward_and_vjp_match_jax_at_a_ragged_m(variant, impl):
    """M=37: no 8-row tile divides it (the port's kernels mask the edge;
    JAX takes one whole-M block and its two-pass backward)."""
    _check(*variant, impl, 37, 16, 24, seed=0)


@pytest.mark.parametrize("variant", VARIANTS[:3], ids=_ids)
def test_op_vjp_matches_jax_single_pass(variant):
    """M=128 with a prologue or without: JAX's pallas backward takes its
    single-pass kernel, the port's (64x64 channels) its single-pass
    version."""
    assert tfcb.single_pass(64, 64)
    _check(*variant, "pallas", 128, 64, 64, seed=1)


def test_single_pass_rule_at_resnet50_shapes():
    """Every 1x1 conv of ResNet-50 (conv1, conv3, the projections): the
    seven of stage 0 are single-pass, the 29 others two-pass."""
    convs, cin = [], 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** stage
        for block in range(blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            convs += [(cin, f), (f, 4 * f)]
            if cin != 4 * f or stride != 1:
                convs.append((cin, 4 * f))
            cin = 4 * f
    single = [c for c in convs if tfcb.single_pass(*c)]
    assert len(convs) == 36 and len(single) == 7
    assert set(single) == {(64, 64), (64, 256), (256, 64)}


#: the dx kernel's tile and residency (``conv_bn_dx_tile`` on the card)
DX_TILE = (128, 128, 1)


@pytest.mark.parametrize("M, cin, sms, want", [
    (200704, 128, 132, 132),  # conv3 of stage 1: one cin tile, one chunk an SM
    (12544, 2048, 132, 8),    # a stage-3 conv1: 16 cin tiles, 128 CTAs
    (12544, 512, 132, 33),    # stage-3 conv3: 4 cin tiles, 132 CTAs
    (300, 200, 132, 3),       # fewer M tiles than the wave holds: one chunk a tile
    (1000, 17000, 132, 1),    # more cin tiles than a wave: one chunk
    (200704, 512, 114, 28),   # a card of 114 SMs: 4 cin tiles, 112 CTAs
])
def test_dx_chunks_fill_one_wave_from_the_shapes(M, cin, sms, want):
    """The dx grid (cin tiles, G) fills at most one wave of the card's
    CTA slots with at most one chunk an M tile, and G depends on the
    shapes and the card alone."""
    bm, bn, per_sm = DX_TILE
    G = tfcb.dx_chunks(M, cin, sms, DX_TILE)
    assert G == want == tfcb.dx_chunks(M, cin, sms, DX_TILE)
    assert 1 <= G <= -(-M // bm)
    assert G == 1 or G * -(-cin // bn) <= per_sm * sms


def test_bwd_impl_policy(monkeypatch):
    monkeypatch.delenv("DTF_FUSED_BWD", raising=False)
    assert _policy.resolve_bwd_impl() == "xla"
    monkeypatch.setenv("DTF_FUSED_BWD", "pallas")
    assert _policy.resolve_bwd_impl() == "pallas"
    assert _policy.resolve_bwd_impl("xla") == "xla"  # the argument wins
    monkeypatch.setenv("DTF_FUSED_BWD", "triton")
    with pytest.raises(ValueError, match="bwd_impl"):
        _policy.resolve_bwd_impl()


def test_bn_helpers_match_jax():
    rng = np.random.default_rng(2)
    s, q = rng.standard_normal(8).astype(np.float32), rng.random(8).astype(np.float32) * 50
    g, b = rng.standard_normal(8).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    jm, jv = jfcb.moments_from_sums(jnp.asarray(s), jnp.asarray(q), 20.0)
    tm, tv = tfcb.moments_from_sums(torch.from_numpy(s), torch.from_numpy(q), 20)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    jsc, jsh = jfcb.bn_scale_shift(jm, jv, jnp.asarray(g), jnp.asarray(b), 1e-5)
    tsc, tsh = tfcb.bn_scale_shift(tm, tv, torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5)
    np.testing.assert_allclose(tsh.numpy(), np.asarray(jsh), rtol=1e-5, atol=1e-6)


def test_cpu_path_launches_no_kernel():
    a = _inputs(20, 8, 16, seed=3)
    before = {n: k.launches for n, k in tfcb.KERNELS.items()}
    x = torch.from_numpy(a["x"]).requires_grad_()
    y, s, q = tfcb.conv1x1_bn_act(x, torch.from_numpy(a["w"]), torch.from_numpy(a["scale"]),
                                  torch.from_numpy(a["shift"]), bwd_impl="pallas")
    (y.sum() + s.sum() + q.sum()).backward()
    assert {n: k.launches for n, k in tfcb.KERNELS.items()} == before
