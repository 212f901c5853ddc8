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


#: the single-pass kernel's tile and residency (``conv_bn_single_tile``)
SINGLE_TILE = (64, 1)


@pytest.mark.parametrize("M, sms, want", [
    (802816, 132, 132),   # ResNet-50's stage 0 at batch 256 (64->64, 64->256, 256->64)
    (200704, 132, 132),   # the same convs at batch 64
    (132 * 64 + 1, 132, 132),  # one row past a whole wave: its tile goes to CTA 0
    (1000, 132, 16),      # fewer M tiles than the wave holds (the last ragged)
    (1, 132, 1),          # one row
    (802816, 114, 114),   # a card of 114 SMs
    # the card tests' multi-tile shapes: each CTA walks 4-6 tiles, past the depth
    # of its ring (2 stages at 64->256, 3 at 256->64, 4 at 64->64 in bf16)
    (3 * 132 * 64 + 37, 132, 132),
    (4 * 132 * 64 + 37, 132, 132),
    (5 * 132 * 64 + 37, 132, 132),
])
def test_single_chunks_fill_one_wave_from_the_shapes(M, sms, want):
    """The single-pass grid is one persistent CTA a slot of one wave, at
    most one an M tile; G depends on M and the card alone, not on the
    channels."""
    bm, per_sm = SINGLE_TILE
    G = tfcb.single_chunks(M, sms, SINGLE_TILE)
    assert G == want == tfcb.single_chunks(M, sms, SINGLE_TILE)
    assert 1 <= G <= -(-M // bm) and G <= per_sm * sms


#: the forward kernel's tile and residency (``conv_bn_fwd_tile``): rows of M
#: a tile, CTAs an SM
FWD_TILE = (128, 1)


@pytest.mark.parametrize("M, cin, cout, sms, want", [
    # stage 0 at batch 256: one cout tile, so one chunk an SM
    (802816, 64, 64, 132, ((128, 64), 132)),
    (802816, 64, 256, 132, ((128, 256), 132)),    # conv3 (the main shape) and projection
    (802816, 256, 64, 132, ((128, 64), 132)),
    # the twelve shapes of the two-pass convs (CONV_BN_DW_SWEEP)
    (802816, 256, 128, 132, ((128, 128), 132)),
    (200704, 256, 512, 132, ((128, 256), 66)),    # two cout tiles
    (200704, 128, 512, 132, ((128, 256), 66)),
    (200704, 512, 128, 132, ((128, 128), 132)),
    (200704, 512, 256, 132, ((128, 256), 132)),
    (50176, 512, 1024, 132, ((128, 256), 33)),    # four cout tiles
    (50176, 256, 1024, 132, ((128, 256), 33)),
    (50176, 1024, 256, 132, ((128, 256), 132)),
    (50176, 1024, 512, 132, ((128, 256), 66)),
    (12544, 1024, 2048, 132, ((128, 256), 16)),   # eight cout tiles, 98 M tiles
    (12544, 512, 2048, 132, ((128, 256), 16)),
    (12544, 2048, 512, 132, ((128, 256), 66)),
    # widths away from the step's shapes
    (100, 72, 40, 132, ((128, 64), 1)),           # cout 40: the 64 width, one M tile
    (333, 200, 136, 132, ((128, 64), 3)),         # cout 136: 64 pads 56, 128 and 256 pad 120
    (12544, 384, 384, 132, ((128, 128), 44)),     # cout 384: 64 and 128 tie, the wider wins
    (1, 64, 256, 132, ((128, 256), 1)),           # one row
    (802816, 64, 256, 1, ((128, 256), 1)),        # a card of one SM
    (200704, 128, 512, 1, ((128, 256), 1)),       # fewer slots than cout tiles: one chunk
    (200704, 128, 512, 114, ((128, 256), 57)),    # a card of 114 SMs
])
def test_fwd_plan_fills_one_wave_from_the_shapes(M, cin, cout, sms, want):
    """The forward grid (cout tiles, G) takes the tile width that pads cout
    least (the wider on a tie) and fills at most one wave of the card's CTA
    slots beside the cout tiles, with at least one chunk and at most one an
    M tile; the plan depends on the shapes and the card alone."""
    rows_m, per_sm = FWD_TILE
    plan = tfcb.fwd_plan(M, cin, cout, sms, FWD_TILE)
    assert (plan["tile"], plan["G"]) == want
    assert plan == tfcb.fwd_plan(M, cin, cout, sms, FWD_TILE)
    G, bn = plan["G"], plan["tile"][1]
    tiles = -(-cout // bn)
    assert 1 <= G <= -(-M // rows_m)
    assert G == 1 or G * tiles <= per_sm * sms
    assert bn in tfcb.FWD_WIDTHS and -(-cout // bn) * bn == min(
        -(-cout // w) * w for w in tfcb.FWD_WIDTHS)


#: the dw kernel's tile and residency (``conv_bn_dw_tile``): rows of cin a
#: tile, rows of M a block, CTAs an SM
DW_TILE = (128, 64, 1)


@pytest.mark.parametrize("M, cin, cout, sms, want", [
    (200704, 128, 512, 132, ((128, 256), 66)),   # stage 1's conv3 (the main shape): 2 tiles
    (802816, 256, 128, 132, ((128, 128), 66)),   # stage 0's conv1 of block 2: cout 128
    (12544, 2048, 512, 132, ((128, 256), 4)),    # stage 3's conv1: 32 tiles, few chunks
    (12544, 1024, 2048, 132, ((128, 256), 2)),   # stage 3's projection: 64 tiles
    (300, 8, 16, 132, ((128, 128), 5)),          # fewer blocks than a wave: one a chunk
    (1000, 128, 512, 132, ((128, 256), 4)),      # a small M: the partials' cap
    (1, 128, 512, 132, ((128, 256), 1)),         # one row
    (200704, 128, 512, 114, ((128, 256), 57)),   # a card of 114 SMs
    (3109, 512, 1024, 132, ((128, 256), 3)),     # the card test's: chunks of 16-17 blocks
    (12544, 384, 384, 132, ((128, 128), 14)),    # cout 384: the 128 width pads nothing
    (5000, 4096, 4096, 132, ((128, 256), 1)),    # more tiles than a wave: one chunk
])
def test_dw_plan_fills_one_wave_from_the_shapes(M, cin, cout, sms, want):
    """The dw grid (tiles, G) takes the tile width that pads cout least and
    fills at most one wave of the card's CTA slots, with at least one
    chunk, at most one a 64-row block, and f32 partials (written and read
    back) within the bf16 bytes the product reads; the plan depends on the
    shapes and the card alone."""
    rows_cin, rows_m, per_sm = DW_TILE
    plan = tfcb.dw_plan(M, cin, cout, sms, DW_TILE)
    assert (plan["tile"], plan["G"]) == want
    assert plan == tfcb.dw_plan(M, cin, cout, sms, DW_TILE)
    G, bn = plan["G"], plan["tile"][1]
    tiles = -(-cin // rows_cin) * -(-cout // bn)
    assert 1 <= G <= -(-M // rows_m)
    assert G == 1 or (G * tiles <= per_sm * sms
                      and 8 * G * cin * cout <= 2 * M * (cin + 2 * cout))
    assert bn in tfcb.DW_WIDTHS and -(-cout // bn) * bn == min(
        -(-cout // w) * w for w in tfcb.DW_WIDTHS)


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
