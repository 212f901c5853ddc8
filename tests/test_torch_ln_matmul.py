"""The port's fused LayerNorm + matmul (ops/fused_ln_matmul.py) against
the JAX package's: the Pallas forward kernel (interpret mode here) and
``ln_matmul_reference``, on the same numpy inputs; and the backward —
``ln_matmul_bwd_plain``, ``xla_bwd``, the kernel wrappers' CPU versions
and the ``LnMatmul`` autograd path — against ``jax.vjp`` of the JAX op
under both ``bwd_impl`` (the Pallas dx and dw kernels in interpret mode,
or its ``_xla_bwd``), for all five cotangents.

Tolerances: f32 1e-5 (same math, other summation order). bf16: both
sides round the normalised rows and the output to bf16, so a row value
sitting on a rounding boundary may come out one bf16 ulp apart, before
and after the product — atol = rtol = 2^-7 (two ulps at |y| ~ 1). The
backward's bf16 outputs (dx, dw) are rounded once from f32 sums taken in
another order, so the same 2^-7 holds them; the f32 sums (dgamma, dbeta,
dbias) of the same exact products sit well inside it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops.fused_ln_matmul import (
    ln_matmul as jax_ln_matmul,
    ln_matmul_reference,
)
from distributed_tensorflow_tpu_torch.ops import fused_ln_matmul as fln
from distributed_tensorflow_tpu_torch.ops.fused_ln_matmul import (
    ln_matmul,
    ln_matmul_plain,
)

D_IN = 64
TOLS = {"float32": 1e-5, "bfloat16": 2 ** -7}


def _inputs(M: int, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((M, D_IN), dtype=np.float32) * 2 + 0.5,
        gamma=1 + 0.1 * rng.standard_normal(D_IN, dtype=np.float32),
        beta=0.1 * rng.standard_normal(D_IN, dtype=np.float32),
        w=rng.standard_normal((D_IN, n), dtype=np.float32) / np.sqrt(D_IN),
        bias=0.1 * rng.standard_normal(n, dtype=np.float32),
    )


def _jax_args(inp, dtype):
    jd = jnp.dtype(dtype)
    return (jnp.asarray(inp["x"]).astype(jd), jnp.asarray(inp["gamma"]),
            jnp.asarray(inp["beta"]), jnp.asarray(inp["w"]).astype(jd),
            jnp.asarray(inp["bias"]))


def _torch_args(inp, dtype):
    td = getattr(torch, dtype)
    return (torch.from_numpy(inp["x"]).to(td), torch.from_numpy(inp["gamma"]),
            torch.from_numpy(inp["beta"]), torch.from_numpy(inp["w"]).to(td),
            torch.from_numpy(inp["bias"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,n", [(8, 96), (40, 128), (64, 32), (200, 96)])
def test_ln_matmul_plain_matches_jax(dtype, M, n):
    inp = _inputs(M, n)
    jargs = _jax_args(inp, dtype)
    want_kernel = np.asarray(jax_ln_matmul(*jargs, interpret=True).astype(jnp.float32))
    want_ref = np.asarray(ln_matmul_reference(*jargs).astype(jnp.float32))
    got = ln_matmul_plain(*_torch_args(inp, dtype)).float().numpy()
    tol = TOLS[dtype]
    np.testing.assert_allclose(got, want_kernel, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_ref, atol=tol, rtol=tol)


def test_ln_matmul_wrapper_on_cpu_takes_both_w_layouts_and_out_dtype():
    """On CPU tensors the wrapper computes the plain version; w may be
    the contiguous [d, n] array or the transposed view of an nn.Linear
    weight [n, d] (what the model passes); bias None means zeros."""
    inp = _inputs(40, 128)
    x, g, b, w, bias = _torch_args(inp, "bfloat16")
    want = ln_matmul_plain(x, g, b, w, bias, out_dtype=torch.float32)
    for wv in (w, w.t().contiguous().t()):
        got = ln_matmul(x, g, b, wv, bias, out_dtype=torch.float32)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    no_bias = ln_matmul(x, g, b, w)
    torch.testing.assert_close(no_bias, ln_matmul_plain(x, g, b, w, torch.zeros(128)),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ln_matmul(x.to("meta"), g, b, w)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

#: M = 40 is no multiple of 16 (the Pallas kernels' rows and the port's
#: 32-row dx tiles both end ragged)
BWD_M, BWD_N = 40, 96
GRADS = ("dx", "dgamma", "dbeta", "dw", "dbias")


def _dy(dtype, M=BWD_M):
    rng = np.random.default_rng(7)
    return rng.standard_normal((M, BWD_N), dtype=np.float32).astype(jnp.dtype(dtype))


@functools.lru_cache(maxsize=None)
def _jax_grads(dtype, bwd_impl, M=BWD_M):
    """The five cotangents of the JAX op (``jax.vjp`` under ``jax.jit``)
    for the shared inputs and a fixed output gradient, as f32 numpy."""
    jargs = _jax_args(_inputs(M, BWD_N, seed=3), dtype)
    f = jax.jit(lambda dy, *a: jax.vjp(functools.partial(
        jax_ln_matmul, interpret=True, bwd_impl=bwd_impl), *a)[1](dy))
    return tuple(np.asarray(g.astype(jnp.float32))
                 for g in f(jnp.asarray(_dy(dtype, M)), *jargs))


def _assert_grads(got, want, dtype, what):
    tol = TOLS[dtype]
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(g.detach().float().reshape(w.shape).numpy(), w, atol=tol,
                                   rtol=tol, err_msg=f"{what}: {name}")


def _check_bwd_plain_and_xla(dtype, bwd_impl, M):
    want = _jax_grads(dtype, bwd_impl, M)
    x, g, b, w, _ = _torch_args(_inputs(M, BWD_N, seed=3), dtype)
    dy = torch.from_numpy(_dy("float32", M)).to(x.dtype)
    for fn in (fln.ln_matmul_bwd_plain, fln.xla_bwd):
        got = fn(x, g, b, w, dy)
        assert [t.dtype for t in got] == [x.dtype, torch.float32, torch.float32, w.dtype,
                                          torch.float32]
        _assert_grads(got, want, dtype, f"{fn.__name__} M={M}")


@pytest.mark.parametrize("bwd_impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_matmul_bwd_plain_and_xla_bwd_match_jax(dtype, bwd_impl):
    """``ln_matmul_bwd_plain`` and ``xla_bwd`` against the JAX op's
    backward under ``bwd_impl``: dx in x's dtype, dw in w's, the rest f32."""
    _check_bwd_plain_and_xla(dtype, bwd_impl, BWD_M)


@pytest.mark.parametrize("bwd_impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_matmul_bwd_plain_and_xla_bwd_match_jax_at_ragged_tile_rows(dtype, bwd_impl):
    """The same at M = 200, ragged against the 128-row tiles of the tiled
    forward and the 64-row stages that dw deals to its chunks."""
    assert 200 % fln.TILE_ROWS and 200 % fln.DW_STAGE_ROWS
    _check_bwd_plain_and_xla(dtype, bwd_impl, 200)


@pytest.mark.parametrize("bwd_impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_matmul_autograd_matches_jax_in_both_w_layouts(dtype, bwd_impl):
    """``ln_matmul`` under autograd (``LnMatmul``): the gradients of x,
    gamma, beta, w and bias against the JAX op's, with w contiguous
    [d, n] and as the transposed view of an nn.Linear weight [n, d] (the
    gradient comes back in the view's shape). On the CPU the ``pallas``
    backward runs the kernel wrappers' plain versions."""
    want = _jax_grads(dtype, bwd_impl)
    x, g, b, w, bias = _torch_args(_inputs(BWD_M, BWD_N, seed=3), dtype)
    dy = torch.from_numpy(_dy("float32")).to(x.dtype)
    for linear_layout in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, g, b)]
        w_leaf = (w.t().contiguous() if linear_layout else w.clone()).requires_grad_()
        bias_leaf = bias.clone().requires_grad_()
        wv = w_leaf.t() if linear_layout else w_leaf
        counts = {k: f.launches for k, f in fln.KERNELS.items()}
        y = ln_matmul(*leaves, wv, bias_leaf, bwd_impl=bwd_impl)
        assert y.grad_fn is not None and y.dtype == x.dtype
        y.backward(dy)
        assert {k: f.launches for k, f in fln.KERNELS.items()} == counts  # the CPU launches none
        dw = w_leaf.grad.t() if linear_layout else w_leaf.grad
        assert dw.shape == (64, BWD_N) and w_leaf.grad.dtype == w.dtype
        _assert_grads([leaves[0].grad, leaves[1].grad, leaves[2].grad, dw, bias_leaf.grad],
                      want, dtype, f"linear_layout={linear_layout}")


def test_ln_matmul_bwd_wrappers_on_cpu_compute_the_plain_version():
    """On CPU tensors ``ln_matmul_bwd_dx`` and ``ln_matmul_bwd_dw`` are the
    plain backward's parts: dx/dgamma/dbeta/dbias and the rows' mean and
    rstd, then dw in x's dtype from those statistics."""
    x, g, b, w, _ = _torch_args(_inputs(BWD_M, BWD_N, seed=3), "bfloat16")
    dy = torch.from_numpy(_dy("float32")).to(x.dtype)
    dx, dg, db, dw, dbias = fln.ln_matmul_bwd_plain(x, g, b, w, dy)
    *got, mean, rstd = fln.ln_matmul_bwd_dx(x, g, w, dy)
    for a, e in zip(got, (dx, dg, db, dbias)):
        torch.testing.assert_close(a, e, atol=0, rtol=0)
    *_, mean_t, rstd_t = fln.ln_matmul_bwd_dx(x, g, w.t().contiguous().t(), dy)
    torch.testing.assert_close(mean_t, mean, atol=0, rtol=0)
    torch.testing.assert_close(rstd_t, rstd, atol=0, rtol=0)
    x32 = x.float()
    torch.testing.assert_close(mean, x32.mean(-1))
    torch.testing.assert_close(rstd, torch.rsqrt(x32.var(-1, unbiased=False) + 1e-6))
    torch.testing.assert_close(fln.ln_matmul_bwd_dw(x, g, b, dy, mean, rstd), dw,
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fln.ln_matmul_bwd_dx(x.to("meta"), g, w, dy)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fln.ln_matmul_bwd_dw(x.to("meta"), g, b, dy, mean, rstd)


@pytest.mark.parametrize("M,d,n,sms", [(8192, 768, 3072, 132), (8192, 768, 768, 132),
                                       (1, 8, 8, 132), (200, 136, 200, 132),
                                       (129, 264, 40, 4), (16, 1024, 8192, 132)])
def test_ln_matmul_bwd_dx_launch_plan_covers_ragged_shapes(M, d, n, sms, monkeypatch):
    """``dx_plan``, the dx wrapper's grids and workspace: the product's
    tile grid covers dh [M, d] with no tile to spare, the row pass takes
    at most ``DX_ROW_CTAS_PER_SM`` CTAs per SM and one row tile per CTA at
    least, and the f32
    workspace is dh (M*d) plus the dgamma/dbeta partials (G*2d) and one
    dbias partial per row tile of the product (row tiles * n). No size
    reads a shared-memory limit: the plan at d=1024, n=8192 (which the
    whole-row design refused) is the same under any limit."""
    plan = fln.dx_plan(M, d, n, sms)
    bm, bn = fln.DH_TILE
    mtiles, dtiles = plan["dh_grid"]
    assert (mtiles - 1) * bm < M <= mtiles * bm
    assert (dtiles - 1) * bn < d <= dtiles * bn
    G = plan["rows_grid"]
    assert G == min(fln.DX_ROW_CTAS_PER_SM * sms, -(-M // fln.DX_ROW_TILE)) >= 1
    assert (plan["dh"], plan["rows_partials"], plan["bias_partials"]) == (
        M * d, G * 2 * d, mtiles * n)
    assert plan["ws"] == M * d + G * 2 * d + mtiles * n
    monkeypatch.setattr(fln, "_SMEM_LIMIT", 1)
    assert fln.dx_plan(M, d, n, sms) == plan


@pytest.mark.parametrize("M,d,n,sms", [(8192, 768, 3072, 132), (8192, 768, 768, 132),
                                       (8136, 768, 3072, 132), (1, 8, 8, 132),
                                       (200, 136, 200, 132), (129, 264, 40, 4),
                                       (100000, 1024, 8192, 132), (16, 1024, 8192, 132)])
def test_ln_matmul_bwd_dw_launch_plan_covers_ragged_shapes(M, d, n, sms, monkeypatch):
    """``dw_plan``, the dw wrapper's split over M: at most ``DW_MAX_G``
    chunks and one per ``DW_STAGE_ROWS`` rows (so no chunk is empty), on the
    one output tile both tiled products use. G depends on the shapes and
    the SM count alone: the same arguments give the same plan, under any
    shared-memory limit and on any device."""
    plan = fln.dw_plan(M, d, n, sms)
    assert plan["tile"] == (fln.TILE_ROWS, fln.TILE_COLS)
    assert 1 <= plan["G"] <= min(fln.DW_MAX_G, -(-M // fln.DW_STAGE_ROWS))
    monkeypatch.setattr(fln, "_SMEM_LIMIT", 1)
    monkeypatch.setattr(fln, "_SMS", {})
    assert fln.dw_plan(M, d, n, sms) == plan


@pytest.mark.parametrize("M,d,n,sms,G", [(8192, 768, 768, 132, 7), (8192, 768, 3072, 132, 7),
                                         (200, 768, 768, 132, 4), (8192, 768, 3072, 4, 1)])
def test_ln_matmul_bwd_dw_plan_fills_the_card_at_gpt_small(M, d, n, sms, G):
    """At gpt_small's training shapes on 132 SMs (an H100) the split puts
    7 chunks on each 128 x 256 tile: 126 CTAs at n=768 (under one wave of
    132 slots) and 504 at n=3072 (3.8 waves), where G=1 would leave 18
    and 72. 200 rows make four 64-row stages, hence at most four chunks;
    on 4 SMs the 72 tiles fill 18 waves already."""
    assert fln.dw_plan(M, d, n, sms)["G"] == G


class _Routed(Exception):
    pass


@pytest.mark.parametrize("M", [1, 8, 40, 64, 65, 128, 200, 255, 256, 257, 1000, 8192, 8136])
@pytest.mark.parametrize("d,n", [(768, 3072), (768, 768), (136, 200)])
def test_ln_matmul_forward_plan_picks_the_kernel_by_rows_alone(M, d, n, monkeypatch):
    """``fwd_plan``: below ``LN_TILED_MIN_M`` rows (every serving call:
    decode slots, prefill chunks of up to 64 rows, verify) the row-tile
    kernel, from there up the statistics pass and the tiled product; the
    forward wrapper launches what it names, whatever d and n (its launch
    stands in here, as if the tensors lay on a card)."""
    assert 64 < fln.LN_TILED_MIN_M
    want = "ln_matmul_kernel" if M < fln.LN_TILED_MIN_M else "ln_matmul_tiled_kernel"
    assert fln.fwd_plan(M) == want

    def launched(kernel):
        def launch(*args):
            raise _Routed(kernel)
        return launch

    monkeypatch.setattr(fln._build, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(fln, "_launch_fwd_rows", launched("ln_matmul_kernel"))
    monkeypatch.setattr(fln, "_launch_fwd_tiled", launched("ln_matmul_tiled_kernel"))
    x = torch.zeros(M, d, dtype=torch.bfloat16)
    w = torch.zeros(n, d, dtype=torch.bfloat16).t()
    g = torch.ones(d)
    with pytest.raises(_Routed) as got:
        fln.ln_matmul(x, g, g, w)
    assert got.value.args == (want,)


# ---------------------------------------------------------------------------
# the serving forward's launch plan and shared memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [768, 100, 136])
@pytest.mark.parametrize("M", [1, 4, 8, 20, 40, 64, 255])
def test_rows_plan_covers_y_with_no_tile_to_spare(M, d, monkeypatch):
    """``rows_plan``, the serving forward's grid: its 64-column tiles cover
    n and its 16-row tiles M with no tile to spare, at most 8 ranks (the
    portable cluster size) split d into slices of whole 16-deep steps that
    cover d with none empty, and the grid fits one wave of
    ``ROWS_CTAS_PER_SM`` CTAs an SM whenever a split allows it. The plan
    depends on the shapes and the SM count alone: the same arguments give
    the same plan, computed afresh, under any shared-memory limit and with
    the SM counts read from no device. The tile sizes and the largest
    split are the kernel source's own."""
    assert (fln.ROWS_TILE, fln.ROWS_COLS, fln.ROWS_KSTEP, fln.ROWS_SPLITS) == (
        16, 64, 16, (1, 2, 4, 8))
    rows, cols = fln.ROWS_TILE, fln.ROWS_COLS
    for n in (768, 3072, 200, 2304):
        for sms in (132, 114, 4):
            plan = fln.rows_plan(M, d, n, sms)
            S, dS = plan.split, plan.slice
            gx, gy = plan.grid
            case = (M, d, n, sms, plan)
            assert S in (1, 2, 4, 8) and gx % S == 0, case
            assert (gx // S - 1) * cols < n <= gx // S * cols, case
            assert (gy - 1) * rows < M <= gy * rows, case
            assert dS % fln.ROWS_KSTEP == 0 and (S - 1) * dS < d <= S * dS, case
            assert dS == fln._slice(d, S), case
            if any(fln._slice(d, s) <= fln.ROWS_MAX_SLICE and (s - 1) * fln._slice(d, s) < d
                   and gx // S * s * gy <= fln.ROWS_CTAS_PER_SM * sms for s in (1, 2, 4, 8)):
                assert gx * gy <= fln.ROWS_CTAS_PER_SM * sms, case
            monkeypatch.setattr(fln, "_SMEM_LIMIT", 1)
            monkeypatch.setattr(fln, "_SMS", {})
            assert fln.rows_plan.__wrapped__(M, d, n, sms) == plan, case
            monkeypatch.undo()


def _first_design_smem(d: int, esz: int) -> int:
    """Shared memory of the first serving design's CTA (16 rows of width d
    padded to 128, one 128 x 64 w tile, the f32 epilogue tile): every d
    whose CTA fit it took."""
    return esz * (16 * (-(-d // 128) * 128 + 8) + 128 * 72) + 4 * 16 * 64


def test_rows_smem_states_the_kernel_layout_and_takes_every_d_the_first_design_took():
    """``rows_smem`` sums the kernel's ``rows_layout``: at d=768, n=3072,
    M=8 on 132 SMs (64 columns, split 8, a 96-deep slice) a bf16 CTA holds
    16 x (96 + 8) of x, 96 x (64 + 8) of w (n contiguous) or 64 x (96 + 8)
    (the nn.Linear view), 2 x 96 f32 of gamma and beta and 64 of the bias,
    the f32 partials
    of its 16 owned 8-column chunks from 8 ranks and 16 rows' mean and
    rstd. No d that the first design's CTA took (``_SMEM_LIMIT``) is
    refused, at any serving M, either layout and either dtype."""
    plan = fln.rows_plan(8, 768, 3072, 132)
    assert (plan.split, plan.slice) == (8, 96)
    tail = 4 * (2 * 96 + 64) + 4 * 8 * 16 * 8 + 8 * 16
    assert fln.rows_smem(plan, 2, True) == 2 * (16 * 104 + 96 * 72) + tail
    assert fln.rows_smem(plan, 2, False) == 2 * (16 * 104 + 64 * 104) + tail
    assert fln.rows_smem(plan, 4, True) == 4 * (16 * 100 + 96 * 68) + tail
    for esz in (2, 4):
        for d in range(1, 8193, 1 if esz == 2 else 3):
            if _first_design_smem(d, esz) > fln._SMEM_LIMIT:
                continue
            for M in (1, 16, 17, 255):
                for n in (8, 3072):
                    p = fln.rows_plan(M, d, n, 132)
                    for n_contig in (True, False):
                        assert fln.rows_smem(p, esz, n_contig) <= fln._SMEM_LIMIT, (
                            esz, d, M, n, n_contig)


class _Launched(Exception):
    pass


def test_serving_forward_refuses_a_cta_past_the_limit_and_passes_its_plan(monkeypatch):
    """The serving wrapper refuses, before any build, a d whose CTA would
    need more shared memory than ``_SMEM_LIMIT`` (f32, d=8192: a 1024-deep
    slice), and otherwise hands its C entry the plan's split after w's
    strides, with as many arguments as ``_build.SIGNATURES``
    lists (the stream last, added by ``_build.launch``)."""
    monkeypatch.setattr(fln._build, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(fln, "_sms", lambda dev: 132)
    monkeypatch.setattr(fln._build, "load", lambda name: name)
    calls = []

    def launch(lib, entry, what, device, *args):
        calls.append((lib, entry, args))
        raise _Launched

    monkeypatch.setattr(fln._build, "launch", launch)
    g = torch.ones(8192)
    with pytest.raises(ValueError, match="shared memory"):
        fln.ln_matmul(torch.zeros(4, 8192), g, g, torch.zeros(8192, 64))
    assert calls == []
    x, g = torch.zeros(8, 768, dtype=torch.bfloat16), torch.ones(768)
    w = torch.zeros(3072, 768, dtype=torch.bfloat16).t()
    with pytest.raises(_Launched):
        fln.ln_matmul(x, g, g, w, torch.zeros(3072), out_dtype=torch.float32)
    (lib, entry, args), = calls
    assert (lib, entry) == ("ln_matmul", "ln_matmul_bf16_f32")
    assert len(args) + 1 == len(fln._build.SIGNATURES["ln_matmul"][entry])
    plan = fln.rows_plan(8, 768, 3072, 132)
    assert args[6:] == (8, 768, 3072, 1, 768, plan.split, 1e-6)
