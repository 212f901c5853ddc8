"""The port's fused LayerNorm + matmul (ops/fused_ln_matmul.py) against
the JAX package's: the Pallas forward kernel (interpret mode here) and
``ln_matmul_reference``, on the same numpy inputs.

Tolerances: f32 1e-5 (same math, other summation order). bf16: both
sides round the normalised rows and the output to bf16, so a row value
sitting on a rounding boundary may come out one bf16 ulp apart, before
and after the product — atol = rtol = 2^-7 (two ulps at |y| ~ 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops.fused_ln_matmul import (
    ln_matmul as jax_ln_matmul,
    ln_matmul_reference,
)
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
@pytest.mark.parametrize("M,n", [(8, 96), (40, 128), (64, 32)])
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
