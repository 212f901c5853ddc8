"""The port's paged attention (ops/attention.py, ops/paged_attention.py)
against the JAX package's, on the same numpy inputs.

Pools with non-contiguous tables, sentinel table entries, an idle
all-sentinel row (past-the-table q_pos) and padded rows (q_pos = -1).
The ``gather``/``fused`` paths spread a fully masked row uniformly (as
``jax.nn.softmax`` does) while the kernel — JAX's Pallas kernel, run in
interpret mode here, and the port's CUDA kernel, whose plain version
runs here — gives exactly 0; so the port's gather/fused/auto are held
against JAX's ``gather`` and the port's kernel path against JAX's
``pallas``. f32, atol = rtol = 2e-5 (same math, other summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import attention as jatt
from distributed_tensorflow_tpu_torch.ops import attention as tatt
from distributed_tensorflow_tpu_torch.ops.paged_attention import (
    paged_attention_plain,
    paged_flash_attention,
)

B, H, D, BS, NB, MB = 3, 2, 16, 8, 10, 4
OOB = MB * BS
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(S: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    table = np.full((B, MB), NB, np.int32)
    table[0, :3] = [4, 9, 1]  # 3 live blocks, non-contiguous
    table[1, :1] = [0]        # 1 live block
    # row 2 stays all-sentinel: an idle slot
    q_pos = np.empty((B, S), np.int32)
    q_pos[0] = 17 + np.arange(S)
    q_pos[1] = np.arange(S)
    q_pos[2] = OOB
    if S > 1:
        q_pos[0, -1] = -1     # padded rows: attend nothing
        q_pos[1, S // 2:] = -1
    return dict(
        q=rng.standard_normal((B, H, S, D), dtype=np.float32),
        k_pool=rng.standard_normal((NB, H, BS, D), dtype=np.float32),
        v_pool=rng.standard_normal((NB, H, BS, D), dtype=np.float32),
        block_table=table, q_pos=q_pos,
    )


def _jax(inp, impl):
    args = [jnp.asarray(inp[k]) for k in ("q", "k_pool", "v_pool", "block_table")]
    return np.asarray(jatt.paged_attention(
        *args, q_pos=jnp.asarray(inp["q_pos"]), impl=impl))


def _torch(inp, fn, **kw):
    args = [torch.from_numpy(inp[k]) for k in ("q", "k_pool", "v_pool", "block_table")]
    return fn(*args, q_pos=torch.from_numpy(inp["q_pos"]), **kw).numpy()


@pytest.mark.parametrize("S", [1, 5, 32])
@pytest.mark.parametrize("impl", ["gather", "fused", "auto"])
def test_paged_attention_dispatch_matches_jax_gather(S, impl):
    inp = _inputs(S)
    got = _torch(inp, tatt.paged_attention, impl=impl)
    np.testing.assert_allclose(got, _jax(inp, "gather"), **TOL,
                               err_msg=f"impl={impl} S={S}")


@pytest.mark.parametrize("S", [1, 5, 32])
def test_paged_kernel_plain_matches_jax_pallas(S):
    """The CUDA kernel's plain version — what ``impl="cuda"`` and the
    wrapper compute for CPU tensors — against the Pallas kernel."""
    inp = _inputs(S)
    want = _jax(inp, "pallas")
    for got in (_torch(inp, paged_attention_plain),
                _torch(inp, paged_flash_attention),
                _torch(inp, tatt.paged_attention, impl="cuda")):
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"S={S}")
    if S > 1:  # padded rows are exactly zero
        assert not got[0, :, -1].any() and not got[1, :, S // 2:].any()


def test_paged_attention_rejects_unknown_impl_and_device():
    inp = _inputs(1)
    with pytest.raises(ValueError, match="impl"):
        _torch(inp, tatt.paged_attention, impl="pallas")
    q = torch.zeros(B, H, 1, D, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_flash_attention(q, q, q, q, q_pos=q)


def test_paged_append_kv_drop_semantics_match_jax():
    """Writes through live table entries land where JAX's scatter puts
    them; past-the-table positions and sentinel table entries touch no
    live block (JAX drops them, the port routes them to its drop block):
    the whole pool equals JAX's."""
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((NB, H, BS, D), dtype=np.float32)
    S = 6
    new = rng.standard_normal((B, H, S, D), dtype=np.float32)
    table = np.full((B, MB), NB, np.int32)
    table[0, :3] = [4, 9, 1]
    table[1, :2] = [0, 7]
    pos = np.array([
        [14, 15, 16, 17, OOB, OOB],    # crosses a block boundary; padded tail
        [3, 4, 8, 16, 17, 40],         # 16, 17 hit sentinel entries; 40 past the table
        [OOB] * S,                     # idle slot
    ], np.int32)
    want = np.asarray(jatt.paged_append_kv(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(table), jnp.asarray(pos)))
    ext = torch.from_numpy(np.concatenate([pool, np.zeros((1, H, BS, D), np.float32)]))
    out = tatt.paged_append_kv(ext, torch.from_numpy(new), torch.from_numpy(table),
                               torch.from_numpy(pos))
    assert out is ext  # in place
    np.testing.assert_array_equal(ext[:NB].numpy(), want)
    assert ext[NB].abs().sum() > 0  # the dropped writes went to the drop block


def test_paged_gather_and_cached_attention_match_jax():
    inp = _inputs(5)
    kg = tatt.paged_gather_kv(torch.from_numpy(inp["k_pool"]),
                              torch.from_numpy(inp["block_table"]))
    jkg = jatt.paged_gather_kv(jnp.asarray(inp["k_pool"]), jnp.asarray(inp["block_table"]))
    np.testing.assert_array_equal(kg.numpy(), np.asarray(jkg))
    got = tatt.cached_attention(torch.from_numpy(inp["q"]), kg, kg,
                                q_pos=torch.from_numpy(inp["q_pos"]))
    want = jatt.cached_attention(jnp.asarray(inp["q"]), jkg, jkg,
                                 q_pos=jnp.asarray(inp["q_pos"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
