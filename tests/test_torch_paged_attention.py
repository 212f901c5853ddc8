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
from distributed_tensorflow_tpu_torch.ops import paged_attention
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


# ---------------------------------------------------------------------------
# the kernel's launch plan and what the wrapper hands its C entry
# ---------------------------------------------------------------------------


def test_paged_plan_covers_every_logical_block_once():
    """``paged_plan`` deals the ``MB * bs`` keys of a row into chunks of
    ``chunk`` keys (whole steps of the mma's 16) and the chunks into the
    contiguous shares of ``ranks`` CTAs, ``cpr`` a rank: every key — so
    every logical block of every row — lies in exactly one rank's share,
    no rank is left with an empty or negative share, the cluster stays
    within 8 (the portable size), a tile holds at most 64 rows (so at S
    <= 64 one cluster per (b, h) reads each block once) and a CTA fits
    shared memory in both dtypes. The plan depends on the shapes and the
    SM count alone: the same arguments give the same plan after its cache
    is cleared."""
    for MB in (1, 3, 20, 64, 128):
        for bs in (8, 16, 32):
            for D in (32, 64, 128):
                for S in (1, 5, 64, 128):
                    for B in (1, 4, 8):
                        for sms in (132, 114, 4):
                            for esz in (2, 4):
                                _check_plan(B, 12, S, MB, bs, D, esz, sms)
    before = paged_attention.paged_plan(8, 12, 1, 64, 16, 64, 2, 132)
    paged_attention.paged_plan.cache_clear()
    assert paged_attention.paged_plan(8, 12, 1, 64, 16, 64, 2, 132) == before


def _check_plan(B, H, S, MB, bs, D, esz, sms):
    plan = paged_attention.paged_plan(B, H, S, MB, bs, D, esz, sms)
    case = (B, H, S, MB, bs, D, esz, sms, plan)
    keys = MB * bs
    chunks = -(-keys // plan.chunk)
    assert plan.chunk % 16 == 0 and 1 <= plan.ranks <= 8 and plan.cpr >= 1, case
    shares = [range(r * plan.cpr * plan.chunk, min(keys, (r + 1) * plan.cpr * plan.chunk))
              for r in range(plan.ranks)]
    assert all(len(sh) > 0 for sh in shares), case
    assert sorted(k for sh in shares for k in sh) == list(range(keys)), case
    assert (plan.ranks - 1) * plan.cpr < chunks <= plan.ranks * plan.cpr, case
    assert plan.rows == (16 if S <= 16 else 32 if S <= 32 else 64), case
    tiles = plan.grid[0] // plan.ranks
    assert plan.grid == (plan.ranks * tiles, H, B) and (tiles - 1) * plan.rows < S, case
    if S <= 64:
        assert tiles == 1, case
    assert paged_attention.paged_smem(plan, S, D, esz) <= paged_attention._SMEM_LIMIT, case


def test_paged_smem_states_the_kernel_layout():
    """``paged_smem`` sums the kernel's ``layout``: at the smoke's decode
    (B=8, H=12, S=1, D=64, bs=16, MB=64, bf16, 132 SMs: 4 ranks of 4
    chunks, 384 CTAs within one wave of 3 an SM) a CTA holds 16 q rows and
    a 3-stage ring of 64-key K and V chunks (rows of 64 + 8 bf16), the f32
    partials of the two of the row's eight 8-column chunks it owns from 4
    ranks x 4 warps, their (m, l), 16 positions and 4 warp maxima, 160
    table ids; f32 adds each warp's 16 x 20 P tile. At the serve pass's
    decode (B=4: 8 ranks of 2 chunks) and a 5-row verify the ring has 2
    stages; a 64-row prefill chunk's CTA has 8 warps (4 row groups x 2 key
    groups, so 2 partials a rank for each of its 64 output chunks)."""
    plan = paged_attention.paged_plan(8, 12, 1, 64, 16, 64, 2, 132)
    assert (plan.ranks, plan.chunk, plan.cpr, plan.rows) == (4, 64, 4, 16)
    assert plan.grid == (4, 12, 8)
    tail = 4 * 4 * 2 * 32 + 4 * 4 * 1 * 8 + 80 + 640
    assert paged_attention.paged_smem(plan, 1, 64, 2) == 2 * 72 * (16 + 3 * 2 * 64) + tail
    assert paged_attention.paged_smem(plan, 1, 64, 4) == (
        4 * 68 * (16 + 3 * 2 * 64) + 4 * 16 * 20 * 4 + tail)
    plan = paged_attention.paged_plan(4, 12, 1, 64, 16, 64, 2, 132)
    assert (plan.ranks, plan.cpr) == (8, 2)
    assert paged_attention.paged_smem(plan, 1, 64, 2) == (
        2 * 72 * (16 + 2 * 2 * 64) + 8 * 4 * 1 * 32 + 8 * 4 * 1 * 8 + 80 + 640)
    plan = paged_attention.paged_plan(4, 12, 5, 64, 16, 64, 2, 132)
    assert (plan.ranks, plan.cpr, plan.rows) == (8, 2, 16)
    assert paged_attention.paged_smem(plan, 5, 64, 2) == (
        2 * 72 * (16 + 2 * 2 * 64) + 8 * 4 * 5 * 32 + 8 * 4 * 5 * 8 + 80 + 640)
    plan = paged_attention.paged_plan(1, 12, 64, 64, 16, 64, 2, 132)
    assert (plan.ranks, plan.cpr, plan.rows) == (8, 2, 64)
    assert paged_attention.paged_smem(plan, 64, 64, 2) == (
        2 * 72 * (64 + 2 * 2 * 64) + 8 * 2 * 64 * 32 + 8 * 2 * 64 * 8 + 72 * 4 + 640)


class _Launched(Exception):
    pass


def test_paged_wrapper_hands_its_entry_the_plan(monkeypatch):
    """The wrapper refuses, before any build, what the kernel does not take
    (a head dim other than a power of two from 8 to 128, blocks over 128
    keys, a table with no block), and otherwise hands its C entry the
    shapes and ``paged_plan``'s ranks, chunk keys and chunks a rank — no
    scratch tensors, no query of the library — with as many arguments as ``_build.SIGNATURES`` lists
    (the stream last, added by ``_build.launch``). Shown on the meta device
    taken for a card: CPU tensors take the plain version."""
    build = paged_attention._build
    monkeypatch.setattr(build, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(paged_attention, "_sms", lambda dev: 132)
    monkeypatch.setattr(build, "load", lambda name: name)
    calls = []

    def launch(lib, entry, what, device, *args):
        calls.append((lib, entry, args))
        raise _Launched

    monkeypatch.setattr(build, "launch", launch)

    def call(Bq, Hq, Sq, Dq, NBq, bsq, MBq, dtype=torch.bfloat16):
        q = torch.zeros(Bq, Hq, Sq, Dq, dtype=dtype, device="meta")
        pool = torch.zeros(NBq, Hq, bsq, Dq, dtype=dtype, device="meta")
        table = torch.zeros(Bq, MBq, dtype=torch.int32, device="meta")
        pos = torch.zeros(Bq, Sq, dtype=torch.int32, device="meta")
        return paged_flash_attention(q, pool, pool, table, q_pos=pos)

    for bad in (dict(Dq=4, dtype=torch.float32), dict(Dq=256), dict(Dq=48)):
        with pytest.raises(ValueError, match="head_dim"):
            call(2, 2, 1, bad["Dq"], 4, 16, 3, bad.get("dtype", torch.bfloat16))
    with pytest.raises(ValueError, match="block_size"):
        call(2, 2, 1, 64, 4, 256, 3)
    with pytest.raises(ValueError, match="MB >= 1"):
        call(2, 2, 1, 64, 4, 16, 0)
    assert calls == []
    with pytest.raises(_Launched):
        call(8, 12, 1, 64, 80, 16, 64)
    (lib, entry, args), = calls
    assert (lib, entry) == ("paged_attention", "paged_attention_bf16")
    assert len(args) + 1 == len(build.SIGNATURES["paged_attention"][entry])
    plan = paged_attention.paged_plan(8, 12, 1, 64, 16, 64, 2, 132)
    assert args[6:] == (8, 12, 1, 64, 80, 16, 64, plan.ranks, plan.chunk, plan.cpr, 0.125)
