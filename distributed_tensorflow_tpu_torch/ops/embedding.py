"""Sharded embedding lookup — the port's counterpart of
``distributed_tensorflow_tpu/ops/embedding.py``: tables sharded over the
``model`` mesh axis, the exchange written as explicit collectives over
that axis's process group (``parallel/collectives.py``).

- ``mod_sharded_lookup``: a mod-sharded table (row r on shard ``r % n``,
  so hot ids spread), ids replicated over the axis. Each rank gathers the
  rows it owns, zeros elsewhere, and one sum over the axis assembles the
  embeddings.
- ``range_sharded_lookup``: the same over a range-sharded table (shard s
  owns ids ``[s·rows, (s+1)·rows)``), the layout of a ``("model",
  None)`` parameter (``parallel/sharding.py``): the Wide&Deep model's.
- ``batch_sharded_lookup``: the ids sharded over the axis too. They are
  all-gathered, each rank computes its rows' part of every id, and a
  reduce-scatter returns each rank its own ids' embeddings.

The sum over the axis is JAX's ``psum`` inside ``shard_map``, whose
transpose there is the identity: every rank of the axis holds the same
cotangent of the summed embeddings (the loss downstream is replicated over
``model``), and each rank's table shard must get the gradient of its own
rows once. ``_SumOverAxis``'s backward is therefore the identity (an
all-reduce of the cotangent there would give ``model`` times the
gradient): ``parallel/collectives.sum_over_axis``, the megatron
``reduce_from_model`` over any axis. The reduce-scatter's backward is the all-gather of the
cotangent, as ``psum_scatter``'s transpose is.

At an axis of size 1 (one process, or ``model=1``) each lookup is a plain
gather, ``F.embedding``. Its backward on the card is PyTorch's sort-based
embedding backward, deterministic run to run. No kernel is written here:
the JAX package's lookups are ``jnp.take`` in XLA.

The port's parameters are born sharded, so ``make_range_sharded_lookup``
and ``make_sharded_lookup`` return functions of this rank's shard (JAX's
take the global array); ``range_shard`` and ``to_mod_sharded`` cut a rank's
shard out of a whole table.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.collectives import (
    all_gather,
    axis_index,
    axis_size,
    reduce_scatter,
    sum_over_axis,
)
from ..parallel.mesh import MODEL, Mesh


def shard_vocab(vocab_size: int, n_shards: int) -> int:
    """Rows a shard: tables are padded so every shard holds the same count."""
    return -(-vocab_size // n_shards)


def local_rows(table: torch.Tensor, shard: int, n_shards: int) -> torch.Tensor:
    """The mod-shard view of a whole [V, D] table: rows ``shard, shard + n,
    shard + 2n, ...`` padded with zeros to ``shard_vocab`` rows."""
    v = table.shape[0]
    idx = shard + n_shards * torch.arange(shard_vocab(v, n_shards), device=table.device)
    return torch.where((idx < v)[:, None], table[idx.clamp(max=v - 1)], 0.0)


def range_shard(table: torch.Tensor, shard: int, n_shards: int) -> torch.Tensor:
    """Rows ``[shard·rows, (shard+1)·rows)`` of ``table`` padded with zeros
    to ``n_shards·rows`` rows (``rows = shard_vocab(V, n_shards)``)."""
    v = table.shape[0]
    rows = shard_vocab(v, n_shards)
    out = table.new_zeros((rows, *table.shape[1:]))
    lo, hi = min(shard * rows, v), min((shard + 1) * rows, v)
    out[:hi - lo] = table[lo:hi]
    return out


def _owned_lookup(ids: torch.Tensor, local_table: torch.Tensor, shard: int, n: int):
    """Rows of ``ids`` this mod-shard owns; zeros elsewhere."""
    mine = (ids % n == shard)[..., None]
    safe = (ids // n).clamp(max=local_table.shape[0] - 1)
    return torch.where(mine, F.embedding(safe, local_table), 0.0)


def mod_sharded_lookup(ids: torch.Tensor, local_table: torch.Tensor, mesh: Mesh,
                       axis: str = MODEL) -> torch.Tensor:
    """[*, D] embeddings of ``ids`` (replicated over ``axis``) from this
    rank's [ceil(V/n), D] mod shard."""
    n = axis_size(axis, mesh)
    if n == 1:
        return F.embedding(ids, local_table)
    return sum_over_axis(_owned_lookup(ids, local_table, axis_index(axis, mesh), n),
                         axis, mesh)


def range_sharded_lookup(ids: torch.Tensor, local_table: torch.Tensor, mesh: Mesh,
                         axis: str = MODEL) -> torch.Tensor:
    """[*, D] embeddings of ``ids`` (replicated over ``axis``) from this
    rank's range shard ``[rows, D]``."""
    if axis_size(axis, mesh) == 1:
        return F.embedding(ids, local_table)
    rows = local_table.shape[0]
    mine = (ids // rows == axis_index(axis, mesh))[..., None]
    part = torch.where(mine, F.embedding(ids % rows, local_table), 0.0)
    return sum_over_axis(part, axis, mesh)


def batch_sharded_lookup(ids: torch.Tensor, local_table: torch.Tensor, mesh: Mesh,
                         axis: str = MODEL) -> torch.Tensor:
    """Embeddings of this rank's ids [b, *] where the batch (dim 0) is
    sharded over ``axis`` too, from a mod-sharded table: all-gather the
    ids, look up the owned rows of all of them, reduce-scatter back."""
    n = axis_size(axis, mesh)
    if n == 1:
        return F.embedding(ids, local_table)
    all_ids = all_gather(ids, axis, mesh, tiled_axis=0)
    part = _owned_lookup(all_ids, local_table, axis_index(axis, mesh), n)
    return reduce_scatter(part, axis, mesh, scatter_axis=0)


def make_sharded_lookup(mesh: Mesh, axis: str = MODEL):
    """``f(ids, local_shard)`` over ``mesh``: ``mod_sharded_lookup`` on this
    rank's mod shard (``to_mod_sharded``); ids are this rank's rows of the
    batch."""
    return lambda ids, local_shard: mod_sharded_lookup(ids, local_shard, mesh, axis)


def make_range_sharded_lookup(mesh: Mesh, axis: str = MODEL):
    """``f(ids, local_shard)`` over ``mesh``: ``range_sharded_lookup`` on
    this rank's range shard of the padded table (``range_shard``)."""
    return lambda ids, local_shard: range_sharded_lookup(ids, local_shard, mesh, axis)


def to_mod_sharded(table: torch.Tensor, mesh: Mesh, axis: str = MODEL) -> torch.Tensor:
    """This rank's mod shard of a whole [V, D] table, for
    ``make_sharded_lookup``."""
    return local_rows(table, axis_index(axis, mesh), axis_size(axis, mesh))
