"""Batch placement and replication — the data-parallel subset of
``distributed_tensorflow_tpu/parallel/sharding.py``.

``batch_spec``'s meaning: dim 0 of a batch is split over ``BATCH_AXES``
in rank order, so rank r of R holds rows ``[r·B/R, (r+1)·B/R)`` of the
global batch of B rows — the row order JAX's ``P(("data",))`` gives.
Every other dim, every parameter and every buffer is replicated.
The partition-rule tables (``partition_rules``, ``auto_fsdp_specs``,
``opt_state_specs``, ...) come with parameter and tensor sharding
(ROADMAP Queue A item 3.1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .collectives import axis_index, axis_size, broadcast
from .mesh import BATCH_AXES, Mesh


def local_rows(global_rows: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``global_rows`` rows."""
    n, r = axis_size(BATCH_AXES, mesh), axis_index(BATCH_AXES, mesh)
    if global_rows % n:
        raise ValueError(f"global batch of {global_rows} rows not divisible by the "
                         f"{n} batch shards")
    per = global_rows // n
    return slice(r * per, (r + 1) * per)


def shard_host_batch(batch: Mapping[str, Any], mesh: Mesh) -> dict[str, Any]:
    """This rank's rows of a global host batch (every leaf split on dim 0)."""
    return {k: v[local_rows(len(v), mesh)] for k, v in batch.items()}


def put_host_batch(batch: Mapping[str, Any], device) -> dict[str, torch.Tensor]:
    """The rank's host batch (numpy arrays or CPU tensors) as tensors on
    ``device``. The copy is from pageable memory; ``data.pipeline.
    DevicePut`` stages it through pinned buffers on a side stream."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            .to(device, non_blocking=True) for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class RowGenerator:
    """A ``torch.Generator`` seeded alike on the ``shards`` ranks of a
    data-parallel step, of which this one is ``index``: ``rand_rows``
    draws the global batch's noise and keeps this rank's rows, so every
    row of the global batch gets its own noise, the same that one process
    stepping on the whole global batch draws for it (the one draw over the
    global batch of the JAX step). The cost is the global draw on every
    rank."""

    generator: torch.Generator
    shards: int
    index: int


def rand_rows(shape, generator: torch.Generator | RowGenerator, device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``; from a ``RowGenerator``,
    this rank's rows (dim 0 of ``shape``) of the draw of the global
    shape."""
    if not isinstance(generator, RowGenerator):
        return torch.rand(shape, generator=generator, device=device)
    b = shape[0]
    full = torch.rand((b * generator.shards, *shape[1:]), generator=generator.generator,
                      device=device)
    return full[generator.index * b:(generator.index + 1) * b]


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's value on
    every rank of the batch axes (after ``init_params``, so that each
    replica starts from the same weights). Returns ``module``."""
    for t in [*module.parameters(), *module.buffers()]:
        t.copy_(broadcast(t, BATCH_AXES, mesh, src=0))
    return module
