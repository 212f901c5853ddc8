"""Collective verbs over named mesh axes — the port's counterpart of
``distributed_tensorflow_tpu/parallel/collectives.py``.

The JAX verbs run inside ``shard_map`` and name their axis; the port's
take the axis and the ``Mesh`` (``parallel/mesh.py``) and run over that
axis's process group (NCCL on the card, gloo on the CPU). Over an axis of
size 1 (and with no process group) each verb is the identity. Every verb
returns a new tensor and leaves its input as it was.

``all_reduce`` is differentiable, as JAX's ``psum`` is: its backward
all-reduces the cotangent (``_AllReduceSum``), so a loss that depends on
an all-reduced sum (the global BatchNorm statistics) hands every rank
the summed cotangent. ``reduce_scatter`` is the all-reduce and this
rank's slice (twice the wire traffic of a native reduce-scatter, which
gloo does not have; it is on no main path yet).

``groups=`` (the emulated subgroups), ``all_to_all`` and ``ring_permute``
are not ported (ROADMAP Queue A item 6: MoE dispatch, ring attention).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .mesh import Mesh

AxisNames = str | tuple[str, ...]
Groups = Sequence[Sequence[int]] | None


def _no_groups(groups, verb: str) -> None:
    if groups is not None:
        raise NotImplementedError(f"{verb}(groups=...): subgroup collectives are not ported "
                                  f"yet (ROADMAP Queue A item 6)")


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the backward sums the cotangent over the
    same group (the transpose of a psum over a batch axis)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, axis: AxisNames, mesh: Mesh, groups: Groups = None):
    """Sum across the axis (differentiable)."""
    _no_groups(groups, "all_reduce")
    group = mesh.group(axis)
    return x if group is None else _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, axis: AxisNames, mesh: Mesh, groups: Groups = None):
    """Mean across the axis: gradient aggregation."""
    _no_groups(groups, "all_reduce_mean")
    n = axis_size(axis, mesh)
    return x if n == 1 else all_reduce(x, axis, mesh) / n


def all_gather(x: torch.Tensor, axis: AxisNames, mesh: Mesh, *, tiled_axis: int = 0,
               groups: Groups = None):
    """Concatenate the ranks' ``x`` along ``tiled_axis``, in rank order."""
    import torch.distributed as dist

    _no_groups(groups, "all_gather")
    group = mesh.group(axis)
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=tiled_axis)


def reduce_scatter(x: torch.Tensor, axis: AxisNames, mesh: Mesh, *, scatter_axis: int = 0,
                   groups: Groups = None):
    """Sum, then keep this rank's slice of ``scatter_axis`` (its size must
    divide by the axis size)."""
    _no_groups(groups, "reduce_scatter")
    n = axis_size(axis, mesh)
    if x.shape[scatter_axis] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_axis} of size "
                         f"{x.shape[scatter_axis]} does not divide by {n} ranks")
    chunk = x.shape[scatter_axis] // n
    return all_reduce(x, axis, mesh).narrow(scatter_axis, axis_index(axis, mesh) * chunk, chunk)


def broadcast(x: torch.Tensor, axis: AxisNames, mesh: Mesh, *, src: int = 0):
    """Every rank gets rank ``src``'s ``x`` (``src`` counted along the axis)."""
    import torch.distributed as dist

    group = mesh.group(axis)
    if group is None:
        return x
    y = x.detach().clone().contiguous()
    dist.broadcast(y, src=dist.get_global_rank(group, src), group=group)
    return y


def barrier(axis: AxisNames, mesh: Mesh) -> int:
    """Every rank of the axis waits for the others; returns the axis size."""
    import torch.distributed as dist

    group = mesh.group(axis)
    if group is not None:
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=group)
    return axis_size(axis, mesh)


def all_to_all(x, axis: AxisNames, mesh: Mesh, *, split_axis: int, concat_axis: int,
               groups: Groups = None):
    raise NotImplementedError("all_to_all (Ulysses sequence parallelism, MoE dispatch) is not "
                              "ported yet (ROADMAP Queue A item 6)")


def ring_permute(x, axis: str, mesh: Mesh, *, shift: int = 1):
    raise NotImplementedError("ring_permute (ring attention) is not ported yet (ROADMAP Queue "
                              "A item 6, parallel/ring_attention.py)")


def axis_index(axis: AxisNames, mesh: Mesh) -> int:
    """This rank's index along the axis (0 on a size-1 axis)."""
    import torch.distributed as dist

    group = mesh.group(axis)
    return 0 if group is None else dist.get_rank(group)


def axis_size(axis: AxisNames, mesh: Mesh) -> int:
    from .mesh import mesh_axis_size

    return mesh_axis_size(mesh, axis)
