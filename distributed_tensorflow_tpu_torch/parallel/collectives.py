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
gloo does not have).

The megatron pair over the ``model`` axis (GSPMD's layout written out,
``models/transformer.py``): ``copy_to_model`` is the identity forward and
an all-reduce of the cotangent backward (it opens a parallel region on
the replicated stream: each rank's part of the stream's gradient is
summed); ``reduce_from_model`` is an all-reduce forward and the identity
backward (it closes one: the row-parallel partial products summed, every
rank holding the same cotangent of the sum, which each rank's partial
product gets once). ``sum_over_axis`` is ``reduce_from_model`` over any
axis (the sharded embedding lookups'). ``gather_fsdp`` all-gathers an
``fsdp`` shard along a dim forward and reduce-scatters the cotangent
backward (ZeRO's parameter gather: each rank's gradient of the gathered
parameter summed over ``fsdp``, this rank's slice kept).

``all_gather`` under NCCL is ``all_gather_into_tensor``; under gloo,
which has no all-gather of CUDA tensors, it is an all-reduce of a
zero-filled full buffer into which each rank wrote its slice (exact: a
value plus zeros). It is differentiable as JAX's is: its backward
reduce-scatters the cotangent.

Sequence parallelism's verbs (``parallel/ring_attention.py``), each
differentiable with JAX's transpose: ``ring_permute`` sends this rank's
tensor ``shift`` ranks on around the axis (``jax.lax.ppermute`` over the
ring; the backward is the permute by ``-shift``); ``all_to_all`` is
``jax.lax.all_to_all(..., tiled=True)`` (the backward the inverse
all-to-all); ``scatter_to_axis`` keeps this rank's chunk of a tensor
replicated over the axis (the backward all-gathers the chunks'
cotangents) and ``gather_from_axis`` all-gathers the chunks back (the
backward keeps this rank's chunk of a cotangent replicated over the
axis): the two bound a ``shard_map`` island over ``seq``. The all-to-all
is ``all_to_all_single`` under every backend (gloo takes CUDA tensors
there). The permute is ``batch_isend_irecv`` under NCCL and under gloo on
CPU tensors; gloo's point-to-point sends of CUDA tensors fail on an H100
(a ``writev`` of a device address), so under gloo on CUDA tensors
(several ranks sharing one card) the permute is emulated exactly as
``all_gather`` is: each rank writes its tensor into a zero-filled buffer
of every rank's, one all-reduce sums them, and each keeps its sender's.

``groups=`` (the emulated subgroups) is not ported (ROADMAP Queue A item
6).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .mesh import FSDP, MODEL, Mesh

AxisNames = str | tuple[str, ...]
Groups = Sequence[Sequence[int]] | None


def _no_groups(groups, verb: str) -> None:
    if groups is not None:
        raise NotImplementedError(f"{verb}(groups=...): subgroup collectives are not ported "
                                  f"yet (ROADMAP Queue A item 6)")


def _nccl(group) -> bool:
    import torch.distributed as dist

    return dist.get_backend(group) == "nccl"


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order (not
    differentiable; module docstring)."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    if _nccl(group):
        y = x.movedim(dim, 0).contiguous()
        out = y.new_empty((n * y.shape[0], *y.shape[1:]))
        dist.all_gather_into_tensor(out, y, group=group)
        return out.movedim(0, dim).contiguous()
    shape = list(x.shape)
    shape[dim] *= n
    out = x.new_zeros(shape)
    out.narrow(dim, r * x.shape[dim], x.shape[dim]).copy_(x)
    dist.all_reduce(out, group=group)
    return out


def _scatter_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` summed, this rank's slice of ``dim`` kept (not
    differentiable)."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    chunk = x.shape[dim] // n
    if _nccl(group):
        y = x.movedim(dim, 0).contiguous()
        out = y.new_empty((chunk, *y.shape[1:]))
        dist.reduce_scatter_tensor(out, y, group=group)
        return out.movedim(0, dim).contiguous()
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y.narrow(dim, r * chunk, chunk).clone()


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


class _SumOverAxis(torch.autograd.Function):
    """All-reduce SUM forward, identity backward (module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToAxis(torch.autograd.Function):
    """Identity forward, all-reduce SUM of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_axis(x: torch.Tensor, axis: AxisNames, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over ``axis``; the gradient passes through unchanged."""
    group = mesh.group(axis)
    return x if group is None else _SumOverAxis.apply(x, group)


def copy_to_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x`` (replicated over ``model``) entering a parallel region: the
    identity, whose backward sums the cotangent over ``model``."""
    group = None if mesh is None else mesh.group(MODEL)
    return x if group is None else _CopyToAxis.apply(x, group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The partial results of a parallel region summed over ``model``;
    the gradient passes through unchanged."""
    return x if mesh is None else sum_over_axis(x, MODEL, mesh)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter backward (JAX's
    transpose of ``all_gather``)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


def gather_fsdp(x: torch.Tensor, dim: int, mesh: Mesh | None) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's ``fsdp`` shard along
    ``dim``; the backward reduce-scatters the cotangent over ``fsdp``."""
    group = None if mesh is None else mesh.group(FSDP)
    return x if group is None else _Gather.apply(x, group, dim)


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide by {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _ScatterToAxis(torch.autograd.Function):
    """This rank's chunk forward, the all-gather of the chunks' cotangents
    backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _GatherFromAxis(torch.autograd.Function):
    """All-gather forward, this rank's chunk of the (replicated) cotangent
    backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim), None, None


def scatter_to_axis(x: torch.Tensor, dim: int, axis: str, mesh: Mesh) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``x``, which every rank of
    ``axis`` holds whole (the entry of a ``shard_map`` island whose input
    is split over ``axis``); the backward all-gathers the chunks'
    cotangents, so every rank ends with the whole tensor's gradient."""
    group = mesh.group(axis)
    return x if group is None else _ScatterToAxis.apply(x, group, dim)


def gather_from_axis(x: torch.Tensor, dim: int, axis: str, mesh: Mesh) -> torch.Tensor:
    """The ranks' chunks along ``dim`` concatenated in rank order (the
    exit of the island); the backward keeps this rank's chunk of the
    cotangent, which every rank of ``axis`` holds whole."""
    group = mesh.group(axis)
    return x if group is None else _GatherFromAxis.apply(x, group, dim)


def _native_p2p(group, x: torch.Tensor) -> bool:
    """Whether the backend sends ``x`` point to point itself (NCCL; gloo
    on CPU tensors); the permute of gloo on CUDA tensors is emulated
    (module docstring)."""
    return _nccl(group) or x.device.type == "cpu"


def _permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """What rank ``r - shift`` of the group holds (this rank's ``x`` goes
    to rank ``r + shift``), ranks counted modulo the group's size."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    if shift % n == 0:
        return x.clone()
    if not _native_p2p(group, x):
        buf = x.new_zeros((n, *x.shape))
        buf[r].copy_(x)
        dist.all_reduce(buf, group=group)
        return buf[(r - shift) % n].clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all: chunk j of ``x`` along ``split_axis`` goes to
    rank j, the chunks received concatenated along ``concat_axis`` in rank
    order."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size {x.shape[split_axis]} does "
                         f"not divide by {n} ranks")
    parts = torch.stack(x.chunk(n, split_axis))  # [n, ...]: part j for rank j
    got = torch.empty_like(parts)
    dist.all_to_all_single(got, parts, group=group)
    return torch.cat(got.unbind(0), concat_axis)


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g, ctx.group, concat_axis, split_axis), None, None, None


def _reduce_op(x: torch.Tensor, axis: AxisNames, mesh: Mesh, op) -> torch.Tensor:
    import torch.distributed as dist

    group = mesh.group(axis)
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=getattr(dist.ReduceOp, op), group=group)
    return y


def all_reduce_max(x: torch.Tensor, axis: AxisNames, mesh: Mesh) -> torch.Tensor:
    """Elementwise max across the axis (not differentiable)."""
    return _reduce_op(x, axis, mesh, "MAX")


def all_reduce_min(x: torch.Tensor, axis: AxisNames, mesh: Mesh) -> torch.Tensor:
    """Elementwise min across the axis (not differentiable)."""
    return _reduce_op(x, axis, mesh, "MIN")


def all_reduce_mean(x: torch.Tensor, axis: AxisNames, mesh: Mesh, groups: Groups = None):
    """Mean across the axis: gradient aggregation."""
    _no_groups(groups, "all_reduce_mean")
    n = axis_size(axis, mesh)
    return x if n == 1 else all_reduce(x, axis, mesh) / n


def all_gather(x: torch.Tensor, axis: AxisNames, mesh: Mesh, *, tiled_axis: int = 0,
               groups: Groups = None):
    """Concatenate the ranks' ``x`` along ``tiled_axis``, in rank order;
    the backward reduce-scatters the cotangent (module docstring)."""
    _no_groups(groups, "all_gather")
    group = mesh.group(axis)
    return x if group is None else _Gather.apply(x, group, tiled_axis)


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
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    chunk j of ``x`` along ``split_axis`` goes to rank j of the axis, and
    the chunks this rank receives are concatenated along ``concat_axis``
    in rank order. Differentiable: the backward is the inverse
    all-to-all."""
    _no_groups(groups, "all_to_all")
    group = mesh.group(axis)
    return x if group is None else _AllToAll.apply(x, group, split_axis, concat_axis)


def ring_permute(x, axis: str, mesh: Mesh, *, shift: int = 1):
    """``jax.lax.ppermute`` over the ring of ``axis``: this rank's ``x``
    goes to rank ``i + shift`` (mod the axis size), and it returns what
    rank ``i - shift`` sent. Differentiable: the backward is the permute
    by ``-shift``."""
    group = mesh.group(axis)
    return x if group is None else _RingPermute.apply(x, group, shift)


def axis_index(axis: AxisNames, mesh: Mesh) -> int:
    """This rank's index along the axis (0 on a size-1 axis)."""
    import torch.distributed as dist

    group = mesh.group(axis)
    return 0 if group is None else dist.get_rank(group)


def axis_size(axis: AxisNames, mesh: Mesh) -> int:
    from .mesh import mesh_axis_size

    return mesh_axis_size(mesh, axis)
