"""Pipeline parallelism over the ``pipe`` mesh axis — the port's
counterpart of ``distributed_tensorflow_tpu/parallel/pipeline.py``.

The JAX package runs the schedule as one ``shard_map`` island whose
``lax.scan`` over ticks hops activations stage to stage with
``ppermute``; here every ``pipe`` rank runs the same Python loop over the
ticks on its own stage's parameters (SPMD: one process a rank), and the
hop is ``collectives.ring_permute`` over the ``pipe`` process group
(NCCL's point to point on the cards; under gloo on CUDA tensors the
exact all-reduce emulation). Autograd through the loop is the backward
pipeline: the permute's backward is the reverse permute, so the
activations' cotangents flow from the last stage to the first.

- **The schedule** (one unified formulation for GPipe, ``n_virtual`` 1,
  and the interleaved one, V > 1): chunk c = v·S + d of the S·V chunks
  lives on rank d. Rank d at tick t sits at λ = t − d; with (g, r) =
  divmod(λ, S·V) and (v, j) = divmod(r, S) it runs its chunk v on
  microbatch m = g·S + j while 0 ≤ λ < M·V (``schedule``). There are
  M·V + S − 1 ticks; stage 0 injects microbatch m whenever it starts
  chunk 0, the last rank's chunk V−1 yields m's output, and every tick
  ends in one permute. Chunk c's output for m (tick m + c) reaches chunk
  c + 1 exactly when that chunk runs m.
- **Idle ticks are skipped**: where JAX computes on garbage and masks the
  result out, a rank outside 0 ≤ λ < M·V calls no stage function and
  passes its buffer on. A rank thus runs its chunks M·V times a step, and
  each kernel a stage runs launches M·V times a step per layer of a chunk
  (twice that for a forward kernel: the recompute below). The permute
  still runs on every rank in every tick, and stays in every rank's
  autograd graph: a collective that one rank leaves out of its backward
  blocks its neighbour in it. So whatever a tick receives stays in the
  graph (``_Keep``): an injected microbatch carries the buffer it
  replaces, the first tick's output the injected input and a stage
  parameter, the pipeline's output the last permute's. A backward must
  ask for the stage parameters' gradients (``torch.autograd.grad`` prunes
  what leads to no input it asks for): the train step asks for every
  parameter's.
  Each permute's backward then waits for the next one's on every rank,
  and they run in the same (reverse tick) order everywhere.
- **Recompute**: each tick's stage call runs under
  ``torch.utils.checkpoint`` (``jax.checkpoint`` on the stage fn): a
  rank keeps one stage-input buffer per in-flight microbatch and chunk,
  O(M·V), GPipe's memory (1F1B's O(S) needs interleaved forward and
  backward ticks, which neither package has).
- **Entry and exit, a conjugate pair**: the input enters through the
  identity whose backward sums the cotangent over ``pipe`` (only stage 0
  reads it, so every rank ends with stage 0's gradient of it), and the
  output leaves as a broadcast from the last stage whose backward is the
  identity (JAX's masked ``psum``, whose transpose moves nothing): the
  loss, computed alike on every rank from the replicated output, gives
  the last stage its cotangent once. The replicated ends of a model (the
  embeddings before the entry, the head after the exit) end the backward
  with the same gradient on every ``pipe`` rank, and each rank's stage
  parameters with their own; a step reduces over ``(data, fsdp)`` alone.
- **Dropout**: with ``generator`` the stage fn also gets the microbatch
  ``m`` and the chunk ``c`` of the call, from which it seeds its own
  generators (``models/transformer.py``): the masks depend on (step, m,
  global layer, batch shard), not on the schedule, and the recompute
  replays them.

Constraints (as in JAX): the stage fn is shape-preserving (``[mb, ...]``
-> ``[mb, ...]``); the heterogeneous ends run outside, pipe-replicated;
M ≥ S, and M % S == 0 when V > 1. ``microbatch`` splits a batch with the
STRIDED assignment (microbatch m takes rows m, M+m, …), so each rank's
rows of the global batch stay its own.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.checkpoint import checkpoint

from . import collectives as col
from .mesh import PIPE, Mesh
from .sharding import check_spec


def stack_stages(per_stage: list) -> Any:
    """``[tree_0, ..., tree_{S-1}]`` (same structure) -> one tree with a
    leading stage dim on every leaf."""
    return tree_map(lambda *leaves: torch.stack(leaves), per_stage[0], *per_stage[1:])


def stage_param_specs(stage_params: Any) -> Any:
    """``("pipe", None, ...)`` for every leaf (the leading dim the stage)."""
    return tree_map(lambda t: check_spec((PIPE,) + (None,) * (t.dim() - 1)), stage_params)


def schedule(S: int, V: int, M: int) -> list[tuple[int, int, int, int, bool]]:
    """Every ``(tick, rank, chunk v, microbatch m, active)`` of the
    schedule (module docstring), ticks outer and ranks inner; an idle
    (rank, tick) gets JAX's clipped indices."""
    out = []
    for t in range(M * V + S - 1):
        for d in range(S):
            lam = t - d
            g, r = divmod(max(lam, 0), S * V)
            v, j = divmod(r, S)
            out.append((t, d, v, min(max(g * S + j, 0), M - 1), 0 <= lam < M * V))
    return out


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """``[B, ...] -> [M, B//M, ...]``, microbatch m the rows m, M+m, 2M+m,
    … (a view)."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by microbatches {n_microbatches}")
    return x.reshape(B // n_microbatches, n_microbatches, *x.shape[1:]).transpose(0, 1)


def unmicrobatch(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`microbatch` (the rows back in their order)."""
    return y.transpose(0, 1).reshape(y.shape[0] * y.shape[1], *y.shape[2:])


class _Keep(torch.autograd.Function):
    """The identity on ``x``, whose backward gives each of ``others`` a
    zero gradient (module docstring: what keeps a permute in the graph)."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.others))


class _ToStages(torch.autograd.Function):
    """The pipeline's entry: identity forward, the cotangent summed over
    ``pipe`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FromLastStage(torch.autograd.Function):
    """The pipeline's exit: the last stage's tensor broadcast to every
    ``pipe`` rank forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.detach().contiguous().clone()
        n = dist.get_world_size(group)
        dist.broadcast(y, src=dist.get_global_rank(group, n - 1), group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _chunk_params(stage_params, s: int, v: int):
    """Chunk v of stage row s: a module's ``[v]`` (the rank's own chunks),
    else every tensor leaf's ``[s, v]``."""
    if isinstance(stage_params, torch.nn.Module):
        return stage_params[v]
    return tree_map(lambda p: p[s, v], stage_params)


def _leaves(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def pipeline_apply(stage_fn: Callable[..., torch.Tensor], stage_params: Any,
                   x_mb: torch.Tensor, mesh: Mesh | None, aux_mb: Any = None,
                   n_virtual: int = 1, param_specs: Any = None, generator: Any = None
                   ) -> torch.Tensor:
    """Run ``x_mb`` through the S-stage (with ``n_virtual`` > 1 the
    interleaved) pipeline of ``mesh``'s ``pipe`` axis; returns the
    ``[M, mb, ...]`` outputs, the same on every ``pipe`` rank.

    stage_fn: ``(params of a chunk, x [mb, ...]) -> y [mb, ...]``; with
        ``aux_mb`` ``(params, x, aux)``; with ``generator`` two more
        trailing arguments, the microbatch m and the chunk c (module
        docstring).
    stage_params: a tree of tensors, every leaf ``[S', ...]`` (``n_virtual``
        1) or ``[S', V, ...]`` — S' = S, the whole stack (rank d takes row
        d), or 1, this rank's row — or a module whose ``[v]`` is this
        rank's chunk v (``len`` V). At ``pipe`` 1 every row's chunks run in
        order, c = s·V + v.
    x_mb: ``[M, mb, ...]`` microbatches of this rank's rows (``microbatch``).
    aux_mb: a tree of ``[M, mb, ...]`` side inputs (the attention masks)
        that do not hop the ring: the stage fn gets microbatch m's.
    param_specs: the stage params' specs, each leading with ``pipe``
        (checked; this rank's rows are what it holds, so they place
        nothing). Refused at ``pipe`` 1, as JAX refuses them outside its
        island.
    generator: given, the stage fn draws (module docstring)."""
    S = 1 if mesh is None else mesh.shape[PIPE]
    M, V = x_mb.shape[0], n_virtual
    for leaf in _leaves(aux_mb):
        if leaf.dim() < 2 or leaf.shape[0] != M:
            raise ValueError(f"aux_mb leaves must be [M={M}, mb, ...] microbatched (use "
                             f"microbatch()); got shape {tuple(leaf.shape)}")
    is_module = isinstance(stage_params, torch.nn.Module)
    if is_module:
        if len(stage_params) != V:
            raise ValueError(f"n_virtual={V} needs a module of V chunks, got "
                             f"{len(stage_params)}")
        rows = 1
    else:
        if V == 1:
            stage_params = tree_map(lambda p: p[:, None], stage_params)
        else:
            for leaf in _leaves(stage_params):
                if leaf.dim() < 2 or leaf.shape[1] != V:
                    raise ValueError(
                        f"n_virtual={V} needs stage_params leaves laid out [S, V, ...]; got "
                        f"shape {tuple(leaf.shape)} (build with to_pipeline_params(..., "
                        f"n_virtual=V) or stack chunks v*S+d at [d, v])")
        rows = _leaves(stage_params)[0].shape[0]
    if S == 1:
        if param_specs is not None:
            raise ValueError("param_specs on a pipe=1 mesh: the degenerate path runs the "
                             "chunks in order on one rank, so a tensor-parallel stage fn's "
                             "specs would place nothing — use the dense model instead")
        out = []
        for m in range(M):
            x = x_mb[m]
            for s in range(rows):
                for v in range(V):
                    args = [_chunk_params(stage_params, s, v), x]
                    if aux_mb is not None:
                        args.append(tree_map(lambda a: a[m], aux_mb))  # noqa: B023
                    if generator is not None:
                        args += [m, s * V + v]
                    x = stage_fn(*args)
            out.append(x)
        return torch.stack(out)
    if M < S:
        raise ValueError(f"need at least as many microbatches ({M}) as stages ({S}) — the "
                         f"bubble would dominate and the schedule assumes M >= S")
    if V > 1 and M % S:
        raise ValueError(f"interleaved schedule needs microbatches ({M}) divisible by "
                         f"stages ({S})")
    if param_specs is not None:
        for spec in tree_flatten(param_specs, is_leaf=lambda x: isinstance(x, tuple))[0]:
            if not spec or check_spec(spec)[0] != PIPE:
                raise ValueError(f"param_specs {spec}: a stage leaf's spec leads with "
                                 f"{PIPE!r}")
    d = col.axis_index(PIPE, mesh)
    if not is_module and rows not in (1, S):
        raise ValueError(f"stage_params lead with {rows} rows: the whole stack ({S}) or "
                         f"this rank's row (1)")
    s_row = 0 if is_module or rows == 1 else d
    return _pipeline_body(stage_fn, stage_params, s_row, x_mb, aux_mb, generator is not None,
                          mesh, S=S, M=M, V=V, d=d)


def _pipeline_body(stage_fn, stage_params, s_row, x_mb, aux_mb, draws, mesh, *, S, M, V,
                   d):
    """Rank d's ticks (module docstring)."""
    group = mesh.group(PIPE)
    grad = torch.is_grad_enabled()
    if grad and x_mb.requires_grad:
        x_mb = _ToStages.apply(x_mb, group)

    buf = torch.zeros_like(x_mb[0])
    outputs: list = [None] * M
    # what the first tick's output is tied to: the injected input and this
    # rank's smallest stage parameter that requires grad (a backward that
    # asks for the stage parameters' gradients then runs every permute's)
    params = [p for p in (stage_params.parameters() if isinstance(stage_params, torch.nn.Module)
                          else _leaves(stage_params)) if p.requires_grad]
    ties = (([x_mb] if x_mb.requires_grad else [])
            + ([min(params, key=lambda p: p.numel())] if params else [])) if grad else []
    for t, _, v, m, active in (e for e in schedule(S, V, M) if e[1] == d):
        if active:
            inp = buf
            if d == 0 and v == 0:  # inject m; the buffer it replaces stays in the graph
                inp = _Keep.apply(x_mb[m], buf) if grad else x_mb[m]
            args = [_chunk_params(stage_params, s_row, v), inp]
            if aux_mb is not None:
                args.append(tree_map(lambda a: a[m], aux_mb))  # noqa: B023
            if draws:
                args += [m, v * S + d]
            y = (checkpoint(stage_fn, *args, use_reentrant=False, preserve_rng_state=False)
                 if grad else stage_fn(*args))
            if d == S - 1 and v == V - 1:
                outputs[m] = y
        else:
            y = buf
        if t == 0 and ties:
            # every rank's first permute in the graph, after its injected
            # input (its backward the entry's, last on every rank)
            y = _Keep.apply(y, *ties)
        buf = col.ring_permute(y, PIPE, mesh)
    out = torch.stack(outputs) if d == S - 1 else torch.zeros_like(x_mb)
    if ties:
        out = _Keep.apply(out, buf)
    return _FromLastStage.apply(out, group)
