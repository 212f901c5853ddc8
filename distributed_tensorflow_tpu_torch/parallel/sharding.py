"""Batch placement, parameter placement and the partition-rule engine —
a subset of ``distributed_tensorflow_tpu/parallel/sharding.py``.

``batch_spec``'s meaning: dim 0 of a batch is split over ``BATCH_AXES``
in rank order, so rank r of R holds rows ``[r·B/R, (r+1)·B/R)`` of the
global batch of B rows — the row order JAX's ``P(("data",))`` gives.

**The rule engine** (``PartitionRules``, ``partition_rules``,
``match_partition_rules``, ``attribute_partition_rules``,
``format_attribution``): a named, ordered table of ``(regex, spec)``
rows, matched with ``re.search`` against a parameter's path, first match
wins; a table is total (every parameter matches a row) and live (every
row matches a parameter), else ``PartitionCoverageError`` with the full
attribution listing. A path is the port's parameter name with ``/`` for
``.`` (``deep_0.weight`` -> ``deep_0/weight``: the JAX package's regexes
read the port's names). A spec is a tuple of mesh axis names (or None),
one entry a leading dim: ``()`` is replicated.

**Placement** (``check_spec``, ``shard_tensor``, ``place``,
``gather_tensor``): a spec gives each dim of a tensor at most one of the
axes ``pipe``, ``fsdp`` and ``model`` (or None), and no axis twice. Along a dim
sharded over an axis of n ranks, rank r holds rows ``[r·rows,
(r+1)·rows)`` of the dim padded with zeros to ``n·rows`` (``rows =
shard_vocab(size, n)``, ``ops/embedding.py``): the contiguous slice GSPMD
gives, the vocabulary's range shards padded as ``shard_vocab`` pads. ``()``
is whole on every rank. ``place`` sets each tensor to the value of the
rank that holds the same shard at index 0 of every other axis;
``gather_tensor`` reassembles a whole tensor from the shards. ``pipe``
shards the leading (stage) dim of a pipeline-stacked leaf alone
(``stacked_stage_specs``: ``[S, (V,) layers, ...]``, ``model`` beside it
under PP×TP); a pipelined model's own parameters are its stage's rows of
those leaves, whose specs are ``StageSpec``s: ``place`` broadcasts them
over every other axis but ``pipe``, and the optimizer's ``Layout`` counts
them once a stage. A spec naming ``expert`` (MoE) is ROADMAP Queue
A item 6c; ``data`` and ``seq`` never shard a parameter (the JAX package
puts none on them: ``seq`` splits attention's sequence).

**The spec engine** (JAX ``init_train_state``'s order): the table's specs
(``specs_from_rules``), then, with ``fsdp``, ``auto_fsdp_specs`` merged in
by ``merge_specs`` (an explicit spec wins unless it is ``()``; a leaf with
a ``model`` spec keeps it even at ``model=1``, so pure FSDP shards only
the leaves the table replicates). These take the JAX package's paths and
shapes (``jax_view``: a model may map its names onto the flax tree's,
``Dense`` weights transposed), so that the same leaves shard along the
same dims; ``param_specs`` then gives each port parameter its spec in
its own layout. JAX's ``opt_state_specs`` rule — an optimizer's state
shards with its parameter — is ``train/optimizers.state_layout``, where
the port's optimizer keeps its state.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

from .collectives import all_gather, axis_index, axis_size, broadcast
from .mesh import AXIS_NAMES, BATCH_AXES, DATA, FSDP, MODEL, PIPE, SEQ, Mesh

#: a spec: one entry a leading dim, each a mesh axis name, a tuple of
#: names or None
Spec = tuple
#: replicated on every rank
REPLICATED: Spec = ()
#: the conventional last row of a total table: the rest is replicated
CATCH_ALL = r".*"
#: a table range-sharded over ``model`` (module docstring)
MODEL_ROWS: Spec = (MODEL, None)
#: the axes a parameter may be sharded over
PARAM_AXES: tuple[str, ...] = (FSDP, MODEL)


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


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's value on
    every rank (after ``init_params``, so that each replica starts from
    the same weights): ``place`` with every tensor replicated. Returns
    ``module``."""
    return place(module, mesh)


def spec_axes(spec: Spec) -> tuple[str, ...]:
    """The mesh axes ``spec`` names, in dim order."""
    out: list[str] = []
    for e in spec:
        out.extend((e,) if isinstance(e, str) else (e or ()))
    return tuple(out)


def check_spec(spec: Spec, name: str = "") -> Spec:
    """``spec`` if the port can place it (module docstring), else raise:
    ``expert`` naming ROADMAP item 6c, ``pipe`` on any dim but the leading
    one, ``data`` and ``seq`` because no parameter is sharded over them."""
    spec = tuple(spec)
    what = name or "a tensor"
    axes = spec_axes(spec)
    later = [a for a in axes if a not in PARAM_AXES and a not in (DATA, SEQ, PIPE)]
    if later:
        raise NotImplementedError(
            f"{what}: spec {spec} shards over {later}: MoE's expert axis is ROADMAP Queue A "
            f"item 6c")
    if PIPE in axes and spec[0] != PIPE:
        raise ValueError(f"{what}: spec {spec}: {PIPE!r} shards the leading (stage) dim of "
                         f"a pipeline-stacked leaf alone (stacked_stage_specs)")
    if DATA in axes:
        raise ValueError(f"{what}: spec {spec}: no parameter is sharded over the batch "
                         f"axis {DATA!r}")
    if SEQ in axes:
        raise ValueError(f"{what}: spec {spec}: no parameter is sharded over {SEQ!r}, "
                         f"which splits the sequence of attention alone (every {SEQ} rank "
                         f"holds every parameter, as in the JAX package)")
    if len(set(axes)) != len(axes) or any(isinstance(e, tuple) and len(e) > 1 for e in spec):
        raise NotImplementedError(f"{what}: spec {spec}: the port shards a dim over at most "
                                  f"one of {(PIPE, *PARAM_AXES)}, and each axis over one dim")
    return spec


def stacked_stage_specs(shapes: Mapping[str, tuple], *, col: str | None = None,
                        row: str | None = None, path=None) -> dict[str, Spec]:
    """The specs of a pipeline-stacked tree (JAX's ``stacked_stage_specs``):
    every leaf's leading (stage) dim over ``pipe``, the stacking dims
    (``[S, (V,) layers]``) and the rest whole. ``col`` / ``row``: path
    regexes of megatron's column- and row-parallel leaves, whose last /
    second-to-last dim of the JAX layout is sharded over ``model``.
    ``shapes``: name -> stacked shape; ``path(name) -> (flax path,
    transposed)`` names a leaf's JAX path and whether its last two dims
    are the flax layout's reversed (a ``Dense`` weight ``[out, in]``),
    whose spec entries are then swapped into the port's layout."""
    col_rx = re.compile(col) if col else None
    row_rx = re.compile(row) if row else None
    out = {}
    for name, shape in shapes.items():
        jpath, transposed = path(name) if path is not None else (param_path(name), False)
        spec = [PIPE] + [None] * (len(shape) - 1)
        if col_rx is not None and col_rx.search(jpath):
            spec[-1] = MODEL
        elif row_rx is not None and row_rx.search(jpath):
            spec[-2] = MODEL
        if transposed:
            spec[-2], spec[-1] = spec[-1], spec[-2]
        out[name] = check_spec(tuple(spec), name)
    return out


class StageSpec(tuple):
    """The spec of a pipeline stage's own tensor: its placement over the
    other axes (a spec, ``model`` under PP×TP), the tensor this ``pipe``
    rank's alone — its row of a stacked ``[S, ...]`` leaf — and not a copy
    or a shard of one that the other ``pipe`` ranks hold."""


def _dims(spec: Spec) -> list[tuple[int, str]]:
    """``(dim, axis)`` of each sharded dim."""
    out = []
    for d, e in enumerate(spec):
        e = e[0] if isinstance(e, tuple) and e else e
        if isinstance(e, str):
            out.append((d, e))
    return out


def local_shape(shape, spec: Spec, mesh: Mesh) -> tuple[int, ...]:
    """This rank's shard's shape of a tensor of ``shape`` (padded rows
    included)."""
    from ..ops.embedding import shard_vocab

    out = list(shape)
    for d, a in _dims(check_spec(spec)):
        out[d] = shard_vocab(shape[d], mesh.shape[a])
    return tuple(out)


def shard_tensor(full: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``full`` (module docstring):
    a copy, zero-padded where a dim does not divide."""
    from ..ops.embedding import shard_vocab

    t = full
    for d, a in _dims(check_spec(spec)):
        n, r = mesh.shape[a], axis_index(a, mesh)
        rows = shard_vocab(full.shape[d], n)
        lo, hi = min(r * rows, full.shape[d]), min((r + 1) * rows, full.shape[d])
        part = t.narrow(d, lo, hi - lo)
        if hi - lo < rows:
            pad = list(part.shape)
            pad[d] = rows - (hi - lo)
            part = torch.cat([part, part.new_zeros(pad)], d)
        t = part
    return t.clone(memory_format=torch.contiguous_format)


@torch.no_grad()
def gather_tensor(local: torch.Tensor, spec: Spec, mesh: Mesh, shape) -> torch.Tensor:
    """The whole tensor of ``shape`` reassembled from the ranks' shards
    (every rank of each sharding axis takes part; the padding dropped)."""
    t = local
    for d, a in _dims(check_spec(spec)):
        t = all_gather(t, a, mesh, tiled_axis=d).narrow(d, 0, shape[d])
    return t.contiguous()


def assemble(shards: Sequence[torch.Tensor], spec: Spec, sizes: Mapping[str, int],
             shape) -> torch.Tensor:
    """The whole tensor of ``shape`` from every rank's shard (``shards`` in
    rank order over a mesh of axis ``sizes``; no process group): the
    shards along each sharded dim concatenated, the padding cut."""
    ranks = np.arange(len(shards)).reshape([sizes[a] for a in AXIS_NAMES])

    def rec(fixed: dict, dims: list) -> torch.Tensor:
        if not dims:
            at = tuple(fixed.get(a, 0) for a in AXIS_NAMES)
            return shards[int(ranks[at])]
        (d, a), rest = dims[0], dims[1:]
        parts = [rec({**fixed, a: j}, rest) for j in range(sizes[a])]
        return torch.cat(parts, d).narrow(d, 0, shape[d])

    return rec({}, [(d, a) for d, a in _dims(check_spec(spec)) if sizes[a] > 1]).clone()


@torch.no_grad()
def place(module: torch.nn.Module, mesh: Mesh,
          specs: Mapping[str, Spec] | None = None) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` (which holds this rank's
    shard of each sharded tensor) set to the value of the rank that holds
    the same shard at index 0 of every other axis (module docstring); not
    in ``specs``: replicated. A pipeline stage's own tensor (a
    ``StageSpec``) is not broadcast over ``pipe``. Returns ``module``."""
    specs = specs or {}
    for name, t in [*module.named_parameters(), *module.named_buffers()]:
        spec = specs.get(name, REPLICATED)
        held = {*spec_axes(check_spec(spec, name)),
                *((PIPE,) if isinstance(spec, StageSpec) else ())}
        # the ranks that hold this shard: every axis it is not sharded over
        t.copy_(broadcast(t, tuple(a for a in AXIS_NAMES if a not in held), mesh, src=0))
    return module


# -- the spec engine (JAX train/step.py init_train_state) -------------------


def replicated_specs(tree) -> dict[str, Spec]:
    """``()`` for every name of ``tree`` (a module, a mapping or names)."""
    return {n: REPLICATED for n in _names(tree)}


def merge_specs(explicit: Mapping[str, Spec], auto: Mapping[str, Spec]) -> dict[str, Spec]:
    """Per leaf: the explicit spec unless it is replicated, where ``auto``
    fills in (JAX's ``merge_specs``)."""
    return {n: auto[n] if tuple(e) == REPLICATED else tuple(e) for n, e in explicit.items()}


def auto_fsdp_specs(shapes: Mapping[str, tuple], mesh: Mesh, *,
                    min_size: int = 2**14) -> dict[str, Spec]:
    """ZeRO-style automatic sharding (JAX's ``auto_fsdp_specs``): each
    leaf of at least ``min_size`` elements sharded over ``fsdp`` along its
    largest dim that the ``fsdp`` size divides (the first such, on a tie);
    the rest replicated. ``shapes``: name -> shape (the JAX layout's, for
    the JAX package's choice of dim)."""
    n = mesh.shape[FSDP]
    out: dict[str, Spec] = {}
    for name, shape in shapes.items():
        size = int(np.prod(shape)) if len(shape) else 1
        fit = [d for d in range(len(shape)) if shape[d] % n == 0]
        if n == 1 or size < min_size or not fit:
            out[name] = REPLICATED
            continue
        best = max(fit, key=lambda d: shape[d])
        spec = [None] * len(shape)
        spec[best] = FSDP
        out[name] = tuple(spec)
    return out


def specs_from_rules(tree, rules: "PartitionRules") -> dict[str, Spec]:
    """The table's spec of every parameter of ``tree`` under the strict
    contract (``match_partition_rules``)."""
    return match_partition_rules(rules, tree)


def param_specs(model: torch.nn.Module, rules: "PartitionRules", mesh: Mesh
                ) -> dict[str, Spec]:
    """Each parameter of ``model`` (its whole shapes: a model on ``meta``
    will do) to its spec in the port's layout, as JAX's
    ``init_train_state`` computes them with ``fsdp=True``: the rules, then
    ``auto_fsdp_specs`` merged. A model with ``jax_view(name) -> (path,
    jax_shape, transposed)`` is matched and auto-sharded on the JAX tree's
    paths and shapes, and a transposed leaf's spec reversed into the port's
    layout."""
    params = dict(model.named_parameters())
    view = getattr(model, "jax_view", None) or (
        lambda n: (param_path(n), tuple(params[n].shape), False))
    jax = {n: view(n) for n in params}
    specs = merge_specs(specs_from_rules(model, rules),
                        auto_fsdp_specs({n: jax[n][1] for n in params}, mesh))
    out = {}
    for n in params:
        spec = tuple(specs[n])
        if jax[n][2] and spec:
            spec = tuple(reversed(spec + (None,) * (len(jax[n][1]) - len(spec))))
        out[n] = check_spec(spec, n)
    return out


def param_path(name: str) -> str:
    """The rule-table path of a port parameter name: ``/`` for ``.``."""
    return name.replace(".", "/")


# -- the partition-rule engine ---------------------------------------------


class PartitionCoverageError(ValueError):
    """A table failed its totality/liveness contract: some parameter
    matched no row, or some row matched no parameter. The message carries
    the full attribution listing."""


@dataclasses.dataclass(frozen=True)
class PartitionRow:
    """One row. ``tag`` marks a variant-conditional row:
    ``PartitionRules.select`` keeps untagged rows and the selected tags'."""

    pattern: str
    spec: Spec
    tag: str | None = None


@dataclasses.dataclass(frozen=True)
class RuleMatch:
    """Which row won a path (first match); ``rule_index`` -1 (``pattern``
    and ``spec`` None) for an unmatched path."""

    path: str
    rule_index: int
    pattern: str | None
    spec: Spec | None


@dataclasses.dataclass(frozen=True)
class PartitionRules:
    """A named, ordered table. ``coverage`` is its static path fixture
    (every path of the trees it serves, over all variants): construction
    checks the table against it."""

    name: str
    rows: tuple[PartitionRow, ...]
    coverage: tuple[str, ...] = ()

    def select(self, *tags: str) -> "PartitionRules":
        """Variant view: untagged rows plus those tagged with any of
        ``tags``, in order; the derived table drops the union coverage."""
        keep = tuple(r for r in self.rows if r.tag is None or r.tag in tags)
        suffix = "+".join(sorted(tags))
        return PartitionRules(name=f"{self.name}[{suffix}]" if suffix else self.name,
                              rows=keep)

    def as_path_rules(self) -> tuple[tuple[str, Spec], ...]:
        """The rows as ``(pattern, spec)`` pairs."""
        return tuple((r.pattern, r.spec) for r in self.rows)


def _is_spec(spec) -> bool:
    def entry(e):
        return e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))

    return isinstance(spec, tuple) and all(entry(e) for e in spec)


def partition_rules(name: str, rules: Sequence[tuple], *,
                    coverage: Sequence[str] = ()) -> PartitionRules:
    """Build and validate a table from ``(pattern, spec[, tag])`` rows:
    every pattern must compile and every spec be a tuple of axis names;
    with ``coverage`` the totality/liveness contract is checked here."""
    built: list[PartitionRow] = []
    for i, row in enumerate(rules):
        if len(row) not in (2, 3):
            raise ValueError(f"partition_rules({name!r}): row {i} must be "
                             f"(pattern, spec[, tag]), got {row!r}")
        pattern, spec = row[0], row[1]
        try:
            re.compile(pattern)
        except re.error as e:
            raise ValueError(f"partition_rules({name!r}): row {i} pattern {pattern!r} does "
                             f"not compile: {e}") from e
        if not _is_spec(spec):
            raise ValueError(f"partition_rules({name!r}): row {i} spec must be a tuple of "
                             f"mesh axis names, got {spec!r}")
        built.append(PartitionRow(pattern, spec, row[2] if len(row) == 3 else None))
    table = PartitionRules(name, tuple(built), tuple(coverage))
    if table.coverage:
        _check_coverage(table, table.coverage)
    return table


def _attribute_paths(rows: Sequence[PartitionRow], paths: Iterable[str]) -> list[RuleMatch]:
    compiled = [re.compile(r.pattern) for r in rows]
    out: list[RuleMatch] = []
    for path in paths:
        for i, rx in enumerate(compiled):
            if rx.search(path):
                out.append(RuleMatch(path, i, rows[i].pattern, rows[i].spec))
                break
        else:
            out.append(RuleMatch(path, -1, None, None))
    return out


def format_attribution(table: PartitionRules, matches: Sequence[RuleMatch]) -> str:
    """One line a path (the winning row, its pattern and spec, or
    UNMATCHED), then a line for each dead row."""
    won = {m.rule_index for m in matches if m.rule_index >= 0}
    lines = [f"table {table.name!r}: {len(table.rows)} rule(s), {len(matches)} param(s)"]
    for m in matches:
        lines.append(f"  {m.path}  <-  UNMATCHED" if m.rule_index < 0 else
                     f"  {m.path}  <-  rule[{m.rule_index}] {m.pattern!r} -> {m.spec}")
    for i, row in enumerate(table.rows):
        if i not in won:
            lines.append(f"  rule[{i}] {row.pattern!r} -> {row.spec}  DEAD (matched no param)")
    return "\n".join(lines)


def _coverage_violations(table: PartitionRules, paths: Sequence[str]
                         ) -> tuple[list[RuleMatch], list[str], list[int]]:
    """(matches, unmatched paths, dead row indices)."""
    matches = _attribute_paths(table.rows, paths)
    unmatched = [m.path for m in matches if m.rule_index < 0]
    won = {m.rule_index for m in matches if m.rule_index >= 0}
    return matches, unmatched, [i for i in range(len(table.rows)) if i not in won]


def _check_coverage(table: PartitionRules, paths: Sequence[str]) -> None:
    matches, unmatched, dead = _coverage_violations(table, paths)
    if unmatched or dead:
        raise PartitionCoverageError(
            f"partition rules table {table.name!r} violates its coverage contract: "
            f"{len(unmatched)} unmatched param(s), {len(dead)} dead rule(s).\n"
            + format_attribution(table, matches))


def _names(tree) -> list[str]:
    """Parameter names of a module, or the keys of a mapping, or the
    strings of an iterable."""
    if isinstance(tree, torch.nn.Module):
        return [n for n, _ in tree.named_parameters()]
    return list(tree)


def attribute_partition_rules(rules: "PartitionRules | Sequence[tuple[str, Spec]]",
                              tree) -> list[RuleMatch]:
    """First-match attribution of every path of ``tree`` (a module, a
    mapping by name or names); never raises on coverage gaps."""
    rows = (rules.rows if isinstance(rules, PartitionRules)
            else tuple(PartitionRow(p, s) for p, s in rules))
    return _attribute_paths(rows, [param_path(n) for n in _names(tree)])


def match_partition_rules(table: PartitionRules, tree) -> dict[str, Spec]:
    """``{name: spec}`` for every parameter of ``tree`` (a module, a
    mapping by name or names), with the hard contract: every parameter
    matches a row and every row a parameter, else
    ``PartitionCoverageError`` with the full attribution listing. A
    module's ``jax_view`` names its parameters' paths (``param_specs``);
    the specs are the table's, in the JAX layout."""
    names = _names(tree)
    view = getattr(tree, "jax_view", None)
    return _match(table, names, {n: view(n)[0] if view is not None else param_path(n)
                                 for n in names})


def _match(table: PartitionRules, names: Sequence[str], paths: Mapping[str, str]
           ) -> dict[str, Spec]:
    matches, unmatched, dead = _coverage_violations(table, [paths[n] for n in names])
    if unmatched or dead:
        raise PartitionCoverageError(
            f"partition rules table {table.name!r} does not cover this param tree: "
            f"{len(unmatched)} unmatched param(s), {len(dead)} dead rule(s). Add/repair rows "
            f"(a final (sharding.CATCH_ALL, sharding.REPLICATED) row declares the replicated "
            f"remainder) or fix the variant selection.\n" + format_attribution(table, matches))
    return {n: m.spec for n, m in zip(names, matches)}


def sharded_axes(specs: Mapping[str, Spec]) -> set[str]:
    """The mesh axes any spec of ``specs`` shards a tensor over."""
    out: set[str] = set()
    for spec in specs.values():
        for e in spec:
            out.update((e,) if isinstance(e, str) else (e or ()))
    return out
