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

**Placement** (``place``): the port honours two specs. ``()``: the
tensor is whole on every rank, set to rank 0's value over every axis.
``("model", None)``: a table whose rows are range-sharded over the
``model`` axis — rank r holds rows ``[r·rows, (r+1)·rows)`` of the table
padded to ``n·shard_vocab(V, n)`` (``ops/embedding.py``), the layout
GSPMD gives ``P("model", None)`` — set to the value of the rank with the
same ``model`` index and batch index 0. Any other spec raises: fsdp and
tensor parallelism, ``auto_fsdp_specs``, ``opt_state_specs`` and the
stacked stage specs are ROADMAP Queue A item 3.1.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

from .collectives import axis_index, axis_size, broadcast
from .mesh import AXIS_NAMES, BATCH_AXES, MODEL, Mesh

#: a spec: one entry a leading dim, each a mesh axis name, a tuple of
#: names or None
Spec = tuple
#: replicated on every rank
REPLICATED: Spec = ()
#: the conventional last row of a total table: the rest is replicated
CATCH_ALL = r".*"
#: the one sharded placement the port honours (module docstring)
MODEL_ROWS: Spec = (MODEL, None)


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


def check_spec(spec: Spec, name: str = "") -> Spec:
    """``spec`` if the port can place it (module docstring), else raise
    naming ROADMAP item 3.1."""
    spec = tuple(spec)
    if spec not in (REPLICATED, MODEL_ROWS):
        raise NotImplementedError(
            f"{name or 'a tensor'}: spec {spec} is not placeable in the port; it honours "
            f"{REPLICATED} (replicated) and {MODEL_ROWS} (tables range-sharded over model) — "
            f"fsdp and tensor parallelism are ROADMAP Queue A item 3.1")
    return spec


@torch.no_grad()
def place(module: torch.nn.Module, mesh: Mesh,
          specs: Mapping[str, Spec] | None = None) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` (which holds this rank's
    shard of each sharded tensor) set to its source rank's value: the
    replicated ones (not in ``specs``, or ``()``) to rank 0's over every
    axis, the ``("model", None)`` ones to batch index 0's over the batch
    axes (module docstring). Returns ``module``."""
    specs = specs or {}
    for name, t in [*module.named_parameters(), *module.named_buffers()]:
        spec = check_spec(specs.get(name, REPLICATED), name)
        t.copy_(broadcast(t, AXIS_NAMES if spec == REPLICATED else BATCH_AXES, mesh, src=0))
    return module


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
    ``PartitionCoverageError`` with the full attribution listing."""
    names = _names(tree)
    matches, unmatched, dead = _coverage_violations(table, [param_path(n) for n in names])
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
