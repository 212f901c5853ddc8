"""Device mesh and named axes — the port's counterpart of
``distributed_tensorflow_tpu/parallel/mesh.py``.

The JAX package names six axes of parallelism (outermost first): ``pipe``,
``data``, ``fsdp``, ``seq``, ``expert``, ``model``; every axis is always
present and unused axes have size 1. The port runs one process per card
and maps the six names onto the dimensions of a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group (``parallel/cluster.py`` starts it); a collective over an axis runs
over that dimension's process group (``parallel/collectives.py``).

With one process and no process group the mesh is the one device, and
every collective over it is the identity, as JAX's ``psum`` over a size-1
axis is. ``data`` and ``fsdp`` may exceed 1 (the batch split over
``BATCH_AXES``, the gradients and the BatchNorm statistics all-reduced
over them; a rule table may shard parameters over ``fsdp``), and so may
``model``, over which a rule table shards parameters (embedding tables,
megatron tensor parallelism: ``parallel/sharding.py``; the runner
refuses a workload that places nothing there), and ``seq``, over which
attention splits the sequence (``parallel/ring_attention.py``; no
parameter is sharded over it, and the runner refuses it for a model
without ``seq_impl``), and ``pipe``, over which the pipeline's stages
split a transformer's layers (``parallel/pipeline.py``); ``expert``
above 1 (item 6c) and the DCN factors of a multislice mesh (item 6d)
raise with their ROADMAP item. A
collective over several axes of the mesh together
(``BATCH_AXES`` on a data x fsdp x model mesh) runs over a process group
of those axes' ranks, made when the mesh is built.
``PodTopology`` and ``factor_mesh_axis`` are not ported (ROADMAP Queue A
item 6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

from ..utils.device import resolve_device

#: canonical axis order, outermost -> innermost
AXIS_NAMES: tuple[str, ...] = ("pipe", "data", "fsdp", "seq", "expert", "model")

PIPE, DATA, FSDP, SEQ, EXPERT, MODEL = AXIS_NAMES

#: axes over which a batch is split; gradients and BatchNorm statistics
#: are summed over them
BATCH_AXES: tuple[str, ...] = (DATA, FSDP)

#: what brings each of the axes not ported yet past 1 (ROADMAP Queue A)
_NOT_PORTED = {
    EXPERT: "expert parallelism, item 6c (ops/moe.py)",
}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; ``-1`` on at most one axis absorbs the rest.
    ``dcn_data``/``dcn_pipe`` are the JAX package's multislice factors
    (an axis's total is its ICI part times its DCN part); the port takes
    them only at 1."""

    pipe: int = 1
    data: int = -1  # default: every process does data parallelism
    fsdp: int = 1
    seq: int = 1
    expert: int = 1
    model: int = 1
    dcn_data: int = 1
    dcn_pipe: int = 1

    def sizes(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in AXIS_NAMES}

    def dcn_sizes(self) -> dict[str, int]:
        return {PIPE: self.dcn_pipe, DATA: self.dcn_data, FSDP: 1, SEQ: 1, EXPERT: 1,
                MODEL: 1}

    @property
    def num_slices(self) -> int:
        return self.dcn_data * self.dcn_pipe

    def resolve(self, n_devices: int) -> "MeshSpec":
        """Fill in the single -1 axis so the product equals ``n_devices``."""
        sizes = self.sizes()
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"At most one axis may be -1, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes product "
                                 f"{fixed} ({sizes})")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"Mesh {sizes} needs {fixed} devices but {n_devices} are "
                             f"available (an axis at -1 takes what there is, e.g. "
                             f"--mesh.data=-1)")
        out = MeshSpec(**sizes, dcn_data=self.dcn_data, dcn_pipe=self.dcn_pipe)
        for name, dcn in out.dcn_sizes().items():
            if dcn > 1 and out.sizes()[name] % dcn != 0:
                raise ValueError(f"axis {name}={out.sizes()[name]} not divisible by its "
                                 f"DCN factor dcn_{name}={dcn}")
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, int]) -> "MeshSpec":
        valid = set(AXIS_NAMES) | {"dcn_data", "dcn_pipe"}
        unknown = set(d) - valid
        if unknown:
            raise ValueError(f"Unknown mesh axes {unknown}; valid: {sorted(valid)}")
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The six named axes over this process's card: ``shape`` maps every
    axis name to its size, ``device`` is this process's device, and
    ``device_mesh`` is the ``DeviceMesh`` over the process group (None
    with no process group: one process, every axis 1)."""

    shape: Mapping[str, int]
    device: torch.device
    device_mesh: object = None  # torch.distributed.device_mesh.DeviceMesh
    #: the process groups of sets of two or more axes above 1 that are not
    #: all of them, keyed by the axes in ``AXIS_NAMES`` order
    subgroups: Mapping = dataclasses.field(default_factory=dict)

    axis_names = AXIS_NAMES

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axes: str | Sequence[str]):
        """The process group of ``axes`` (a name or a tuple of names), or
        None where their product is 1 (a collective over them is then the
        identity). Several axes above 1 together: every axis of the mesh
        above 1 is the default group, a part of them the subgroup made for
        them (``build_mesh``); either way the ranks are numbered as the
        axes flatten in ``AXIS_NAMES`` order."""
        import torch.distributed as dist

        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"mesh has no axis {unknown}: {AXIS_NAMES}")
        big = [a for a in axes if self.shape[a] > 1]
        if not big:
            return None
        if len(big) > 1:
            if set(big) == {a for a, v in self.shape.items() if v > 1}:
                return dist.group.WORLD
            return self.subgroups[tuple(a for a in AXIS_NAMES if a in big)]
        return self.device_mesh.get_group(big[0])


def build_mesh(spec: MeshSpec | Mapping[str, int] | None = None, device="cuda") -> Mesh:
    """The mesh of ``spec`` over the processes of the default process
    group (one process per card; one process, no group: the one device),
    on ``device`` (the card by default, this process's current one when
    no index is given; raises without a card unless ``device="cpu"``)."""
    import torch.distributed as dist

    spec = spec if isinstance(spec, MeshSpec) else MeshSpec.from_dict(spec or {})
    grouped = dist.is_available() and dist.is_initialized()
    spec = spec.resolve(dist.get_world_size() if grouped else 1)
    if spec.num_slices > 1:
        raise NotImplementedError(
            f"dcn_data={spec.dcn_data} dcn_pipe={spec.dcn_pipe}: multislice meshes are not "
            f"ported yet (ROADMAP Queue A item 6d)")
    big = {a: v for a, v in spec.sizes().items() if v > 1 and a in _NOT_PORTED}
    if big:
        raise NotImplementedError(
            f"mesh {big}: only the pipe, data, fsdp, seq and model axes may exceed 1 in the "
            f"port so far; " + "; ".join(f"{a}: {_NOT_PORTED[a]}" for a in big) + " (ROADMAP Queue A)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    device_mesh, subgroups = None, {}
    if grouped:
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(dev.type, tuple(spec.sizes().values()),
                                       mesh_dim_names=AXIS_NAMES)
        subgroups = _subgroups(spec.sizes())
    return Mesh(spec.sizes(), dev, device_mesh, subgroups)


def _subgroups(sizes: Mapping[str, int]) -> dict:
    """A process group for each set of two or more axes above 1 that is not
    all of them: this rank's, of the ranks that share its index on every
    other axis. Every rank makes every group, in one order (``new_group``
    is collective)."""
    import itertools

    import numpy as np
    import torch.distributed as dist

    big = [a for a in AXIS_NAMES if sizes[a] > 1]
    ranks = np.arange(math.prod(sizes.values())).reshape([sizes[a] for a in AXIS_NAMES])
    me, out = dist.get_rank(), {}
    for n in range(2, len(big)):
        for axes in itertools.combinations(big, n):
            keep = [AXIS_NAMES.index(a) for a in axes]
            blocks = np.moveaxis(ranks, keep, list(range(len(AXIS_NAMES) - len(keep),
                                                         len(AXIS_NAMES))))
            for block in blocks.reshape(-1, math.prod(sizes[a] for a in axes)):
                group = dist.new_group([int(r) for r in block])
                if me in block:
                    out[axes] = group
    return out


def mesh_axis_size(mesh: Mesh, axes: str | Sequence[str]) -> int:
    """Product of the named axis sizes (e.g. the number of batch shards)."""
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def rescale_for_world(spec: MeshSpec, old_world: int, new_world: int) -> MeshSpec:
    """Respec a mesh for an elastic resize of the worker count from
    ``old_world`` to ``new_world``: only a batch axis may absorb it
    (``data == -1`` passes through; else the first of ``data``, ``fsdp``
    whose extent scales integrally). Anything else raises."""
    if old_world < 1 or new_world < 1:
        raise ValueError("old_world and new_world must be >= 1")
    if new_world == old_world or spec.data == -1:
        return spec
    for axis in (DATA, FSDP):
        scaled = getattr(spec, axis) * new_world
        if scaled % old_world == 0 and scaled >= old_world:
            return dataclasses.replace(spec, **{axis: scaled // old_world})
    raise ValueError(
        f"neither batch axis scales by {new_world}/{old_world} (data={spec.data}, "
        f"fsdp={spec.fsdp}): the resized extent would not be integral — use data=-1 so "
        f"the batch axis absorbs the surviving devices, or pick a fleet size dividing a "
        f"batch-axis extent")


def describe(mesh: Mesh) -> str:
    """One line, e.g. 'pipe=1 data=4 fsdp=1 seq=1 expert=1 model=1 (4 devices, cuda)'."""
    parts = " ".join(f"{a}={mesh.shape[a]}" for a in AXIS_NAMES)
    return f"{parts} ({mesh.size} devices, {mesh.device.type})"
