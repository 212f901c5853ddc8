"""Data parallelism over ``torch.distributed`` — the mesh, cluster,
collectives and batch-placement subset of ``distributed_tensorflow_tpu/
parallel`` (pipeline, ring attention, sharding rule tables: ROADMAP
Queue A items 3.1 and 6)."""

from . import cluster, collectives, sharding  # noqa: F401
from .mesh import (  # noqa: F401
    AXIS_NAMES,
    BATCH_AXES,
    Mesh,
    MeshSpec,
    build_mesh,
    describe,
    mesh_axis_size,
    rescale_for_world,
)
