"""Data, fully-sharded and tensor parallelism over ``torch.distributed``
— the mesh, cluster, collectives, placement and spec-engine subset of
``distributed_tensorflow_tpu/parallel`` (the pipeline, ring attention
and the stacked stage specs: ROADMAP Queue A item 6)."""

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
