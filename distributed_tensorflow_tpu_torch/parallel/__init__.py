"""Data, fully-sharded, tensor and sequence parallelism over
``torch.distributed`` — the mesh, cluster, collectives, placement,
spec-engine and ring-attention subset of ``distributed_tensorflow_tpu/
parallel`` (the pipeline and the stacked stage specs: ROADMAP Queue A
item 6)."""

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
