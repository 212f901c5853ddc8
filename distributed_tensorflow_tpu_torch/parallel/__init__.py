"""Data, fully-sharded, tensor, sequence and pipeline parallelism over
``torch.distributed`` — the mesh, cluster, collectives, placement,
spec-engine, ring-attention and pipeline subset of
``distributed_tensorflow_tpu/parallel`` (the pod topology and the
multislice mesh: ROADMAP Queue A item 6d)."""

from . import cluster, collectives, pipeline, sharding  # noqa: F401
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
