"""Device meshes for the estimation system (the port of the estimation
part of ``repro.distributed``): ``MeshSpec``, the time-mesh resolution of
``method="distributed"`` and the record-axis split."""
from . import sharding
from .sharding import (
    Mesh,
    MeshSpec,
    active_mesh,
    as_mesh,
    canonical_device,
    data_parallel_size,
    default_devices,
    device_scope,
    mesh_context,
    mesh_fingerprint,
    resolve_time_mesh,
    shard_over_batch,
)

__all__ = [
    "Mesh",
    "MeshSpec",
    "active_mesh",
    "as_mesh",
    "canonical_device",
    "data_parallel_size",
    "default_devices",
    "device_scope",
    "mesh_context",
    "mesh_fingerprint",
    "resolve_time_mesh",
    "shard_over_batch",
    "sharding",
]
