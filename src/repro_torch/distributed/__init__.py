"""Device meshes (the port of ``repro.distributed``): ``MeshSpec``, the
time-mesh resolution of ``method="distributed"`` and the record-axis split
of the estimation system; the GPipe schedule over a ``pipe`` axis
(:mod:`.pipeline`); the bf16 all-reduce with float32 error feedback of a
data-parallel step (:mod:`.grad_compress`)."""
from . import grad_compress, pipeline, sharding
from .grad_compress import (
    compressed_psum,
    init_error_state,
    make_compressed_dp_step,
)
from .pipeline import pipeline_forward
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
    "compressed_psum",
    "data_parallel_size",
    "default_devices",
    "device_scope",
    "grad_compress",
    "init_error_state",
    "make_compressed_dp_step",
    "mesh_context",
    "mesh_fingerprint",
    "pipeline",
    "pipeline_forward",
    "resolve_time_mesh",
    "shard_over_batch",
    "sharding",
]
