"""Device meshes (the port of ``repro.distributed``): ``MeshSpec``, the
time-mesh resolution of ``method="distributed"`` and the record-axis split
of the estimation system; the language models' logical sharding rules
(``choose_pspec``, ``NamedSharding``); their execution on a single-controller
mesh (:mod:`.spmd`: ``ShardedTensor``, the collectives and their log); the
GPipe schedule over a ``pipe`` axis (:mod:`.pipeline`); the bf16
all-reduce with float32 error feedback of a data-parallel step
(:mod:`.grad_compress`)."""
from . import grad_compress, pipeline, sharding, spmd
from .grad_compress import (
    compressed_psum,
    init_error_state,
    make_compressed_dp_step,
)
from .pipeline import pipeline_forward
from .sharding import (
    BATCH_AXES,
    MODEL_PRIORITY,
    SEQ_AXES,
    Mesh,
    MeshSpec,
    NamedSharding,
    PartitionSpec,
    active_mesh,
    as_mesh,
    canonical_device,
    choose_pspec,
    data_parallel_size,
    default_devices,
    device_scope,
    logical_constraint,
    mesh_context,
    mesh_fingerprint,
    named_sharding,
    resolve_time_mesh,
    shard_over_batch,
    tree_pspecs,
    tree_shardings,
)
from .spmd import CollectiveLog, ShardedTensor, device_put, gather

__all__ = [
    "BATCH_AXES",
    "CollectiveLog",
    "MODEL_PRIORITY",
    "Mesh",
    "MeshSpec",
    "NamedSharding",
    "PartitionSpec",
    "SEQ_AXES",
    "ShardedTensor",
    "active_mesh",
    "as_mesh",
    "canonical_device",
    "choose_pspec",
    "compressed_psum",
    "data_parallel_size",
    "default_devices",
    "device_put",
    "device_scope",
    "gather",
    "grad_compress",
    "init_error_state",
    "logical_constraint",
    "make_compressed_dp_step",
    "mesh_context",
    "mesh_fingerprint",
    "named_sharding",
    "pipeline",
    "pipeline_forward",
    "resolve_time_mesh",
    "shard_over_batch",
    "sharding",
    "spmd",
    "tree_pspecs",
    "tree_shardings",
]
