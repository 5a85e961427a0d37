"""State synchronisation (port of ``metrics_tpu/parallel``): the collectives
and the fused sync bundle with its q8 carrier, over a ``torch.distributed``
process group or over the shards of an in-process device mesh; the mesh
(``MeshConfig``); the mesh engine's step builders and the sharded
embedded-model forwards; the ambient sync group."""
from metrics_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_gather_stack,
    axis_size_or_one,
    class_reduce,
    fused_axis_sync,
    in_mapped_context,
    reduce,
    sync_axis_state,
)
from metrics_tpu_torch.parallel.embedded import (
    data_parallel_mesh,
    pipeline_stage_forward,
    shard_batch_forward,
    sharded_masked_step,
    stem_tensor_batch_forward,
)
from metrics_tpu_torch.parallel.mesh import Mesh, MeshConfig, current_metric_axis, metric_axis, set_metric_axis

__all__ = [
    "Mesh",
    "MeshConfig",
    "all_gather_cat",
    "all_gather_stack",
    "axis_size_or_one",
    "class_reduce",
    "current_metric_axis",
    "data_parallel_mesh",
    "fused_axis_sync",
    "in_mapped_context",
    "metric_axis",
    "pipeline_stage_forward",
    "reduce",
    "set_metric_axis",
    "shard_batch_forward",
    "sharded_masked_step",
    "stem_tensor_batch_forward",
    "sync_axis_state",
]
