"""Cross-process state sync over ``torch.distributed`` (port of
``metrics_tpu/parallel``): the collectives, the fused sync bundle with its
q8 carrier, and the ambient sync group."""
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
from metrics_tpu_torch.parallel.mesh import current_metric_axis, metric_axis, set_metric_axis

__all__ = [
    "all_gather_cat",
    "all_gather_stack",
    "axis_size_or_one",
    "class_reduce",
    "current_metric_axis",
    "fused_axis_sync",
    "in_mapped_context",
    "metric_axis",
    "reduce",
    "set_metric_axis",
    "sync_axis_state",
]
