"""Streaming-update kernel library: hand-written CUDA kernels for Hopper, each
with a plain PyTorch version beside it, behind a dispatcher that picks by the
tensor's device (port of ``metrics_tpu/ops/kernels``)."""
from metrics_tpu_torch.ops.kernels.common import REDUCE_OPS, combine, reduce_identity, stack_reduce, supported_dtype
from metrics_tpu_torch.ops.kernels.dispatch import (
    fold_rows_masked,
    histogram_accumulate,
    kernel_fault_scope,
    megastep_fold,
    megastep_segment,
    segment_reduce_masked,
)
from metrics_tpu_torch.ops.kernels.xla_ref import (
    fold_rows_ref,
    histogram_ref,
    megastep_fold_ref,
    megastep_segment_ref,
    segment_reduce_ref,
)

__all__ = [
    "REDUCE_OPS",
    "combine",
    "fold_rows_masked",
    "fold_rows_ref",
    "histogram_accumulate",
    "histogram_ref",
    "kernel_fault_scope",
    "megastep_fold",
    "megastep_fold_ref",
    "megastep_segment",
    "megastep_segment_ref",
    "reduce_identity",
    "segment_reduce_masked",
    "segment_reduce_ref",
    "stack_reduce",
    "supported_dtype",
]
