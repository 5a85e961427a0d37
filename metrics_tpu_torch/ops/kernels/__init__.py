"""Streaming-update kernel library: hand-written CUDA kernels for Hopper, each
with a plain PyTorch version beside it, behind a dispatcher that picks by the
tensor's device (port of ``metrics_tpu/ops/kernels``)."""
from metrics_tpu_torch.ops.kernels.common import REDUCE_OPS, combine, reduce_identity, supported_dtype
from metrics_tpu_torch.ops.kernels.dispatch import fold_rows_masked, histogram_accumulate
from metrics_tpu_torch.ops.kernels.xla_ref import fold_rows_ref, histogram_ref

__all__ = [
    "REDUCE_OPS",
    "combine",
    "fold_rows_masked",
    "fold_rows_ref",
    "histogram_accumulate",
    "histogram_ref",
    "reduce_identity",
    "supported_dtype",
]
