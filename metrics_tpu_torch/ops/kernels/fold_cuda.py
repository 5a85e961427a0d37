"""K1: the CUDA masked row fold, and its plain version beside it.

Replaces ``metrics_tpu/ops/kernels/pallas_fold.py::fold_rows_pallas``. The
kernel (``csrc/fold.cu``) is one launch over column tiles x row chunks, the
chunks of a tile one thread-block cluster: each chunk folds its rows with
16-byte loads, and the cluster's first block folds the chunks' values in a
fixed order through distributed shared memory, because Hopper's thread blocks
do not run in sequence the way the TPU grid does. It is bound by bytes: the
unmasked rows are read once. :func:`fold_rows_cuda` is the wrapper; the plain
version is :func:`fold_rows_plain` (``xla_ref.fold_rows_ref``). The same
kernel, with a per-column op row, is K5 (``megastep_cuda``), which launches it
through :func:`launch_fold`.
"""
from typing import Optional

import torch

from metrics_tpu_torch.ops.kernels import build
from metrics_tpu_torch.ops.kernels.common import REDUCE_OPS
from metrics_tpu_torch.ops.kernels.segment_cuda import DTYPE_CODE, check_inputs
from metrics_tpu_torch.ops.kernels.xla_ref import fold_rows_ref as fold_rows_plain

__all__ = ["fold_rows_cuda", "fold_rows_plain"]


def fold_rows_cuda(state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, fx: str) -> torch.Tensor:
    """``(F,) state ⊕ masked-reduce((N, F) rows)`` on the card.

    ``mask`` is ``(N,)`` int32 0/1; ``state`` and ``rows`` share one of f32,
    bf16 or int32 and lie, with ``mask``, contiguous on one CUDA device.
    Returns a new ``(F,)`` tensor. Raises on anything else.
    """
    if fx not in REDUCE_OPS:
        raise ValueError(f"fold_rows_cuda supports {REDUCE_OPS}, got {fx!r}")
    if state.ndim != 1:
        raise ValueError(f"fold_rows_cuda: expected an (F,) state, got {tuple(state.shape)}")
    check_inputs("fold_rows_cuda", state.unsqueeze(0), rows, mask)  # a view: strides are checked as given
    out = launch_fold("fold_rows", state, rows, mask, REDUCE_OPS.index(fx))
    fold_rows_cuda.launches += 1
    return out


def launch_fold(name: str, state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, uniform: int,
                ops: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/fold.cu::fold_rows`` on checked ``(F,)`` state, ``(N, F)``
    rows and ``(N,)`` int32 mask; returns the new ``(F,)`` state. ``uniform``
    is an index into ``REDUCE_OPS``, or 3 (mixed): then ``ops`` is the
    ``(F,)`` int32 op row."""
    n, f = rows.shape
    dev = state.device
    out = torch.empty_like(state)
    lib = build.library("fold")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fold_rows(state.data_ptr(), rows.data_ptr(), mask.data_ptr(),
                            None if ops is None else ops.data_ptr(), out.data_ptr(), n, f,
                            DTYPE_CODE[state.dtype], uniform, stream)
    build.check(err, f"{name} launch")
    return out


#: launches of the K1 kernel since the count was last set to 0
fold_rows_cuda.launches = 0
