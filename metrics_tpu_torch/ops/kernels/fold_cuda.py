"""K1: the CUDA masked row fold, and its plain version beside it.

Replaces ``metrics_tpu/ops/kernels/pallas_fold.py::fold_rows_pallas``. The
kernel (``csrc/fold.cu``) is two deterministic passes, column tiles x row
chunks into partials and then one ordered fold per column, because Hopper's
thread blocks do not run in sequence the way the TPU grid does. It is bound by
bytes: the rows are read once. :func:`fold_rows_cuda` is the wrapper; the plain
version is :func:`fold_rows_plain` (``xla_ref.fold_rows_ref``).
"""
import torch

from metrics_tpu_torch.ops.kernels import build
from metrics_tpu_torch.ops.kernels.common import REDUCE_OPS
from metrics_tpu_torch.ops.kernels.xla_ref import fold_rows_ref as fold_rows_plain

__all__ = ["fold_rows_cuda", "fold_rows_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_ROW_CHUNK = 64  # rows per pass-1 block: 16 chunks x 32 column tiles at (1024, 1000)


def fold_rows_cuda(state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, fx: str) -> torch.Tensor:
    """``(F,) state ⊕ masked-reduce((N, F) rows)`` on the card.

    ``mask`` is ``(N,)`` int32 0/1; ``state`` and ``rows`` share one of f32,
    bf16 or int32 and lie, with ``mask``, contiguous on one CUDA device.
    Returns a new ``(F,)`` tensor. Raises on anything else.
    """
    if fx not in REDUCE_OPS:
        raise ValueError(f"fold_rows_cuda supports {REDUCE_OPS}, got {fx!r}")
    dev = state.device
    if dev.type != "cuda" or rows.device != dev or mask.device != dev:
        raise ValueError("fold_rows_cuda: state, rows and mask must lie on one CUDA device")
    if state.dtype not in _DTYPE_CODE or rows.dtype != state.dtype:
        raise TypeError(f"fold_rows_cuda takes f32, bf16 or int32 rows of the state's dtype, got "
                        f"{rows.dtype} rows for a {state.dtype} state")
    if mask.dtype != torch.int32:
        raise TypeError(f"fold_rows_cuda: mask must be int32, got {mask.dtype}")
    if state.ndim != 1 or rows.ndim != 2 or mask.ndim != 1:
        raise ValueError("fold_rows_cuda: expected state (F,), rows (N, F) and mask (N,)")
    n, f = rows.shape
    if f != state.shape[0] or mask.shape[0] != n or f == 0:
        raise ValueError(f"fold_rows_cuda: shapes do not agree: state {tuple(state.shape)}, "
                         f"rows {tuple(rows.shape)}, mask {tuple(mask.shape)}")
    if not (state.is_contiguous() and rows.is_contiguous() and mask.is_contiguous()):
        raise ValueError("fold_rows_cuda: inputs must be contiguous")
    lib = build.library("fold")
    acc_dtype = torch.int32 if state.dtype == torch.int32 else torch.float32
    chunks = -(-n // _ROW_CHUNK)
    partials = torch.empty((max(chunks, 1), f), dtype=acc_dtype, device=dev)
    out = torch.empty_like(state)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fold_rows(state.data_ptr(), rows.data_ptr(), mask.data_ptr(), partials.data_ptr(),
                            out.data_ptr(), n, f, _ROW_CHUNK, _DTYPE_CODE[state.dtype],
                            REDUCE_OPS.index(fx), stream)
    build.check(err, "fold_rows launch")
    fold_rows_cuda.launches += 1
    return out


#: launches of the K1 kernel since the count was last set to 0
fold_rows_cuda.launches = 0
