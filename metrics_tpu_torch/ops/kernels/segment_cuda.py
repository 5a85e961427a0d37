"""K4: the CUDA masked segment reduce, its plain version beside it, and the
launcher the megastep segment forms (K6, K7) share with it.

Replaces ``metrics_tpu/ops/kernels/pallas_segment.py::segment_reduce_pallas``.
The kernel (``csrc/segment.cu``) is bound by bytes (rows read once, the
``(S, F)`` state read and written once) and runs in two launches. Pass 0, one
block of 1024 threads, reads ids and mask once and sorts the row indices by
segment (a stable counting sort: each warp counts a contiguous range of rows
into a ``(segment, warp)`` table that the whole block scans; masked rows and
out-of-range ids drop, their ids never used as addresses), and cuts every
segment of more than 64 rows into 64-row chunks. Pass 1 gives every
``(segment, 128-column tile)`` one block: a short segment is folded in row
order straight into the output, an untouched one copied through, and a long
one (the engines' one-stream step puts every row in one segment) is folded
by one block per chunk into partials that the tile's last block to finish
folds in chunk order. One writer per cell, no float atomics: float sums are
the same on every run. It takes every S and F: the TPU's VMEM gates
(``block_rows``, the ``num_segments * f * itemsize`` test) have no
counterpart. The kernel allocates nothing: the wrapper sizes one int32
scratch buffer with ``segment_scratch_ints``. :func:`segment_reduce_cuda` is
the wrapper; the plain version is :func:`segment_reduce_plain`
(``xla_ref.segment_reduce_ref``).
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.kernels import build
from metrics_tpu_torch.ops.kernels.common import REDUCE_OPS
from metrics_tpu_torch.ops.kernels.xla_ref import segment_reduce_ref as segment_reduce_plain

__all__ = ["segment_reduce_cuda", "segment_reduce_plain"]

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
MIXED = 3  # the kernels' code for an op row that is not uniform


def check_inputs(name: str, state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                 ids: Optional[torch.Tensor] = None) -> None:
    """Raise unless ``state`` ``(S, F)`` and ``rows`` ``(N, F)`` share a kernel
    dtype and, with ``mask`` (and ``ids``) ``(N,)`` int32, lie contiguous on
    one CUDA device."""
    dev = state.device
    tensors = [state, rows, mask] + ([] if ids is None else [ids])
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every input must lie on one CUDA device")
    if state.dtype not in DTYPE_CODE or rows.dtype != state.dtype:
        raise TypeError(f"{name} takes f32, bf16 or int32 rows of the state's dtype, got "
                        f"{rows.dtype} rows for a {state.dtype} state")
    if mask.dtype != torch.int32 or (ids is not None and ids.dtype != torch.int32):
        raise TypeError(f"{name}: mask and segment ids must be int32")
    n = rows.shape[0] if rows.ndim == 2 else -1
    if (state.ndim != 2 or rows.ndim != 2 or rows.shape[1] != state.shape[1] or state.shape[1] == 0
            or any(t.ndim != 1 or t.shape[0] != n for t in tensors[2:])):
        raise ValueError(f"{name}: expected state (S, F), rows (N, F) and (N,) mask/ids, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def launch_segment_fold(name: str, state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                        ids: torch.Tensor, uniform: int, ops: Optional[torch.Tensor] = None,
                        q8: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """Launch ``csrc/segment.cu::segment_fold`` on checked inputs; returns the
    new ``(S, F)`` state. ``uniform`` is an index into ``REDUCE_OPS`` or
    :data:`MIXED` (then ``ops`` is the ``(F,)`` int32 op row); ``q8`` is
    ``(flags (S,) int32, codes (S, F) int8, scales (S, F) f32, qcol (F,) int32)``."""
    s, f = state.shape
    n = rows.shape[0]
    dev = state.device
    lib = build.library("segment")
    scratch = torch.empty(lib.segment_scratch_ints(n, s, f), dtype=torch.int32, device=dev)
    out = torch.empty_like(state)
    flags, codes, scales, qcol = q8 if q8 is not None else (None, None, None, None)

    def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_fold(state.data_ptr(), rows.data_ptr(), ids.data_ptr(), mask.data_ptr(), ptr(ops),
                               ptr(flags), ptr(codes), ptr(scales), ptr(qcol), scratch.data_ptr(),
                               out.data_ptr(), n, f, s, DTYPE_CODE[state.dtype], uniform, stream)
    build.check(err, f"{name} launch")
    return out


def segment_reduce_cuda(state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                        segment_ids: torch.Tensor, fx: str) -> torch.Tensor:
    """``(S, F) state ⊕ fx`` of the ``(N, F)`` rows into the segments their
    ``(N,)`` int32 ids address, on the card. ``mask`` is ``(N,)`` int32 0/1;
    masked rows and unmasked ids outside ``[0, S)`` fold into nothing. Returns
    a new ``(S, F)`` tensor. Raises on anything else."""
    if fx not in REDUCE_OPS:
        raise ValueError(f"segment_reduce_cuda supports {REDUCE_OPS}, got {fx!r}")
    check_inputs("segment_reduce_cuda", state, rows, mask, segment_ids)
    out = launch_segment_fold("segment_reduce", state, rows, mask, segment_ids, REDUCE_OPS.index(fx))
    segment_reduce_cuda.launches += 1
    return out


#: launches of the K4 kernel since the count was last set to 0
segment_reduce_cuda.launches = 0
