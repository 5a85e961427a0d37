"""K5, K6 and K7: the CUDA whole-arena megastep kernels, and their plain
versions beside them.

Replace ``metrics_tpu/ops/kernels/pallas_megastep.py``: one launch folds every
leaf of one arena dtype, each column under its own reduction (the ``(F,)``
int32 op row: 0 sum, 1 min, 2 max; a uniform row takes a body without the
per-column select).

* K5 :func:`megastep_fold_cuda` (``megastep_fold_pallas``): the ``(F,)`` arena
  of the single-stream engine, K1's kernel (``csrc/fold.cu``: one launch over
  column tiles x row chunks, each tile's chunks one cluster folding their
  values in a fixed order) given the op row.
* K6 :func:`megastep_segment_cuda` (``_mega_segment_kernel``): the paged
  engine's ``(S, F)`` slot-stacked arena, ``csrc/segment.cu`` (K4's sort and
  one-writer-per-cell fold) with the op row.
* K7 :func:`megastep_segment_q8_cuda` (``_mega_segment_q8_kernel``): K6 whose
  seed first decodes the flagged slots' quantized columns,
  ``f32(codes) * scales`` cast to the arena dtype, bit-identical to the host
  codec (``engine/quantize.py::_decode_blocks``). It decodes every flagged
  slot, touched or not, also when no row arrives.

All three are bound by bytes. The plain versions are
:func:`megastep_fold_plain` and :func:`megastep_segment_plain`
(``xla_ref.megastep_*_ref``).
"""
from typing import Optional

import torch

from metrics_tpu_torch.ops.kernels.common import REDUCE_OPS
from metrics_tpu_torch.ops.kernels.fold_cuda import launch_fold
from metrics_tpu_torch.ops.kernels.segment_cuda import MIXED, check_inputs, launch_segment_fold
from metrics_tpu_torch.ops.kernels.xla_ref import megastep_fold_ref, megastep_segment_ref

__all__ = [
    "megastep_fold_cuda",
    "megastep_fold_plain",
    "megastep_segment_cuda",
    "megastep_segment_plain",
    "megastep_segment_q8_cuda",
]

def _uniform_code(uniform: Optional[str]) -> int:
    if uniform is None:
        return MIXED
    if uniform not in REDUCE_OPS:
        raise ValueError(f"uniform op must be one of {REDUCE_OPS} or None, got {uniform!r}")
    return REDUCE_OPS.index(uniform)


def _check_ops(name: str, ops: torch.Tensor, state: torch.Tensor) -> None:
    if ops.device != state.device or ops.dtype != torch.int32 or ops.shape != (state.shape[-1],) \
            or not ops.is_contiguous():
        raise ValueError(f"{name}: the op row must be a contiguous ({state.shape[-1]},) int32 tensor "
                         f"on {state.device}")


def megastep_fold_cuda(state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, ops: torch.Tensor,
                       uniform: Optional[str]) -> torch.Tensor:
    """K5: ``(F,) arena ⊕`` each column's op over the unmasked ``(N, F)`` rows.

    ``mask`` is ``(N,)`` int32 0/1, ``ops`` the ``(F,)`` int32 op row and
    ``uniform`` the op every column shares (None: per-column). Returns a new
    ``(F,)`` tensor. Raises on anything the kernel does not take."""
    if state.ndim != 1:
        raise ValueError(f"megastep_fold_cuda: expected an (F,) arena, got {tuple(state.shape)}")
    check_inputs("megastep_fold_cuda", state.unsqueeze(0), rows, mask)  # a view: strides are checked as given
    _check_ops("megastep_fold_cuda", ops, state)
    out = launch_fold("megastep_fold", state, rows, mask, _uniform_code(uniform), ops)
    megastep_fold_cuda.launches += 1
    return out


def megastep_segment_cuda(state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                          segment_ids: torch.Tensor, ops: torch.Tensor, uniform: Optional[str]) -> torch.Tensor:
    """K6: ``(S, F) arena ⊕`` each column's op over the rows each ``(N,)``
    int32 segment id addresses (masked rows and ids outside ``[0, S)`` fold
    into nothing). Returns a new ``(S, F)`` tensor."""
    check_inputs("megastep_segment_cuda", state, rows, mask, segment_ids)
    _check_ops("megastep_segment_cuda", ops, state)
    out = launch_segment_fold("megastep_segment", state, rows, mask, segment_ids, _uniform_code(uniform), ops)
    megastep_segment_cuda.launches += 1
    return out


def megastep_segment_q8_cuda(state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                             segment_ids: torch.Tensor, ops: torch.Tensor, uniform: Optional[str],
                             flags: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                             qcol: torch.Tensor) -> torch.Tensor:
    """K7: K6 on a seed whose flagged slots (``flags`` ``(S,)`` int32 != 0)
    hold ``f32(codes) * scales`` in their quantized columns (``qcol`` ``(F,)``
    int32 != 0); ``codes`` ``(S, F)`` int8, ``scales`` ``(S, F)`` f32. Float
    arenas only. Returns a new ``(S, F)`` tensor."""
    check_inputs("megastep_segment_q8_cuda", state, rows, mask, segment_ids)
    _check_ops("megastep_segment_q8_cuda", ops, state)
    if state.dtype == torch.int32:
        raise TypeError("megastep_segment_q8_cuda decodes into float arenas only (q8 quantizes float sums)")
    s, f = state.shape
    want = ((flags, torch.int32, (s,)), (codes, torch.int8, (s, f)), (scales, torch.float32, (s, f)),
            (qcol, torch.int32, (f,)))
    for t, dtype, shape in want:
        if t.device != state.device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"megastep_segment_q8_cuda: expected contiguous {dtype} {shape} q8 inputs on "
                             f"{state.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = launch_segment_fold("megastep_segment_q8", state, rows, mask, segment_ids, _uniform_code(uniform), ops,
                              (flags, codes, scales, qcol))
    megastep_segment_q8_cuda.launches += 1
    return out


def megastep_fold_plain(state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, ops: torch.Tensor,
                        uniform: Optional[str] = None) -> torch.Tensor:
    """K5's function in plain PyTorch (``uniform`` is implied by ``ops``)."""
    return megastep_fold_ref(state.reshape(1, -1), rows, mask, ops).reshape(state.shape)


def megastep_segment_plain(state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                           segment_ids: torch.Tensor, ops: torch.Tensor, uniform: Optional[str] = None,
                           q8=None) -> torch.Tensor:
    """K6's (and, with ``q8``, K7's) function in plain PyTorch."""
    return megastep_segment_ref(state, rows, mask, segment_ids, state.shape[0], ops, q8)


#: launches of the K5, K6 and K7 kernels since each count was last set to 0
megastep_fold_cuda.launches = 0
megastep_segment_cuda.launches = 0
megastep_segment_q8_cuda.launches = 0
