"""Plain PyTorch versions of the streaming-update primitives.

Port of ``metrics_tpu/ops/kernels/xla_ref.py`` (the file keeps its reference
twin's name): the masked row fold, the masked segment reduce, the two
whole-arena megastep forms (with the q8 seed decode) and the histogram. They
serve two jobs:

* the path a CPU tensor takes through ``dispatch.py`` (the tests run there);
* the oracle every CUDA kernel is held against on the card (``chip_smoke.py``)
  — int states bit-exact, float states within reassociation tolerance.

Semantics as in the JAX package: masked-out rows contribute the reduction's
identity element; histogram indices follow ``jnp.bincount(x, length=L)`` —
negatives clip to bin 0, indices ``>= length`` drop. Segment ids of masked
rows are never used; an unmasked id outside ``[0, S)`` drops, as the CUDA
kernels and the TPU kernels drop it. (The JAX package's plain ``.at[ids]``
path would wrap a negative unmasked id; no caller passes one.) bf16 sums
accumulate in f32 and round once, as the kernels do.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.kernels.common import REDUCE_OPS, combine, reduce_identity


def fold_rows_ref(state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, fx: str) -> torch.Tensor:
    """Masked row fold: ``combine(state, reduce(where(mask, rows, identity)))``."""
    m = mask.to(torch.bool).reshape((mask.shape[0],) + (1,) * (rows.ndim - 1))
    if fx == "sum":
        red = torch.sum(torch.where(m, rows, torch.zeros_like(rows)), dim=0, dtype=rows.dtype)
        return state + red
    ident = reduce_identity(rows.dtype, fx).to(rows.device)
    if rows.shape[0] == 0:
        red = ident.expand(rows.shape[1:])
    elif fx == "min":
        red = torch.amin(torch.where(m, rows, ident), dim=0)
    else:
        red = torch.amax(torch.where(m, rows, ident), dim=0)
    return torch.minimum(state, red) if fx == "min" else torch.maximum(state, red)


def _segment_reduction(rows: torch.Tensor, ids: torch.Tensor, keep: torch.Tensor, num_segments: int,
                       fx: str) -> torch.Tensor:
    """``fx`` of the kept rows into an identity-filled ``(S, *leaf)`` base."""
    sel, sel_ids = rows[keep], ids[keep]
    shape = (num_segments,) + tuple(rows.shape[1:])
    if fx == "sum":
        acc = torch.float32 if rows.dtype == torch.bfloat16 else rows.dtype
        out = torch.zeros(shape, dtype=acc, device=rows.device).index_add_(0, sel_ids, sel.to(acc))
        return out.to(rows.dtype)
    base = reduce_identity(rows.dtype, fx).to(rows.device).expand(shape).clone()
    if sel.shape[0] == 0:
        return base
    idx = sel_ids.reshape((-1,) + (1,) * (rows.ndim - 1)).expand_as(sel)
    out = base.scatter_reduce(0, idx, sel, reduce="amin" if fx == "min" else "amax", include_self=True)
    if rows.dtype.is_floating_point:  # NaN propagates, as torch.minimum does
        nans = torch.zeros(shape, dtype=torch.int32, device=rows.device)
        nans.index_add_(0, sel_ids, torch.isnan(sel).to(torch.int32))
        out = torch.where(nans > 0, torch.full_like(out, float("nan")), out)
    return out


def _segment_rows(mask: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 ids and the rows that fold: unmasked, with an id in ``[0, S)``."""
    ids = segment_ids.reshape(-1).to(torch.int64)
    keep = mask.reshape(-1).to(torch.bool) & (ids >= 0) & (ids < num_segments)
    return ids, keep


def segment_reduce_ref(
    state: torch.Tensor,
    rows: torch.Tensor,
    mask: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    fx: str,
) -> torch.Tensor:
    """Masked segment reduce: ``combine(state, fx of each segment's rows)``."""
    ids, keep = _segment_rows(mask, segment_ids, num_segments)
    return combine(state, _segment_reduction(rows, ids, keep, num_segments, fx), fx)


def _op_select(op_row: torch.Tensor, state: torch.Tensor, reds: dict) -> torch.Tensor:
    """Per-column combine select for the megastep forms (op 0=sum 1=min 2=max);
    ``reds`` holds the reduction of each op the row uses."""
    op = op_row.reshape(1, -1).to(state.device)
    out = state
    for i, fx in enumerate(REDUCE_OPS):
        if fx in reds:
            out = torch.where(op == i, combine(state, reds[fx], fx), out)
    return out


def _ops_used(op_row: torch.Tensor) -> list:
    return [REDUCE_OPS[int(i)] for i in torch.unique(op_row.reshape(-1)).tolist()]


def megastep_fold_ref(state2d: torch.Tensor, rows2d: torch.Tensor, mask: torch.Tensor,
                      op_row: torch.Tensor) -> torch.Tensor:
    """Whole-arena masked row fold with PER-COLUMN reductions: every column of
    the packed ``(N, F)`` delta matrix folds into the ``(1, F)`` arena row
    under its own opcode (the one-segment case of :func:`megastep_segment_ref`)."""
    ids = torch.zeros(rows2d.shape[0], dtype=torch.int64, device=rows2d.device)
    return megastep_segment_ref(state2d, rows2d, mask, ids, 1, op_row)


def megastep_segment_ref(
    state2d: torch.Tensor,
    rows2d: torch.Tensor,
    mask: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op_row: torch.Tensor,
    q8=None,
) -> torch.Tensor:
    """Whole-arena masked segment reduce with per-column reductions; with
    ``q8 = (flags, codes, scales, qcol)`` the flagged slots' quantized columns
    are decoded first (``f32(codes) * scales``, cast to the state's dtype) —
    the same decode-on-touch the kernel's seed performs."""
    if q8 is not None:
        flags, codes, scales, qcol = q8
        staged = (flags.reshape(-1, 1) != 0) & (qcol.reshape(1, -1) != 0)
        dec = (codes.to(torch.float32) * scales.to(torch.float32)).to(state2d.dtype)
        state2d = torch.where(staged.to(state2d.device), dec, state2d)
    ids, keep = _segment_rows(mask, segment_ids, num_segments)
    reds = {fx: _segment_reduction(rows2d, ids, keep, num_segments, fx) for fx in _ops_used(op_row)}
    return _op_select(op_row, state2d, reds)


def histogram_ref(
    indices: torch.Tensor,
    length: int,
    weights: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted/masked fixed-length bincount with ``jnp.bincount`` semantics.

    ``weights`` None → int32 counts; ``weights`` ``(N,)`` or ``(N, K)`` →
    per-column weighted sums, shape ``(length,)`` or ``(length, K)``, in the
    weights' dtype.
    """
    idx = indices.to(torch.int64).clamp(min=0)
    keep = idx < length
    if mask is not None:
        keep = keep & mask.to(torch.bool)
    if weights is None:
        out = torch.zeros(length, dtype=torch.int32, device=idx.device)
        return out.index_add_(0, idx[keep], torch.ones_like(idx[keep], dtype=torch.int32))
    out = torch.zeros((length,) + tuple(weights.shape[1:]), dtype=weights.dtype, device=idx.device)
    return out.index_add_(0, idx[keep], weights[keep])
