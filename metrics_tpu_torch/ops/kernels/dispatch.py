"""Device dispatch for the streaming-update primitives.

Port of ``metrics_tpu/ops/kernels/dispatch.py``, with the same semantics
and the JAX signatures minus ``backend``:

* :func:`fold_rows_masked` — fused masked row-delta reduction
  (``Metric.update_state_masked``, delta strategy), kernel K1;
* :func:`segment_reduce_masked` — masked segment sum/min/max
  (``Metric.update_state_segmented``, the unsharded ``MultiStreamEngine``), K4;
* :func:`megastep_fold` / :func:`megastep_segment` — the whole-arena
  megastep forms (``engine/megastep.py``), K5 and K6, and K7 when ``q8``
  stages cold slots for decode-on-touch;
* :func:`histogram_accumulate` — masked/weighted fixed-length bincount
  (``utils/data.py::_bincount``, the confusion-matrix family), K2.

The choice between kernel and plain version is made by the tensor's device
and by nothing else: a CUDA tensor takes the hand-written kernel (and the call
raises if the kernel cannot take it), a CPU tensor takes the plain version.
There is no fallback from a failed kernel. The JAX dispatcher's backend names
(``pallas_interpret``, ``megastep*``, ``use_backend``) and its TPU gates have
no counterpart here: the CUDA histogram covers every length and counts in
int32, so neither ``MAX_HIST_LENGTH`` nor ``_HIST_EXACT_ROWS`` applies, and no
kernel needs VMEM block sizing: the segment kernels take every S and F, so the
``block_rows``/``VMEM_BLOCK_BYTES``/``num_segments * f * itemsize`` gates are
gone too.

:func:`kernel_fault_scope` installs a thread-local hook that each entry
calls with its kernel's name, on every device, before it dispatches; a raise
propagates (the JAX package's ``pallas_interpret`` policy: its silent
fallback under ``pallas`` has no counterpart here).

A uint32 state (``BootStrapper``'s draw counter) folds as its int32 bits
(``common.int32_bits``), with the sign bit flipped in its min/max columns:
torch has no uint32 arithmetic kernels, and neither do the CUDA kernels.
"""
import contextlib
import math
import threading
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from metrics_tpu_torch.ops.kernels.common import REDUCE_OPS, SIGN_BIT, as_2d_rows, int32_bits, uint32_from_bits
from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda
from metrics_tpu_torch.ops.kernels.hist_cuda import INDEX_DTYPES, MASK_DTYPES, WEIGHT_DTYPES, histogram_op
from metrics_tpu_torch.ops.kernels.megastep_cuda import (
    megastep_fold_cuda,
    megastep_segment_cuda,
    megastep_segment_q8_cuda,
)
from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda
from metrics_tpu_torch.ops.kernels.xla_ref import (
    fold_rows_ref,
    megastep_fold_ref,
    megastep_segment_ref,
    segment_reduce_ref,
)


_tls = threading.local()


def _maybe_kernel_fault(kernel: str) -> None:
    """Call this thread's kernel fault hook, if one is installed, with the
    kernel's name (``fold_rows``, ``segment_reduce``, ``megastep_fold``,
    ``megastep_segment``, ``histogram``, ``binned_counts``)."""
    hook = getattr(_tls, "fault_hook", None)
    if hook is not None:
        hook(kernel)


@contextlib.contextmanager
def kernel_fault_scope(hook: Optional[Callable[[str], None]]) -> Iterator[None]:
    """Install a thread-local kernel fault hook: ``hook(kernel_name)`` runs
    before every entry of the dispatch functions (and of
    ``ops/binned_update.py``'s ``binned_counts``) in this scope, on every
    device, and may raise to simulate a kernel failure.

    A raise propagates to the caller. This is the JAX package's
    ``pallas_interpret`` policy; its silent fallback to the reference lowering
    under ``pallas`` has no counterpart in the port, where nothing falls back
    from a kernel. Under a CUDA graph capture the hook runs once, while the
    step is captured (the warm-up that precedes it calls it; the recorded
    pass does not), as JAX's runs once at trace time: a replay never calls
    it. Distinct from the engine's ``kernel`` fault site, which demotes a
    whole engine ``megastep -> auto``."""
    prev = getattr(_tls, "fault_hook", None)
    _tls.fault_hook = hook
    try:
        yield
    finally:
        _tls.fault_hook = prev


def fold_rows_masked(state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, fx: str) -> torch.Tensor:
    """Fused masked row-delta reduction.

    ``rows`` is the row-stacked delta ``(N, *leaf)``, ``state`` the carried
    leaf ``(*leaf)``, ``mask`` ``(N,)``; rows where ``mask`` is False
    contribute the reduction identity. Returns the new leaf.
    """
    if fx not in REDUCE_OPS:
        raise ValueError(f"fold_rows_masked supports {REDUCE_OPS}, got {fx!r}")
    rows = rows.to(state.dtype)
    if state.dtype == torch.uint32:
        flip = None if fx == "sum" else SIGN_BIT
        return uint32_from_bits(fold_rows_masked(int32_bits(state, flip), int32_bits(rows, flip), mask, fx), flip)
    _maybe_kernel_fault("fold_rows")
    if state.device.type != "cuda":
        return fold_rows_ref(state, rows, mask, fx)
    n = int(rows.shape[0])
    rows2d, trailing = as_2d_rows(rows, n)
    mask_i32 = mask.to(device=state.device, dtype=torch.int32).reshape(n).contiguous()
    out = fold_rows_cuda(state.reshape(-1).contiguous(), rows2d.contiguous(), mask_i32, fx)
    return out.reshape(trailing)


def _as_i32(x: torch.Tensor, n: int, device: torch.device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).reshape(n).contiguous()


def segment_reduce_masked(
    state: torch.Tensor,
    rows: torch.Tensor,
    mask: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    fx: str,
) -> torch.Tensor:
    """Masked segment sum/min/max: each row folds into the stream row
    addressed by ``segment_ids`` (masked rows fold into nothing).

    ``state`` is stream-stacked ``(num_segments, *leaf)``; returns its
    updated value.
    """
    if fx not in REDUCE_OPS:
        raise ValueError(f"segment_reduce_masked supports {REDUCE_OPS}, got {fx!r}")
    rows = rows.to(state.dtype)
    if state.dtype == torch.uint32:
        flip = None if fx == "sum" else SIGN_BIT
        out = segment_reduce_masked(int32_bits(state, flip), int32_bits(rows, flip), mask, segment_ids,
                                    num_segments, fx)
        return uint32_from_bits(out, flip)
    _maybe_kernel_fault("segment_reduce")
    if state.device.type != "cuda":
        return segment_reduce_ref(state, rows, mask, segment_ids, num_segments, fx)
    n = int(rows.shape[0])
    if n == 0:
        return state
    rows2d, trailing = as_2d_rows(rows, n)
    f = int(rows2d.shape[1])
    out = segment_reduce_cuda(state.reshape(num_segments, f).contiguous(), rows2d.contiguous(),
                              _as_i32(mask, n, state.device), _as_i32(segment_ids, n, state.device), fx)
    return out.reshape((num_segments,) + trailing)


class OpRow(NamedTuple):
    """A canonical opcode row: the ``(f,)`` int32 tensor on the arena's device
    and the reduction every column shares (None: per-column)."""

    ops: torch.Tensor
    uniform: Optional[str]


def _op_row_info(op_row, f: int, device: torch.device) -> OpRow:
    """Canonicalize a HOST opcode row (static plan metadata,
    ``engine/megastep.py``): the ``(f,)`` int32 tensor on ``device`` plus the
    shared reduction name when every column agrees (the kernels then skip the
    per-column select). An :class:`OpRow` passes through, so a plan
    canonicalizes its rows once and not on every step."""
    if isinstance(op_row, OpRow):
        if tuple(op_row.ops.shape) != (f,) or op_row.ops.device != device:
            raise ValueError(f"opcode row {tuple(op_row.ops.shape)} on {op_row.ops.device} does not fit an "
                             f"arena of {f} columns on {device}")
        return op_row
    op_np = np.asarray(op_row, np.int32).reshape(-1)
    if op_np.shape[0] != f:
        raise ValueError(f"opcode row has {op_np.shape[0]} columns, arena has {f}")
    uniq = {int(x) for x in np.unique(op_np)} if op_np.size else {0}
    if not uniq <= {0, 1, 2}:
        raise ValueError(f"megastep opcodes must index {REDUCE_OPS}, got {sorted(uniq)}")
    uniform = REDUCE_OPS[next(iter(uniq))] if len(uniq) == 1 else None
    return OpRow(torch.from_numpy(op_np.copy()).to(device), uniform)


def _order_flip(op_row: OpRow):
    """What :func:`~metrics_tpu_torch.ops.kernels.common.int32_bits` XORs into
    a uint32 buffer under ``op_row``: nothing for sum columns, the sign bit
    for min/max columns."""
    if op_row.uniform == "sum":
        return None
    if op_row.uniform is not None:
        return SIGN_BIT
    return (op_row.ops != 0).to(torch.int32) * SIGN_BIT


def megastep_fold(state_buf: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, op_row) -> torch.Tensor:
    """Whole-arena masked fold: ONE launch folds every leaf of a dtype.

    ``state_buf`` is a packed arena buffer ``(F,)`` (every same-dtype leaf
    raveled and concatenated, per :class:`~metrics_tpu_torch.engine.arena
    .ArenaLayout`), ``rows`` the column-aligned packed row deltas ``(N, F)``,
    ``mask`` ``(N,)``, and ``op_row`` a HOST ``(F,)`` int32 opcode row (each
    column's reduction, indices into ``REDUCE_OPS``) or the :class:`OpRow`
    :func:`_op_row_info` made of one. Returns the new buffer.
    """
    rows = rows.to(state_buf.dtype)
    n = int(rows.shape[0])
    if n == 0:
        return state_buf
    f = int(rows.shape[1])
    ops, uniform = _op_row_info(op_row, f, state_buf.device)
    if state_buf.dtype == torch.uint32:
        row = OpRow(ops, uniform)
        flip = _order_flip(row)
        return uint32_from_bits(megastep_fold(int32_bits(state_buf, flip), int32_bits(rows, flip), mask, row), flip)
    _maybe_kernel_fault("megastep_fold")
    if state_buf.device.type != "cuda":
        return megastep_fold_ref(state_buf.reshape(1, f), rows, mask, ops).reshape(state_buf.shape)
    out = megastep_fold_cuda(state_buf.reshape(f).contiguous(), rows.contiguous(),
                             _as_i32(mask, n, state_buf.device), ops, uniform)
    return out.reshape(state_buf.shape)


def megastep_segment(
    state_buf: torch.Tensor,
    rows: torch.Tensor,
    mask: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op_row,
    q8=None,
) -> torch.Tensor:
    """Whole-arena masked segment reduce: one launch scatters every leaf of a
    dtype into the addressed stream slots.

    ``state_buf`` is the slot-stacked arena buffer ``(S, F)`` (pager slot ids
    ARE the segment ids), ``rows`` the packed deltas ``(N, F)``, ``op_row``
    the per-column opcode row (host, or an :class:`OpRow`). ``q8``, when
    given, is ``(flags (S,), codes (S, F) int8, scales (S, F) f32, qcol (F,)
    bool or int32, host or on the arena's device)`` — q8-resident cold slots
    whose quantized columns decode on touch inside the kernel (and inside the
    plain version alike, also on a step without rows).
    """
    rows = rows.to(state_buf.dtype)
    n = int(rows.shape[0])
    f = int(state_buf.shape[-1])
    dev = state_buf.device
    ops, uniform = _op_row_info(op_row, f, dev)
    if state_buf.dtype == torch.uint32:  # never quantized: only float columns are
        row = OpRow(ops, uniform)
        flip = _order_flip(row)
        out = megastep_segment(int32_bits(state_buf, flip), int32_bits(rows, flip), mask, segment_ids,
                               num_segments, row)
        return uint32_from_bits(out, flip)
    _maybe_kernel_fault("megastep_segment")
    q8c = None
    if q8 is not None:
        flags, codes, scales, qcol = q8
        if not isinstance(qcol, torch.Tensor):
            qcol = torch.from_numpy(np.asarray(qcol, bool))
        q8c = (
            _as_i32(flags, num_segments, dev),
            torch.as_tensor(codes).to(device=dev, dtype=torch.int8).contiguous(),
            torch.as_tensor(scales).to(device=dev, dtype=torch.float32).contiguous(),
            _as_i32(qcol, f, dev),
        )
    if n == 0 and q8c is None:
        return state_buf
    if dev.type != "cuda":
        return megastep_segment_ref(state_buf, rows, mask, segment_ids, num_segments, ops, q8c)
    args = (state_buf.contiguous(), rows.reshape(n, f).contiguous(), _as_i32(mask, n, dev),
            _as_i32(segment_ids, n, dev), ops, uniform)
    if q8c is None:
        return megastep_segment_cuda(*args)
    # no early return with staged slots: the decode IS the page-in, and an
    # empty step must not leave stale quantized columns
    return megastep_segment_q8_cuda(*args, *q8c)


def histogram_accumulate(
    indices: torch.Tensor,
    length: int,
    weights: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked/weighted fixed-length bincount.

    ``jnp.bincount(x, length=length)`` semantics — negative indices clip to
    bin 0, indices ``>= length`` are dropped — extended with optional per-row
    ``weights`` (``(N,)`` or ``(N, K)``, any dtype in
    :data:`~metrics_tpu_torch.ops.kernels.hist_cuda.WEIGHT_DTYPES`; bool and
    complex raise) and an optional row ``mask``. Returns int32 counts (no
    weights) or the sums in the weights' dtype, shape ``(length,)`` /
    ``(length, K)`` matching the weights' rank. The call is the batched op at
    ``B = 1``: indices and a mask of the dtypes the kernel reads go in as they
    are. Under ``torch.func.vmap`` the op's vmap rule makes the whole
    batch one launch.
    """
    length = int(length)
    _maybe_kernel_fault("histogram")
    # both paths go through the custom op, whose CPU implementation is the
    # plain version: that is what lets the plain path run under vmap too
    idx = indices.reshape(1, -1)
    if idx.dtype not in INDEX_DTYPES:
        idx = idx.to(torch.int64)
    if mask is not None:
        mask = mask.reshape(1, -1)
        if mask.dtype not in MASK_DTYPES:
            mask = mask.to(torch.bool)
    if weights is None:
        return histogram_op(idx, mask, None, length)[0]
    if weights.dtype not in WEIGHT_DTYPES:
        raise TypeError(f"histogram_accumulate cannot sum {weights.dtype} weights; it takes {WEIGHT_DTYPES}")
    k = math.prod(weights.shape[1:])
    out = histogram_op(idx, mask, weights.reshape(1, idx.shape[1], k), length)[0]
    return out.reshape((length,) + tuple(weights.shape[1:]))
