"""Device dispatch for the streaming-update primitives.

Port of ``fold_rows_masked`` and ``histogram_accumulate`` from
``metrics_tpu/ops/kernels/dispatch.py``, with the same semantics:

* :func:`fold_rows_masked` — fused masked row-delta reduction
  (``Metric.update_state_masked``, delta strategy);
* :func:`histogram_accumulate` — masked/weighted fixed-length bincount
  (``utils/data.py::_bincount``, the confusion-matrix family).

The choice between kernel and plain version is made by the tensor's device
and by nothing else: a CUDA tensor takes the hand-written kernel (and the call
raises if the kernel cannot take it), a CPU tensor takes the plain version.
There is no fallback from a failed kernel. The JAX dispatcher's backend names
(``pallas_interpret``, ``megastep*``, ``use_backend``) and its TPU gates have
no counterpart here: the CUDA histogram covers every length and counts in
int32, so neither ``MAX_HIST_LENGTH`` nor ``_HIST_EXACT_ROWS`` applies, and the
fold needs no VMEM block sizing.
"""
from typing import Optional

import torch

from metrics_tpu_torch.ops.kernels.common import REDUCE_OPS, as_2d_rows
from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda
from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_counts_op, histogram_weights_op
from metrics_tpu_torch.ops.kernels.xla_ref import fold_rows_ref


def fold_rows_masked(state: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, fx: str) -> torch.Tensor:
    """Fused masked row-delta reduction.

    ``rows`` is the row-stacked delta ``(N, *leaf)``, ``state`` the carried
    leaf ``(*leaf)``, ``mask`` ``(N,)``; rows where ``mask`` is False
    contribute the reduction identity. Returns the new leaf.
    """
    if fx not in REDUCE_OPS:
        raise ValueError(f"fold_rows_masked supports {REDUCE_OPS}, got {fx!r}")
    rows = rows.to(state.dtype)
    if state.device.type != "cuda":
        return fold_rows_ref(state, rows, mask, fx)
    n = int(rows.shape[0])
    rows2d, trailing = as_2d_rows(rows, n)
    mask_i32 = mask.to(device=state.device, dtype=torch.int32).reshape(n).contiguous()
    out = fold_rows_cuda(state.reshape(-1).contiguous(), rows2d.contiguous(), mask_i32, fx)
    return out.reshape(trailing)


def histogram_accumulate(
    indices: torch.Tensor,
    length: int,
    weights: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked/weighted fixed-length bincount.

    ``jnp.bincount(x, length=length)`` semantics — negative indices clip to
    bin 0, indices ``>= length`` are dropped — extended with optional per-row
    ``weights`` (f32 or bf16, ``(N,)`` or ``(N, K)``; other dtypes raise) and an
    optional row ``mask``. Returns int32 counts (no weights) or the
    weights-dtype sums, shape ``(length,)`` / ``(length, K)`` matching the
    weights' rank. Works under
    ``torch.func.vmap``: the custom ops' vmap rules launch one kernel for the
    whole batch.
    """
    length = int(length)
    # both paths go through the custom ops, whose CPU implementation is the
    # plain version: that is what lets the plain path run under vmap too
    idx = indices.reshape(-1).to(torch.int32)
    if mask is not None:
        # a masked row takes index `length`: out of range, so it drops
        idx = torch.where(mask.to(torch.bool), idx, torch.full_like(idx, length))
    idx = idx.contiguous()
    if weights is None:
        return histogram_counts_op(idx, length)
    if weights.dtype not in (torch.float32, torch.bfloat16):
        # the kernel sums in f32: integer weights would lose exactness past 2**24
        raise TypeError(f"histogram_accumulate takes f32 or bf16 weights, got {weights.dtype}")
    cols = weights.reshape(idx.shape[0], -1).contiguous()
    out = histogram_weights_op(idx, cols, length).to(weights.dtype)
    return out[:, 0] if weights.ndim == 1 else out
