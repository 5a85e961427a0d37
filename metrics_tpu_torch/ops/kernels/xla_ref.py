"""Plain PyTorch versions of the fold and histogram primitives.

Port of ``fold_rows_ref`` and ``histogram_ref`` from
``metrics_tpu/ops/kernels/xla_ref.py`` (the file keeps its reference twin's
name). They serve two jobs:

* the path a CPU tensor takes through ``dispatch.py`` (the tests run there);
* the oracle every CUDA kernel is held against on the card (``chip_smoke.py``)
  — int states bit-exact, float states within reassociation tolerance.

Semantics as in the JAX package: masked-out rows contribute the reduction's
identity element; histogram indices follow ``jnp.bincount(x, length=L)`` —
negatives clip to bin 0, indices ``>= length`` drop.
"""
from typing import Optional

import torch

from metrics_tpu_torch.ops.kernels.common import reduce_identity


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
