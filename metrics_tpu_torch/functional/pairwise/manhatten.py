"""Pairwise manhatten (L1) distance (port of ``metrics_tpu/functional/pairwise/manhatten.py``,
the reference's spelling kept).

The JAX package's ``(N, M, d)`` broadcast: its memory grows as N * M * d.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.utils.device import DeviceLike

Tensor = torch.Tensor


def _pairwise_manhatten_distance_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None, device: DeviceLike = None
) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal, device)
    distance = torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
    return _zero_diagonal(distance, zero_diagonal)


def pairwise_manhatten_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
    device: DeviceLike = None,
) -> Tensor:
    """Pairwise L1 distance between the rows of ``x`` (and ``y``)."""
    distance = _pairwise_manhatten_distance_update(x, y, zero_diagonal, device)
    return _reduce_distance_matrix(distance, reduction)
