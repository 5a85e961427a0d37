"""Pairwise euclidean distance (port of ``metrics_tpu/functional/pairwise/euclidean.py``).

The JAX package's expansion ``|x|^2 + |y|^2 - 2 x.y``, clipped at 0 before
the square root, so the heavy term is one matrix product; not
``torch.cdist``, so the values follow the JAX package's formula.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.utils.device import DeviceLike

Tensor = torch.Tensor


def _pairwise_euclidean_distance_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None, device: DeviceLike = None
) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal, device)
    x_norm = torch.sum(x * x, dim=1, keepdim=True)
    y_norm = torch.sum(y * y, dim=1)
    distance = x_norm + y_norm - 2 * (x @ y.T)
    distance = torch.sqrt(torch.clamp(distance, min=0.0))
    return _zero_diagonal(distance, zero_diagonal)


def pairwise_euclidean_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
    device: DeviceLike = None,
) -> Tensor:
    """Pairwise euclidean distance between the rows of ``x`` (and ``y``)."""
    distance = _pairwise_euclidean_distance_update(x, y, zero_diagonal, device)
    return _reduce_distance_matrix(distance, reduction)
