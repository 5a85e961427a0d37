"""Pairwise cosine similarity (port of ``metrics_tpu/functional/pairwise/cosine.py``):
the rows normalised, then one matrix product."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.utils.device import DeviceLike

Tensor = torch.Tensor


def _pairwise_cosine_similarity_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None, device: DeviceLike = None
) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal, device)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    y = y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
    distance = x @ y.T
    return _zero_diagonal(distance, zero_diagonal)


def pairwise_cosine_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
    device: DeviceLike = None,
) -> Tensor:
    """Pairwise cosine similarity between the rows of ``x`` (and ``y``)."""
    distance = _pairwise_cosine_similarity_update(x, y, zero_diagonal, device)
    return _reduce_distance_matrix(distance, reduction)
