"""Shared pairwise helpers (port of ``metrics_tpu/functional/pairwise/helpers.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _check_input(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None, device: DeviceLike = None
) -> Tuple[Tensor, Tensor, bool]:
    """``x`` and ``y`` as float tensors on the device (``y`` defaults to
    ``x``), and whether the diagonal is zeroed (by default only when ``y``
    is not given)."""
    dev = tensor_device(x, y, device=device)
    x = as_input(x, dev)
    x = x if x.is_floating_point() else x.to(torch.float32)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        y = as_input(y, dev)
        y = y if y.is_floating_point() else y.to(x.dtype)
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _zero_diagonal(distance: Tensor, zero_diagonal: bool) -> Tensor:
    """``distance`` (a fresh matrix) with its main diagonal set to 0."""
    return distance.fill_diagonal_(0) if zero_diagonal else distance


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[str] = None) -> Tensor:
    if reduction == "mean":
        return torch.mean(distmat, dim=-1)
    if reduction == "sum":
        return torch.sum(distmat, dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")
