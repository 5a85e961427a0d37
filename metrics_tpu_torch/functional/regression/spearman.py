"""Spearman rank correlation (port of ``metrics_tpu/functional/regression/spearman.py``).

Ties get the mean of their ranks through one stable sort and segment sums,
as in the JAX package: group ids from the change flags of the sorted values
(``cumsum``), the group sums by ``index_add``, the mean ranks written back
to the original order by ``index_copy``.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _rank_data(data: Tensor) -> Tensor:
    """Ranks (1-based); ties get the mean of their ranks."""
    n = data.numel()
    idx = torch.argsort(data, stable=True)
    srt = data[idx]
    # group ids over the sorted data: increments where the value changes
    change = torch.cat([torch.zeros(1, dtype=torch.int64, device=data.device), (srt[1:] != srt[:-1]).long()])
    gid = torch.cumsum(change, 0)
    pos = torch.arange(1, n + 1, dtype=data.dtype, device=data.device)
    group_sum = torch.zeros(n, dtype=data.dtype, device=data.device).index_add_(0, gid, pos)
    group_cnt = torch.zeros(n, dtype=data.dtype, device=data.device).index_add_(0, gid, torch.ones_like(pos))
    mean_rank_sorted = (group_sum / torch.clamp(group_cnt, min=1))[gid]
    return torch.zeros(n, dtype=data.dtype, device=data.device).index_copy_(0, idx, mean_rank_sorted)


def _spearman_corrcoef_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if not preds.is_floating_point() or not target.is_floating_point():
        raise TypeError(
            "Expected `preds` and `target` both to be floating point tensors, but got"
            f" {preds.dtype} and {target.dtype}."
        )
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    preds = torch.squeeze(preds)
    target = torch.squeeze(target)
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    return preds, target


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    preds = _rank_data(preds)
    target = _rank_data(target)

    preds_diff = preds - torch.mean(preds)
    target_diff = target - torch.mean(target)

    cov = torch.mean(preds_diff * target_diff)
    preds_std = torch.sqrt(torch.mean(preds_diff * preds_diff))
    target_std = torch.sqrt(torch.mean(target_diff * target_diff))

    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0)


def _widen(x: Tensor) -> Tensor:
    """Sub-f32 floats widen to f32 for the ranking math; integers pass
    through to the update's ``TypeError`` (floats are required)."""
    return x.to(torch.float32) if x.is_floating_point() and x.dtype not in (torch.float32, torch.float64) else x


def spearman_corrcoef(preds: Tensor, target: Tensor, device: DeviceLike = None) -> Tensor:
    """Compute Spearman's rank correlation coefficient."""
    dev = tensor_device(preds, target, device=device)
    preds, target = _spearman_corrcoef_update(_widen(as_input(preds, dev)), _widen(as_input(target, dev)))
    return _spearman_corrcoef_compute(preds, target)
