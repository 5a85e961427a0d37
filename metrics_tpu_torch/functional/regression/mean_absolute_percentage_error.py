"""MAPE (port of ``metrics_tpu/functional/regression/mean_absolute_percentage_error.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor

_EPSILON = 1.17e-06


def _mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = _EPSILON
) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    abs_diff = torch.abs(preds - target)
    abs_per_error = abs_diff / torch.clamp(torch.abs(target), min=epsilon)
    sum_abs_per_error = torch.sum(abs_per_error)
    return sum_abs_per_error, target.numel()


def _mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs: Tensor) -> Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: Tensor, target: Tensor, device: DeviceLike = None) -> Tensor:
    """Compute mean absolute percentage error."""
    dev = tensor_device(preds, target, device=device)
    sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(as_input(preds, dev), as_input(target, dev))
    return _mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)
