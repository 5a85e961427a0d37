"""MAE (port of ``metrics_tpu/functional/regression/mean_absolute_error.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _mean_absolute_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    sum_abs_error = torch.sum(torch.abs(preds - target))
    return sum_abs_error, target.numel()


def _mean_absolute_error_compute(sum_abs_error: Tensor, n_obs: Tensor) -> Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds: Tensor, target: Tensor, device: DeviceLike = None) -> Tensor:
    """Compute mean absolute error."""
    dev = tensor_device(preds, target, device=device)
    sum_abs_error, n_obs = _mean_absolute_error_update(as_input(preds, dev), as_input(target, dev))
    return _mean_absolute_error_compute(sum_abs_error, n_obs)
