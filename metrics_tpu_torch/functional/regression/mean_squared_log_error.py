"""MSLE (port of ``metrics_tpu/functional/regression/mean_squared_log_error.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    diff = torch.log1p(preds) - torch.log1p(target)
    sum_squared_log_error = torch.sum(diff * diff)
    return sum_squared_log_error, target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, n_obs: Tensor) -> Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: Tensor, target: Tensor, device: DeviceLike = None) -> Tensor:
    """Compute mean squared log error."""
    dev = tensor_device(preds, target, device=device)
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(as_input(preds, dev), as_input(target, dev))
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)
