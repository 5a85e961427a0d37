"""MSE / RMSE (port of ``metrics_tpu/functional/regression/mean_squared_error.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _mean_squared_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    diff = preds - target
    sum_squared_error = torch.sum(diff * diff)
    return sum_squared_error, target.numel()


def _mean_squared_error_compute(sum_squared_error: Tensor, n_obs: Tensor, squared: bool = True) -> Tensor:
    mse = sum_squared_error / n_obs
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, device: DeviceLike = None) -> Tensor:
    """Compute MSE (or RMSE with ``squared=False``)."""
    dev = tensor_device(preds, target, device=device)
    sum_squared_error, n_obs = _mean_squared_error_update(as_input(preds, dev), as_input(target, dev))
    return _mean_squared_error_compute(sum_squared_error, n_obs, squared=squared)
