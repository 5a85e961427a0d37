"""Area under a curve by the trapezoidal rule.

Port of ``metrics_tpu/functional/classification/auc.py``.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _auc_update(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    if x.ndim > 1:
        x = torch.squeeze(x)
    if y.ndim > 1:
        y = torch.squeeze(y)
    if x.ndim > 1 or y.ndim > 1:
        raise ValueError(
            f"Expected both `x` and `y` tensor to be 1d, but got tensors with dimension {x.ndim} and {y.ndim}"
        )
    if x.numel() != y.numel():
        raise ValueError(
            f"Expected the same number of elements in `x` and `y` tensor but received {x.numel()} and {y.numel()}"
        )
    return x, y


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float) -> Tensor:
    return torch.trapezoid(y, x) * direction


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    if reorder:
        x_idx = torch.argsort(x, stable=True)
        x, y = x[x_idx], y[x_idx]
    dx = x[1:] - x[:-1]
    if bool(torch.any(dx < 0)):
        if bool(torch.all(dx <= 0)):
            direction = -1.0
        else:
            raise ValueError(
                "The `x` tensor is neither increasing or decreasing. Try setting the reorder argument to `True`."
            )
    else:
        direction = 1.0
    return _auc_compute_without_check(x, y, direction)


def auc(x: Tensor, y: Tensor, reorder: bool = False, device: DeviceLike = None) -> Tensor:
    """Area under the curve through the points ``(x, y)`` by the trapezoidal
    rule, on ``device`` (default: the inputs' device, else ``cuda``)."""
    dev = tensor_device(x, y, device=device)
    x, y = _auc_update(as_input(x, dev), as_input(y, dev))
    return _auc_compute(x, y, reorder=reorder)
