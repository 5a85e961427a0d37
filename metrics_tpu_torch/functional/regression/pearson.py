"""Pearson correlation coefficient from streaming statistics (port of
``metrics_tpu/functional/regression/pearson.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _pearson_corrcoef_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    n_prior: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One streaming-statistics step over a batch."""
    _check_same_shape(preds, target)
    preds = torch.squeeze(preds)
    target = torch.squeeze(target)
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")

    n_obs = preds.numel()
    mx_new = (n_prior * mean_x + torch.mean(preds) * n_obs) / (n_prior + n_obs)
    my_new = (n_prior * mean_y + torch.mean(target) * n_obs) / (n_prior + n_obs)
    n_new = n_prior + n_obs
    var_x = var_x + torch.sum((preds - mx_new) * (preds - mean_x))
    var_y = var_y + torch.sum((target - my_new) * (target - mean_y))
    corr_xy = corr_xy + torch.sum((preds - mx_new) * (target - mean_y))
    return mx_new, my_new, var_x, var_y, corr_xy, n_new


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = torch.squeeze(corr_xy / torch.sqrt(var_x * var_y))
    return torch.clamp(corrcoef, -1.0, 1.0)


def _as_float(x: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
    """``x`` itself when floating, else cast to ``dtype``."""
    return x if x.is_floating_point() else x.to(dtype)


def pearson_corrcoef(preds: Tensor, target: Tensor, device: DeviceLike = None) -> Tensor:
    """Compute the Pearson correlation coefficient."""
    dev = tensor_device(preds, target, device=device)
    preds = _as_float(as_input(preds, dev))
    target = _as_float(as_input(target, dev), preds.dtype)
    zero = torch.zeros((), dtype=preds.dtype, device=dev)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, zero, zero, zero, zero, zero, zero)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
