"""Explained variance (port of ``metrics_tpu/functional/regression/explained_variance.py``).

The sums run over axis 0, so a 2-D input gives one score per output column.
"""
from typing import Sequence, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    _check_same_shape(preds, target)
    n_obs = preds.shape[0]
    diff = target - preds
    sum_error = torch.sum(diff, dim=0)
    sum_squared_error = torch.sum(diff * diff, dim=0)
    sum_target = torch.sum(target, dim=0)
    sum_squared_target = torch.sum(target * target, dim=0)
    return n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target


def _explained_variance_compute(
    n_obs: Tensor,
    sum_error: Tensor,
    sum_squared_error: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg * diff_avg
    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    output_scores = torch.where(
        nonzero_numerator & nonzero_denominator,
        1.0 - numerator / torch.where(nonzero_denominator, denominator, 1.0),
        torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, torch.ones_like(diff_avg)),
    )

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        denom_sum = torch.sum(denominator)
        return torch.sum(denominator / denom_sum * output_scores)
    raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {multioutput}")


def explained_variance(
    preds: Tensor, target: Tensor, multioutput: str = "uniform_average", device: DeviceLike = None
) -> Union[Tensor, Sequence[Tensor]]:
    """Compute explained variance."""
    dev = tensor_device(preds, target, device=device)
    n_obs, sum_error, ss_error, sum_target, ss_target = _explained_variance_update(
        as_input(preds, dev), as_input(target, dev)
    )
    return _explained_variance_compute(n_obs, sum_error, ss_error, sum_target, ss_target, multioutput)
