"""MeanSquaredError module metric (port of ``metrics_tpu/regression/mean_squared_error.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.mean_squared_error import (
    _mean_squared_error_compute,
    _mean_squared_error_update,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class MeanSquaredError(Metric):
    """Mean squared error (RMSE with ``squared=False``)."""

    is_differentiable = True
    higher_is_better = False

    def __init__(self, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_error", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.squared = squared

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, squared=self.squared)
