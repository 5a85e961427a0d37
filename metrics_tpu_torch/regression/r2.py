"""R2Score module metric (port of ``metrics_tpu/regression/r2.py``).

Its updates serve through the engines (``(num_outputs,)`` f32 sums and an
int32 count); its value does not: the compute reads the count on the host,
and an engine's ``result()``/``results()`` raise, as the JAX package's do
(``functional/regression/r2.py``).
"""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.r2 import _r2_score_compute, _r2_score_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class R2Score(Metric):
    """R² coefficient of determination (with adjusted and multioutput options)."""

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        num_outputs: int = 1,
        adjusted: int = 0,
        multioutput: str = "uniform_average",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs

        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted

        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}"
            )
        self.multioutput = multioutput

        for name in ("sum_squared_error", "sum_error", "residual"):
            self.add_state(name, default=torch.zeros(num_outputs, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + rss
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )
