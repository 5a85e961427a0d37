"""TweedieDevianceScore module metric (port of ``metrics_tpu/regression/tweedie_deviance.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class TweedieDevianceScore(Metric):
    """Tweedie deviance score for the given ``power`` (0 normal, 1 Poisson, 2 gamma)."""

    is_differentiable = True
    higher_is_better = False

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("num_observations", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)
