"""CohenKappa module metric (port of ``metrics_tpu/classification/cohen_kappa.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_compute, _cohen_kappa_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class CohenKappa(Metric):
    """Cohen's kappa, unweighted or with linear or quadratic weights."""

    is_differentiable = False
    higher_is_better = True

    def __init__(self, num_classes: int, weights: Optional[str] = None, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.weights = weights
        self.threshold = threshold

        allowed_weights = ("linear", "quadratic", "none", None)
        if weights not in allowed_weights:
            raise ValueError(f"Argument weights needs to one of the following: {allowed_weights}")

        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32),
                       dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.confmat = self.confmat + _cohen_kappa_update(preds, target, self.num_classes, self.threshold)

    def compute(self) -> Tensor:
        return _cohen_kappa_compute(self.confmat, self.weights)
