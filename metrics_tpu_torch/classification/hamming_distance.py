"""HammingDistance module metric (port of ``metrics_tpu/classification/hamming_distance.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.hamming_distance import (
    _hamming_distance_compute,
    _hamming_distance_update,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class HammingDistance(Metric):
    """Average Hamming distance (loss) between targets and predictions.

    ``num_classes``/``multiclass`` are static-shape hints (integer labels in
    the engines' vmapped update cannot give the class count from values).
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(
        self,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.add_state("correct", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.threshold = threshold
        self.num_classes = num_classes
        self.multiclass = multiclass

    def update(self, preds: Tensor, target: Tensor) -> None:
        correct, total = _hamming_distance_update(preds, target, self.threshold, self.num_classes, self.multiclass)
        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _hamming_distance_compute(self.correct, self.total)
