"""AveragePrecision module metric.

Port of ``metrics_tpu/classification/avg_precision.py``. Like ``AUROC``,
``capacity=N`` keeps static buffers (``classification/_capacity.py``) so the
exact step-integrated AP is computed with static shapes
(``ops/masked_curves.py``) and the metric serves through the streaming
engine's scan strategy; overflow gives NaN.
"""
from typing import Any, List, Optional, Union

import torch

from metrics_tpu_torch.classification._capacity import CapacityCurveStateMixin
from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.masked_curves import masked_binary_average_precision, masked_multilabel_average_precision
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class AveragePrecision(CapacityCurveStateMixin, Metric):
    """Average precision (area under the PR curve by step integration)."""

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        allowed_average = ("micro", "macro", "weighted", "none", None)
        if average not in allowed_average:
            raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")
        self.average = average
        self.capacity = capacity
        if capacity is None:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            self._validate_capacity_kwargs(pos_label, average)
            self._init_capacity_states()

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, num_classes, pos_label = _average_precision_update(
            preds, target, self.num_classes, self.pos_label, self.average
        )
        if self.capacity is None:
            self.preds.append(preds)
            self.target.append(target)
            self.num_classes = num_classes
            self.pos_label = pos_label
            return
        self._capacity_curve_write(preds, target)

    def compute(self) -> Union[Tensor, List[Tensor]]:
        if self.capacity is not None:
            return self._compute_capacity_with(masked_binary_average_precision, masked_multilabel_average_precision)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        if not self.num_classes:
            raise ValueError(f"`num_classes` bas to be positive number, but got {self.num_classes}")
        return _average_precision_compute(preds, target, self.num_classes, self.pos_label, self.average)
