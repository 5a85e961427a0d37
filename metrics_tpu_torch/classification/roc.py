"""ROC module metric.

Port of ``metrics_tpu/classification/roc.py``. By default the scores are list
states and the exact curve is computed eagerly. ``capacity=N`` keeps static
buffers instead (``classification/_capacity.py``): the curve is then
fixed-length, ``(capacity+1,)`` per class, its points overlaying the classic
distinct-threshold curve (``ops/masked_curves.py``), and the metric serves
through the streaming engine's scan strategy.
"""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification._capacity import CapacityCurveStateMixin
from metrics_tpu_torch.functional.classification.roc import _roc_compute, _roc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.masked_curves import masked_binary_roc
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class ROC(CapacityCurveStateMixin, Metric):
    """Receiver operating characteristic curve."""

    is_differentiable = False
    higher_is_better = None

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.capacity = capacity
        if capacity is None:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            self._validate_capacity_kwargs(pos_label, None)  # curves average nothing
            self._init_capacity_states()

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.capacity is not None:
            self._capacity_curve_precheck(preds)
        preds, target, num_classes, pos_label = _roc_update(preds, target, self.num_classes, self.pos_label)
        if self.capacity is None:
            self.preds.append(preds)
            self.target.append(target)
            self.num_classes = num_classes
            self.pos_label = pos_label
            return
        self._capacity_curve_write(preds, target)

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        if self.capacity is not None:
            return self._compute_capacity_curve_with(masked_binary_roc)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        if not self.num_classes:
            raise ValueError(f"`num_classes` bas to be positive number, but got {self.num_classes}")
        return _roc_compute(preds, target, self.num_classes, self.pos_label)
