"""AUC module metric: the trapezoidal area under any ``(x, y)`` points.

Port of ``metrics_tpu/classification/auc.py``. Its points are list states,
so the engines refuse it, as the JAX package's do.
"""
from typing import Any

import torch

from metrics_tpu_torch.functional.classification.auc import _auc_compute, _auc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class AUC(Metric):
    """Area under any curve given (x, y) points."""

    is_differentiable = False
    higher_is_better = None

    def __init__(self, reorder: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reorder = reorder
        self.add_state("x", default=[], dist_reduce_fx="cat")
        self.add_state("y", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        # argument names as the JAX package's: these are the curve's x and y points
        x, y = _auc_update(preds, target)
        self.x.append(x)
        self.y.append(y)

    def compute(self) -> Tensor:
        return _auc_compute(dim_zero_cat(self.x), dim_zero_cat(self.y), reorder=self.reorder)
