"""MatthewsCorrCoef module metric and its deprecated ``MatthewsCorrcoef``
alias (port of ``metrics_tpu/classification/matthews_corrcoef.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.classification.matthews_corrcoef import (
    _matthews_corrcoef_compute,
    _matthews_corrcoef_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class MatthewsCorrCoef(Metric):
    """Matthews correlation coefficient from an accumulated confusion matrix."""

    is_differentiable = False
    higher_is_better = True

    def __init__(self, num_classes: int, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.threshold = threshold
        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32),
                       dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.confmat = self.confmat + _matthews_corrcoef_update(preds, target, self.num_classes, self.threshold)

    def compute(self) -> Tensor:
        return _matthews_corrcoef_compute(self.confmat)


class MatthewsCorrcoef(MatthewsCorrCoef):
    """Deprecated alias of :class:`MatthewsCorrCoef`."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        rank_zero_warn(
            "`MatthewsCorrcoef` was renamed to `MatthewsCorrCoef` and it will be removed.", DeprecationWarning
        )
        super().__init__(*args, **kwargs)
