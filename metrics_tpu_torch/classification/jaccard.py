"""JaccardIndex module metric and its deprecated ``IoU`` alias (port of
``metrics_tpu/classification/jaccard.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.functional.classification.jaccard import _jaccard_from_confmat
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class JaccardIndex(ConfusionMatrix):
    """Jaccard index (intersection over union) from an accumulated confusion matrix."""

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        absent_score: float = 0.0,
        threshold: float = 0.5,
        multilabel: bool = False,
        reduction: str = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, normalize=None, threshold=threshold, multilabel=multilabel,
                         **kwargs)
        self.reduction = reduction
        self.ignore_index = ignore_index
        self.absent_score = absent_score

    def compute(self) -> Tensor:
        return _jaccard_from_confmat(self.confmat, self.num_classes, self.ignore_index, self.absent_score,
                                     self.reduction)


class IoU(JaccardIndex):
    """Deprecated alias of :class:`JaccardIndex`."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        rank_zero_warn("`IoU` was renamed to `JaccardIndex` and it will be removed.", DeprecationWarning)
        super().__init__(*args, **kwargs)
