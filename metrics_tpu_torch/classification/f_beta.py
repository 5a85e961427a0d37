"""FBeta / F1Score module metrics (port of ``metrics_tpu/classification/f_beta.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.stat_scores import _AveragedStatScores
from metrics_tpu_torch.functional.classification.f_beta import _fbeta_compute

Tensor = torch.Tensor


class FBeta(_AveragedStatScores):
    """F-beta score with configurable beta."""

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_classes: Optional[int] = None,
        beta: float = 1.0,
        threshold: float = 0.5,
        average: str = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, threshold=threshold, average=average, mdmc_average=mdmc_average,
                         ignore_index=ignore_index, top_k=top_k, multiclass=multiclass, **kwargs)
        self.beta = beta

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _fbeta_compute(tp, fp, tn, fn, self.beta, self.ignore_index, self.average, self.mdmc_reduce)


class F1Score(FBeta):
    """F1 = F-beta with beta=1.0."""

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: str = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            beta=1.0,
            threshold=threshold,
            average=average,
            mdmc_average=mdmc_average,
            ignore_index=ignore_index,
            top_k=top_k,
            multiclass=multiclass,
            **kwargs,
        )
