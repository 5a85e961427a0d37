"""Specificity (port of ``metrics_tpu/functional/classification/specificity.py``)."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.precision_recall import _stat_scores_for
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.utils.device import DeviceLike
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod

Tensor = torch.Tensor


def _specificity_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: str, mdmc_average: Optional[str]
) -> Tensor:
    numerator = tn
    denominator = tn + fp
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = (tp | fn | fp) == 0
        numerator = torch.where(meaningless, torch.full_like(numerator, -1), numerator)
        denominator = torch.where(meaningless, torch.full_like(denominator, -1), denominator)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else denominator,
        average=average,
        mdmc_average=mdmc_average,
    )


def specificity(
    preds: Tensor,
    target: Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    device: DeviceLike = None,
) -> Tensor:
    """Specificity = TN / (TN + FP)."""
    tp, fp, tn, fn = _stat_scores_for(preds, target, average, mdmc_average, ignore_index, num_classes, threshold,
                                      top_k, multiclass, device)
    return _specificity_compute(tp, fp, tn, fn, average, mdmc_average)
