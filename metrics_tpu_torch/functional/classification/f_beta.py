"""F-beta / F1 scores (port of ``metrics_tpu/functional/classification/f_beta.py``)."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.precision_recall import _stat_scores_for
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.utils.device import DeviceLike
from metrics_tpu_torch.utils.enums import AverageMethod as AvgMethod
from metrics_tpu_torch.utils.enums import MDMCAverageMethod

Tensor = torch.Tensor


def _safe_divide(num: Tensor, denom: Tensor) -> Tensor:
    """Division that treats 0/0 as 0."""
    num = num if num.is_floating_point() else num.to(torch.float32)
    denom = denom.to(num.dtype)
    return num / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def _fbeta_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: str,
    mdmc_average: Optional[str],
) -> Tensor:
    if average == AvgMethod.MICRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        mask = tp >= 0
        zero = torch.zeros_like(tp)
        tp_sum = torch.sum(torch.where(mask, tp, zero), dtype=torch.int32).to(torch.float32)
        precision = _safe_divide(tp_sum, torch.sum(torch.where(mask, tp + fp, zero), dtype=torch.int32))
        recall = _safe_divide(tp_sum, torch.sum(torch.where(mask, tp + fn, zero), dtype=torch.int32))
    else:
        precision = _safe_divide(tp.to(torch.float32), tp + fp)
        recall = _safe_divide(tp.to(torch.float32), tp + fn)

    num = (1 + beta**2) * precision * recall
    denom = beta**2 * precision + recall
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)

    classes = torch.arange(num.shape[-1], device=num.device) if num.ndim else None
    if average == AvgMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = (tp | fn | fp) == 0
        if ignore_index is not None:
            meaningless = meaningless | (classes == ignore_index)
        num = torch.where(meaningless, torch.full_like(num, -1.0), num)
        denom = torch.where(meaningless, torch.full_like(denom, -1.0), denom)
    elif ignore_index is not None and average not in (AvgMethod.MICRO, AvgMethod.SAMPLES):
        ignored = classes == ignore_index
        num = torch.where(ignored, torch.full_like(num, -1.0), num)
        denom = torch.where(ignored, torch.full_like(denom, -1.0), denom)

    if average == AvgMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = ((tp + fp + fn) == 0) | ((tp + fp + fn) == -3)
        num = torch.where(cond, torch.zeros_like(num), num)
        denom = torch.where(cond, torch.full_like(denom, -1.0), denom)

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != AvgMethod.WEIGHTED else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    device: DeviceLike = None,
) -> Tensor:
    """Compute F-beta on ``device`` (default: the inputs' device, else ``cuda``)."""
    tp, fp, tn, fn = _stat_scores_for(preds, target, average, mdmc_average, ignore_index, num_classes, threshold,
                                      top_k, multiclass, device)
    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    device: DeviceLike = None,
) -> Tensor:
    """F1 = F-beta with beta=1."""
    return fbeta(preds, target, 1.0, average, mdmc_average, ignore_index, num_classes, threshold, top_k,
                 multiclass, device)


f1_score = f1
