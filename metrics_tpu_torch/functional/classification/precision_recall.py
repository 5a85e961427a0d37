"""Precision and Recall (port of ``metrics_tpu/functional/classification/precision_recall.py``).

Absent classes are masked with the static-shape -1 denominator (as F1 does),
with ``torch.where`` rather than boolean indexing, so the computes run under
``torch.func.vmap`` (the engines' batched ``results()``).
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod

Tensor = torch.Tensor


def _mask_absent_classes(numerator: Tensor, denominator: Tensor, tp: Tensor, fp: Tensor, fn: Tensor,
                         average: Optional[str], mdmc_average: Optional[str]) -> Tuple[Tensor, Tensor]:
    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = (tp + fp + fn) == 0
        numerator = torch.where(cond, torch.zeros_like(numerator), numerator)
        denominator = torch.where(cond, torch.full_like(denominator, -1), denominator)
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = (tp | fn | fp) == 0
        numerator = torch.where(meaningless, torch.full_like(numerator, -1), numerator)
        denominator = torch.where(meaningless, torch.full_like(denominator, -1), denominator)
    return numerator, denominator


def _precision_compute(tp: Tensor, fp: Tensor, fn: Tensor, average: str, mdmc_average: Optional[str]) -> Tensor:
    numerator, denominator = _mask_absent_classes(tp, tp + fp, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != "weighted" else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
    )


def _recall_compute(tp: Tensor, fp: Tensor, fn: Tensor, average: str, mdmc_average: Optional[str]) -> Tensor:
    numerator, denominator = _mask_absent_classes(tp, tp + fn, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
    )


def _validate_average_args(average: str, mdmc_average: Optional[str], num_classes: Optional[int],
                           ignore_index: Optional[int]) -> None:
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    allowed_mdmc_average = (None, "samplewise", "global")
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")
    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def _stat_scores_for(preds: Tensor, target: Tensor, average: str, mdmc_average: Optional[str],
                     ignore_index: Optional[int], num_classes: Optional[int], threshold: float,
                     top_k: Optional[int], multiclass: Optional[bool],
                     device: DeviceLike) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Validate the averaging arguments and count tp/fp/tn/fn on ``device``
    (default: the inputs' device, else ``cuda``)."""
    _validate_average_args(average, mdmc_average, num_classes, ignore_index)
    dev = tensor_device(preds, target, device=device)
    reduce = "macro" if average in ("weighted", "none", None) else average
    return _stat_scores_update(
        as_input(preds, dev), as_input(target, dev), reduce=reduce, mdmc_reduce=mdmc_average,
        threshold=threshold, num_classes=num_classes, top_k=top_k, multiclass=multiclass,
        ignore_index=ignore_index,
    )


def precision(
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
    """Precision = TP / (TP + FP)."""
    tp, fp, _, fn = _stat_scores_for(preds, target, average, mdmc_average, ignore_index, num_classes, threshold,
                                     top_k, multiclass, device)
    return _precision_compute(tp, fp, fn, average, mdmc_average)


def recall(
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
    """Recall = TP / (TP + FN)."""
    tp, fp, _, fn = _stat_scores_for(preds, target, average, mdmc_average, ignore_index, num_classes, threshold,
                                     top_k, multiclass, device)
    return _recall_compute(tp, fp, fn, average, mdmc_average)


def precision_recall(
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
) -> Tuple[Tensor, Tensor]:
    """Precision and recall from one count."""
    tp, fp, _, fn = _stat_scores_for(preds, target, average, mdmc_average, ignore_index, num_classes, threshold,
                                     top_k, multiclass, device)
    return _precision_compute(tp, fp, fn, average, mdmc_average), _recall_compute(tp, fp, fn, average, mdmc_average)
