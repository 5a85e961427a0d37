"""Average precision score (port of
``metrics_tpu/functional/classification/average_precision.py``)."""
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.utils.data import _bincount
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _average_precision_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    if average == "micro":
        if preds.ndim == target.ndim:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1
        else:
            raise ValueError("Cannot use `micro` average with multi-class input")
    return preds, target, num_classes, pos_label


def _average_precision_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[Tensor], Tensor]:
    precision, recall, _ = _precision_recall_curve_compute(preds, target, num_classes, pos_label)
    if average == "weighted":
        if preds.ndim == target.ndim and target.ndim > 1:
            weights = torch.sum(target, dim=0).to(torch.float32)
        else:
            weights = _bincount(target, num_classes).to(torch.float32)
        weights = weights / torch.sum(weights)
    else:
        weights = None
    return _average_precision_compute_with_precision_recall(precision, recall, num_classes, average, weights)


def _average_precision_compute_with_precision_recall(
    precision: Union[Tensor, List[Tensor]],
    recall: Union[Tensor, List[Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Union[List[Tensor], Tensor]:
    if num_classes == 1:
        return -torch.sum((recall[1:] - recall[:-1]) * precision[:-1])

    res = [-torch.sum((r[1:] - r[:-1]) * p[:-1]) for p, r in zip(precision, recall)]

    if average in ("macro", "weighted"):
        res_t = torch.stack(res)
        # the warning reads the data: not under vmap (a batched results()), where it cannot branch
        if not torch._C._functorch.is_batchedtensor(res_t) and bool(torch.any(torch.isnan(res_t))):
            warnings.warn("Average precision score for one or more classes was `nan`. Ignoring these classes "
                          f"in {average}-average", UserWarning)
        if average == "macro":
            return torch.nanmean(res_t)
        weights = torch.where(torch.isnan(res_t), torch.zeros_like(weights), weights)
        weights = weights / torch.sum(weights)
        return torch.nansum(res_t * weights)
    if average in (None, "none"):
        return res
    allowed_average = ("micro", "macro", "weighted", "none", None)
    raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
    device: DeviceLike = None,
) -> Union[List[Tensor], Tensor]:
    """Compute average precision on ``device`` (default: the inputs' device,
    else ``cuda``)."""
    dev = tensor_device(preds, target, device=device)
    preds, target, num_classes, pos_label = _average_precision_update(
        as_input(preds, dev), as_input(target, dev), num_classes, pos_label, average
    )
    return _average_precision_compute(preds, target, num_classes, pos_label, average, sample_weights)
