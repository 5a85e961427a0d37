"""True/false positive/negative counting — the backbone of classification metrics.

Port of ``metrics_tpu/functional/classification/stat_scores.py``: the same
reduce/mdmc_reduce/ignore_index semantics and output shapes. Counts are int32,
the JAX package's dtype with x64 off (``torch.sum`` of bool would give int64,
so every sum names its dtype).
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod

Tensor = torch.Tensor


def _del_column(data: Tensor, idx: int) -> Tensor:
    return torch.cat([data[:, :idx], data[:, idx + 1:]], dim=1)


def _stat_scores(preds: Tensor, target: Tensor, reduce: Optional[str] = "micro") -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Count tp/fp/tn/fn over canonical (N, C[, X]) binary tensors.

    Output shapes: (N,C): micro->(), macro->(C,), samples->(N,);
    (N,C,X): micro->(N,), macro->(N,C), samples->(N,X).
    """
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = 0 if preds.ndim == 2 else 2
    else:  # samples
        dim = 1

    true_pred = target == preds
    false_pred = target != preds
    pos_pred = preds == 1
    neg_pred = preds == 0

    tp = torch.sum(true_pred & pos_pred, dim=dim, dtype=torch.int32)
    fp = torch.sum(false_pred & pos_pred, dim=dim, dtype=torch.int32)
    tn = torch.sum(true_pred & neg_pred, dim=dim, dtype=torch.int32)
    fn = torch.sum(false_pred & neg_pred, dim=dim, dtype=torch.int32)
    return tp, fp, tn, fn


def _stat_scores_update(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Canonicalize inputs and count statistics."""
    preds, target, _ = _input_format_classification(
        preds, target, threshold=threshold, num_classes=num_classes, multiclass=multiclass, top_k=top_k
    )

    if ignore_index is not None and not 0 <= ignore_index < preds.shape[1]:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes")
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            preds = torch.swapaxes(preds, 1, 2).reshape(-1, preds.shape[1])
            target = torch.swapaxes(target, 1, 2).reshape(-1, target.shape[1])

    if ignore_index is not None and reduce != "macro":
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce)

    if ignore_index is not None and reduce == "macro":
        keep = torch.arange(tp.shape[-1], device=tp.device) != ignore_index
        tp, fp, tn, fn = (torch.where(keep, x, torch.full_like(x, -1)) for x in (tp, fp, tn, fn))

    return tp, fp, tn, fn


def _stat_scores_compute(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tensor:
    """Stack [tp, fp, tn, fn, support] along the last dim."""
    outputs = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return torch.where(outputs < 0, torch.full_like(outputs, -1), outputs)


def _reduce_stat_scores(
    numerator: Tensor,
    denominator: Tensor,
    weights: Optional[Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    """Weighted num/denom reduction with zero-division and ignored-class (-1) masking."""
    numerator = numerator if numerator.is_floating_point() else numerator.to(torch.float32)
    denominator = denominator if denominator.is_floating_point() else denominator.to(numerator.dtype)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.to(denominator.dtype)
    numerator = torch.where(zero_div_mask, torch.full_like(numerator, float(zero_division)), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, torch.ones_like(denominator), denominator)
    weights = torch.where(ignore_mask, torch.zeros_like(weights), weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    scores = torch.where(torch.isnan(scores), torch.full_like(scores, float(zero_division)), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        scores = torch.mean(scores, dim=0)
        ignore_mask = torch.sum(ignore_mask, dim=0).to(torch.bool)

    if average in (AverageMethod.NONE, None):
        scores = torch.where(ignore_mask, torch.full_like(scores, float("nan")), scores)
    else:
        scores = torch.sum(scores)
    return scores


def stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    device: DeviceLike = None,
) -> Tensor:
    """Compute [tp, fp, tn, fn, support] on ``device`` (default: the inputs'
    device, else ``cuda``)."""
    if reduce not in ["micro", "macro", "samples"]:
        raise ValueError(f"The `reduce` {reduce} is not valid.")
    if mdmc_reduce not in [None, "samplewise", "global"]:
        raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")
    dev = tensor_device(preds, target, device=device)
    tp, fp, tn, fn = _stat_scores_update(
        as_input(preds, dev),
        as_input(target, dev),
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        top_k=top_k,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _stat_scores_compute(tp, fp, tn, fn)
