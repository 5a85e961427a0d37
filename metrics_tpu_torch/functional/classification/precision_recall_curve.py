"""Precision-recall curve (exact, one threshold per distinct score).

Port of ``metrics_tpu/functional/classification/precision_recall_curve.py``.
The exact curve has a data-dependent length, so this path is eager-only; the
static-shape alternative is the Binned* family
(``metrics_tpu_torch/classification/binned_precision_recall.py``).
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Cumulative fps/tps at each distinct score threshold (descending)."""
    if sample_weights is not None and not isinstance(sample_weights, Tensor):
        sample_weights = torch.as_tensor(sample_weights, dtype=torch.float32, device=preds.device)

    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    desc_score_indices = torch.argsort(-preds, stable=True)

    preds = preds[desc_score_indices]
    target = target[desc_score_indices]

    weight = sample_weights[desc_score_indices] if sample_weights is not None else 1.0

    distinct_value_indices = torch.nonzero(preds[1:] - preds[:-1]).reshape(-1)
    last = torch.tensor([target.shape[0] - 1], device=preds.device)
    threshold_idxs = torch.cat([distinct_value_indices, last])
    target = (target == pos_label).to(torch.int32)
    tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]
    if tps.dtype == torch.int64:
        tps = tps.to(torch.int32)

    if sample_weights is not None:
        fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    else:
        fps = (1 + threshold_idxs - tps).to(tps.dtype)
    return fps, tps, preds[threshold_idxs]


def _precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    """Canonicalize curve inputs; returns (preds, target, num_classes, pos_label)."""
    if preds.ndim == target.ndim:
        if pos_label is None:
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} in"
                    f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                    " number of classes from predictions"
                )
            preds = torch.swapaxes(preds, 0, 1).reshape(num_classes, -1).T
            target = torch.swapaxes(target, 0, 1).reshape(num_classes, -1).T
        else:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1
    elif preds.ndim == target.ndim + 1:
        if pos_label is not None:
            rank_zero_warn(
                "Argument `pos_label` should be `None` when running"
                f" multiclass precision recall curve. Got {pos_label}"
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} in"
                f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                " number of classes from predictions"
            )
        preds = torch.swapaxes(preds, 0, 1).reshape(num_classes, -1).T
        target = target.reshape(-1)
    else:
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")
    return preds, target, num_classes, pos_label


def _precision_recall_curve_compute_single_class(
    preds: Tensor,
    target: Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    fps, tps, thresholds = _binary_clf_curve(preds, target, sample_weights, pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]

    # stop when full recall attained; reverse so recall is decreasing
    last_ind = int(torch.nonzero(tps == tps[-1])[0, 0])
    sl = slice(0, last_ind + 1)
    precision = torch.cat([precision[sl].flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall[sl].flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    thresholds = thresholds[sl].flip(0)
    return precision, recall, thresholds


def _precision_recall_curve_compute_multi_class(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    precision, recall, thresholds = [], [], []
    for cls in range(num_classes):
        args = dict(preds=preds[:, cls], target=target, num_classes=1, pos_label=cls, sample_weights=sample_weights)
        if target.ndim > 1:
            args.update(dict(target=target[:, cls], pos_label=1))
        res = precision_recall_curve(**args)
        precision.append(res[0])
        recall.append(res[1])
        thresholds.append(res[2])
    return precision, recall, thresholds


def _precision_recall_curve_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    if num_classes == 1:
        if pos_label is None:
            pos_label = 1
        return _precision_recall_curve_compute_single_class(preds, target, pos_label, sample_weights)
    return _precision_recall_curve_compute_multi_class(preds, target, num_classes, sample_weights)


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
    device: DeviceLike = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Compute the precision-recall curve on ``device`` (default: the inputs'
    device, else ``cuda``)."""
    dev = tensor_device(preds, target, device=device)
    preds, target, num_classes, pos_label = _precision_recall_curve_update(
        as_input(preds, dev), as_input(target, dev), num_classes, pos_label
    )
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)
