"""Area under the ROC curve.

Port of ``metrics_tpu/functional/classification/auroc.py``: one ROC curve per
class, integrated by the trapezoidal rule; binary ``max_fpr`` adds a point at
``max_fpr`` by linear interpolation and applies the McClish correction. The
weighted multiclass average counts class support through
``utils/data.py::_bincount`` (the K2 histogram kernel on the card).
"""
import warnings
from typing import Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.classification.auc import _auc_compute_without_check
from metrics_tpu_torch.functional.classification.roc import roc
from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.data import _bincount
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.enums import AverageMethod, DataType

Tensor = torch.Tensor


def _auroc_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, DataType]:
    _, _, mode = _input_format_classification(preds, target)

    if mode == DataType.MULTIDIM_MULTICLASS:
        n_classes = preds.shape[1]
        preds = torch.swapaxes(preds, 0, 1).reshape(n_classes, -1).T
        target = target.reshape(-1)
    if mode == DataType.MULTILABEL and preds.ndim > 2:
        n_classes = preds.shape[1]
        preds = torch.swapaxes(preds, 0, 1).reshape(n_classes, -1).T
        target = torch.swapaxes(target, 0, 1).reshape(n_classes, -1).T
    return preds, target, mode


def _auroc_compute(
    preds: Tensor,
    target: Tensor,
    mode: DataType,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> Tensor:
    if mode == DataType.BINARY:
        num_classes = 1

    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                f"Partial AUC computation not available in multilabel/multiclass setting,"
                f" 'max_fpr' must be set to `None`, received `{max_fpr}`."
            )

    if mode == DataType.MULTILABEL:
        if average == AverageMethod.MICRO:
            fpr, tpr, _ = roc(preds.reshape(-1), target.reshape(-1), 1, pos_label, sample_weights)
        elif num_classes:
            output = [
                roc(preds[:, i], target[:, i], num_classes=1, pos_label=1, sample_weights=sample_weights)
                for i in range(num_classes)
            ]
            fpr = [o[0] for o in output]
            tpr = [o[1] for o in output]
        else:
            raise ValueError("Detected input to be `multilabel` but you did not provide `num_classes` argument")
    else:
        if mode != DataType.BINARY:
            if num_classes is None:
                raise ValueError("Detected input to `multiclass` but you did not provide `num_classes` argument")
            if average == AverageMethod.WEIGHTED and len(torch.unique(target)) < num_classes:
                # classes with 0 observations are dropped (their weight would be 0)
                target_bool_mat = target.reshape(-1, 1) == torch.arange(num_classes, device=target.device)
                class_observed = torch.sum(target_bool_mat, dim=0) > 0
                for c, seen in enumerate(class_observed.tolist()):
                    if not seen:
                        warnings.warn(f"Class {c} had 0 observations, omitted from AUROC calculation", UserWarning)
                keep = torch.nonzero(class_observed).reshape(-1)
                preds = preds[:, keep]
                target_bool_mat = target_bool_mat[:, keep]
                target = torch.nonzero(target_bool_mat)[:, 1]
                num_classes = int(len(keep))
                if num_classes == 1:
                    raise ValueError("Found 1 non-empty class in `multiclass` AUROC calculation")
        fpr, tpr, _ = roc(preds, target, num_classes, pos_label, sample_weights)

    if max_fpr is None or max_fpr == 1:
        if mode == DataType.MULTILABEL and average == AverageMethod.MICRO:
            pass
        elif num_classes != 1:
            auc_scores = torch.stack([_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)])
            if average == AverageMethod.NONE:
                return auc_scores
            if average == AverageMethod.MACRO:
                return torch.mean(auc_scores)
            if average == AverageMethod.WEIGHTED:
                if mode == DataType.MULTILABEL:
                    support = torch.sum(target, dim=0)
                else:
                    support = _bincount(target.reshape(-1), num_classes)
                return torch.sum(auc_scores * support / torch.sum(support))
            allowed_average = (AverageMethod.NONE.value, AverageMethod.MACRO.value, AverageMethod.WEIGHTED.value)
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        return _auc_compute_without_check(fpr, tpr, 1.0)

    max_area = torch.tensor(max_fpr, dtype=fpr.dtype, device=fpr.device)
    # add a point at max_fpr by linear interpolation
    stop = int(torch.searchsorted(fpr, max_area, right=True))
    weight = (max_area - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1])
    interp_tpr = tpr[stop - 1] + weight * (tpr[stop] - tpr[stop - 1])
    tpr = torch.cat([tpr[:stop], interp_tpr.reshape(1)])
    fpr = torch.cat([fpr[:stop], max_area.reshape(1)])

    partial_auc = _auc_compute_without_check(fpr, tpr, 1.0)
    min_area = 0.5 * max_area**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
    device: DeviceLike = None,
) -> Tensor:
    """Area under the ROC curve (binary, multiclass one-vs-rest, multilabel)
    on ``device`` (default: the inputs' device, else ``cuda``)."""
    dev = tensor_device(preds, target, device=device)
    preds, target, mode = _auroc_update(as_input(preds, dev), as_input(target, dev))
    return _auroc_compute(preds, target, mode, num_classes, pos_label, average, max_fpr, sample_weights)
