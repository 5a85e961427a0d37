"""Jaccard index (port of ``metrics_tpu/functional/classification/jaccard.py``).

``ignore_index`` zeroes that class's confusion-matrix row with ``torch.where``
and drops its score by static slicing, and absent classes take
``absent_score`` through ``torch.where``: no branch reads the data, so the
compute runs under ``torch.func.vmap`` (the engines' batched ``results()``).
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.parallel.collectives import reduce
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _jaccard_from_confmat(
    confmat: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> Tensor:
    ignored = ignore_index is not None and 0 <= ignore_index < num_classes
    if ignored:
        rows = torch.arange(num_classes, device=confmat.device).unsqueeze(1)
        confmat = torch.where(rows == ignore_index, torch.zeros_like(confmat), confmat)

    intersection = torch.diagonal(confmat, dim1=-2, dim2=-1)
    union = torch.sum(confmat, dim=0) + torch.sum(confmat, dim=1) - intersection

    scores = intersection.to(torch.float32) / union.to(torch.float32)
    scores = torch.where(union == 0, torch.full_like(scores, absent_score), scores)

    if ignored:
        scores = torch.cat([scores[:ignore_index], scores[ignore_index + 1:]])
    return reduce(scores, reduction=reduction)


def jaccard_index(
    preds: Tensor,
    target: Tensor,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    reduction: str = "elementwise_mean",
    device: DeviceLike = None,
) -> Tensor:
    """The Jaccard index (intersection over union) of ``preds`` and ``target``."""
    dev = tensor_device(preds, target, device=device)
    preds, target = as_input(preds, dev), as_input(target, dev)
    if num_classes is None:
        if preds.ndim == target.ndim:
            num_classes = int(max(torch.max(preds), torch.max(target))) + 1
        else:
            num_classes = preds.shape[1]
        num_classes = max(2, num_classes)
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold)
    return _jaccard_from_confmat(confmat, num_classes, ignore_index, absent_score, reduction)
