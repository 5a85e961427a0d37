"""Confusion matrix (binary / multiclass / multilabel).

Port of ``metrics_tpu/functional/classification/confusion_matrix.py``. The
bincount over ``target * C + preds`` goes through ``utils/data.py::_bincount``
to the K2 histogram kernel on the card (its vmap rule serves the masked
engine step) and to its plain version on the CPU.
"""
from typing import Optional

import torch

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.data import _bincount
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.enums import DataType

Tensor = torch.Tensor


def _confusion_matrix_update(
    preds: Tensor, target: Tensor, num_classes: int, threshold: float = 0.5, multilabel: bool = False
) -> Tensor:
    # integer label inputs get the ctor's num_classes as the formatter hint
    # (it cannot be inferred from values under vmap); float inputs must not,
    # since num_classes=2 means a 2x2 matrix over BINARY data there
    is_int = not preds.is_floating_point()
    preds, target, mode = _input_format_classification(
        preds, target, threshold,
        num_classes=num_classes if is_int else None,
        multiclass=False if (multilabel and is_int) else None,
    )
    if multilabel:
        offsets = 4 * torch.arange(num_classes, device=preds.device, dtype=torch.int32)
        unique_mapping = (2 * target + preds + offsets).reshape(-1)
        minlength = 4 * num_classes
    else:
        if mode not in (DataType.BINARY, DataType.MULTILABEL):
            preds = torch.argmax(preds, dim=1)
            target = torch.argmax(target, dim=1)
        unique_mapping = target.reshape(-1) * num_classes + preds.reshape(-1)
        minlength = num_classes**2

    bins = _bincount(unique_mapping, minlength)
    if multilabel:
        return bins.reshape(num_classes, 2, 2)
    return bins.reshape(num_classes, num_classes)


def _confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat if confmat.is_floating_point() else confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / torch.sum(confmat, dim=1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / torch.sum(confmat, dim=0, keepdim=True)
        elif normalize == "all":
            confmat = confmat / torch.sum(confmat)
        confmat = torch.where(torch.isnan(confmat), torch.zeros_like(confmat), confmat)
    return confmat


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    threshold: float = 0.5,
    multilabel: bool = False,
    device: DeviceLike = None,
) -> Tensor:
    """The (C, C) (or (C, 2, 2) multilabel) confusion matrix on ``device``
    (default: the inputs' device, else ``cuda``)."""
    dev = tensor_device(preds, target, device=device)
    confmat = _confusion_matrix_update(as_input(preds, dev), as_input(target, dev), num_classes, threshold, multilabel)
    return _confusion_matrix_compute(confmat, normalize)
