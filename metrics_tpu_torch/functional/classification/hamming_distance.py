"""Hamming distance (port of ``metrics_tpu/functional/classification/hamming_distance.py``).

``num_classes``/``multiclass`` are the JAX build's static-shape hints: under
``torch.func.vmap`` (the engines' per-row update) integer labels cannot give
the class count from their values.
"""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _hamming_distance_update(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[Tensor, int]:
    preds, target, _ = _input_format_classification(
        preds, target, threshold=threshold, num_classes=num_classes, multiclass=multiclass
    )
    correct = torch.sum(preds == target, dtype=torch.int32)
    return correct, preds.numel()


def _hamming_distance_compute(correct: Tensor, total: Union[int, Tensor]) -> Tensor:
    return 1 - correct.to(torch.float32) / total


def hamming_distance(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    device: DeviceLike = None,
) -> Tensor:
    """The average Hamming distance (loss) between targets and predictions."""
    dev = tensor_device(preds, target, device=device)
    correct, total = _hamming_distance_update(as_input(preds, dev), as_input(target, dev), threshold, num_classes,
                                              multiclass)
    return _hamming_distance_compute(correct, total)
