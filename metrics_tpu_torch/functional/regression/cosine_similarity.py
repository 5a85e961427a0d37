"""Cosine similarity over the last dim (port of
``metrics_tpu/functional/regression/cosine_similarity.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    dot_product = torch.sum(preds * target, dim=-1)
    preds_norm = torch.linalg.vector_norm(preds, dim=-1)
    target_norm = torch.linalg.vector_norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    if reduction == "sum":
        return torch.sum(similarity)
    if reduction == "mean":
        return torch.mean(similarity)
    return similarity


def cosine_similarity(
    preds: Tensor, target: Tensor, reduction: Optional[str] = "sum", device: DeviceLike = None
) -> Tensor:
    """Compute cosine similarity row by row, with sum, mean or no reduction."""
    dev = tensor_device(preds, target, device=device)
    preds, target = _cosine_similarity_update(as_input(preds, dev), as_input(target, dev))
    return _cosine_similarity_compute(preds, target, reduction)
