"""Retrieval precision@k (port of ``metrics_tpu/functional/retrieval/precision.py``)."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.retrieval._inputs import best_first, check_k, query_inputs, zero_like
from metrics_tpu_torch.utils.device import DeviceLike

Tensor = torch.Tensor


def retrieval_precision(preds: Tensor, target: Tensor, k: Optional[int] = None, device: DeviceLike = None) -> Tensor:
    """Fraction of the top-k documents that are relevant."""
    preds, target = query_inputs(preds, target, device)
    if k is None:
        k = preds.shape[-1]
    check_k(k)
    if not int(target.sum()):
        return zero_like(preds)
    relevant = best_first(preds, target)[: min(k, preds.shape[-1])].sum().to(torch.float32)
    return relevant / k
