"""Retrieval fall-out@k (port of ``metrics_tpu/functional/retrieval/fall_out.py``)."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.retrieval._inputs import best_first, check_k, query_inputs, zero_like
from metrics_tpu_torch.utils.device import DeviceLike

Tensor = torch.Tensor


def retrieval_fall_out(preds: Tensor, target: Tensor, k: Optional[int] = None, device: DeviceLike = None) -> Tensor:
    """Fraction of the non-relevant documents retrieved in the top k."""
    preds, target = query_inputs(preds, target, device)
    k = preds.shape[-1] if k is None else k
    check_k(k)
    target = 1 - target
    if not int(target.sum()):
        return zero_like(preds)
    relevant = best_first(preds, target)[:k].sum().to(torch.float32)
    return relevant / target.sum()
