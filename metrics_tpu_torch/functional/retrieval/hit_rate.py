"""Retrieval hit rate@k (port of ``metrics_tpu/functional/retrieval/hit_rate.py``)."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.retrieval._inputs import best_first, check_k, query_inputs
from metrics_tpu_torch.utils.device import DeviceLike

Tensor = torch.Tensor


def retrieval_hit_rate(preds: Tensor, target: Tensor, k: Optional[int] = None, device: DeviceLike = None) -> Tensor:
    """1.0 if any of the top-k documents is relevant."""
    preds, target = query_inputs(preds, target, device)
    if k is None:
        k = preds.shape[-1]
    check_k(k)
    relevant = best_first(preds, target)[:k].sum()
    return (relevant > 0).to(torch.float32)
