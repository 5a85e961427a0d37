"""Retrieval mean reciprocal rank (port of ``metrics_tpu/functional/retrieval/reciprocal_rank.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._inputs import best_first, query_inputs, zero_like
from metrics_tpu_torch.utils.device import DeviceLike

Tensor = torch.Tensor


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor, device: DeviceLike = None) -> Tensor:
    """RR = 1 / rank of the first relevant document."""
    preds, target = query_inputs(preds, target, device)
    if not int(target.sum()):
        return zero_like(preds)
    target = best_first(preds, target)
    first = (target > 0).to(torch.int32).argmax()  # the first relevant position
    return 1.0 / (first.to(torch.float32) + 1.0)
