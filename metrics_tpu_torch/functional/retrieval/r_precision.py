"""Retrieval R-precision (port of ``metrics_tpu/functional/retrieval/r_precision.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._inputs import best_first, query_inputs, zero_like
from metrics_tpu_torch.utils.device import DeviceLike

Tensor = torch.Tensor


def retrieval_r_precision(preds: Tensor, target: Tensor, device: DeviceLike = None) -> Tensor:
    """Precision at R where R = number of relevant documents."""
    preds, target = query_inputs(preds, target, device)
    relevant_number = int(target.sum())
    if not relevant_number:
        return zero_like(preds)
    relevant = best_first(preds, target)[:relevant_number].sum().to(torch.float32)
    return relevant / relevant_number
