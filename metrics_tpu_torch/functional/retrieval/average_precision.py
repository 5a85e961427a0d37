"""Retrieval average precision (port of ``metrics_tpu/functional/retrieval/average_precision.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._inputs import best_first, query_inputs, zero_like
from metrics_tpu_torch.utils.device import DeviceLike

Tensor = torch.Tensor


def retrieval_average_precision(preds: Tensor, target: Tensor, device: DeviceLike = None) -> Tensor:
    """AP of a single query's predictions."""
    preds, target = query_inputs(preds, target, device)
    if not int(target.sum()):
        return zero_like(preds)
    target = best_first(preds, target)
    # positions (1-based) of relevant docs; precision@pos averaged over relevant docs
    positions = torch.arange(1, target.shape[0] + 1, dtype=torch.float32, device=target.device)
    rel = target > 0
    cum_rel = torch.cumsum(rel.to(torch.float32), dim=0)
    prec_at_rel = torch.where(rel, cum_rel / positions, 0.0)
    return prec_at_rel.sum() / rel.sum()
