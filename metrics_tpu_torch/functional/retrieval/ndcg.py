"""Retrieval normalized discounted cumulative gain (port of
``metrics_tpu/functional/retrieval/ndcg.py``)."""
from typing import Optional

import numpy as np
import torch

from metrics_tpu_torch.functional.retrieval._inputs import best_first, check_k, query_inputs
from metrics_tpu_torch.utils.device import DeviceLike

Tensor = torch.Tensor


def log2_position_discounts(n: int, device: torch.device) -> Tensor:
    """``1 / log2(rank + 1)`` for 1-based ranks ``1..n``, computed in float64
    numpy and rounded once to f32 (an f32 ``log2`` costs ~1e-5 absolute in
    the final nDCG). Shared by the per-query functional and the segment
    path (``_segment.py``)."""
    return torch.from_numpy((1.0 / np.log2(np.arange(n) + 2.0)).astype(np.float32)).to(device)


def _dcg(target: Tensor) -> Tensor:
    return torch.sum(target * log2_position_discounts(target.shape[-1], target.device), dim=-1)


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, k: Optional[int] = None,
                             device: DeviceLike = None) -> Tensor:
    """nDCG@k with (possibly graded) relevance targets."""
    preds, target = query_inputs(preds, target, device, allow_non_binary_target=True)
    k = preds.shape[-1] if k is None else k
    check_k(k)
    sorted_target = best_first(preds, target)[:k]
    ideal_target = torch.sort(target, descending=True).values[:k]
    ideal_dcg = _dcg(ideal_target)
    target_dcg = _dcg(sorted_target)
    return torch.where(ideal_dcg == 0, 0.0, target_dcg / torch.where(ideal_dcg == 0, 1.0, ideal_dcg))
