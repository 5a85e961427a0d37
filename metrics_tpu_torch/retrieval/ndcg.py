"""RetrievalNormalizedDCG (port of ``metrics_tpu/retrieval/ndcg.py``; graded
relevance allowed)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.retrieval.ndcg import retrieval_normalized_dcg
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric, check_metric_k

Tensor = torch.Tensor


class RetrievalNormalizedDCG(RetrievalMetric):
    """nDCG@k averaged over queries."""

    _segment_kind = "ndcg"

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 k: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        self.k = check_metric_k(k)
        self.allow_non_binary_target = True

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_normalized_dcg(preds, target, k=self.k)
