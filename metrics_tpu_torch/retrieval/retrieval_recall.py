"""RetrievalRecall (port of ``metrics_tpu/retrieval/retrieval_recall.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.retrieval.recall import retrieval_recall
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric, check_metric_k

Tensor = torch.Tensor


class RetrievalRecall(RetrievalMetric):
    """Recall@k averaged over queries."""

    _segment_kind = "recall"

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 k: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        self.k = check_metric_k(k)

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_recall(preds, target, k=self.k)
