"""RetrievalMRR (port of ``metrics_tpu/retrieval/mean_reciprocal_rank.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric

Tensor = torch.Tensor


class RetrievalMRR(RetrievalMetric):
    """Mean reciprocal rank over queries."""

    _segment_kind = "mrr"

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_reciprocal_rank(preds, target)
