"""RetrievalRPrecision (port of ``metrics_tpu/retrieval/r_precision.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval.r_precision import retrieval_r_precision
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric

Tensor = torch.Tensor


class RetrievalRPrecision(RetrievalMetric):
    """R-precision averaged over queries."""

    _segment_kind = "r_precision"

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_r_precision(preds, target)
