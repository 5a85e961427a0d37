"""RetrievalMAP (port of ``metrics_tpu/retrieval/mean_average_precision.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval.average_precision import retrieval_average_precision
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric

Tensor = torch.Tensor


class RetrievalMAP(RetrievalMetric):
    """Mean average precision over queries."""

    _segment_kind = "map"

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_average_precision(preds, target)
