"""RetrievalFallOut (port of ``metrics_tpu/retrieval/fall_out.py``): lower is
better, and "empty" means a query with no NEGATIVE targets."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.retrieval.fall_out import retrieval_fall_out
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric, check_metric_k

Tensor = torch.Tensor


class RetrievalFallOut(RetrievalMetric):
    """Fall-out@k averaged over queries."""

    higher_is_better = False
    _segment_kind = "fall_out"

    def __init__(self, empty_target_action: str = "pos", ignore_index: Optional[int] = None,
                 k: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        self.k = check_metric_k(k)

    def _is_empty_query(self, mini_target: Tensor) -> bool:
        # a query is degenerate when it has no negative targets
        return not float(torch.sum(1 - mini_target))

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_fall_out(preds, target, k=self.k)
