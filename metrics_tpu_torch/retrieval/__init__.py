"""Retrieval metrics of the port (``metrics_tpu/retrieval``)."""
from metrics_tpu_torch.retrieval.fall_out import RetrievalFallOut
from metrics_tpu_torch.retrieval.hit_rate import RetrievalHitRate
from metrics_tpu_torch.retrieval.mean_average_precision import RetrievalMAP
from metrics_tpu_torch.retrieval.mean_reciprocal_rank import RetrievalMRR
from metrics_tpu_torch.retrieval.ndcg import RetrievalNormalizedDCG
from metrics_tpu_torch.retrieval.r_precision import RetrievalRPrecision
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.retrieval.retrieval_precision import RetrievalPrecision
from metrics_tpu_torch.retrieval.retrieval_recall import RetrievalRecall

__all__ = [
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalRPrecision",
    "RetrievalRecall",
]
