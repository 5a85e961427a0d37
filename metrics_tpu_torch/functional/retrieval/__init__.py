"""Retrieval functionals of the port (``metrics_tpu/functional/retrieval``)."""
from metrics_tpu_torch.functional.retrieval.average_precision import retrieval_average_precision
from metrics_tpu_torch.functional.retrieval.fall_out import retrieval_fall_out
from metrics_tpu_torch.functional.retrieval.hit_rate import retrieval_hit_rate
from metrics_tpu_torch.functional.retrieval.ndcg import retrieval_normalized_dcg
from metrics_tpu_torch.functional.retrieval.precision import retrieval_precision
from metrics_tpu_torch.functional.retrieval.r_precision import retrieval_r_precision
from metrics_tpu_torch.functional.retrieval.recall import retrieval_recall
from metrics_tpu_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank

__all__ = [
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
