"""Functional metrics of the port."""
from metrics_tpu_torch.functional.classification import (
    accuracy,
    average_precision,
    confusion_matrix,
    f1,
    f1_score,
    fbeta,
    precision_recall_curve,
    stat_scores,
)

__all__ = [
    "accuracy",
    "average_precision",
    "confusion_matrix",
    "f1",
    "f1_score",
    "fbeta",
    "precision_recall_curve",
    "stat_scores",
]
