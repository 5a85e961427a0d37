"""Functional classification metrics of the port."""
from metrics_tpu_torch.functional.classification.accuracy import accuracy
from metrics_tpu_torch.functional.classification.average_precision import average_precision
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix
from metrics_tpu_torch.functional.classification.f_beta import f1, f1_score, fbeta
from metrics_tpu_torch.functional.classification.precision_recall_curve import precision_recall_curve
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores

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
