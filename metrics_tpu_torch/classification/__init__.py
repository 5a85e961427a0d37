"""Module metrics for classification."""
from metrics_tpu_torch.classification.accuracy import Accuracy
from metrics_tpu_torch.classification.binned_precision_recall import (
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
)
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.classification.f_beta import F1Score, FBeta
from metrics_tpu_torch.classification.stat_scores import StatScores

__all__ = [
    "Accuracy",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "ConfusionMatrix",
    "F1Score",
    "FBeta",
    "StatScores",
]
