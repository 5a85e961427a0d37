"""Precision and Recall module metrics (port of ``metrics_tpu/classification/precision_recall.py``)."""
import torch

from metrics_tpu_torch.classification.stat_scores import _AveragedStatScores
from metrics_tpu_torch.functional.classification.precision_recall import _precision_compute, _recall_compute

Tensor = torch.Tensor


class Precision(_AveragedStatScores):
    """Precision = TP / (TP + FP)."""

    is_differentiable = False
    higher_is_better = True

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _precision_compute(tp, fp, fn, self.average, self.mdmc_reduce)


class Recall(_AveragedStatScores):
    """Recall = TP / (TP + FN)."""

    is_differentiable = False
    higher_is_better = True

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _recall_compute(tp, fp, fn, self.average, self.mdmc_reduce)
