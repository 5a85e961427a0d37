"""Specificity module metric (port of ``metrics_tpu/classification/specificity.py``)."""
import torch

from metrics_tpu_torch.classification.stat_scores import _AveragedStatScores
from metrics_tpu_torch.functional.classification.specificity import _specificity_compute

Tensor = torch.Tensor


class Specificity(_AveragedStatScores):
    """Specificity = TN / (TN + FP)."""

    is_differentiable = False
    higher_is_better = True

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _specificity_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)
