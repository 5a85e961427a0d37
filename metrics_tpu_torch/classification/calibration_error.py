"""CalibrationError module metric (port of ``metrics_tpu/classification/calibration_error.py``).

Its confidences and accuracies are list states, so the engines refuse it
(``masked_update_strategy()`` is None), as the JAX package's engines do.
"""
from typing import Any

import torch

from metrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries, _ce_compute, _ce_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class CalibrationError(Metric):
    """Top-label calibration error with the l1 (ECE), l2 or max norm."""

    is_differentiable = False
    higher_is_better = False

    DISTANCES = {"l1", "l2", "max"}

    def __init__(self, n_bins: int = 15, norm: str = "l1", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if norm not in self.DISTANCES:
            raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
        if not isinstance(n_bins, int) or n_bins <= 0:
            raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")
        self.n_bins = n_bins
        self.norm = norm
        self.bin_boundaries = _bin_boundaries(n_bins, self.device)
        self.add_state("confidences", [], dist_reduce_fx="cat")
        self.add_state("accuracies", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        confidences, accuracies = _ce_update(preds, target)
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)

    def compute(self) -> Tensor:
        confidences = dim_zero_cat(self.confidences)
        accuracies = dim_zero_cat(self.accuracies)
        return _ce_compute(confidences, accuracies, self.bin_boundaries, norm=self.norm)
