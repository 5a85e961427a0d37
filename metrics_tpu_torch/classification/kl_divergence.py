"""KLDivergence module metric (port of ``metrics_tpu/classification/kl_divergence.py``).

With ``reduction="mean"`` or ``"sum"`` the state is a float sum and an int32
count, which the engines serve; with ``"none"`` the per-row measures are a
list state, which they refuse.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.kl_divergence import _kld_compute, _kld_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class KLDivergence(Metric):
    """KL divergence D_KL(P||Q) with mean, sum or no reduction."""

    is_differentiable = True
    higher_is_better = False

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.log_prob = log_prob

        allowed_reduction = ["mean", "sum", "none", None]
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction

        if self.reduction in ["mean", "sum"]:
            self.add_state("measures", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, p: Tensor, q: Tensor) -> None:
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction is None or self.reduction == "none":
            self.measures.append(measures)
        else:
            self.measures = self.measures + torch.sum(measures)
            self.total = self.total + total

    def compute(self) -> Tensor:
        measures = dim_zero_cat(self.measures) if self.reduction in (None, "none") else self.measures
        return _kld_compute(measures, self.total, self.reduction)
