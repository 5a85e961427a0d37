"""SpearmanCorrCoef module metric (port of ``metrics_tpu/regression/spearman.py``):
``cat`` list states, ranked at compute. The engines refuse it (a list state
has no static shape); it runs eagerly."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.spearman import (
    _spearman_corrcoef_compute,
    _spearman_corrcoef_update,
    _widen,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation (ties ranked by their mean rank at compute)."""

    is_differentiable = False
    higher_is_better = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        rank_zero_warn(
            "Metric `SpearmanCorrcoef` will save all targets and predictions in the buffer."
            " For large datasets, this may lead to large memory footprint."
        )
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        # the functional's contract: integer inputs raise, sub-f32 floats widen
        preds, target = _spearman_corrcoef_update(_widen(preds), _widen(target))
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _spearman_corrcoef_compute(preds, target)


class SpearmanCorrcoef(SpearmanCorrCoef):
    """Deprecated alias of :class:`SpearmanCorrCoef`."""

    def __init__(self, **kwargs: Any) -> None:
        rank_zero_warn(
            "`SpearmanCorrcoef` was renamed to `SpearmanCorrCoef` and it will be removed.",
            DeprecationWarning,
        )
        super().__init__(**kwargs)
