"""PearsonCorrCoef module metric (port of ``metrics_tpu/regression/pearson.py``).

Six ``dist_reduce_fx=None`` streaming moments, merged jointly rather than
leaf by leaf: ``full_state_update`` sends ``forward`` through the snapshot
path, and the engines refuse the metric. After a sync the moments arrive
stacked ``(world, ...)`` and ``compute`` folds them with Chan's parallel
formula (:func:`_final_aggregation`).
"""
from typing import Any, Tuple

import torch

from metrics_tpu_torch.functional.regression.pearson import (
    _as_float,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _final_aggregation(
    means_x: Tensor,
    means_y: Tensor,
    vars_x: Tensor,
    vars_y: Tensor,
    corrs_xy: Tensor,
    nbs: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fold per-process streaming statistics with the Chan et al. parallel
    formula: the accumulated states are exact sums of squared deviations and
    cross products, so M2 = M2_1 + M2_2 + n1*n2/nb * (m1-m2)^2 (and the
    cross-product analogue), as in the JAX package."""
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, means_x.shape[0]):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        mean_x = (n1 * mx1 + n2 * mx2) / nb
        mean_y = (n1 * my1 + n2 * my2) / nb
        w = (n1 * n2) / nb
        var_x = vx1 + vx2 + w * (mx1 - mx2) ** 2
        var_y = vy1 + vy2 + w * (my1 - my2) ** 2
        corr_xy = cxy1 + cxy2 + w * (mx1 - mx2) * (my1 - my2)
        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return vx1, vy1, cxy1, n1


class PearsonCorrCoef(Metric):
    """Pearson correlation coefficient from streaming mean, variance and
    covariance statistics, merged across processes by Chan's formula."""

    is_differentiable = True
    higher_is_better = None
    # forward() must snapshot and restore: the streaming statistics merge
    # jointly (Chan's formula over the whole state), not leaf by leaf
    full_state_update = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        for name in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"):
            self.add_state(name, default=torch.zeros((), dtype=torch.float32), dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = _as_float(preds)
        target = _as_float(target, preds.dtype)
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
        )

    def compute(self) -> Tensor:
        if self.mean_x.ndim > 0 and self.mean_x.shape[0] > 1:
            # after a sync: statistics stacked (world, ...), folded by Chan's formula
            var_x, var_y, corr_xy, n_total = _final_aggregation(
                self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
            )
        else:
            var_x, var_y, corr_xy, n_total = self.var_x, self.var_y, self.corr_xy, self.n_total
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)


class PearsonCorrcoef(PearsonCorrCoef):
    """Deprecated alias of :class:`PearsonCorrCoef`."""

    def __init__(self, **kwargs: Any) -> None:
        rank_zero_warn(
            "`PearsonCorrcoef` was renamed to `PearsonCorrCoef` and it will be removed.",
            DeprecationWarning,
        )
        super().__init__(**kwargs)
