"""Binned (constant-memory, static-shape) precision-recall curve metrics.

Port of ``BinnedPrecisionRecallCurve``, ``BinnedAveragePrecision`` and
``BinnedRecallAtFixedPrecision`` from
``metrics_tpu/classification/binned_precision_recall.py``. States are fixed
``(C, T)`` f32 sum counters; the counting goes through
``ops/binned_update.binned_counts`` — the K3 kernel on the card, its plain
version on the CPU. ``thresholds`` defaults to 100 bins.
"""
from typing import Any, List, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute_with_precision_recall,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.binned_update import binned_counts
from metrics_tpu_torch.utils.data import METRIC_EPS, to_onehot

Tensor = torch.Tensor


def _recall_at_precision(
    precision: Tensor, recall: Tensor, thresholds: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    """Max recall subject to ``precision >= min_precision``, with static
    shapes: only the first ``len(thresholds)`` curve points count, and ties
    break toward the highest (recall, precision, threshold), as the
    reference's ``max`` over tuples does."""
    n = thresholds.shape[0]
    p, r = precision[:n], recall[:n]
    valid = p >= min_precision
    masked_recall = torch.where(valid, r, float("-inf"))
    best_r = torch.max(masked_recall)
    tie = masked_recall == best_r
    masked_p = torch.where(tie, p, float("-inf"))
    best_p = torch.max(masked_p)
    tie2 = tie & (masked_p == best_p)
    best_t = torch.max(torch.where(tie2, thresholds, float("-inf")))
    any_valid = torch.any(valid)
    max_recall = torch.where(any_valid, best_r, 0.0)
    best_threshold = torch.where(any_valid, best_t, 0.0)
    best_threshold = torch.where(max_recall == 0.0, 1e6, best_threshold)
    return max_recall, best_threshold


def _unit_linspace(num: int) -> Tensor:
    """``jnp.linspace(0, 1, num)`` in f32, bit for bit: JAX (on XLA) computes
    ``iota * (1 / (num - 1))`` in f32 and appends the end point."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32)
    step = torch.tensor(1.0, dtype=torch.float32) / (num - 1)
    return torch.cat([torch.arange(num - 1, dtype=torch.float32) * step, torch.ones(1, dtype=torch.float32)])


class BinnedPrecisionRecallCurve(Metric):
    """Precision-recall pairs at T fixed thresholds; states are (C, T) sum counters."""

    is_differentiable = False
    higher_is_better = None

    def __init__(
        self,
        num_classes: int,
        thresholds: Union[int, Tensor, List[float]] = 100,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        if isinstance(thresholds, int):
            self.num_thresholds = thresholds
            thr = _unit_linspace(thresholds)
        elif isinstance(thresholds, (list, Tensor)):
            thr = torch.as_tensor(thresholds, dtype=torch.float32)
            self.num_thresholds = thr.numel()
        else:
            raise ValueError("Expected argument `thresholds` to either be an integer, list of floats or a tensor")
        self.thresholds = thr.to(self.device)

        for name in ("TPs", "FPs", "FNs"):
            self.add_state(
                name=name,
                default=torch.zeros((num_classes, self.num_thresholds), dtype=torch.float32),
                dist_reduce_fx="sum",
            )

    def update(self, preds: Tensor, target: Tensor) -> None:
        """preds (N,) or (N, C) probabilities; target (N,) labels or (N, C) binary."""
        if preds.ndim == target.ndim == 1:
            preds = preds.reshape(-1, 1)
            target = target.reshape(-1, 1)
        if preds.ndim == target.ndim + 1:
            target = to_onehot(target, num_classes=self.num_classes)
        tps, fps, fns = binned_counts(preds, target == 1, self.thresholds)
        self.TPs = self.TPs + tps
        self.FPs = self.FPs + fps
        self.FNs = self.FNs + fns

    def _stacked_curves(self) -> Tuple[Tensor, Tensor]:
        """The curves in stacked ``(C, T+1)`` form."""
        precisions = (self.TPs + METRIC_EPS) / (self.TPs + self.FPs + METRIC_EPS)
        recalls = self.TPs / (self.TPs + self.FNs + METRIC_EPS)
        ones = torch.ones((self.num_classes, 1), dtype=precisions.dtype, device=precisions.device)
        zeros = torch.zeros((self.num_classes, 1), dtype=recalls.dtype, device=recalls.device)
        return torch.cat([precisions, ones], dim=1), torch.cat([recalls, zeros], dim=1)

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        precisions, recalls = self._stacked_curves()
        if self.num_classes == 1:
            return precisions[0, :], recalls[0, :], self.thresholds
        return list(precisions), list(recalls), [self.thresholds for _ in range(self.num_classes)]


class BinnedAveragePrecision(BinnedPrecisionRecallCurve):
    """Average precision summarised from the binned curve (one value per class)."""

    def compute(self) -> Union[List[Tensor], Tensor]:
        precisions, recalls, _ = super().compute()
        return _average_precision_compute_with_precision_recall(precisions, recalls, self.num_classes, average=None)


class BinnedRecallAtFixedPrecision(BinnedPrecisionRecallCurve):
    """Highest recall subject to a minimum precision, per class."""

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Union[int, Tensor, List[float]] = 100,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, **kwargs)
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        """``(max_recall, best_threshold)`` per class (scalars for binary):
        one ``torch.func.vmap`` over the stacked curves."""
        precisions, recalls = self._stacked_curves()
        if self.num_classes == 1:
            return _recall_at_precision(precisions[0], recalls[0], self.thresholds, self.min_precision)
        return torch.func.vmap(_recall_at_precision, in_dims=(0, 0, None, None))(
            precisions, recalls, self.thresholds, self.min_precision
        )
