"""AUROC module metric.

Port of ``metrics_tpu/classification/auroc.py``. Two state layouts:

* default: list states of the scores and labels; the exact sort-based
  compute runs eagerly on their concatenation;
* ``capacity=N``: static ``(capacity, ...)`` buffers with a valid mask and a
  device cursor (``classification/_capacity.py``), so the exact tie-aware
  compute (``ops/masked_curves.py``) has static shapes and the metric serves
  through the streaming engine's scan strategy. Overflowing the capacity
  gives NaN (and a warning where the flag can be read on the host).
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.classification._capacity import CapacityCurveStateMixin
from metrics_tpu_torch.functional.classification.auroc import _auroc_compute, _auroc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.masked_curves import masked_binary_auroc, masked_multilabel_auroc
from metrics_tpu_torch.utils.data import dim_zero_cat, to_onehot
from metrics_tpu_torch.utils.enums import DataType

Tensor = torch.Tensor


class AUROC(CapacityCurveStateMixin, Metric):
    """Area under the ROC curve (binary, multiclass one-vs-rest, multilabel)."""

    is_differentiable = False
    higher_is_better = True
    # `mode` is latched from the data during update, and compute refuses to
    # run without it: the engines latch and carry it
    _host_derived_compute_attrs = ("mode",)

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.average = average
        self.max_fpr = max_fpr
        self.capacity = capacity

        allowed_average = (None, "macro", "weighted", "micro")
        if average not in allowed_average:
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        if max_fpr is not None and (not isinstance(max_fpr, float) or not 0 < max_fpr <= 1):
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")

        self.mode: Optional[DataType] = None
        if capacity is None:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            if max_fpr is not None:
                raise ValueError("`max_fpr` is not supported in static-capacity mode (use the default eager mode)")
            self._validate_capacity_kwargs(pos_label, average)
            self._init_capacity_states()

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, mode = _auroc_update(preds, target)
        if self.mode and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode
        if self.capacity is None:
            self.preds.append(preds)
            self.target.append(target)
            return

        c = self._capacity_num_columns()
        if (mode == DataType.BINARY) != (c is None):
            raise ValueError(
                "Static-capacity AUROC needs `num_classes` matching the data: leave it unset/1 for"
                f" binary inputs, set it to C for multiclass/multilabel — got num_classes={self.num_classes}"
                f" with {mode} data"
            )
        if c and target.ndim == 1:
            # multiclass (and multidim-multiclass, flattened by _auroc_update) labels become one-hot columns
            target = to_onehot(target, c)
        self._capacity_write(preds, target)

    def compute(self) -> Tensor:
        if not self.mode:
            raise RuntimeError("You have to have determined mode.")
        if self.capacity is not None:
            return self._compute_capacity_with(masked_binary_auroc, masked_multilabel_auroc)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _auroc_compute(preds, target, self.mode, self.num_classes, self.pos_label, self.average, self.max_fpr)
