"""HingeLoss module metric and its deprecated ``Hinge`` alias (port of
``metrics_tpu/classification/hinge.py``)."""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.hinge import MulticlassMode, _hinge_compute, _hinge_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class HingeLoss(Metric):
    """Mean hinge loss, with the Crammer-Singer or one-vs-all multiclass modes."""

    is_differentiable = True
    higher_is_better = False

    def __init__(
        self,
        squared: bool = False,
        multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.add_state("measure", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

        if multiclass_mode not in (None, MulticlassMode.CRAMMER_SINGER, MulticlassMode.ONE_VS_ALL):
            raise ValueError(
                "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
                "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
                f" got {multiclass_mode}."
            )
        self.squared = squared
        self.multiclass_mode = multiclass_mode

    def update(self, preds: Tensor, target: Tensor) -> None:
        measure, total = _hinge_update(preds, target, squared=self.squared, multiclass_mode=self.multiclass_mode)
        self.measure = measure + self.measure
        self.total = total + self.total

    def compute(self) -> Tensor:
        return _hinge_compute(self.measure, self.total)


class Hinge(HingeLoss):
    """Deprecated alias of :class:`HingeLoss`."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        rank_zero_warn("`Hinge` was renamed to `HingeLoss` and it will be removed.", DeprecationWarning)
        super().__init__(*args, **kwargs)
