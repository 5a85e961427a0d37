"""PIT module metric (port of ``metrics_tpu/audio/pit.py``) and its deprecated alias ``PIT``."""
from typing import Any, Callable, Dict

import torch

from metrics_tpu_torch.functional.audio.pit import pit
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

#: the keyword arguments the base class takes; every other one goes to ``metric_func``
_BASE_KWARGS = ("compute_on_step", "dist_sync_on_step", "sync_axis", "dist_sync_fn", "process_group", "device",
                "sync_precision")


class PermutationInvariantTraining(Metric):
    """Permutation-invariant evaluation of a signal-level audio metric,
    averaged over batch rows.

    The base class's keyword arguments (``compute_on_step``,
    ``dist_sync_on_step``, ``sync_axis``, ``dist_sync_fn``,
    ``process_group``, ``device``, ``sync_precision``) are taken out of
    ``kwargs``; the rest go to ``metric_func`` on every call.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PermutationInvariantTraining
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_noise_ratio
        >>> n = torch.arange(64.0)
        >>> preds = torch.stack([torch.sin(n/3) + 0.2*torch.cos(n/7), torch.cos(n/5) + 0.2*torch.sin(n/9)])[None]
        >>> target = torch.stack([torch.cos(n/5), torch.sin(n/3)])[None]  # speakers swapped
        >>> pit = PermutationInvariantTraining(scale_invariant_signal_noise_ratio, eval_func="max", device="cpu")
        >>> print(f"{float(pit(preds, target)):.4f}")
        14.2851
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        metric_func: Callable,
        eval_func: str = "max",
        **kwargs: Any,
    ) -> None:
        base_kwargs: Dict[str, Any] = {k: kwargs.pop(k) for k in _BASE_KWARGS if k in kwargs}
        super().__init__(**base_kwargs)
        self.metric_func = metric_func
        self.eval_func = eval_func
        self.kwargs = kwargs
        self.add_state("sum_pit_metric", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        pit_metric = pit(preds, target, self.metric_func, self.eval_func, **self.kwargs)[0]
        self.sum_pit_metric = self.sum_pit_metric + torch.sum(pit_metric)
        self.total = self.total + pit_metric.numel()

    def compute(self) -> Tensor:
        return self.sum_pit_metric / self.total


class PIT(PermutationInvariantTraining):
    """Deprecated alias of :class:`PermutationInvariantTraining`."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        rank_zero_warn(
            "`PIT` was renamed to `PermutationInvariantTraining` and it will be removed.", DeprecationWarning
        )
        super().__init__(*args, **kwargs)
