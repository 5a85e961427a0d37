"""Aggregation metrics: generic reducers usable as standalone metrics.

Port of ``metrics_tpu/aggregation.py`` (BaseAggregator, MaxMetric, MinMetric,
SumMetric, CatMetric, MeanMetric) with the ``nan_strategy``
(error/warn/ignore/<float impute>) contract. NaN handling is branch-free
(``torch.where``); the 'error'/'warn' strategies read the values on the host,
so under ``torch.func.vmap`` (the engines' masked steps) or graph capture they
act as 'ignore' and warn, as the JAX package does inside ``jit``. ``Sum``,
``Mean``, ``Max`` and ``Min`` serve through the engines on the delta path;
``CatMetric``'s list state is refused there.
"""
from typing import Any, Callable, List, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _is_traced
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _is_impute(nan_strategy: Any) -> bool:
    return isinstance(nan_strategy, (int, float)) and not isinstance(nan_strategy, bool)


class BaseAggregator(Metric):
    """Base of the aggregation metrics: one state ``value`` reduced by ``fn``."""

    is_differentiable = None
    higher_is_better = None

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[Tensor, List],
        nan_strategy: Union[str, float] = "error",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, (int, float)):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy} but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        self.add_state("value", default=default_value, dist_reduce_fx=fn)

    def _forward_jit_safe(self) -> bool:
        # 'error'/'warn' must see the values of EVERY batch (raise or warn on
        # nan); a compiled forward would degrade them to 'ignore'
        return self.nan_strategy not in ("error", "warn") and super()._forward_jit_safe()

    def _cast_and_nan_check_input(self, x: Union[float, Tensor]) -> Tensor:
        """The input as an f32 tensor on the metric's device, NaN strategy
        applied. A Python number becomes a device fill (no host-to-device
        copy, so it can sit inside a captured step)."""
        if isinstance(x, Tensor):
            x = x.to(torch.float32)
        elif isinstance(x, (int, float)):
            x = torch.full((), float(x), dtype=torch.float32, device=self.device)
        else:
            x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if self.nan_strategy in ("error", "warn"):
            if _is_traced(x):
                rank_zero_warn(
                    "nan_strategy='error'/'warn' cannot run under vmap or graph capture; treating as 'ignore'.",
                    UserWarning,
                )
            else:
                contains_nan = bool(torch.any(torch.isnan(x)))
                if contains_nan and self.nan_strategy == "error":
                    raise RuntimeError("Encountered `nan` values in tensor")
                if contains_nan and self.nan_strategy == "warn":
                    rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
        return x

    def _nan_mask_or_impute(self, x: Tensor, neutral: float) -> Tensor:
        """NaNs replaced by the impute value or a reduction-neutral element."""
        fill = float(self.nan_strategy) if _is_impute(self.nan_strategy) else neutral
        return torch.where(torch.isnan(x), fill, x)

    def update(self, value: Union[float, Tensor]) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def compute(self) -> Tensor:
        return self.value


class MaxMetric(BaseAggregator):
    """Running max."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(float("-inf")), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value = self._nan_mask_or_impute(self._cast_and_nan_check_input(value), float("-inf"))
        if value.numel():
            self.value = torch.maximum(self.value, torch.max(value))


class MinMetric(BaseAggregator):
    """Running min."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(float("inf")), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value = self._nan_mask_or_impute(self._cast_and_nan_check_input(value), float("inf"))
        if value.numel():
            self.value = torch.minimum(self.value, torch.min(value))


class SumMetric(BaseAggregator):
    """Running sum."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value = self._nan_mask_or_impute(self._cast_and_nan_check_input(value), 0.0)
        if value.numel():
            self.value = self.value + torch.sum(value)


class CatMetric(BaseAggregator):
    """Concatenation of every value seen (a list state: not served by the engines)."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value = torch.atleast_1d(self._cast_and_nan_check_input(value))
        if isinstance(self.nan_strategy, (int, float)) and not isinstance(self.nan_strategy, str):
            value = self._nan_mask_or_impute(value, 0.0)
        elif not _is_traced(value):
            value = value[~torch.isnan(value)]
        if value.numel():
            self.value.append(value)

    def compute(self) -> Tensor:
        return dim_zero_cat(self.value) if self.value else torch.zeros(0, device=self.device)


class MeanMetric(BaseAggregator):
    """Running (weighted) mean."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        value = self._cast_and_nan_check_input(value)
        weight = self._cast_and_nan_check_input(weight)
        if value.numel() == 0:
            return
        weight = torch.broadcast_to(weight, value.shape)
        nan = torch.isnan(value)
        value = self._nan_mask_or_impute(value, 0.0)
        if not _is_impute(self.nan_strategy):
            weight = torch.where(nan, 0.0, weight)
        self.value = self.value + torch.sum(value * weight)
        self.weight = self.weight + torch.sum(weight)

    def compute(self) -> Tensor:
        return self.value / self.weight
