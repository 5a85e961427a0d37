"""MinMaxMetric wrapper: track the running min/max of a base metric's value.

Port of ``metrics_tpu/wrappers/minmax.py``.
"""
from typing import Any, Dict

import torch

from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class MinMaxMetric(Metric):
    """Wraps a metric and also reports the min and max value seen so far.

    The extremes track the running accumulated value after every update (the
    base metric's value on each growing prefix). Reading the accumulated
    state inside ``update`` makes this a ``full_state_update`` metric: the
    engines refuse it, and ``forward`` keeps the snapshot path.
    ``fold_on_compute=True`` folds the extremes only when ``compute`` runs,
    so ``update x N; compute`` gives ``min == max == raw``. The wrapper runs
    on its base metric's device unless ``device`` says otherwise.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MinMaxMetric
        >>> minmax = MinMaxMetric(Accuracy(device="cpu"))
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> _ = minmax(torch.tensor([0, 1, 0, 0]), target)  # running acc 0.75
        >>> _ = minmax(torch.tensor([1, 1, 0, 0]), target)  # running acc 0.875
        >>> {k: f"{float(v):.4f}" for k, v in minmax.compute().items()}
        {'raw': '0.8750', 'max': '0.8750', 'min': '0.7500'}
    """

    full_state_update = True

    def __init__(self, base_metric: Metric, fold_on_compute: bool = False, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu_torch.Metric` but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._base_metric = base_metric
        self.fold_on_compute = bool(fold_on_compute)
        self.add_state("min_val", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("max_val", torch.tensor(float("-inf")), dist_reduce_fx="max")

    def _fold_extremes(self, val: Any) -> None:
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}.")
        self.max_val = torch.where(self.max_val < val, val, self.max_val)
        self.min_val = torch.where(self.min_val > val, val, self.min_val)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)
        if not self.fold_on_compute:
            self._fold_extremes(self._base_metric._inner_compute())

    def compute(self) -> Dict[str, Tensor]:
        val = self._base_metric.compute()
        self._fold_extremes(val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def reset(self) -> None:
        super().reset()
        self._base_metric.reset()

    @staticmethod
    def _is_suitable_val(val: Any) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        return False
