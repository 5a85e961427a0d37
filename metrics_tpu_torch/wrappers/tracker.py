"""MetricTracker wrapper: track a metric (or collection) over several epochs.

Port of ``metrics_tpu/wrappers/tracker.py``.
"""
from copy import deepcopy
from typing import Any, Dict, List, Tuple, Union

import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


def _stackable(value: Any) -> Tensor:
    """A value as one tensor: a list of per-class values (binned average
    precision's) stacks, as ``jnp.stack`` takes it."""
    return torch.stack(list(value)) if isinstance(value, (list, tuple)) else value


class MetricTracker:
    """A list of metric snapshots, one per ``increment()`` call.

    ``best_metric(return_step=True)`` returns ``(step, value)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricTracker
        >>> tracker = MetricTracker(Accuracy(device="cpu"))
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> for epoch_preds in [torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0])]:
        ...     tracker.increment()
        ...     _ = tracker(epoch_preds, target)
        >>> step, best = tracker.best_metric(return_step=True)
        >>> print(f"{best:.4f} at step {step}")
        1.0000 at step 1
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a metrics_tpu_torch"
                f" `Metric` or `MetricCollection` but got {metric}"
            )
        self._base_metric = metric
        self._metrics: List[Union[Metric, MetricCollection]] = []
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
            raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        self.maximize = maximize
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        """Number of tracked metrics (increments so far)."""
        return len(self._metrics)

    def increment(self) -> None:
        """Create a new (clean) instance of the metric to track."""
        self._increment_called = True
        self._metrics.append(deepcopy(self._base_metric))
        self._metrics[-1].reset()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._metrics[-1](*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._metrics[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._metrics[-1].compute()

    def compute_all(self) -> Union[Tensor, Dict[str, Tensor]]:
        """Compute all tracked metrics, stacked over steps."""
        self._check_for_increment("compute_all")
        res = [metric.compute() for metric in self._metrics]
        if isinstance(self._base_metric, MetricCollection):
            keys = res[0].keys()
            return {k: torch.stack([_stackable(r[k]) for r in res], dim=0) for k in keys}
        return torch.stack([_stackable(r) for r in res], dim=0)

    def reset(self) -> None:
        """Reset the current metric being tracked."""
        self._metrics[-1].reset()

    def reset_all(self) -> None:
        for metric in self._metrics:
            metric.reset()

    def best_metric(
        self, return_step: bool = False
    ) -> Union[float, Tuple[int, float], Dict[str, float], Tuple[Dict[str, int], Dict[str, float]]]:
        """Best value seen and, with ``return_step``, the step it was seen at
        (``(step, value)``)."""
        res = self.compute_all()
        if isinstance(res, dict):
            maximize = self.maximize if isinstance(self.maximize, list) else [self.maximize] * len(res)
            value, idx = {}, {}
            for i, (k, v) in enumerate(res.items()):
                out = torch.argmax(v, dim=0) if maximize[i] else torch.argmin(v, dim=0)
                value[k] = float(v[out])
                idx[k] = int(out)
            if return_step:
                return idx, value
            return value
        i = int(torch.argmax(res, dim=0) if self.maximize else torch.argmin(res, dim=0))
        if return_step:
            return i, float(res[i])
        return float(res[i])

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called")
