"""MultioutputWrapper: apply a metric independently along an output dimension.

Port of ``metrics_tpu/wrappers/multioutput.py``.
"""
from copy import deepcopy
from typing import Any, List, Tuple

import numpy as np
import torch
from torch import nn

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import apply_to_collection
from metrics_tpu_torch.utils.device import as_input

Tensor = torch.Tensor


def _get_nan_indices(*tensors: Tensor) -> Tensor:
    """Rows where ANY of the tensors has a NaN."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    n = len(tensors[0])
    return torch.stack([torch.isnan(t.reshape(n, -1)).any(dim=1) for t in tensors]).any(dim=0)


class MultioutputWrapper(Metric):
    """Evaluate ``base_metric`` separately on each slice along ``output_dim``.

    ``remove_nans`` drops, per output, the rows where any input is NaN: a
    boolean index whose length depends on the data, so it runs eagerly only
    and its masked update raises (as in the JAX package); serve the wrapper
    with ``remove_nans=False``. The wrapper runs on its base metric's device
    unless ``device`` says otherwise.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MultioutputWrapper
        >>> acc2 = MultioutputWrapper(Accuracy(device="cpu"), num_outputs=2)
        >>> preds = torch.tensor([[1, 0], [0, 0], [1, 1]])
        >>> target = torch.tensor([[1, 1], [0, 0], [0, 1]])
        >>> [f"{float(v):.4f}" for v in acc2(preds, target)]
        ['0.6667', '0.6667']
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = nn.ModuleList([deepcopy(base_metric) for _ in range(num_outputs)])
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Any, **kwargs: Any) -> List[Tuple]:
        """Slice the inputs per output index, NaN rows dropped when asked."""
        args, kwargs = apply_to_collection((args, kwargs), (Tensor, np.ndarray), as_input, self.device)
        out = []
        for i in range(len(self.metrics)):
            selected_args = apply_to_collection(args, Tensor, torch.narrow, self.output_dim, i, 1)
            selected_kwargs = apply_to_collection(kwargs, Tensor, torch.narrow, self.output_dim, i, 1)
            if self.remove_nans:
                tensors = list(selected_args) + list(selected_kwargs.values())
                if tensors:
                    keep = ~_get_nan_indices(*tensors)
                    selected_args = [arg[keep] for arg in selected_args]
                    selected_kwargs = {k: v[keep] for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [arg.squeeze(self.output_dim) for arg in selected_args]
            out.append((selected_args, selected_kwargs))
        return out

    def update(self, *args: Any, **kwargs: Any) -> None:
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs)):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> Tensor:
        return torch.stack([m.compute() for m in self.metrics], 0)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        results = []
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs)):
            results.append(metric(*selected_args, **selected_kwargs))
        self._mark_updated()  # the per-output children updated through their own forwards
        if results[0] is None:
            return None
        return torch.stack(results, 0)

    def reset(self) -> None:
        for metric in self.metrics:
            metric.reset()
        Metric.reset(self)
