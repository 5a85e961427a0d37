"""PSNR module metric (port of ``metrics_tpu/image/psnr.py``).

The states follow the configuration, as in JAX: with ``dim=None`` a float32
``sum_squared_error`` and an int32 ``total`` (``sum``), with ``dim`` two
``cat`` lists; with no ``data_range``, ``min_target``/``max_target``
reduced by ``min``/``max`` from +-inf, else a ``data_range`` state reduced
by ``mean``.
"""
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class PSNR(Metric):
    """Peak signal-to-noise ratio.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PSNR
        >>> preds = torch.tensor([[0.0, 1.0], [1.0, 0.0]])
        >>> target = torch.tensor([[0.0, 1.0], [1.0, 1.0]])
        >>> psnr = PSNR(data_range=1.0, device="cpu")
        >>> print(f"{float(psnr(preds, target)):.4f}")
        6.0206
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: str = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[], dist_reduce_fx="cat")
            self.add_state("total", default=[], dist_reduce_fx="cat")

        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", default=torch.tensor(float("inf")), dist_reduce_fx="min")
            self.add_state("max_target", default=torch.tensor(float("-inf")), dist_reduce_fx="max")
        else:
            self.add_state("data_range", default=torch.tensor(float(data_range)), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                # running extremes of the target: the data range at compute
                self.min_target = torch.minimum(torch.min(target), self.min_target)
                self.max_target = torch.maximum(torch.max(target), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + n_obs
        else:
            self.sum_squared_error.append(torch.ravel(sum_squared_error))
            self.total.append(torch.ravel(n_obs))

    def compute(self) -> Tensor:
        if self.data_range is not None:
            data_range = self.data_range
        else:
            data_range = self.max_target - self.min_target
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = dim_zero_cat(self.sum_squared_error)
            total = dim_zero_cat(self.total)
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)
