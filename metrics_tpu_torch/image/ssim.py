"""SSIM and multi-scale SSIM module metrics (port of ``metrics_tpu/image/ssim.py``).

Both keep every image in ``cat`` states and score them all at
``compute()``, as in JAX; each warns once, when constructed, of the memory
that takes."""
from typing import Any, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.image.ms_ssim import _multiscale_ssim_compute
from metrics_tpu_torch.functional.image.ssim import _ssim_compute, _ssim_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class SSIM(Metric):
    """Structural similarity index measure.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SSIM
        >>> preds = torch.arange(256.0).reshape(1, 1, 16, 16) / 255.0
        >>> target = preds * 0.9
        >>> ssim = SSIM(device="cpu")
        >>> print(f"{float(ssim(preds, target)):.4f}")
        0.9893
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: str = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        rank_zero_warn(
            "Metric `SSIM` will save all targets and predictions in buffer."
            " For large datasets this may lead to large memory footprint."
        )
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")
        self.kernel_size = tuple(kernel_size)
        self.sigma = tuple(sigma)
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ssim_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _ssim_compute(
            preds, target, self.kernel_size, self.sigma, self.reduction, self.data_range, self.k1, self.k2
        )


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """Multi-scale SSIM."""

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: str = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        rank_zero_warn(
            "Metric `MS_SSIM` will save all targets and predictions in buffer."
            " For large datasets this may lead to large memory footprint."
        )
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")
        self.kernel_size = tuple(kernel_size)
        self.sigma = tuple(sigma)
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.reduction = reduction
        if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
        self.betas = betas
        if normalize and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
        self.normalize = normalize

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ssim_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _multiscale_ssim_compute(
            preds, target, self.kernel_size, self.sigma, self.reduction, self.data_range,
            self.k1, self.k2, self.betas, self.normalize,
        )
