"""Kernel Inception Distance (port of ``metrics_tpu/image/kid.py``).

Polynomial-kernel MMD over InceptionV3 features, averaged over random
subsets. The subsets come from ``np.random.RandomState(seed)``
permutations drawn in JAX's order (real, then fake, per subset), so both
packages score the same subsets; a ``subset_size`` equal to the sample count
takes every sample in order. ``std`` has ddof 0, as JAX's ``jnp.std``. The
kernels' matmuls run under :func:`full_f32`.
"""
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.precision import full_f32

Tensor = torch.Tensor


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    m = k_xx.shape[0]
    kt_xx_sum = torch.sum(k_xx) - torch.sum(torch.diagonal(k_xx))
    kt_yy_sum = torch.sum(k_yy) - torch.sum(torch.diagonal(k_yy))
    k_xy_sum = torch.sum(k_xy)
    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    return value - 2 * k_xy_sum / (m**2)


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    with full_f32():
        return (f1 @ f2.T * gamma + coef) ** degree


def poly_mmd(f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None,
             coef: float = 1.0) -> Tensor:
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


class KID(Metric):
    """Kernel Inception Distance: polynomial-kernel MMD over InceptionV3 features.

    ``feature``, ``params`` and ``model_host`` as for :class:`~metrics_tpu_torch.image.fid.FID`;
    ``compute()`` returns ``(mean, std)`` of the MMD over ``subsets``
    subsets of ``subset_size`` samples a side.
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(
        self,
        feature: Union[int, str, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        params: Optional[Any] = None,
        seed: Optional[int] = None,
        mesh: Optional[Any] = None,
        mesh_axis: Any = "dp",
        model_host: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        from metrics_tpu_torch.models.inception import resolve_feature_extractor

        self.inception, _ = resolve_feature_extractor(
            "KID", feature, params, mesh, mesh_axis, ("64", "192", "768", "2048"),
            model_host=model_host, device=self.device,
        )
        self.model_host = getattr(self.inception, "model_host", None)
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        self._rng = np.random.RandomState(seed)

        self.add_state("real_features", default=[], dist_reduce_fx=None)
        self.add_state("fake_features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        features = self.inception(imgs)
        (self.real_features if real else self.fake_features).append(features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """``(mean, std)`` of the MMD over random subsets."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        def subset(features: Tensor, n: int) -> Tensor:
            # every sample in order when the subset is the whole set: a deterministic score, std exactly 0
            if self.subset_size == n:
                return features
            perm = self._rng.permutation(n)[: self.subset_size]
            return features[torch.from_numpy(perm).to(features.device)]

        scores = []
        for _ in range(self.subsets):
            f_real = subset(real_features, n_samples_real)
            f_fake = subset(fake_features, n_samples_fake)
            scores.append(poly_mmd(f_real, f_fake, self.degree, self.gamma, self.coef))
        kid_scores = torch.stack(scores)
        return torch.mean(kid_scores), torch.std(kid_scores, correction=0)


KernelInceptionDistance = KID
