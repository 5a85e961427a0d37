"""Frechet Inception Distance, streaming with constant memory (port of ``metrics_tpu/image/fid.py``).

As in JAX, streaming mode keeps a centred Chan/Welford triple ``(mu, M2, n)``
a distribution instead of the feature lists, with ``mu`` and ``M2`` as
float-float pairs of f32 (``ops/floatfloat.py``, ~48 significant bits): ten
states, each with ``dist_reduce_fx=None``, so a sync stacks them
``(world, ...)`` and compute folds the stack with the Chan formula in rank
order. ``full_state_update`` is set: a batch folds into the whole triple.

Compute. Eager, the pairs are recovered in float64 on the metric's device
and the covariances, their ``eigh`` square roots and the distance computed in
float64 there (the port's form of JAX's x64 island); the result is f32.
Float64 exists on the card, so nothing falls back: a failure raises. While
a capture runs (or under ``traced_rows``) compute takes JAX's in-trace path
instead: pair arithmetic, then f32. The batch statistics' matmul and the
float64 path's matmuls run under :func:`full_f32`.

``torch.linalg.eigh`` on the card checks its status on the host, so FID's
forward takes the eager path (its batch value from the float64 compute,
where JAX's jitted forward takes the f32 pair path).

List mode (a callable ``feature`` without ``feature_dim``, or
``streaming=False``) keeps the reference's feature lists and computes in
float64 on the device.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops import floatfloat as ff
from metrics_tpu_torch.ops.sqrtm import trace_sqrtm_product
from metrics_tpu_torch.utils.checks import _is_traced
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.precision import full_f32

Tensor = torch.Tensor
Pair = Tuple[Tensor, Tensor]


def _fid_from_stats(diff: Tensor, sigma1: Tensor, sigma2: Tensor, eps: float = 1e-6) -> Tensor:
    """FID from the mean difference and the covariances; where the product's
    square root is not finite, the diagonals take ``eps`` (the reference's
    fallback). Outside a trace the fallback runs only when needed."""
    tr_covmean = trace_sqrtm_product(sigma1, sigma2)
    offset = torch.eye(sigma1.shape[0], dtype=sigma1.dtype, device=sigma1.device) * eps
    if _is_traced(tr_covmean) or not bool(torch.isfinite(tr_covmean)):
        tr_covmean = torch.where(torch.isfinite(tr_covmean), tr_covmean,
                                 trace_sqrtm_product(sigma1 + offset, sigma2 + offset))
    with full_f32():
        return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr_covmean


def _compute_fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor, eps: float = 1e-6) -> Tensor:
    return _fid_from_stats(mu1 - mu2, sigma1, sigma2, eps)


def _mean_cov(features: Tensor) -> Tuple[Tensor, Tensor]:
    n = features.shape[0]
    mean = torch.mean(features, dim=0)
    diff = features - mean
    with full_f32():
        cov = (diff.T @ diff) / (n - 1)
    return mean, cov


def _chan_combine(mean_a: Pair, m2_a: Pair, n_a: Tensor, mean_b: Pair, m2_b: Pair,
                  n_b: Tensor) -> Tuple[Pair, Pair, Tensor]:
    """Chan's parallel combine of two centred triples, in pair arithmetic:
    ``mu = mu_a + (n_b / n) delta``, ``M2 = M2_a + M2_b + (n_a n_b / n) delta
    delta^T``, ``delta = mu_b - mu_a``; an empty operand weighs 0."""
    n = n_a + n_b
    safe_n = torch.clamp(n, min=1.0)
    frac_b = n_b / safe_n
    w = n_a * n_b / safe_n
    delta = ff.ff_sub(mean_b, mean_a)
    mean = ff.ff_add(mean_a, ff.ff_scale(delta, frac_b))
    d_col = (delta[0][:, None], delta[1][:, None])
    d_row = (delta[0][None, :], delta[1][None, :])
    m2 = ff.ff_add(ff.ff_add(m2_a, m2_b), ff.ff_scale(ff.ff_mul(d_col, d_row), w))
    return mean, m2, n


class FID(Metric):
    """Frechet Inception Distance with streaming constant-memory statistics.

    Args:
        feature: an int/str naming an InceptionV3 tap (64/192/768/2048), or a
            callable ``imgs -> (N, d)`` feature extractor.
        params: weights of the built-in InceptionV3 (the port's state dict or
            the JAX package's Flax variables); the seeded fill otherwise.
        feature_dim: ``d``, needed for streaming with a callable ``feature``.
        streaming: accumulate ``(mu, M2, n)`` instead of feature lists
            (default: whenever ``d`` is known).
        model_host: serve the forward from a resident ``ModelHost``
            (``engine/model_host.py``): ``True``, a ``ModelHostConfig`` or a
            host; with ``mesh=``, the host's hybrid stem-tensor layout.
        mesh, mesh_axis: run the built-in forward batch-sharded over the
            mesh's axis (``parallel.embedded.shard_batch_forward``).
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(
        self,
        feature: Union[int, str, Callable] = 2048,
        params: Optional[Any] = None,
        feature_dim: Optional[int] = None,
        streaming: Optional[bool] = None,
        mesh: Optional[Any] = None,
        mesh_axis: Any = "dp",
        model_host: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        from metrics_tpu_torch.models.inception import resolve_feature_extractor

        self.inception, builtin_dim = resolve_feature_extractor(
            "FID", feature, params, mesh, mesh_axis, ("64", "192", "768", "2048"),
            model_host=model_host, device=self.device,
        )
        self.model_host = getattr(self.inception, "model_host", None)
        if feature_dim is None:
            feature_dim = builtin_dim
        if streaming is None:
            streaming = feature_dim is not None
        if streaming and feature_dim is None:
            raise ValueError(
                "FID(streaming=True) with a callable `feature` needs `feature_dim=` "
                "(the extractor's output width) to allocate the statistic buffers."
            )
        self.streaming = bool(streaming)
        self.feature_dim = feature_dim

        if self.streaming:
            # the triple folds jointly: forward snapshots and restores, never merges leaf-wise
            self.full_state_update = True
            d = int(feature_dim)
            for dist in ("real", "fake"):
                # None-reduction: a sync stacks (world, ...) triples, which compute() folds
                self.add_state(f"{dist}_mean_hi", default=torch.zeros(d), dist_reduce_fx=None)
                self.add_state(f"{dist}_mean_lo", default=torch.zeros(d), dist_reduce_fx=None)
                self.add_state(f"{dist}_m2_hi", default=torch.zeros(d, d), dist_reduce_fx=None)
                self.add_state(f"{dist}_m2_lo", default=torch.zeros(d, d), dist_reduce_fx=None)
                self.add_state(f"{dist}_n", default=torch.zeros(()), dist_reduce_fx=None)
        else:
            self.add_state("real_features", default=[], dist_reduce_fx=None)
            self.add_state("fake_features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract features and fold them into the matching distribution's statistics."""
        features = self.inception(imgs)
        if not self.streaming:
            (self.real_features if real else self.fake_features).append(features)
            return
        features = torch.as_tensor(features, device=self.device).to(torch.float32)
        bn = torch.full((), float(features.shape[0]), device=self.device)
        bm = torch.mean(features, dim=0)
        centered = features - bm
        with full_f32():
            bm2 = centered.T @ centered
        dist = "real" if real else "fake"
        mean, m2, n = _chan_combine(*self._triple(dist), ff.ff_from_f32(bm), ff.ff_from_f32(bm2), bn)
        self._set_triple(dist, mean, m2, n)

    def _triple(self, dist: str) -> Tuple[Pair, Pair, Tensor]:
        return (
            (getattr(self, f"{dist}_mean_hi"), getattr(self, f"{dist}_mean_lo")),
            (getattr(self, f"{dist}_m2_hi"), getattr(self, f"{dist}_m2_lo")),
            getattr(self, f"{dist}_n"),
        )

    def _set_triple(self, dist: str, mean: Pair, m2: Pair, n: Tensor) -> None:
        setattr(self, f"{dist}_mean_hi", mean[0])
        setattr(self, f"{dist}_mean_lo", mean[1])
        setattr(self, f"{dist}_m2_hi", m2[0])
        setattr(self, f"{dist}_m2_lo", m2[1])
        setattr(self, f"{dist}_n", n)

    def _folded_triple(self, dist: str) -> Tuple[Pair, Pair, Tensor]:
        """The distribution's ``(mu, M2, n)``; a synced ``(world, ...)`` stack
        is folded with the Chan formula in rank order."""
        mean, m2, n = self._triple(dist)
        if m2[0].ndim == 3:
            fmean, fm2, fn = (mean[0][0], mean[1][0]), (m2[0][0], m2[1][0]), n[0]
            for i in range(1, m2[0].shape[0]):
                fmean, fm2, fn = _chan_combine(fmean, fm2, fn, (mean[0][i], mean[1][i]), (m2[0][i], m2[1][i]), n[i])
            return fmean, fm2, fn
        return mean, m2, n

    def _compute_streaming(self) -> Tensor:
        r_mean, r_m2, r_n = self._folded_triple("real")
        f_mean, f_m2, f_n = self._folded_triple("fake")
        # a covariance needs n >= 2: an under-filled distribution reads NaN, not a perfect 0
        enough = torch.minimum(r_n, f_n) >= 2.0
        nan = torch.tensor(float("nan"), device=r_n.device)
        if not (_is_traced(r_m2[0]) or _is_traced(f_m2[0])):
            # the pairs' full width, in float64 on the device
            mu1, mu2 = ff.ff_to_f64(r_mean), ff.ff_to_f64(f_mean)
            cov1 = ff.ff_to_f64(r_m2) / (r_n.to(torch.float64) - 1.0)
            cov2 = ff.ff_to_f64(f_m2) / (f_n.to(torch.float64) - 1.0)
            if not bool(enough):
                return nan
            return _compute_fid(mu1, cov1, mu2, cov2).to(torch.float32)
        # in a trace: pair arithmetic keeps the statistics at ~48 bits, the result rounds to f32
        diff = ff.ff_to_f32(ff.ff_sub(r_mean, f_mean))
        cov1 = ff.ff_to_f32(ff.ff_scale(r_m2, 1.0 / torch.clamp(r_n - 1.0, min=1.0)))
        cov2 = ff.ff_to_f32(ff.ff_scale(f_m2, 1.0 / torch.clamp(f_n - 1.0, min=1.0)))
        return torch.where(enough, _fid_from_stats(diff, cov1, cov2), nan)

    def compute(self) -> Tensor:
        if self.streaming:
            return self._compute_streaming()
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        orig_dtype = real_features.dtype
        if not (_is_traced(real_features) or _is_traced(fake_features)):
            real_features, fake_features = real_features.to(torch.float64), fake_features.to(torch.float64)
        mean1, cov1 = _mean_cov(real_features)
        mean2, cov2 = _mean_cov(fake_features)
        return _compute_fid(mean1, cov1, mean2, cov2).to(orig_dtype)


FrechetInceptionDistance = FID
