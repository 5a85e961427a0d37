"""R2 score (port of ``metrics_tpu/functional/regression/r2.py``).

``_r2_score_compute`` reads ``n_obs`` on the host (``int(n_obs) < 2``, and
the adjusted branch), as the JAX package's does. Under the JAX package's
engines that read fails on a tracer; the port's engines compute their
results as traced too (``utils/checks.py``'s ``traced_rows``, and
``torch.func.vmap`` in ``results()``), so the read raises there as well,
with a :class:`MetricsTPUUserError`. An eager compute, including on an
engine's ``state()``, works.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape, _is_traced
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

SERVED_COMPUTE_REASON = (
    "R2Score's compute reads n_obs on the host (`int(n_obs) < 2` in _r2_score_compute), which a served "
    "(traced) compute cannot do, as in the JAX package, whose engines raise ConcretizationTypeError here; "
    "compute it eagerly instead, e.g. `metric.compute_from(engine.state())`"
)


def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors,"
            f" but received tensors with dimension {preds.shape}"
        )
    sum_obs = torch.sum(target, dim=0)
    sum_squared_obs = torch.sum(target * target, dim=0)
    residual = target - preds
    rss = torch.sum(residual * residual, dim=0)
    return sum_squared_obs, sum_obs, rss, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    rss: Tensor,
    n_obs: Tensor,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    if _is_traced(n_obs):
        raise MetricsTPUUserError(SERVED_COMPUTE_REASON)
    if int(n_obs) < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")

    mean_obs = sum_obs / n_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    raw_scores = 1 - (rss / tss)

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        tss_sum = torch.sum(tss)
        r2 = torch.sum(tss / tss_sum * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")

    if adjusted != 0:
        n = int(n_obs)
        if adjusted > n - 1:
            rank_zero_warn(
                "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif adjusted == n - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            r2 = 1 - (1 - r2) * (n_obs - 1) / (n_obs - adjusted - 1)
    return r2


def r2_score(
    preds: Tensor,
    target: Tensor,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
    device: DeviceLike = None,
) -> Tensor:
    """Compute the R2 (coefficient of determination) score."""
    dev = tensor_device(preds, target, device=device)
    sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(as_input(preds, dev), as_input(target, dev))
    n_obs = torch.full((), n_obs, dtype=torch.int32, device=dev)
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, n_obs, adjusted, multioutput)
