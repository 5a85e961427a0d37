"""Permutation-invariant training (port of ``metrics_tpu/functional/audio/pit.py``).

The ``(spk, spk)`` metric matrix comes from ``spk^2`` batched calls of the
metric function. The best permutation is found by an exhaustive search over
the cached permutation table (a gather and an arg-max, no host read), or,
for more than three speakers outside a trace, by scipy's
``linear_sum_assignment`` on the host, as the JAX package does. Inside a
trace (a CUDA-graph capture, :func:`traced_rows`, ``torch.func.vmap``) the
exhaustive search runs for any speaker count, as JAX's traced path does.
"""
from itertools import permutations
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.checks import _check_same_shape, _is_traced
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor

# the tables on each device, made in an eager call so a captured one copies nothing from the host
_ps_cache: Dict[Tuple[int, str], Tensor] = {}


def _perm_table(spk_num: int, device: torch.device) -> Tensor:
    """``(spk, perm)`` int64 on ``device``: every permutation of ``range(spk_num)``, one per column."""
    key = (spk_num, str(device))
    if key not in _ps_cache:
        _ps_cache[key] = torch.as_tensor(np.asarray(list(permutations(range(spk_num)))).T, dtype=torch.int64,
                                         device=device)
    return _ps_cache[key]


def _find_best_perm_by_linear_sum_assignment(metric_mtx: Tensor, eval_max: bool) -> Tuple[Tensor, Tensor]:
    from scipy.optimize import linear_sum_assignment

    mmtx = metric_mtx.detach().cpu().numpy()
    best_perm = torch.as_tensor(np.asarray([linear_sum_assignment(pwm, eval_max)[1] for pwm in mmtx]),
                                device=metric_mtx.device)
    best_metric = torch.mean(torch.take_along_dim(metric_mtx, best_perm[:, :, None], dim=2), dim=(-1, -2))
    return best_metric, best_perm


def _find_best_perm_by_exhuastive_method(metric_mtx: Tensor, eval_max: bool) -> Tuple[Tensor, Tensor]:
    batch_size, spk_num = metric_mtx.shape[:2]
    ps = _perm_table(spk_num, metric_mtx.device)  # [spk, perm]
    bps = ps[None].expand(batch_size, spk_num, ps.shape[-1])
    metric_of_ps = torch.mean(torch.take_along_dim(metric_mtx, bps, dim=2), dim=1)  # [batch, perm]
    # argmax/argmin take the first of tied values, as JAX's do (torch.max's index may be any)
    if eval_max:
        best_indexes, best_metric = torch.argmax(metric_of_ps, dim=1), torch.amax(metric_of_ps, dim=1)
    else:
        best_indexes, best_metric = torch.argmin(metric_of_ps, dim=1), torch.amin(metric_of_ps, dim=1)
    return best_metric, ps.T[best_indexes, :]


def pit(
    preds: Tensor,
    target: Tensor,
    metric_func: Callable,
    eval_func: str = "max",
    device: DeviceLike = None,
    **kwargs: Any,
) -> Tuple[Tensor, Tensor]:
    """The best-permutation metric over speakers, and that permutation.

    ``preds`` and ``target`` are ``[batch, spk, ...]``; ``metric_func(preds,
    target, **kwargs)`` scores one speaker pair per batch row. Returns
    ``(best_metric [batch], best_perm [batch, spk])``.
    """
    dev = tensor_device(preds, target, device=device)
    preds, target = as_input(preds, dev), as_input(target, dev)
    _check_same_shape(preds, target)
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if target.ndim < 2:
        raise ValueError(f"Inputs must be of shape [batch, spk, ...], got {target.shape} and {preds.shape} instead")

    spk_num = target.shape[1]
    # metric_mtx[b, i, j] = metric(preds[:, j], target[:, i]): a loop over the (small, static) speaker count
    metric_mtx = torch.stack(
        [torch.stack([metric_func(preds[:, j], target[:, i], **kwargs) for j in range(spk_num)], dim=1)
         for i in range(spk_num)],
        dim=1,
    )  # [batch, spk(target), spk(pred)]

    eval_max = eval_func == "max"
    if spk_num > 3 and not _is_traced(metric_mtx):
        return _find_best_perm_by_linear_sum_assignment(metric_mtx, eval_max)
    return _find_best_perm_by_exhuastive_method(metric_mtx, eval_max)


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """``preds`` with its speakers reordered by ``perm`` (``[batch, spk]``)."""
    return torch.take_along_dim(preds, perm[..., None], dim=1)
