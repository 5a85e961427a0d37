"""KL divergence (port of ``metrics_tpu/functional/classification/kl_divergence.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import METRIC_EPS
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, int]:
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")

    total = p.shape[0]
    if log_prob:
        measures = torch.sum(torch.exp(p) * (p - q), dim=-1)
    else:
        p = p / torch.sum(p, dim=-1, keepdim=True)
        q = q / torch.sum(q, dim=-1, keepdim=True)
        q = torch.clamp(q, min=METRIC_EPS)
        measures = torch.sum(p * torch.log(p / q), dim=-1)
    return measures, total


def _kld_compute(measures: Tensor, total: Tensor, reduction: Optional[str] = "mean") -> Tensor:
    if reduction == "sum":
        return torch.sum(measures)
    if reduction == "mean":
        return torch.sum(measures) / total
    if reduction is None or reduction == "none":
        return measures
    return measures / total


def kl_divergence(p: Tensor, q: Tensor, log_prob: bool = False, reduction: Optional[str] = "mean",
                  device: DeviceLike = None) -> Tensor:
    """D_KL(P||Q) of two ``(N, C)`` distributions."""
    dev = tensor_device(p, q, device=device)
    measures, total = _kld_update(as_input(p, dev), as_input(q, dev), log_prob)
    return _kld_compute(measures, torch.full((), total, dtype=torch.int32, device=dev), reduction)
