"""The shared entry of the per-query retrieval functionals: inputs onto one
device, validated and flattened, and the best-first order of a query's
documents."""
from typing import Any, Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def query_inputs(preds: Any, target: Any, device: DeviceLike = None,
                 allow_non_binary_target: bool = False) -> Tuple[Tensor, Tensor]:
    """``(preds, target)`` on the call's device, checked and flattened."""
    dev = tensor_device(preds, target, device=device)
    return _check_retrieval_functional_inputs(as_input(preds, dev), as_input(target, dev), allow_non_binary_target)


def best_first(preds: Tensor, target: Tensor) -> Tensor:
    """``target`` in descending-``preds`` order; equal preds keep their
    input order (a stable sort)."""
    return target[torch.argsort(-preds, stable=True)]


def zero_like(x: Tensor) -> Tensor:
    """The f32 zero a query with no relevant document scores."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


def check_k(k: Any) -> None:
    if not (isinstance(k, int) and k > 0):
        raise ValueError("`k` has to be a positive integer or None")
