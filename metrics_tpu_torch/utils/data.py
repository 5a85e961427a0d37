"""Tensor utilities: list-state concatenation, onehot/top-k masks, collection mapping.

Port of ``metrics_tpu/utils/data.py``. One-hot and top-k masks are built by
comparing against an ``arange`` rather than by scatter, so they run unchanged
under ``torch.func.vmap`` (the masked engine step vmaps every update).
"""
from typing import Any, Callable, List, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.ops.kernels import histogram_accumulate

METRIC_EPS = 1e-6
#: non-batch (broadcast) leaves larger than this are never compared element by
#: element when the dispatcher decides whether two batches can share a step
_COALESCE_AUX_COMPARE_CAP = 4096

Tensor = torch.Tensor


def is_batch_leaf(leaf: Any, n_rows: int) -> bool:
    """True when ``leaf`` carries the batch on its leading axis: anything
    array-shaped whose leading dimension equals the batch/mask length is
    batch-carried; everything else broadcasts (the padding contract of
    ``Metric.update_state_masked``)."""
    shape = getattr(leaf, "shape", None)
    return shape is not None and len(shape) >= 1 and shape[0] == n_rows


def infer_batch_size(leaves: List[Any]) -> Optional[int]:
    """Leading dimension of the FIRST array-shaped leaf — the batch size every
    other leaf is classified against by :func:`is_batch_leaf`. None when no
    leaf has a leading axis."""
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        if shape is not None and len(shape) >= 1:
            return int(shape[0])
    return None


def _aux_leaves_equal(a: Any, b: Any) -> bool:
    """Equality for non-batch (broadcast/config) leaves, cheap and safe:
    unequal on doubt, so an uncertain comparison costs one un-coalesced step,
    never a wrong result. Arrays are rejected on metadata first; a tensor off
    the CPU, or any array larger than the compare cap, is never read."""
    if a is b:
        return True
    try:
        arrays = (np.ndarray, torch.Tensor)
        if isinstance(a, arrays) or isinstance(b, arrays):
            if type(a) is not type(b) or tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                return False
            if int(np.prod(a.shape)) > _COALESCE_AUX_COMPARE_CAP:
                return False
            if isinstance(a, torch.Tensor):
                # a device-resident leaf would cost a copy to the host per check
                return a.device.type == "cpu" and b.device.type == "cpu" and bool(torch.equal(a, b))
            return bool(np.array_equal(a, b))
        return bool(a == b)
    except Exception:  # noqa: BLE001 - any exotic leaf: just don't coalesce
        return False


def dim_zero_cat(x: Union[Tensor, List[Tensor]]) -> Tensor:
    """Concatenate a (possibly list of) tensor(s) along dim 0."""
    if isinstance(x, (list, tuple)):
        if len(x) == 0:
            return torch.zeros((0,))
        return torch.cat([torch.atleast_1d(v) for v in x], dim=0)
    return x


def _class_axis(n: int, ndim: int, device: torch.device) -> Tensor:
    """``arange(n)`` shaped to broadcast along dim 1 of an ``ndim`` tensor."""
    return torch.arange(n, device=device).reshape((1, n) + (1,) * (ndim - 2))


def to_onehot(label_tensor: Tensor, num_classes: int) -> Tensor:
    """Integer labels ``(N, ...)`` → int32 one-hot ``(N, C, ...)``; labels
    outside ``[0, C)`` give an all-zero row, as ``jax.nn.one_hot`` does."""
    labels = label_tensor.unsqueeze(1)
    return (labels == _class_axis(num_classes, labels.ndim, labels.device)).to(torch.int32)


def to_categorical(tensor: Tensor, argmax_dim: int = 1) -> Tensor:
    """Probabilities/one-hot ``(N, C, ...)`` -> integer labels ``(N, ...)``."""
    return torch.argmax(tensor, dim=argmax_dim)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """int32 mask of the top-k entries along ``dim``."""
    moved = prob_tensor.movedim(dim, -1)
    c = moved.shape[-1]
    classes = torch.arange(c, device=moved.device)
    if topk == 1:  # first maximum, as jnp.argmax picks
        mask = torch.argmax(moved, dim=-1, keepdim=True) == classes
    else:
        idx = torch.topk(moved, topk, dim=-1).indices
        mask = (idx.unsqueeze(-1) == classes).any(dim=-2)
    return mask.to(torch.int32).movedim(-1, dim)


def apply_to_collection(data: Any, dtype: Union[type, tuple], function: Callable, *args: Any, **kwargs: Any) -> Any:
    """Recursively apply ``function`` to all ``dtype`` leaves of a collection."""
    if isinstance(data, dtype):
        return function(data, *args, **kwargs)
    if isinstance(data, (list, tuple)):
        out = [apply_to_collection(d, dtype, function, *args, **kwargs) for d in data]
        return type(data)(out) if isinstance(data, tuple) else out
    if isinstance(data, dict):
        return {k: apply_to_collection(v, dtype, function, *args, **kwargs) for k, v in data.items()}
    return data


def _bincount(x: Tensor, minlength: int) -> Tensor:
    """Static-length bincount through the kernel dispatcher: the CUDA histogram
    kernel on a CUDA tensor, the plain version on a CPU one. ``jnp.bincount``
    semantics on both: negatives clip to bin 0, indices ``>= minlength`` drop;
    int32 counts."""
    return histogram_accumulate(x, minlength)

