"""Carry metric state between the JAX package and the port, as numpy arrays.

A state accumulated in ``metrics_tpu`` (taken to the host with
``jax.tree.map(np.asarray, state)``) becomes the port's state dict with
:func:`state_from_numpy`, so a stream begun on a TPU can be finished and
computed on the card; :func:`state_to_numpy` goes the other way. Each leaf
keeps the dtype and shape the port's metric registered (int32 counts, f32
sums) and is checked against them. The JAX package's host-derived compute
attributes (``Accuracy.mode``) travel separately, through ``host_attrs``.
"""
from enum import Enum
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils import enums
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device


def _leaf_from_numpy(name: str, value: Any, default: Any, device: torch.device) -> Any:
    if isinstance(default, list):
        return [torch.as_tensor(np.asarray(v)).to(device) for v in value]
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(default.shape):
        raise ValueError(f"state {name!r}: shape {arr.shape} does not match the port's {tuple(default.shape)}")
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=default.dtype)  # a writable copy


def _metric_state(metric: Metric, np_state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    missing = sorted(set(metric._defaults) - set(np_state))
    if missing:
        raise KeyError(f"{type(metric).__name__}: state has no {missing}")
    return {k: _leaf_from_numpy(k, np_state[k], d, device) for k, d in metric._defaults.items()}


def _port_value(value: Any) -> Any:
    """An enum of the JAX package becomes the port's enum of the same name."""
    if isinstance(value, Enum):
        return getattr(enums, type(value).__name__)(value.value)
    return value


def state_from_numpy(
    metric_or_collection: Union[Metric, MetricCollection],
    np_state: Dict[str, Any],
    device: DeviceLike = None,
    host_attrs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The port's state dict for ``np_state``, a JAX state as numpy arrays.

    ``host_attrs`` (what the JAX object's ``host_compute_attrs()`` returns)
    are set on the port's metric or collection, so it can compute the
    bridged state without an update first.
    """
    dev = resolve_device(device)
    target = metric_or_collection
    if isinstance(target, MetricCollection):
        state = {k: _metric_state(m, np_state[k], dev) for k, m in target.items(keep_base=True)}
    else:
        state = _metric_state(target, np_state, dev)
    if host_attrs:
        target.restore_host_compute_attrs({k: _port_value(v) for k, v in host_attrs.items()})
    return state


def state_to_numpy(state: Any) -> Any:
    """The same structure with every tensor as a numpy array (bf16 widened
    to f32, which numpy has no type for)."""
    if isinstance(state, torch.Tensor):
        t = state.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(state_to_numpy(v) for v in state)
    return state
