"""Carry metric state between the JAX package and the port, as numpy arrays.

A state accumulated in ``metrics_tpu`` (taken to the host with
``jax.tree.map(np.asarray, state)``) becomes the port's state dict with
:func:`state_from_numpy`, so a stream begun on a TPU can be finished and
computed on the card; :func:`state_to_numpy` goes the other way. Each leaf
keeps the dtype and shape the port's metric registered (int32 counts, f32
sums; a bf16 state crosses as an ``ml_dtypes.bfloat16`` array, as JAX's
does) and is checked against them; a wrapper's or a composition's nested
metrics cross in their ``"_children"`` subtree. The JAX package's
host-derived compute attributes (``Accuracy.mode``) travel separately,
through ``host_attrs``.

An ENGINE's state crosses the same way: :func:`engine_state_from_numpy` seats
a JAX engine's packed arena (per-dtype numpy buffers) and, for the paged
multi-stream engine, its pager's ``snapshot_payload()`` in the port's engine;
:func:`engine_state_to_numpy` is the inverse. Seating first checks that the
two packages pack the state the same way (``ArenaLayout.leaf_slices()``).
Both flush the engine first and write or read its state buffers in place.
"""
from enum import Enum
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils import enums
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device


def _bf16_numpy_dtype(leaf: str) -> Any:
    """numpy's bfloat16, which only the ``ml_dtypes`` package provides: it
    is imported here, when a bf16 leaf is first met."""
    try:
        import ml_dtypes
    except ImportError:
        raise TypeError(
            f"state {leaf!r} is bfloat16, which numpy holds only through the ml_dtypes package, and that is "
            "not installed; install it, or cast the state to float32 before it crosses"
        ) from None
    return ml_dtypes.bfloat16


def _tensor_to_numpy(t: torch.Tensor, leaf: str) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bf16_numpy_dtype(leaf))
    return t.numpy()


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A writable copy of ``arr`` as a tensor; a bf16 array keeps its bits."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf_from_numpy(name: str, value: Any, default: Any, device: torch.device, host: bool = False) -> Any:
    if isinstance(default, list):
        if host:  # a list the metric stages on the host (MAP's) stays numpy
            return [np.array(v) for v in value]
        return [_tensor_from_numpy(v).to(device) for v in value]
    arr = np.asarray(value)
    # a scalar default may have grown by broadcasting (ExplainedVariance's sums over 2-D rows)
    if default.ndim and tuple(arr.shape) != tuple(default.shape):
        raise ValueError(f"state {name!r}: shape {arr.shape} does not match the port's {tuple(default.shape)}")
    return _tensor_from_numpy(arr).to(device=device, dtype=default.dtype)


def _metric_state(metric: Metric, np_state: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """``np_state`` seated as ``metric``'s state, nested metrics' ``"_children"``
    subtree included."""
    has_children = bool(metric._child_metrics())
    missing = sorted(set(metric._defaults) - set(np_state)) + (
        [metric._CHILD_KEY] if has_children and metric._CHILD_KEY not in np_state else [])
    if missing:
        raise KeyError(f"{type(metric).__name__}: state has no {missing}")
    state = {k: _leaf_from_numpy(k, np_state[k], d, device, k in metric._host_list_states)
             for k, d in metric._defaults.items()}
    if has_children:
        state[metric._CHILD_KEY] = metric._map_children(lambda c, cs: _metric_state(c, cs, device),
                                                         np_state[metric._CHILD_KEY])
    return state


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


def state_to_numpy(state: Any, _path: str = "state") -> Any:
    """The same structure with every tensor as a numpy array of its dtype: a
    bf16 leaf becomes an ``ml_dtypes.bfloat16`` array (the JAX package's own
    host form), and raises, naming the leaf, where ``ml_dtypes`` is missing."""
    if isinstance(state, torch.Tensor):
        return _tensor_to_numpy(state, _path)
    if isinstance(state, dict):
        return {k: state_to_numpy(v, f"{_path}.{k}") for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(state_to_numpy(v, f"{_path}[{i}]") for i, v in enumerate(state))
    return state


def _slices_signature(slices: Sequence[Tuple[Any, ...]]) -> Tuple[Tuple[Any, ...], ...]:
    """``leaf_slices()`` with every dtype spelled by name, comparable across
    packages (jnp and torch dtypes differ as objects)."""
    return tuple((str(k), int(o), int(s), tuple(int(d) for d in shape), str(dt).replace("torch.", ""))
                 for k, o, s, shape, dt in slices)


def _pager_row(value: Any) -> np.ndarray:
    """A spilled row as the port's pager holds it: bf16 widened to f32,
    losslessly (``engine/quantize.py``'s host dtype)."""
    arr = np.asarray(value)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _payload_row(key: str, value: Any) -> Any:
    """The inverse of :func:`_pager_row` for one pager payload entry: the
    spilled rows of a bf16 buffer (``spill_bfloat16``, and the exact section
    ``spill_bfloat16#ex`` of a compressed one) narrow back to bf16, as JAX's
    payload holds them. Lossless: they are bf16 values widened."""
    from metrics_tpu_torch.engine.quantize import ArenaRowCodec

    if key.split("#")[0] == "spill_bfloat16" and not key.endswith((ArenaRowCodec.CODES, ArenaRowCodec.SCALES)):
        return np.asarray(value, np.float32).astype(_bf16_numpy_dtype(key))
    return value


def engine_state_from_numpy(
    engine: Any,
    arena: Dict[str, Any],
    leaf_slices: Sequence[Tuple[Any, ...]],
    pager_payload: Optional[Dict[str, Any]] = None,
    host_attrs: Optional[Dict[str, Any]] = None,
) -> None:
    """Seat a JAX engine's state in the port's ``engine``.

    ``arena`` is the JAX engine's carried arena as numpy, one buffer per
    dtype: flat ``(n,)`` for a ``StreamingEngine`` or an unsharded
    ``MultiStreamEngine``, ``(1, R, n)`` for the paged one (stream-sharded on
    a one-device mesh), whose ``pager_payload`` (``snapshot_payload()``:
    slot table and spilled rows, compressed or not) is required then.
    ``leaf_slices`` is the JAX engine's ``arena_layout.leaf_slices()``; it
    must equal the port engine's, or this raises before touching anything.
    ``host_attrs`` are set on the port's metric, as in :func:`state_from_numpy`.
    """
    layout = engine.arena_layout
    if layout is None:
        raise ValueError("engine state crosses as a packed arena: the port engine needs use_arena=True")
    if _slices_signature(leaf_slices) != _slices_signature(layout.leaf_slices()):
        raise ValueError("the two packages pack this state differently (ArenaLayout.leaf_slices() differ)")
    paged = bool(getattr(engine, "stream_shard", False))
    if paged != (pager_payload is not None):
        raise ValueError("a pager payload goes with the paged (stream_shard) engine, and only with it")
    engine.flush()  # every batch submitted before lands first
    with engine._device_section():
        state = {}
        for k, buf in engine._state.items():
            arr = np.asarray(arena[k])
            arr = arr.reshape(arr.shape[1:]) if paged and arr.ndim == 3 and arr.shape[0] == 1 else arr
            if tuple(arr.shape) != tuple(buf.shape):
                raise ValueError(f"arena buffer {k!r}: shape {arr.shape} does not fit the port's {tuple(buf.shape)}")
            state[k] = _tensor_from_numpy(arr).to(device=buf.device, dtype=buf.dtype)
        if paged:
            engine.pager.load_payload({k: _pager_row(v) for k, v in pager_payload.items()})
        engine._write_state(state)  # in place: captured steps address these buffers
    if host_attrs:
        engine._metric.restore_host_compute_attrs({k: _port_value(v) for k, v in host_attrs.items()})


def engine_state_to_numpy(engine: Any) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, Any]]]:
    """The inverse of :func:`engine_state_from_numpy`: the port engine's arena
    in the JAX engine's form (``(1, R, n)`` buffers for the paged engine) and,
    for the paged engine, its pager's ``snapshot_payload()`` (else None),
    with a bf16 buffer's spilled rows as bf16, as JAX's payload holds them."""
    paged = bool(getattr(engine, "stream_shard", False))
    engine.flush()
    with engine._device_section():
        arena = {k: state_to_numpy(v, f"arena[{k!r}]") for k, v in engine._state.items()}
    if paged:
        payload = {k: _payload_row(k, v) for k, v in engine.pager.snapshot_payload().items()}
        return {k: v[None] for k, v in arena.items()}, payload
    return arena, None
