"""Checkpoint/resume of metric states (port of ``metrics_tpu/utils/checkpoint.py``).

The state tree is saved directly, as the JAX package's pickle codec writes it:
numpy arrays of the states' dtypes (a bf16 state as ``ml_dtypes.bfloat16``),
nested metrics under ``"_children"``, a collection's members by name. Either
package loads the other's file. ``save_metric_state(metric, synced=True)``
saves the state merged across the process group through the pure
``sync_states`` (the local accumulation is untouched). The JAX package's
default codec, orbax, writes a directory and imports JAX: the port refuses
one.
"""
import os
import pickle
from typing import Any, Optional, Union

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.state_bridge import _metric_state, state_to_numpy

__all__ = ["load_metric_state", "save_metric_state"]


def save_metric_state(
    metric: Union[Metric, MetricCollection],
    path: str,
    synced: bool = False,
    group: Optional[Any] = None,
) -> None:
    """Save a metric's (or collection's) state tree to ``path`` as a numpy
    pickle. With ``synced=True`` the saved state is merged across ``group``
    (the JAX package's ``axis_name``; default: the ambient or default process
    group) by ``sync_states``; the local accumulation is untouched."""
    if isinstance(metric, MetricCollection):
        state = {k: m._pack_state() for k, m in metric.items(keep_base=True)}
    else:
        state = metric._pack_state()
    if synced:
        state = metric.sync_states(state, group)
    state = state_to_numpy(state)
    with open(path, "wb") as f:
        pickle.dump(state, f)


def load_metric_state(metric: Union[Metric, MetricCollection], path: str) -> None:
    """Restore a metric's (or collection's) state tree from ``path``, each
    leaf checked against the state's registered shape and seated in its
    dtype on the metric's device."""
    if os.path.isdir(path):
        raise MetricsTPUUserError(
            f"checkpoint {path} is an orbax directory, which the port cannot read (orbax imports JAX); save it "
            "with the JAX package's pickle codec, which both packages read"
        )
    with open(path, "rb") as f:
        state = pickle.load(f)
    if isinstance(metric, MetricCollection):
        for k, m in metric.items(keep_base=True):
            m._load_state(_metric_state(m, state[k], m.device))
    else:
        metric._load_state(_metric_state(metric, state, metric.device))
