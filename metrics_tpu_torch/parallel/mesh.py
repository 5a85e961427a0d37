"""The ambient sync group and the in-process device mesh (port of
``metrics_tpu/parallel/mesh.py``).

Two ways a metric's states reduce across participants:

* **across processes**: a ``torch.distributed.ProcessGroup`` (``None`` is the
  default group). A metric learns its group explicitly
  (``Accuracy(process_group=group)``) or ambiently, from ``with
  metric_axis(group): ...`` around the code that computes;
* **across the devices of one process**: a :class:`Mesh` (JAX's
  ``jax.sharding.Mesh``), which one controller drives, as the JAX package's
  streaming engine drives its ``shard_map``-ped steps. :class:`MeshConfig`
  builds it with JAX's names and checks; :meth:`Mesh.axis` names the axis
  states sync over (a :class:`MeshAxis`, what ``Metric.sync_states`` and
  ``parallel/collectives.py`` take in place of a process group).

A mesh holds ``torch.device`` objects in one of two layouts, and the layout
alone picks the transport of its collectives (``Mesh.transport``):

* W distinct CUDA devices: ``"nccl"``, one ``torch.cuda.nccl`` group call
  over the W per-device tensors;
* one device repeated W times (W logical shards on one card, or on the CPU,
  as JAX's virtual mesh puts 8 shards on one host): ``"one_device"``, the
  shard axis stacked as a leading dimension and reduced over.

A mix of the two is refused; a transport never changes after construction.
"""
import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

_LOCAL = threading.local()

AxisName = Union[str, Tuple[str, ...]]


def current_metric_axis() -> Optional[Any]:
    """The ambient sync group (a process group or a :class:`MeshAxis`), if
    one was set with :func:`metric_axis` or :func:`set_metric_axis` on this
    thread."""
    return getattr(_LOCAL, "axis", None)


def set_metric_axis(group: Optional[Any]) -> None:
    _LOCAL.axis = group


@contextlib.contextmanager
def metric_axis(group: Optional[Any]) -> Iterator[None]:
    """Context manager: every metric sync inside that names no group of its
    own reduces over ``group``."""
    prev = current_metric_axis()
    set_metric_axis(group)
    try:
        yield
    finally:
        set_metric_axis(prev)


def _as_device(d: Any) -> torch.device:
    """``d`` as a ``torch.device``; ``cuda`` with its index (the current
    device's), so that equal devices compare equal."""
    d = d if isinstance(d, torch.device) else torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return d


class Mesh:
    """An array of ``torch.device`` with named axes: the port's
    ``jax.sharding.Mesh``. ``shape`` maps each axis name to its size, as
    JAX's ``Mesh.shape`` does; ``devices`` is the device array."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [_as_device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        arr.reshape(-1)[:] = flat
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"mesh of {arr.ndim} dims needs {arr.ndim} axis names, got {names}")
        if not flat:
            raise ValueError("a mesh needs at least one device")
        if len(set(flat)) == 1:
            transport = "one_device"
        elif len(set(flat)) == len(flat) and all(d.type == "cuda" for d in flat):
            transport = "nccl"
        else:
            raise MetricsTPUUserError(
                f"mesh devices {[str(d) for d in flat]} mix layouts: a mesh is either W distinct CUDA devices "
                "(the nccl transport) or one device repeated W times (W shards on one device)"
            )
        self.devices = arr
        self.axis_names = names
        self.transport = transport

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[torch.device]:
        """The devices in row-major order: shard ``k`` of a full-mesh axis
        lives on element ``k``."""
        return list(self.devices.reshape(-1))

    def axis(self, axis: AxisName) -> "MeshAxis":
        """The sync axis ``axis`` (a name or a tuple of names) of this mesh."""
        return MeshAxis(self, axis)

    def describe(self) -> str:
        """A stable one-line identity (program keys, telemetry)."""
        devs = ",".join(str(d) for d in self.device_list())
        return f"Mesh({self.shape}, {self.transport}, [{devs}])"

    def __repr__(self) -> str:
        return self.describe()


class MeshAxis:
    """The axis (or tuple of axes) of a :class:`Mesh` that states reduce
    over, as a sync group: ``world`` shards, shard ``k`` on ``devices[k]``.
    The engine's meshes shard every axis of a 1-D (or flattened) layout, so
    the axis covers the mesh's devices in row-major order."""

    def __init__(self, mesh: Mesh, axis: AxisName):
        names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        missing = [a for a in names if a not in mesh.axis_names]
        if missing:
            raise MetricsTPUUserError(f"mesh axes {mesh.axis_names} lack the sync axes {missing}")
        if names != tuple(mesh.axis_names):
            raise MetricsTPUUserError(
                f"the port's mesh engines sync over every axis of their mesh, in order ({mesh.axis_names}); "
                f"got {names}"
            )
        self.mesh = mesh
        self.names = names
        self.world = int(np.prod([mesh.shape[a] for a in names]))
        self.devices = mesh.device_list()
        self.transport = mesh.transport

    def __repr__(self) -> str:
        return f"MeshAxis({self.names}, world={self.world}, {self.transport})"


@dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh description: ``shape``/``axis_names`` describe the
    device mesh, ``sync_axis`` the axis (or tuple of axes) states reduce
    over. ``devices`` defaults to ``cuda:0 .. cuda:n-1``; pass ``[device] *
    n`` for ``n`` shards on one device. Build with :meth:`make_mesh`."""

    shape: Tuple[int, ...] = (1,)
    axis_names: Tuple[str, ...] = ("dp",)
    sync_axis: AxisName = "dp"
    devices: Optional[Sequence[Any]] = field(default=None, compare=False)

    def make_mesh(self) -> Mesh:
        devs = list(self.devices) if self.devices is not None else _cuda_devices()
        n = int(np.prod(self.shape))
        if len(devs) < n:
            raise ValueError(f"mesh shape {self.shape} needs {n} devices, have {len(devs)}")
        arr = np.empty((n,), dtype=object)
        arr[:] = [_as_device(d) for d in devs[:n]]
        return Mesh(arr.reshape(self.shape), self.axis_names)

    @classmethod
    def data_parallel(cls, n_devices: Optional[int] = None, axis: str = "dp") -> "MeshConfig":
        n = n_devices if n_devices is not None else len(_cuda_devices())
        return cls(shape=(n,), axis_names=(axis,), sync_axis=axis)

    @classmethod
    def multi_slice(cls, n_slices: int, chips_per_slice: Optional[int] = None, *, slice_axis: str = "dcn",
                    chip_axis: str = "ici") -> "MeshConfig":
        """Two-level layout (JAX's DCN x ICI form): the sync axis is the tuple
        of both, so one logical collective spans every device."""
        if chips_per_slice is None:
            n = len(_cuda_devices())
            if n % n_slices:
                raise ValueError(f"{n} devices do not split into {n_slices} equal slices; pass chips_per_slice "
                                 "explicitly")
            chips_per_slice = n // n_slices
        return cls(shape=(n_slices, chips_per_slice), axis_names=(slice_axis, chip_axis),
                   sync_axis=(slice_axis, chip_axis))


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
