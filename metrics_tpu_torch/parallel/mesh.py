"""The ambient sync group (port of the axis part of ``metrics_tpu/parallel/mesh.py``).

The JAX package names a mesh axis; the port holds a
``torch.distributed.ProcessGroup`` (``None`` is the default group). A metric
learns its group explicitly (``Accuracy(process_group=group)``) or
ambiently, from ``with metric_axis(group): ...`` around the code that
computes. ``MeshConfig`` builds a ``jax.sharding.Mesh`` and is not ported
(stream sharding over several ranks is later work).
"""
import contextlib
import threading
from typing import Any, Iterator, Optional

_LOCAL = threading.local()


def current_metric_axis() -> Optional[Any]:
    """The ambient process group, if one was set with :func:`metric_axis` or
    :func:`set_metric_axis` on this thread."""
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
