"""The port's device rule: the card unless the caller asks for the CPU.

Every metric constructor and entry point takes ``device``. ``None`` means
``"cuda"``, and a CUDA device on a machine without CUDA raises: the port
never falls through to the CPU on its own.
"""
from typing import Any, Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device`` (default ``cuda``); raises when it
    names CUDA and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "metrics_tpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def as_input(x: Any, device: torch.device) -> Any:
    """A metric input on ``device``: numpy arrays and tensors become tensors
    there (float64 narrows to float32, as the JAX package's inputs do with
    x64 off); anything else passes through."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    if not isinstance(x, torch.Tensor):
        return x
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    return x.to(device)


def tensor_device(*xs: Any, device: Optional[DeviceLike] = None) -> torch.device:
    """The device a functional entry point runs on: ``device`` when given,
    else that of its first tensor argument, else the default of
    :func:`resolve_device`."""
    if device is not None:
        return resolve_device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(None)
