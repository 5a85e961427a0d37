"""Image gradients, one-step finite differences (port of ``metrics_tpu/functional/image/gradients.py``)."""
from typing import Any, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _image_gradients_validate(img: Any) -> None:
    if not isinstance(img, (Tensor, np.ndarray)):
        raise TypeError(f"The `img` expects a value of <Array> type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    batch_size, channels, height, width = img.shape
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    dy = torch.cat([dy, torch.zeros((batch_size, channels, 1, width), dtype=img.dtype, device=img.device)], dim=2)
    dx = torch.cat([dx, torch.zeros((batch_size, channels, height, 1), dtype=img.dtype, device=img.device)], dim=3)
    return dy, dx


def image_gradients(img: Tensor, device: DeviceLike = None) -> Tuple[Tensor, Tensor]:
    """``(dy, dx)`` finite-difference gradients of an ``(N, C, H, W)`` image,
    zero in the last row (``dy``) and column (``dx``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import image_gradients
        >>> img = torch.arange(16.0).reshape(1, 1, 4, 4)
        >>> dy, dx = image_gradients(img)
        >>> dy[0, 0, 0].tolist()
        [4.0, 4.0, 4.0, 4.0]
    """
    if not isinstance(img, Tensor):  # as JAX's ``jnp.asarray``: a nested list is an array too
        img = np.asarray(img)
    _image_gradients_validate(img)
    return _compute_image_gradients(as_input(img, tensor_device(img, device=device)))
