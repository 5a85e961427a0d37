"""Structural similarity index measure (port of ``metrics_tpu/functional/image/ssim.py``).

The five Gaussian-window moments (mu_x, mu_y, E[x^2], E[y^2], E[xy]) come
from ONE depthwise ``conv2d`` over the five reflect-padded copies stacked
on the batch axis, as the JAX package runs one convolution; it runs under
:func:`full_f32`: on the card, a one-channel image's convolution runs on
cuDNN, which may take TF32 by default (PyTorch runs an f32 depthwise one
of several channels on its own kernel, without TF32). As in JAX, the
height is padded by ``pad_h`` and the width by ``pad_w`` (the reference
swaps them, which shows with a non-square kernel), and the border is
cropped from the map only when both pads are non-zero.
"""
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from metrics_tpu_torch.parallel.collectives import reduce
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.precision import full_f32

Tensor = torch.Tensor


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype, device: torch.device) -> Tensor:
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=dtype, device=device)
    gauss = torch.exp(-((dist / sigma) ** 2) / 2)
    return gauss / torch.sum(gauss)  # (kernel_size,)


def _gaussian_kernel(channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype,
                     device: torch.device) -> Tensor:
    kernel_x = _gaussian(kernel_size[0], sigma[0], dtype, device)
    kernel_y = _gaussian(kernel_size[1], sigma[1], dtype, device)
    # the outer product as a broadcast multiply: one rounding per entry, as JAX's (k, 1) @ (1, k)
    kernel = kernel_x[:, None] * kernel_y[None, :]  # (kh, kw)
    return kernel.expand(channel, 1, kernel_size[0], kernel_size[1])


def _ssim_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {preds.shape} and target: {target.shape}."
        )
    return preds, target


def _ssim_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        data_range = torch.maximum(torch.max(preds) - torch.min(preds), torch.max(target) - torch.min(target))

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    channel = preds.shape[1]
    kernel = _gaussian_kernel(channel, kernel_size, sigma, preds.dtype, preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2

    pad_cfg = (pad_w, pad_w, pad_h, pad_h)  # F.pad: last axis (width) first
    preds_p = F.pad(preds, pad_cfg, mode="reflect")
    target_p = F.pad(target, pad_cfg, mode="reflect")

    # one convolution over the five stacked copies (mu_x, mu_y, E[x^2], E[y^2], E[xy])
    input_list = torch.cat([preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p])
    del preds_p, target_p
    with full_f32():
        outputs = F.conv2d(input_list, kernel, groups=channel)
    del input_list
    b = preds.shape[0]
    mu_pred, mu_target = outputs[:b], outputs[b:2 * b]
    e_pred_sq, e_target_sq, e_pred_target = outputs[2 * b:3 * b], outputs[3 * b:4 * b], outputs[4 * b:]

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = e_pred_sq - mu_pred_sq
    sigma_target_sq = e_target_sq - mu_target_sq
    sigma_pred_target = e_pred_target - mu_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2

    ssim_idx = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)
    # the reference crops the border region out of the final map
    ssim_idx = ssim_idx[..., pad_h:-pad_h, pad_w:-pad_w] if pad_h and pad_w else ssim_idx

    if return_contrast_sensitivity:
        contrast_sensitivity = upper / lower
        contrast_sensitivity = (
            contrast_sensitivity[..., pad_h:-pad_h, pad_w:-pad_w] if pad_h and pad_w else contrast_sensitivity
        )
        return reduce(ssim_idx, reduction), reduce(contrast_sensitivity, reduction)
    return reduce(ssim_idx, reduction)


def ssim(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    device: DeviceLike = None,
) -> Tensor:
    """SSIM of ``(N, C, H, W)`` images."""
    dev = tensor_device(preds, target, device=device)
    preds, target = _ssim_update(as_input(preds, dev), as_input(target, dev))
    return _ssim_compute(preds, target, kernel_size, sigma, reduction, data_range, k1, k2)
