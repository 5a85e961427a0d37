"""Multi-scale SSIM (port of ``metrics_tpu/functional/image/ms_ssim.py``).

SSIM and its contrast sensitivity at each of ``len(betas)`` scales, the
images halved between scales by a 2x2 VALID average pool."""
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from metrics_tpu_torch.functional.image.ssim import _ssim_compute, _ssim_update
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def _get_normalized_sim_and_cs(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int],
    sigma: Sequence[float],
    reduction: str,
    data_range: Optional[float],
    k1: float,
    k2: float,
    normalize: Optional[str] = None,
) -> Tuple[Tensor, Tensor]:
    sim, contrast_sensitivity = _ssim_compute(
        preds, target, kernel_size, sigma, reduction, data_range, k1, k2, return_contrast_sensitivity=True
    )
    if normalize == "relu":
        sim = torch.relu(sim)
        contrast_sensitivity = torch.relu(contrast_sensitivity)
    return sim, contrast_sensitivity


def _multiscale_ssim_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    sim_list: List[Tensor] = []
    cs_list: List[Tensor] = []

    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    for _ in range(len(betas)):
        sim, contrast_sensitivity = _get_normalized_sim_and_cs(
            preds, target, kernel_size, sigma, reduction, data_range, k1, k2, normalize
        )
        sim_list.append(sim)
        cs_list.append(contrast_sensitivity)
        preds = F.avg_pool2d(preds, 2)
        target = F.avg_pool2d(target, 2)

    sim_stack = torch.stack(sim_list)
    cs_stack = torch.stack(cs_list)

    if normalize == "simple":
        sim_stack = (sim_stack + 1) / 2
        cs_stack = (cs_stack + 1) / 2

    # non_blocking: a small host copy that waits for none of the device's queued work
    betas_arr = torch.tensor(betas, dtype=torch.float32).to(sim_stack.device, non_blocking=True)
    sim_stack = sim_stack**betas_arr
    cs_stack = cs_stack**betas_arr
    return torch.prod(cs_stack[:-1]) * sim_stack[-1]


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
    device: DeviceLike = None,
) -> Tensor:
    """MS-SSIM of ``(N, C, H, W)`` images; ``normalize`` is None, ``"relu"`` or ``"simple"``."""
    if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    dev = tensor_device(preds, target, device=device)
    preds, target = _ssim_update(as_input(preds, dev), as_input(target, dev))
    return _multiscale_ssim_compute(
        preds, target, kernel_size, sigma, reduction, data_range, k1, k2, betas, normalize
    )


ms_ssim = multiscale_structural_similarity_index_measure
