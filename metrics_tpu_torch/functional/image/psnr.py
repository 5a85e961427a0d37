"""Peak signal-to-noise ratio (port of ``metrics_tpu/functional/image/psnr.py``)."""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.parallel.collectives import reduce
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _psnr_compute(
    sum_squared_error: Tensor,
    n_obs: Tensor,
    data_range: Tensor,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
) -> Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    # torch.full, not torch.tensor: no copy from the host, so a captured forward may run it
    psnr_vals = psnr_base_e * (10 / torch.log(torch.full((), base, dtype=torch.float32, device=psnr_base_e.device)))
    return reduce(psnr_vals, reduction=reduction)


def _psnr_update(
    preds: Tensor,
    target: Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[Tensor, Tensor]:
    """``(sum_squared_error, n_obs)``: scalars when ``dim`` is None, else the
    sums over ``dim`` with the (int32) count of each beside them."""
    if dim is None:
        return torch.sum((preds - target) ** 2), torch.full((), target.numel(), dtype=torch.int32, device=target.device)

    diff = preds - target
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    # an empty ``dim`` sums over no axis, as ``jnp.sum(axis=())`` does (torch's would sum over all)
    sum_squared_error = torch.sum(diff * diff, dim=dim_list) if dim_list else diff * diff
    n = target.numel()
    if dim_list:
        n = 1
        for d in dim_list:
            n *= target.shape[d]
    n_obs = torch.full(sum_squared_error.shape, n, dtype=torch.int32, device=target.device)
    return sum_squared_error, n_obs


def psnr(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
    device: DeviceLike = None,
) -> Tensor:
    """PSNR, with the data range taken from ``target``'s extremes when not given.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import psnr
        >>> preds = torch.tensor([[0.0, 1.0], [1.0, 0.0]])
        >>> target = torch.tensor([[0.0, 1.0], [1.0, 1.0]])
        >>> print(f"{float(psnr(preds, target, data_range=1.0)):.4f}")
        6.0206
    """
    dev = tensor_device(preds, target, device=device)
    preds, target = as_input(preds, dev), as_input(target, dev)
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = torch.max(target) - torch.min(target)
    else:
        data_range = torch.full((), float(data_range), dtype=torch.float32, device=dev)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
