"""Signal-to-noise ratio family (port of ``metrics_tpu/functional/audio/snr.py``).

``signal_noise_ratio``, ``scale_invariant_signal_noise_ratio`` and the
deprecated ``snr``/``si_snr`` aliases, which warn with a
``DeprecationWarning``. Elementwise sums over the last axis: no kernel,
and nothing reads the device from the host.
"""
import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False, device: DeviceLike = None) -> Tensor:
    """SNR = 10 log10(P_signal / P_noise) over the last axis, with ``eps``
    the machine epsilon of ``preds``' dtype.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import signal_noise_ratio
        >>> target = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([1.1, 2.1, 2.9, 4.2])
        >>> print(f"{float(signal_noise_ratio(preds, target)):.4f}")
        26.3202
    """
    dev = tensor_device(preds, target, device=device)
    preds, target = as_input(preds, dev), as_input(target, dev)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    noise = target - preds
    snr_value = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def snr(preds: Tensor, target: Tensor, zero_mean: bool = False, device: DeviceLike = None) -> Tensor:
    """Deprecated alias of :func:`signal_noise_ratio`."""
    rank_zero_warn("`snr` was renamed to `signal_noise_ratio` and it will be removed.", DeprecationWarning)
    return signal_noise_ratio(preds, target, zero_mean, device=device)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor, device: DeviceLike = None) -> Tensor:
    """SI-SNR: scale-invariant SDR of the zero-mean signals.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_noise_ratio
        >>> target = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([1.1, 2.1, 2.9, 4.2])
        >>> print(f"{float(scale_invariant_signal_noise_ratio(preds, target)):.4f}")
        20.3551
    """
    from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio

    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True, device=device)


def si_snr(preds: Tensor, target: Tensor, device: DeviceLike = None) -> Tensor:
    """Deprecated alias of :func:`scale_invariant_signal_noise_ratio`."""
    rank_zero_warn(
        "`si_snr` was renamed to `scale_invariant_signal_noise_ratio` and it will be removed.", DeprecationWarning
    )
    return scale_invariant_signal_noise_ratio(preds, target, device=device)
