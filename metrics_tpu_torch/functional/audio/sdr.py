"""Signal distortion ratio and scale-invariant SDR (port of ``metrics_tpu/functional/audio/sdr.py``).

``signal_distortion_ratio`` follows the JAX package's algorithm ("SDR -
Medium Rare", Scheibler 2021), not the reference's ``fast_bss_eval`` call:
both signals normalised, their rFFT auto- and cross-correlations at
``n_fft = 2^ceil(log2(n + L))``, ``load_diag`` added to the zero lag, the
symmetric ``(L, L)`` Toeplitz system solved, then ``coh = xcorr . sol`` and
``10 log10(coh / (1 - coh))``. ``use_cg_iter`` is accepted and ignored, as
in JAX.

JAX solves by LU. The port solves by the Levinson recursion, from the
system's first column alone (:func:`~metrics_tpu_torch.ops.kernels.
toeplitz_cuda.toeplitz_solve`: the K8 kernel on the card, its plain
version on the CPU, float64 inside both). PyTorch's own batched LU at the
default ``filter_length`` of 512 runs on MAGMA, which a CUDA graph cannot
capture; the kernel can, so SDR's compiled forward is captured. Nothing
reads the solve's status on the host: a silent target makes the system
singular and the result NaN, as JAX's solve gives. The coherence dot runs
under :func:`full_f32`: no TF32.
"""
import math
from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.ops.kernels.toeplitz_cuda import toeplitz_solve
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.precision import full_f32
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _normalize(x: Tensor) -> Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int) -> Tuple[Tensor, Tensor]:
    """FFT autocorrelation of ``target`` and cross-correlation target -> preds,
    the first ``corr_len`` lags of each."""
    n = target.shape[-1]
    n_fft = int(2 ** math.ceil(math.log2(n + corr_len)))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    acf = torch.fft.irfft(t_fft * torch.conj(t_fft), n=n_fft, dim=-1)[..., :corr_len]
    xcorr = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return acf, xcorr


def _toeplitz(c: Tensor) -> Tensor:
    """The symmetric Toeplitz matrix of first column ``c``, batched over
    leading dims (JAX's form of the system; the port's solve takes ``c``)."""
    ar = torch.arange(c.shape[-1], device=c.device)
    return c[..., torch.abs(ar[:, None] - ar[None, :])]


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
    device: DeviceLike = None,
) -> Tensor:
    """SDR with an optimal length-``filter_length`` distortion filter, over the last axis.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import signal_distortion_ratio
        >>> n = torch.arange(64.0)
        >>> target = torch.sin(n / 4)[None]
        >>> preds = target + 0.1 * torch.cos(n / 3)[None]
        >>> print(f"{float(signal_distortion_ratio(preds, target)[0]):.2f}")
        28.53
    """
    dev = tensor_device(preds, target, device=device)
    preds, target = as_input(preds, dev), as_input(target, dev)
    _check_same_shape(preds, target)

    if not preds.is_floating_point() or preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)
    target = target.to(preds.dtype)

    if zero_mean:
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
        target = target - torch.mean(target, dim=-1, keepdim=True)

    preds = _normalize(preds)
    target = _normalize(target)

    acf, xcorr = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)

    if load_diag is not None:
        acf = torch.cat([acf[..., :1] + load_diag, acf[..., 1:]], dim=-1)

    sol = toeplitz_solve(acf.contiguous(), xcorr.contiguous())
    with full_f32():
        coh = torch.einsum("...l,...l->...", xcorr, sol)
    ratio = coh / (1 - coh)
    return 10.0 * torch.log10(ratio)


def sdr(preds: Tensor, target: Tensor, **kwargs: Any) -> Tensor:
    """Deprecated alias of :func:`signal_distortion_ratio`."""
    rank_zero_warn("`sdr` was renamed to `signal_distortion_ratio` and it will be removed.", DeprecationWarning)
    return signal_distortion_ratio(preds, target, **kwargs)


def scale_invariant_signal_distortion_ratio(
    preds: Tensor, target: Tensor, zero_mean: bool = False, device: DeviceLike = None
) -> Tensor:
    """SI-SDR over the last axis; ``eps`` is the machine epsilon of
    ``preds``' dtype, float32's for an integer input."""
    dev = tensor_device(preds, target, device=device)
    preds, target = as_input(preds, dev), as_input(target, dev)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype if preds.is_floating_point() else torch.float32).eps
    if not preds.is_floating_point():  # torch takes no mean of integers; JAX's promotes them to float32
        preds = preds.to(torch.float32)
    if not target.is_floating_point():
        target = target.to(torch.float32)

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (
        torch.sum(target**2, dim=-1, keepdim=True) + eps
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(val)


def si_sdr(preds: Tensor, target: Tensor, zero_mean: bool = False, device: DeviceLike = None) -> Tensor:
    """Deprecated alias of :func:`scale_invariant_signal_distortion_ratio`."""
    rank_zero_warn(
        "`si_sdr` was renamed to `scale_invariant_signal_distortion_ratio` and it will be removed.",
        DeprecationWarning,
    )
    return scale_invariant_signal_distortion_ratio(preds, target, zero_mean, device=device)
