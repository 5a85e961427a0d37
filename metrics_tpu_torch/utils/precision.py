"""Full float32 precision on the port's own convolutions and matmuls.

The JAX package pins ``Precision.HIGHEST`` on the ops of its signal metrics
(STOI's resampler and band matmuls, SSIM's depthwise convolution), so the
metric is exact in f32 however the caller configures JAX. PyTorch has no
per-op precision argument: cuDNN convolutions take TF32 by default on an
Ampere or later card, and ``torch.set_float32_matmul_precision("high")``
or ``("medium")`` lets a float32 matmul (and cuBLAS routines under it, such
as the triangular solves of ``torch.linalg.solve``) run on TF32 or bf16
tensor cores with a 10- or 8-bit mantissa. :func:`full_f32` sets both to
full float32 around the port's ops and restores the caller's settings.
Of the port's convolutions, cuDNN runs STOI's decimation and SSIM's over
one-channel images; an f32 depthwise convolution of several channels
(SSIM's over RGB) PyTorch runs on its own kernel, which takes no TF32. On
an H100, cuDNN takes TF32 for STOI's strided conv1d unpinned (its scores
move by ~1e-5) and an algorithm without it for SSIM's one-channel 11 x 11
window; the pin holds whichever algorithm cuDNN picks.

Both the legacy flags (``torch.backends.cudnn.allow_tf32``,
``set_float32_matmul_precision``) and, from torch 2.9 on, the per-op
``fp32_precision`` settings are set, consistently, and each is restored
to what it was: torch refuses to read a TF32 flag when the two APIs
disagree.

Thread safety: the settings are process-global. Entries from several
threads nest through one lock and a depth count, so the caller's settings
are saved at the first entry and restored at the last exit; but while any
thread is inside, every other thread's convolutions and matmuls run strict
too, and a setting another thread changes meanwhile is overwritten at the
last exit. On the CPU, TF32 does not apply, but at "medium" a float32
matmul may take oneDNN's bf16 passes: the pin holds there too.
"""
import contextlib
import threading
from typing import Any, Iterator, List

import torch

_LOCK = threading.Lock()
_depth = 0
_saved: List[Any] = []


def _fp32_setting(holder: Any) -> Any:
    """``holder`` if this torch has per-op ``fp32_precision`` settings (2.9 and later), else None."""
    try:
        holder.fp32_precision  # noqa: B018 - probing the attribute
    except AttributeError:
        return None
    return holder


def _cudnn_legacy() -> Any:
    """cuDNN's legacy TF32 flag, or None where the caller mixed the two APIs
    (torch then refuses to read it)."""
    try:
        return torch._C._get_cudnn_allow_tf32()
    except RuntimeError:
        return None


def _enter() -> List[Any]:
    cudnn = torch.backends.cudnn
    conv = _fp32_setting(getattr(cudnn, "conv", None))
    rnn = _fp32_setting(getattr(cudnn, "rnn", None))
    matmul = _fp32_setting(torch.backends.cuda.matmul)
    saved = [_cudnn_legacy(), conv and conv.fp32_precision, rnn and rnn.fp32_precision,
             torch.get_float32_matmul_precision(), matmul and matmul.fp32_precision]
    torch._C._set_cudnn_allow_tf32(False)
    for holder in (conv, rnn):
        if holder is not None:
            holder.fp32_precision = "ieee"
    torch.set_float32_matmul_precision("highest")
    if matmul is not None:
        matmul.fp32_precision = "ieee"
    return saved


def _exit(saved: List[Any]) -> None:
    legacy, conv_p, rnn_p, mm_legacy, mm_p = saved
    cudnn = torch.backends.cudnn
    # the legacy setters also write the per-op settings: they go first
    if legacy is not None:
        torch._C._set_cudnn_allow_tf32(legacy)
    torch.set_float32_matmul_precision(mm_legacy)
    if conv_p is not None:
        cudnn.conv.fp32_precision = conv_p
    if rnn_p is not None:
        cudnn.rnn.fp32_precision = rnn_p
    if mm_p is not None:
        torch.backends.cuda.matmul.fp32_precision = mm_p


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Run the body with cuDNN convolutions and float32 matmuls at full
    float32 precision (no TF32, no bf16 passes); the caller's settings are
    restored after it. See the module docstring on threads."""
    global _depth
    with _LOCK:
        if _depth == 0:
            _saved[:] = _enter()
        _depth += 1
    try:
        yield
    finally:
        with _LOCK:
            _depth -= 1
            if _depth == 0:
                _exit(_saved)
