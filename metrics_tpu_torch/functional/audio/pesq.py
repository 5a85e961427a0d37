"""Perceptual evaluation of speech quality (port of ``metrics_tpu/functional/audio/pesq.py``).

The ITU-T P.862 DSP is the native ``pesq`` package's, on the host, as in
the JAX package and the reference: this module checks the arguments, makes
one host call per signal of the flattened batch and returns the scores on
the inputs' device. Without the package it raises ``ModuleNotFoundError``;
nothing falls back.
"""
from typing import Any

import numpy as np
import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, tensor_device
from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE

Tensor = torch.Tensor


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def pesq(preds: Any, target: Any, fs: int, mode: str, keep_same_device: bool = False,
         device: DeviceLike = None) -> Tensor:
    """PESQ of ``[..., time]`` signals: float32 scores ``[...]``.

    Args:
        preds: estimated signal.
        target: reference signal.
        fs: sampling frequency, 8000 or 16000 Hz.
        mode: ``'wb'`` (wide-band) or ``'nb'`` (narrow-band).
        keep_same_device: accepted for the reference's API; the scores are
            on the inputs' device either way.
        device: where the scores of a numpy input go (default: the card).
    """
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed. Either install as `pip install pesq`."
        )
    import pesq as pesq_backend

    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    dev = tensor_device(preds, target, device=device)
    preds_np, target_np = _host(preds), _host(target)
    _check_same_shape(preds_np, target_np)

    if preds_np.ndim == 1:
        return torch.tensor(pesq_backend.pesq(fs, target_np, preds_np, mode), dtype=torch.float32, device=dev)
    flat_p = preds_np.reshape(-1, preds_np.shape[-1])
    flat_t = target_np.reshape(-1, target_np.shape[-1])
    scores = np.empty(flat_p.shape[0], dtype=np.float32)
    for b in range(flat_p.shape[0]):
        scores[b] = pesq_backend.pesq(fs, flat_t[b], flat_p[b], mode)
    return torch.from_numpy(scores.reshape(preds_np.shape[:-1])).to(dev)
