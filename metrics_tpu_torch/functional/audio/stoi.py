"""Short-time objective intelligibility, native on the device (port of ``metrics_tpu/functional/audio/stoi.py``).

The port's own copy of the JAX package's STOI/ESTOI (Taal et al., IEEE TASL
2011; Jensen & Taal 2016), which needs no ``pystoi``:

* resampling to the 10 kHz model rate with scipy ``resample_poly``
  semantics: a Kaiser(5.0)-windowed sinc planned once on the host
  (:func:`_resample_plan`), run as one strided ``conv1d`` for a pure
  decimation, else as a gather of the taps' input samples and one
  contraction (the polyphase sum, O(n_out * taps / up));
* silent-frame removal (40 dB below the loudest clean frame) with static
  shapes: kept frames compacted first by a stable sort, overlap-added into
  a fixed-size buffer, the kept count carried as data;
* 256-sample Hann frames, a 512-point rFFT and 15 one-third-octave bands,
  framed with pystoi's EXCLUSIVE convention (:func:`_frame_offsets`);
* 30-frame segments with validity masks; the standard mode clips the
  normalised degraded envelope at -15 dB SDR and averages band
  correlations, the extended mode row- and column-normalises each segment.
  Fewer than 30 kept frames give 1e-5, pystoi's sentinel.

Branch-free on values: a batch (every leading dimension at once, no loop
over signals) is one fixed sequence of device ops, which a CUDA graph can
capture. The convolution and the two contractions run under
:func:`full_f32`, as JAX pins ``Precision.HIGHEST`` on them (unpinned,
cuDNN's TF32 in the decimation conv1d moves scores by ~1e-5 on an H100).
The device constants (tap indices and weights, the band matrix, the
window) are cached per device by an eager call.
"""
from functools import lru_cache
from math import gcd
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.precision import full_f32

Tensor = torch.Tensor

FS = 10_000          # internal model rate (Hz)
N_FRAME = 256        # analysis window
NFFT = 512
HOP = N_FRAME // 2
NUM_BANDS = 15
MIN_FREQ = 150.0     # center frequency of the lowest third-octave band
N_SEG = 30           # frames per intermediate-intelligibility segment
BETA = -15.0         # lower SDR clip bound (dB)
DYN_RANGE = 40.0     # silent-frame energy range (dB)
_EPS = float(np.finfo(np.float32).eps)


@lru_cache(maxsize=None)
def _resample_plan(fs_in: int, fs_out: int) -> Optional[Tuple[np.ndarray, int, int, int]]:
    """``(taps, up, down, n_pre_remove)`` for scipy-style ``resample_poly``, or
    None when the rates are equal. Host numpy, cached."""
    g = gcd(fs_in, fs_out)
    up, down = fs_out // g, fs_in // g
    if up == down:
        return None
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    m = np.arange(-half_len, half_len + 1, dtype=np.float64)
    h = f_c * np.sinc(f_c * m) * np.kaiser(2 * half_len + 1, 5.0)
    h /= h.sum()          # firwin lowpass scaling: unit DC response
    h *= up               # resample_poly gain compensation
    # left-pad the filter so the first kept output sample sits on the input's t=0, as scipy aligns it
    n_pre_pad = (down - half_len % down) % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    return np.asarray(h, np.float32), up, down, n_pre_remove


@lru_cache(maxsize=32)
def _resample_operands(fs_in: int, fs_out: int, n_in: int, device: torch.device) -> Tuple[Tensor, Tensor]:
    """The resampler's device operands for ``n_in`` input samples: the flipped
    taps ``(1, 1, k)`` for a pure decimation, else the ``(n_out, T)`` input
    indices and tap weights of the polyphase sum (exact integers on the host)."""
    taps, up, down, n_pre_remove = _resample_plan(fs_in, fs_out)
    k = taps.shape[0]
    if up == 1:
        return torch.as_tensor(taps[::-1].copy().reshape(1, 1, k), device=device), None
    n_out = -(-n_in * up // down)  # ceil
    t_cols = k // up + 1
    j = np.arange(n_out)
    m = (n_pre_remove + j) * down
    i_lo = np.maximum(0, -(-(m - k + 1) // up))          # ceil((m-k+1)/up)
    ii = i_lo[:, None] + np.arange(t_cols)[None, :]       # (n_out, T) input idx
    tap_idx = m[:, None] - ii * up
    valid = (tap_idx >= 0) & (tap_idx < k) & (ii < n_in)
    weights = np.where(valid, taps[np.clip(tap_idx, 0, k - 1)], 0.0).astype(np.float32)
    return (torch.as_tensor(np.clip(ii, 0, n_in - 1), dtype=torch.int64, device=device),
            torch.as_tensor(weights, device=device))


def _resample(x: Tensor, fs_in: int, fs_out: int) -> Tensor:
    """Polyphase resampling along the last axis (scipy ``resample_poly`` semantics)."""
    plan = _resample_plan(int(fs_in), int(fs_out))
    if plan is None:
        return x
    _, up, down, n_pre_remove = plan
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    lead = x.shape[:-1]
    # upfirdn(h, x, up, down): out[j] = y_full[(n_pre_remove + j) * down], y_full[m] = sum_i x[i] * taps[m - i*up]
    a, b = _resample_operands(int(fs_in), int(fs_out), n_in, x.device)
    with full_f32():
        if up == 1:
            # pure decimation: one strided convolution, no dilation
            k = a.shape[-1]
            y = F.conv1d(x.reshape(-1, 1, n_in), a, stride=down, padding=k - 1)
            return y[..., n_pre_remove:n_pre_remove + n_out].reshape(lead + (n_out,))
        # rational rate: each output touches only the <= k // up + 1 real inputs under its taps
        return torch.einsum("...jt,jt->...j", x[..., a], b)


@lru_cache(maxsize=None)
def _third_octave_matrix() -> Tuple[np.ndarray, int]:
    """``(NUM_BANDS, NFFT//2+1)`` 0/1 band matrix on the 10 kHz rFFT grid (host)."""
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    k = np.arange(NUM_BANDS, dtype=np.float64)
    freq_low = MIN_FREQ * 2.0 ** ((2 * k - 1) / 6)
    freq_high = MIN_FREQ * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((NUM_BANDS, f.size))
    for i in range(NUM_BANDS):
        fl = int(np.argmin(np.square(f - freq_low[i])))
        fh = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, fl:fh] = 1.0
    return np.asarray(obm, np.float32), f.size


@lru_cache(maxsize=None)
def _hann_window() -> np.ndarray:
    """The trimmed Hann window pystoi and MATLAB use: ``hanning(N+2)[1:-1]`` (host)."""
    return np.asarray(np.hanning(N_FRAME + 2)[1:-1], np.float32)


@lru_cache(maxsize=8)
def _constants(device: torch.device) -> Tuple[Tensor, Tensor]:
    """The Hann window and the transposed band matrix on ``device``."""
    return (torch.as_tensor(_hann_window(), device=device),
            torch.as_tensor(_third_octave_matrix()[0].T.copy(), device=device))


def _frame_offsets(length: int, device: torch.device) -> Tensor:
    """``(frames, N_FRAME)`` sample indices at HOP, pystoi's EXCLUSIVE framing:
    ``range(0, len - N, hop)``, ``ceil((len - N) / hop)`` frames, which drops
    the last frame whenever ``(len - N) % hop == 0`` (always for the overlap-add
    buffer, whose length is a whole number of hops)."""
    n_frames = max(0, -(-(length - N_FRAME) // HOP))
    return (torch.arange(n_frames, device=device)[:, None] * HOP
            + torch.arange(N_FRAME, device=device)[None, :])


def _stoi_batch(deg: Tensor, clean: Tensor, fs: int, extended: bool) -> Tensor:
    """STOI of each ``(degraded, clean)`` row of two ``(B, n)`` float32 tensors: ``(B,)``."""
    if deg.shape[0] == 0:  # no signal: no scores (an empty FFT is an error on some backends)
        return deg.new_zeros((0,))
    deg = _resample(deg, fs, FS)
    clean = _resample(clean, fs, FS)
    if clean.shape[-1] <= N_FRAME:
        raise ValueError(
            f"STOI needs more than {N_FRAME} samples at {FS} Hz after resampling "
            f"(pystoi's exclusive framing yields zero frames otherwise); "
            f"got {clean.shape[-1]} (input rate {fs} Hz)."
        )
    dev = clean.device
    w, obm_t = _constants(dev)
    b = clean.shape[0]

    # ---- silent-frame removal (clean-signal energies, 40 dB range) ----------
    offs = _frame_offsets(clean.shape[-1], dev)
    clean_frames = clean[:, offs] * w          # (B, F, N_FRAME)
    deg_frames = deg[:, offs] * w
    n_f = clean_frames.shape[1]
    energies = 20.0 * torch.log10(torch.linalg.vector_norm(clean_frames, dim=-1) + _EPS)
    keep = energies > (torch.amax(energies, dim=-1, keepdim=True) - DYN_RANGE)
    n_kept = torch.sum(keep.to(torch.int32), dim=-1)
    # stable compaction: kept frames first, original order kept (an int key: CUDA sorts no bool)
    order = torch.argsort((~keep).to(torch.int32), dim=-1, stable=True)
    valid = (torch.arange(n_f, device=dev)[None, :] < n_kept[:, None])[..., None]
    gather = order[..., None].expand(b, n_f, N_FRAME)
    clean_kept = torch.where(valid, torch.gather(clean_frames, 1, gather), 0.0)
    deg_kept = torch.where(valid, torch.gather(deg_frames, 1, gather), 0.0)
    # overlap-add into a fixed-size buffer (Hann at 50 % overlap): at most two frames
    # touch a sample, so the order of addition cannot change the sum
    n_buf = (n_f - 1) * HOP + N_FRAME
    flat = offs.reshape(-1)
    clean_sil = torch.zeros((b, n_buf), dtype=clean.dtype, device=dev).index_add_(1, flat, clean_kept.reshape(b, n_f * N_FRAME))
    deg_sil = torch.zeros((b, n_buf), dtype=deg.dtype, device=dev).index_add_(1, flat, deg_kept.reshape(b, n_f * N_FRAME))

    # ---- STFT -> third-octave band envelopes --------------------------------
    offs = _frame_offsets(n_buf, dev)
    spec_c = torch.fft.rfft(clean_sil[:, offs] * w, n=NFFT)   # (B, F', NFFT/2+1)
    spec_d = torch.fft.rfft(deg_sil[:, offs] * w, n=NFFT)
    with full_f32():
        x_tob = torch.sqrt(torch.matmul(torch.abs(spec_c) ** 2, obm_t))  # clean    (B, F', 15)
        y_tob = torch.sqrt(torch.matmul(torch.abs(spec_d) ** 2, obm_t))  # degraded (B, F', 15)

    # ---- 30-frame sliding segments ------------------------------------------
    # exclusive framing of the buffer gives n_f - 1 spectral frames; only the first
    # n_kept - 1 of them come from kept audio
    n_spec = x_tob.shape[1]
    n_seg = n_spec - N_SEG + 1
    if n_seg < 1:
        return torch.full((b,), 1e-5, dtype=torch.float32, device=dev)
    seg_ix = torch.arange(n_seg, device=dev)[:, None] + torch.arange(N_SEG, device=dev)[None, :]
    x_seg = x_tob[:, seg_ix].transpose(-1, -2)         # (B, S, 15, N_SEG)
    y_seg = y_tob[:, seg_ix].transpose(-1, -2)
    # frames past the compacted signal are synthetic zeros: a segment is real
    # only when all its N_SEG frames come from kept audio
    seg_ok = (torch.arange(n_seg, device=dev)[None, :] + N_SEG) <= (n_kept[:, None] - 1)
    n_valid = torch.sum(seg_ok.to(torch.float32), dim=-1)

    if extended:
        def row_col_norm(s: Tensor) -> Tensor:
            s = s - torch.mean(s, dim=-1, keepdim=True)
            s = s / (torch.linalg.vector_norm(s, dim=-1, keepdim=True) + _EPS)
            s = s - torch.mean(s, dim=-2, keepdim=True)
            return s / (torch.linalg.vector_norm(s, dim=-2, keepdim=True) + _EPS)

        per_seg = torch.sum(row_col_norm(x_seg) * row_col_norm(y_seg), dim=(-2, -1)) / N_SEG
        total = torch.sum(torch.where(seg_ok, per_seg, 0.0), dim=-1)
        score = total / torch.clamp(n_valid, min=1.0)
    else:
        # the degraded segment's energy per band normalised to the clean one,
        # clipped at -BETA dB SDR, then per-band Pearson correlation
        alpha = torch.linalg.vector_norm(x_seg, dim=-1, keepdim=True) / (
            torch.linalg.vector_norm(y_seg, dim=-1, keepdim=True) + _EPS
        )
        y_prime = torch.minimum(y_seg * alpha, x_seg * (1.0 + 10.0 ** (-BETA / 20.0)))
        xc = x_seg - torch.mean(x_seg, dim=-1, keepdim=True)
        yc = y_prime - torch.mean(y_prime, dim=-1, keepdim=True)
        xc = xc / (torch.linalg.vector_norm(xc, dim=-1, keepdim=True) + _EPS)
        yc = yc / (torch.linalg.vector_norm(yc, dim=-1, keepdim=True) + _EPS)
        per_seg = torch.sum(xc * yc, dim=(-2, -1))               # sum over bands
        total = torch.sum(torch.where(seg_ok, per_seg, 0.0), dim=-1)
        score = total / (torch.clamp(n_valid, min=1.0) * NUM_BANDS)

    # pystoi's contract: fewer than N_SEG kept frames -> 1e-5
    return torch.where(n_valid > 0, score, torch.full_like(score, 1e-5))


def stoi(
    preds: Any,
    target: Any,
    fs: int,
    extended: bool = False,
    keep_same_device: bool = False,
    device: DeviceLike = None,
) -> Tensor:
    """Short-time objective intelligibility of ``[..., time]`` signals: scores ``[...]``.

    Args:
        preds: estimated (degraded) signal.
        target: reference (clean) signal.
        fs: sampling frequency in Hz.
        extended: the extended (ESTOI) variant.
        keep_same_device: accepted for the reference's API; the scores are
            on the inputs' device either way.
        device: where a numpy input runs (default: the card).
    """
    dev = tensor_device(preds, target, device=device)
    preds = as_input(preds, dev).to(torch.float32)
    target = as_input(target, dev).to(torch.float32)
    _check_same_shape(preds, target)
    lead = preds.shape[:-1]
    out = _stoi_batch(preds.reshape(-1, preds.shape[-1]), target.reshape(-1, target.shape[-1]),
                      int(fs), bool(extended))
    return out.reshape(lead)
