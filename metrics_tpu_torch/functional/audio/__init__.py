"""Audio functionals of the port (``metrics_tpu/functional/audio``)."""
from metrics_tpu_torch.functional.audio.pesq import pesq
from metrics_tpu_torch.functional.audio.pit import pit, pit_permutate
from metrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    sdr,
    si_sdr,
    signal_distortion_ratio,
)
from metrics_tpu_torch.functional.audio.snr import (
    scale_invariant_signal_noise_ratio,
    si_snr,
    signal_noise_ratio,
    snr,
)
from metrics_tpu_torch.functional.audio.stoi import stoi

__all__ = [
    "pesq",
    "pit",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "sdr",
    "si_sdr",
    "si_snr",
    "signal_distortion_ratio",
    "signal_noise_ratio",
    "snr",
    "stoi",
]
