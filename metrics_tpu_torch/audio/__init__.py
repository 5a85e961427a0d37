"""Audio metrics of the port (``metrics_tpu/audio``)."""
from metrics_tpu_torch.audio.pesq import PESQ
from metrics_tpu_torch.audio.pit import PIT, PermutationInvariantTraining
from metrics_tpu_torch.audio.sdr import SDR, ScaleInvariantSignalDistortionRatio, SignalDistortionRatio
from metrics_tpu_torch.audio.si_sdr import SI_SDR
from metrics_tpu_torch.audio.si_snr import SI_SNR
from metrics_tpu_torch.audio.snr import SNR, ScaleInvariantSignalNoiseRatio, SignalNoiseRatio
from metrics_tpu_torch.audio.stoi import STOI

__all__ = [
    "PESQ",
    "PIT",
    "PermutationInvariantTraining",
    "SDR",
    "SI_SDR",
    "SI_SNR",
    "SNR",
    "STOI",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
]
