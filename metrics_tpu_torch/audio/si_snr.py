"""The deprecated ``SI_SNR`` alias class (port of ``metrics_tpu/audio/si_snr.py``):
``ScaleInvariantSignalNoiseRatio`` that warns when constructed."""
from typing import Any

from metrics_tpu_torch.audio.snr import ScaleInvariantSignalNoiseRatio
from metrics_tpu_torch.utils.prints import rank_zero_warn


class SI_SNR(ScaleInvariantSignalNoiseRatio):
    def __init__(self, **kwargs: Any) -> None:
        rank_zero_warn(
            "`SI_SNR` was renamed to `ScaleInvariantSignalNoiseRatio` and it will be removed.",
            DeprecationWarning,
        )
        super().__init__(**kwargs)
