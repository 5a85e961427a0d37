"""The deprecated ``SI_SDR`` alias class (port of ``metrics_tpu/audio/si_sdr.py``):
``ScaleInvariantSignalDistortionRatio`` that warns when constructed."""
from typing import Any

from metrics_tpu_torch.audio.sdr import ScaleInvariantSignalDistortionRatio
from metrics_tpu_torch.utils.prints import rank_zero_warn


class SI_SDR(ScaleInvariantSignalDistortionRatio):
    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        rank_zero_warn(
            "`SI_SDR` was renamed to `ScaleInvariantSignalDistortionRatio` and it will be removed.",
            DeprecationWarning,
        )
        super().__init__(zero_mean=zero_mean, **kwargs)
