"""SDR module metrics (port of ``metrics_tpu/audio/sdr.py``): ``SignalDistortionRatio``,
the deprecated ``SDR`` and ``ScaleInvariantSignalDistortionRatio``."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class SignalDistortionRatio(Metric):
    """SDR with an optimal distortion filter, averaged over signals.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SignalDistortionRatio
        >>> n = torch.arange(64.0)
        >>> target = torch.sin(n / 4)[None]
        >>> preds = target + 0.1 * torch.cos(n / 3)[None]
        >>> sdr = SignalDistortionRatio(device="cpu")
        >>> print(f"{float(sdr(preds, target)):.2f}")
        28.53
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag
        self.add_state("sum_sdr", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sdr_batch = signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )
        self.sum_sdr = self.sum_sdr + torch.sum(sdr_batch)
        self.total = self.total + sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_sdr / self.total


class SDR(SignalDistortionRatio):
    """Deprecated alias of :class:`SignalDistortionRatio`."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        rank_zero_warn("`SDR` was renamed to `SignalDistortionRatio` and it will be removed.", DeprecationWarning)
        super().__init__(*args, **kwargs)


class ScaleInvariantSignalDistortionRatio(Metric):
    """SI-SDR, averaged over signals."""

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_si_sdr", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_sdr_batch = scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_si_sdr = self.sum_si_sdr + torch.sum(si_sdr_batch)
        self.total = self.total + si_sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_sdr / self.total
