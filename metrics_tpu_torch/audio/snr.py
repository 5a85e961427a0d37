"""SNR module metrics (port of ``metrics_tpu/audio/snr.py``): ``SignalNoiseRatio``,
the deprecated ``SNR`` and ``ScaleInvariantSignalNoiseRatio``."""
from typing import Any

import torch

from metrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class SignalNoiseRatio(Metric):
    """Signal-to-noise ratio, averaged over signals."""

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_snr", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        # int32, as JAX's ``jnp.asarray(0)``: the state bridge, sync and snapshots keep each state's dtype
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        snr_batch = signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_snr = self.sum_snr + torch.sum(snr_batch)
        self.total = self.total + snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_snr / self.total


class SNR(SignalNoiseRatio):
    """Deprecated alias of :class:`SignalNoiseRatio`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SNR
        >>> target = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([1.1, 2.1, 2.9, 4.2])
        >>> snr = SNR(device="cpu")
        >>> print(f"{float(snr(preds, target)):.4f}")
        26.3202
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        rank_zero_warn("`SNR` was renamed to `SignalNoiseRatio` and it will be removed.", DeprecationWarning)
        super().__init__(*args, **kwargs)


class ScaleInvariantSignalNoiseRatio(Metric):
    """Scale-invariant SNR, averaged over signals.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ScaleInvariantSignalNoiseRatio
        >>> target = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([1.1, 2.1, 2.9, 4.2])
        >>> si_snr = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> print(f"{float(si_snr(preds, target)):.4f}")
        20.3551
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_si_snr", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_snr_batch = scale_invariant_signal_noise_ratio(preds=preds, target=target)
        self.sum_si_snr = self.sum_si_snr + torch.sum(si_snr_batch)
        self.total = self.total + si_snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_snr / self.total
