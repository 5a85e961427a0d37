"""PESQ module metric (port of ``metrics_tpu/audio/pesq.py``): the native ``pesq``
package's scores (host DSP) summed on the metric's device."""
from typing import Any

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE

Tensor = torch.Tensor


class PESQ(Metric):
    """Perceptual evaluation of speech quality (narrow or wide band),
    averaged over signals. Raises ``ModuleNotFoundError`` when constructed
    without the ``pesq`` package."""

    is_differentiable = False
    higher_is_better = True

    def __init__(self, fs: int, mode: str, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PESQ metric requires that pesq is installed. Either install as `pip install pesq`."
            )
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        self.fs = fs
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.mode = mode
        self.add_state("sum_pesq", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        from metrics_tpu_torch.functional.audio.pesq import pesq as pesq_fn

        scores = pesq_fn(preds, target, self.fs, self.mode)
        self.sum_pesq = self.sum_pesq + torch.sum(scores)
        self.total = self.total + scores.numel()

    def compute(self) -> Tensor:
        return self.sum_pesq / self.total
