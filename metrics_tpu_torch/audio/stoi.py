"""STOI module metric (port of ``metrics_tpu/audio/stoi.py``): the native STOI/ESTOI
of ``functional/audio/stoi.py`` averaged over signals; needs no ``pystoi``."""
from typing import Any

import torch

from metrics_tpu_torch.functional.audio.stoi import stoi
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class STOI(Metric):
    """Short-time objective intelligibility, averaged over signals."""

    is_differentiable = False
    higher_is_better = True

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.fs = fs
        self.extended = extended
        self.add_state("sum_stoi", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        scores = stoi(preds, target, self.fs, extended=self.extended)
        self.sum_stoi = self.sum_stoi + torch.sum(scores)
        self.total = self.total + scores.numel()

    def compute(self) -> Tensor:
        return self.sum_stoi / self.total
