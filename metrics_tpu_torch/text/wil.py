"""WordInfoLost module metric (port of ``metrics_tpu/text/wil.py``)."""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.wil import _wil_compute, _wil_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class WordInfoLost(Metric):
    """Word information lost (1 - hits²/(pred words × ref words)).

    Example:
        >>> from metrics_tpu_torch import WordInfoLost
        >>> metric = WordInfoLost(device="cpu")
        >>> score = metric(['hello there world'], ['hello there word'])
        >>> print(f"{float(score):.4f}")
        0.5556
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("reference_total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("prediction_total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, predictions: Union[str, List[str]], references: Union[str, List[str]]) -> None:
        errors, reference_total, prediction_total = _wil_update(predictions, references, self.device)
        self.errors = self.errors + errors
        self.reference_total = self.reference_total + reference_total
        self.prediction_total = self.prediction_total + prediction_total

    def compute(self) -> Tensor:
        return _wil_compute(self.errors, self.reference_total, self.prediction_total)
