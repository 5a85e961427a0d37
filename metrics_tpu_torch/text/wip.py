"""WordInfoPreserved module metric (port of ``metrics_tpu/text/wip.py``)."""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.wip import _wip_compute, _wip_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class WordInfoPreserved(Metric):
    """Word information preserved (hits²/(pred words × ref words)).

    Example:
        >>> from metrics_tpu_torch import WordInfoPreserved
        >>> metric = WordInfoPreserved(device="cpu")
        >>> score = metric(['hello there world'], ['hello there word'])
        >>> print(f"{float(score):.4f}")
        0.4444
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("reference_total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("prediction_total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, predictions: Union[str, List[str]], references: Union[str, List[str]]) -> None:
        errors, reference_total, prediction_total = _wip_update(predictions, references, self.device)
        self.errors = self.errors + errors
        self.reference_total = self.reference_total + reference_total
        self.prediction_total = self.prediction_total + prediction_total

    def compute(self) -> Tensor:
        return _wip_compute(self.errors, self.reference_total, self.prediction_total)
