"""MatchErrorRate module metric (port of ``metrics_tpu/text/mer.py``)."""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.mer import _mer_compute, _mer_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class MatchErrorRate(Metric):
    """Match error rate (word edits / (edits + hits)).

    Example:
        >>> from metrics_tpu_torch import MatchErrorRate
        >>> metric = MatchErrorRate(device="cpu")
        >>> score = metric(['hello there world'], ['hello there word'])
        >>> print(f"{float(score):.4f}")
        0.3333
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, predictions: Union[str, List[str]], references: Union[str, List[str]]) -> None:
        errors, total = _mer_update(predictions, references, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _mer_compute(self.errors, self.total)
