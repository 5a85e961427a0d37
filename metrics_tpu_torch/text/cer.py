"""CharErrorRate module metric (port of ``metrics_tpu/text/cer.py``)."""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.cer import _cer_compute, _cer_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class CharErrorRate(Metric):
    """Character error rate (Levenshtein character edits / reference characters).

    Example:
        >>> from metrics_tpu_torch import CharErrorRate
        >>> metric = CharErrorRate(device="cpu")
        >>> score = metric(['hello there world'], ['hello there word'])
        >>> print(f"{float(score):.4f}")
        0.0625
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, predictions: Union[str, List[str]], references: Union[str, List[str]]) -> None:
        errors, total = _cer_update(predictions, references, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _cer_compute(self.errors, self.total)
