"""WordErrorRate module metric (port of ``metrics_tpu/text/wer.py``)."""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.wer import _wer_compute, _wer_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class WordErrorRate(Metric):
    """Word error rate (Levenshtein word edits / reference words; native C++ library).

    Example:
        >>> from metrics_tpu_torch import WordErrorRate
        >>> metric = WordErrorRate(device="cpu")
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
        errors, total = _wer_update(predictions, references, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _wer_compute(self.errors, self.total)


class WER(WordErrorRate):
    """Deprecated alias of :class:`WordErrorRate`."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        rank_zero_warn("`WER` was renamed to `WordErrorRate` and it will be removed.", DeprecationWarning)
        super().__init__(*args, **kwargs)
