"""SQuAD module metric (port of ``metrics_tpu/text/squad.py``)."""
from typing import Any, Dict

import torch

from metrics_tpu_torch.functional.text.squad import (
    PREDS_TYPE,
    TARGETS_TYPE,
    _squad_compute,
    _squad_input_check,
    _squad_update,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class SQuAD(Metric):
    """SQuAD v1.1 exact-match and token-F1 over prediction/answer dicts.

    Example:
        >>> from metrics_tpu_torch import SQuAD
        >>> squad = SQuAD(device="cpu")
        >>> preds = [{"prediction_text": "berlin", "id": "q1"}]
        >>> refs = [{"answers": {"text": ["berlin"], "answer_start": [0]}, "id": "q1"}]
        >>> {k: float(v) for k, v in squad(preds, refs).items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("exact_match", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        # int32, as JAX's ``jnp.asarray(0)``: the state bridge and snapshots keep each state's dtype
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: PREDS_TYPE, targets: TARGETS_TYPE) -> None:
        preds_dict, targets_list = _squad_input_check(preds, targets)
        f1, exact_match, total = _squad_update(preds_dict, targets_list, self.device)
        self.f1_score = self.f1_score + f1
        self.exact_match = self.exact_match + exact_match
        self.total = self.total + total

    def compute(self) -> Dict[str, Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)
