"""ROUGEScore module metric (port of ``metrics_tpu/text/rouge.py``: one
``cat`` list state ``rouge{key}_{score_type}`` per key and score type, of
one (1,) float32 tensor per sentence pair)."""
from typing import Any, Dict, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _f32
from metrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ROUGE_KEYS,
    _rouge_score_compute,
    _rouge_score_update,
    _stemmer,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class ROUGEScore(Metric):
    """ROUGE-N / ROUGE-L scores (n-gram and LCS in Python, no optional package).

    Example:
        >>> from metrics_tpu_torch import ROUGEScore
        >>> rouge = ROUGEScore(device="cpu")
        >>> scores = rouge(["the cat sat"], ["the cat sat on the mat"])
        >>> print(f"{float(scores['rouge1_fmeasure']):.4f}")
        0.6667
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        use_stemmer: bool = False,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.stemmer = _stemmer(use_stemmer)

        if isinstance(rouge_keys, str):
            rouge_keys = (rouge_keys,)
        for key in rouge_keys:
            if key not in ALLOWED_ROUGE_KEYS:
                raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {ALLOWED_ROUGE_KEYS}")
        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [
            int(key[5:]) if key[5:].isdigit() else key[5:] for key in rouge_keys
        ]
        if accumulate not in ("best", "avg"):
            raise ValueError(f"Got unknown accumulate method {accumulate}. Expected 'best' or 'avg'.")
        self.accumulate = accumulate
        for key in self.rouge_keys_values:
            for score_type in ("fmeasure", "precision", "recall"):
                self.add_state(f"rouge{key}_{score_type}", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], targets: Union[str, Sequence[str]]) -> None:
        preds = [preds] if isinstance(preds, str) else list(preds)
        targets = [targets] if isinstance(targets, str) else list(targets)
        results = _rouge_score_update(preds, targets, self.rouge_keys_values, self.accumulate, self.stemmer)
        for key, scores in results.items():
            if not scores:
                continue
            for score_type in ("precision", "recall", "fmeasure"):
                # one upload per key and score type; the list holds a (1,) view per pair, as JAX's does
                values = _f32([s[score_type] for s in scores], self.device)
                getattr(self, f"rouge{key}_{score_type}").extend(values.split(1))

    def compute(self) -> Dict[str, Tensor]:
        update_output = {}
        for key in self.rouge_keys_values:
            for score_type in ("fmeasure", "precision", "recall"):
                vals = getattr(self, f"rouge{key}_{score_type}")
                update_output[f"rouge{key}_{score_type}"] = [dim_zero_cat(vals)] if vals else []
        return _rouge_score_compute(update_output)
