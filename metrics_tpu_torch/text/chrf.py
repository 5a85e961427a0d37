"""CHRFScore module metric (port of ``metrics_tpu/text/chrf.py``: per-order
count states, all sum-reduced, and with ``return_sentence_level_score`` a
``cat`` list of the sentence scores)."""
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.chrf import _chrf_compute, _chrf_update
from metrics_tpu_torch.functional.text.helper import _canonicalize_corpora, _f32
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class CHRFScore(Metric):
    """chrF / chrF++ score (character n-gram F-score).

    Example:
        >>> from metrics_tpu_torch import CHRFScore
        >>> chrf = CHRFScore(device="cpu")
        >>> score = chrf(['the cat sat on the mat'], ['a cat sat on the mat'])
        >>> print(f"{float(score):.4f}")
        0.8719
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(n_char_order, int) or n_char_order < 1:
            raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
        if not isinstance(n_word_order, int) or n_word_order < 0:
            raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
        if beta < 0:
            raise ValueError("Expected argument `beta` to be greater than 0.")
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score

        n_order = n_char_order + n_word_order
        self.add_state("matching", torch.zeros(n_order, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total_pred", torch.zeros(n_order, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total_ref", torch.zeros(n_order, dtype=torch.float32), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf", [], dist_reduce_fx="cat")

    def update(self, hypothesis_corpus: Sequence[str], reference_corpus: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        # the reference's argument names (``text/chrf.py:145``), for keyword calls
        preds, targets = _canonicalize_corpora(hypothesis_corpus, reference_corpus)
        sentence_scores: Optional[List[float]] = [] if self.return_sentence_level_score else None
        self.matching, self.total_pred, self.total_ref = _chrf_update(
            preds, targets, self.matching, self.total_pred, self.total_ref,
            self.n_char_order, self.n_word_order, self.lowercase, self.whitespace, self.beta, sentence_scores,
        )
        if self.return_sentence_level_score and sentence_scores:
            self.sentence_chrf.append(_f32(sentence_scores, self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = _chrf_compute(self.matching, self.total_pred, self.total_ref, self.beta)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_chrf)
        return score
