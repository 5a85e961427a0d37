"""TranslationEditRate module metric (port of ``metrics_tpu/text/ter.py``)."""
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _canonicalize_corpora, _f32
from metrics_tpu_torch.functional.text.ter import _ter_compute, _ter_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class TranslationEditRate(Metric):
    """Translation edit rate (edits / average reference length).

    Example:
        >>> from metrics_tpu_torch import TranslationEditRate
        >>> ter = TranslationEditRate(device="cpu")
        >>> score = ter(['the cat sat on the mat'], [['a cat sat on the mat']])
        >>> print(f"{float(score):.4f}")
        0.1667
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_num_edits", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total_ref_len", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def update(self, hypothesis_corpus: Sequence[str], reference_corpus: Sequence[Union[str, Sequence[str]]]) -> None:
        # the reference's argument names (``text/ter.py:105``), for keyword calls
        preds, targets = _canonicalize_corpora(hypothesis_corpus, reference_corpus)
        sentence_scores: Optional[List[float]] = [] if self.return_sentence_level_score else None
        self.total_num_edits, self.total_ref_len = _ter_update(
            preds, targets, self.total_num_edits, self.total_ref_len,
            self.lowercase, self.normalize, self.no_punctuation, sentence_scores,
            self.asian_support,
        )
        if self.return_sentence_level_score and sentence_scores:
            self.sentence_ter.append(_f32(sentence_scores, self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = _ter_compute(self.total_num_edits, self.total_ref_len)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_ter)
        return score
