"""BLEUScore module metric (port of ``metrics_tpu/text/bleu.py``: n-gram
numerator/denominator and length counters, all sum-reduced)."""
from typing import Any, Sequence

import torch

from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class BLEUScore(Metric):
    """BLEU score (n-gram precision with brevity penalty) over a translation corpus.

    Example:
        >>> from metrics_tpu_torch import BLEUScore
        >>> preds = ["the cat sat on the mat"]
        >>> refs = [["a cat sat on the mat", "the cat sits on the mat"]]
        >>> bleu = BLEUScore(device="cpu")
        >>> print(f"{float(bleu(preds, refs)):.4f}")
        0.8409
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(self, n_gram: int = 4, smooth: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        self.add_state("trans_len", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("ref_len", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(n_gram, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(n_gram, dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, translate_corpus: Sequence[str], reference_corpus: Sequence[Sequence[str]]) -> None:
        translate_corpus = [translate_corpus] if isinstance(translate_corpus, str) else translate_corpus
        reference_corpus = [[ref] if isinstance(ref, str) else ref for ref in reference_corpus]
        self.trans_len, self.ref_len, self.numerator, self.denominator = _bleu_score_update(
            translate_corpus, reference_corpus, self.numerator, self.denominator,
            self.trans_len, self.ref_len, self.n_gram,
        )

    def compute(self) -> Tensor:
        return _bleu_score_compute(
            self.trans_len, self.ref_len, self.numerator, self.denominator, self.n_gram, self.smooth
        )
