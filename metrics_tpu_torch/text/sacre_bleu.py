"""SacreBLEUScore module metric (port of ``metrics_tpu/text/sacre_bleu.py``)."""
from typing import Any, Sequence

from metrics_tpu_torch.functional.text.bleu import _bleu_score_update
from metrics_tpu_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer
from metrics_tpu_torch.text.bleu import BLEUScore


class SacreBLEUScore(BLEUScore):
    """BLEU with canonical sacrebleu tokenization.

    Example:
        >>> from metrics_tpu_torch import SacreBLEUScore
        >>> preds = ["the cat sat on the mat"]
        >>> refs = [["a cat sat on the mat", "the cat sits on the mat"]]
        >>> sacre_bleu = SacreBLEUScore(tokenize="13a", device="cpu")
        >>> print(f"{float(sacre_bleu(preds, refs)):.4f}")
        0.8409
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, **kwargs)
        self.tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)

    def update(self, translate_corpus: Sequence[str], reference_corpus: Sequence[Sequence[str]]) -> None:
        translate_corpus = [translate_corpus] if isinstance(translate_corpus, str) else translate_corpus
        reference_corpus = [[ref] if isinstance(ref, str) else ref for ref in reference_corpus]
        self.trans_len, self.ref_len, self.numerator, self.denominator = _bleu_score_update(
            translate_corpus, reference_corpus, self.numerator, self.denominator,
            self.trans_len, self.ref_len, self.n_gram, tokenizer=self.tokenizer,
        )
