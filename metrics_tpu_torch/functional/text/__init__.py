"""Text functionals of the port (``metrics_tpu/functional/text``)."""
from metrics_tpu_torch.functional.text.bert import bert_score
from metrics_tpu_torch.functional.text.bleu import bleu_score
from metrics_tpu_torch.functional.text.cer import char_error_rate
from metrics_tpu_torch.functional.text.chrf import chrf_score
from metrics_tpu_torch.functional.text.mer import match_error_rate
from metrics_tpu_torch.functional.text.rouge import rouge_score
from metrics_tpu_torch.functional.text.sacre_bleu import sacre_bleu_score
from metrics_tpu_torch.functional.text.squad import squad
from metrics_tpu_torch.functional.text.ter import translation_edit_rate
from metrics_tpu_torch.functional.text.wer import wer, word_error_rate
from metrics_tpu_torch.functional.text.wil import word_information_lost
from metrics_tpu_torch.functional.text.wip import word_information_preserved

__all__ = [
    "bert_score",
    "bleu_score",
    "char_error_rate",
    "chrf_score",
    "match_error_rate",
    "rouge_score",
    "sacre_bleu_score",
    "squad",
    "translation_edit_rate",
    "wer",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
