"""Text metrics of the port (``metrics_tpu/text``)."""
from metrics_tpu_torch.text.bert import BERTScore
from metrics_tpu_torch.text.bleu import BLEUScore
from metrics_tpu_torch.text.cer import CharErrorRate
from metrics_tpu_torch.text.chrf import CHRFScore
from metrics_tpu_torch.text.mer import MatchErrorRate
from metrics_tpu_torch.text.rouge import ROUGEScore
from metrics_tpu_torch.text.sacre_bleu import SacreBLEUScore
from metrics_tpu_torch.text.squad import SQuAD
from metrics_tpu_torch.text.ter import TranslationEditRate
from metrics_tpu_torch.text.wer import WER, WordErrorRate
from metrics_tpu_torch.text.wil import WordInfoLost
from metrics_tpu_torch.text.wip import WordInfoPreserved

__all__ = [
    "BERTScore",
    "BLEUScore",
    "CHRFScore",
    "CharErrorRate",
    "MatchErrorRate",
    "ROUGEScore",
    "SQuAD",
    "SacreBLEUScore",
    "TranslationEditRate",
    "WER",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
