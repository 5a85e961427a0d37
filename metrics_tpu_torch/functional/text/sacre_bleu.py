"""SacreBLEU: BLEU with canonical tokenizers (port of
``metrics_tpu/functional/text/sacre_bleu.py``).

``13a`` (mteval-v13a), ``intl`` (mteval-v14 international, which needs the
``regex`` package for its unicode property classes), ``char``, ``none`` and
``zh``: each CJK character (by the reference's effective block table) is
split out as its own token and the rest goes through the 13a regexes, with
no segmenter.
"""
import re
from typing import Sequence

import torch

from metrics_tpu_torch.functional.text.bleu import _bleu_counters, _bleu_score_compute, _bleu_score_update
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device
from metrics_tpu_torch.utils.imports import _REGEX_AVAILABLE

Tensor = torch.Tensor

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")


class _SacreBLEUTokenizer:
    """Canonical sacrebleu tokenizers (the reference's ``sacre_bleu.py:45-200``)."""

    _REGEX_13A = (
        # language-independent part of mteval-v13a
        (re.compile(r"<skipped>"), ""),
        (re.compile(r"-\n"), ""),
        (re.compile(r"\n"), " "),
        (re.compile(r"&quot;"), '"'),
        (re.compile(r"&amp;"), "&"),
        (re.compile(r"&lt;"), "<"),
        (re.compile(r"&gt;"), ">"),
    )
    _REGEX_13A_TOK = (
        (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
        (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
        (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
        (re.compile(r"([0-9])(-)"), r"\1 \2 "),
    )
    # The EFFECTIVE char set of sacrebleu's TokenizerZh._is_chinese_char: its
    # range table compares python strings, and the two "UTF16" entries are
    # 5-char literals, so the real behavior is [U+2001-U+2A6D] (not CJK Ext B,
    # which is never matched) plus the BMP blocks. Parity requires the quirk,
    # not the nominal block list.
    _ZH_CHAR = re.compile(
        "(["
        "\u2001-\u2a6d"  # quirk: the "\u20000"-"\u2a6d6" string-compare entry
        "\u2e80-\u2fdf"  # CJK radicals + Kangxi radicals
        "\u2ff0-\u303f"  # ideographic description + CJK punctuation
        "\u3100-\u312f"  # bopomofo
        "\u31a0-\u31ef"  # bopomofo extended + CJK strokes
        "\u3200-\u4db5"  # enclosed CJK + compatibility + Ext A
        "\u4e00-\u9fbb"  # CJK Unified Ideographs
        "\uf900-\ufa2d\ufa30-\ufa6a\ufa70-\ufad9"  # compatibility ideographs
        "\ufe10-\ufe1f\ufe30-\ufe4f"  # vertical/compatibility forms
        "\uff00-\uffef"  # full-width forms
        "])"
    )

    def __init__(self, tokenize: str = "13a", lowercase: bool = False) -> None:
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        self.tokenize_name = tokenize
        self.lowercase = lowercase
        if tokenize == "intl" and not _REGEX_AVAILABLE:
            raise ModuleNotFoundError(
                "`intl` tokenization requires the `regex` package (unicode property classes)."
            )

    def __call__(self, line: str) -> Sequence[str]:
        if self.lowercase:
            line = line.lower()
        if self.tokenize_name == "none":
            return line.split()
        if self.tokenize_name == "13a":
            return self._tokenize_13a(line)
        if self.tokenize_name == "char":
            return self._tokenize_char(line)
        if self.tokenize_name == "intl":
            return self._tokenize_intl(line)
        if self.tokenize_name == "zh":
            return self._tokenize_zh(line)
        raise ValueError(f"Unsupported tokenizer {self.tokenize_name}")

    @classmethod
    def _tokenize_13a(cls, line: str) -> Sequence[str]:
        for pattern, replacement in cls._REGEX_13A:
            line = pattern.sub(replacement, line)
        norm = f" {line} "
        for pattern, replacement in cls._REGEX_13A_TOK:
            norm = pattern.sub(replacement, norm)
        return norm.split()

    @staticmethod
    def _tokenize_char(line: str) -> Sequence[str]:
        # every char is a token; whitespace chars drop out (sacrebleu semantics)
        return [ch for ch in line if not ch.isspace()]

    @staticmethod
    def _tokenize_intl(line: str) -> Sequence[str]:
        # mteval-v14 international: split punctuation off non-digit neighbors,
        # then isolate symbols — rule order follows sacrebleu's TokenizerV14
        import regex

        line = regex.sub(r"(\P{N})(\p{P})", r"\1 \2 ", line)
        line = regex.sub(r"(\p{P})(\P{N})", r" \1 \2", line)
        line = regex.sub(r"(\p{S})", r" \1 ", line)
        return line.split()

    @classmethod
    def _tokenize_zh(cls, line: str) -> Sequence[str]:
        # Isolate every CJK character, then run the non-Chinese remainder
        # through the 13a language-dependent regexes. No segmenter needed
        # (reference sacre_bleu.py:203-229). Unlike 13a, zh applies NO space
        # padding around the line (sacrebleu calls TokenizerRegexp directly),
        # so leading ".5" stays one token here.
        norm = cls._ZH_CHAR.sub(r" \1 ", line.strip())
        for pattern, replacement in cls._REGEX_13A_TOK:
            norm = pattern.sub(replacement, norm)
        return norm.split()


def sacre_bleu_score(
    translate_corpus: Sequence[str],
    reference_corpus: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    device: DeviceLike = None,
) -> Tensor:
    """BLEU with a sacrebleu tokenizer, on ``device`` (default ``cuda``)."""
    tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
    translate_corpus_ = [translate_corpus] if isinstance(translate_corpus, str) else list(translate_corpus)
    reference_corpus_ = [
        [ref] if isinstance(ref, str) else list(ref) for ref in reference_corpus
    ]
    if len(translate_corpus_) != len(reference_corpus_):
        raise ValueError(f"Corpus has different size {len(translate_corpus_)} != {len(reference_corpus_)}")

    numerator, denominator, trans_len, ref_len = _bleu_counters(n_gram, resolve_device(device))
    trans_len, ref_len, numerator, denominator = _bleu_score_update(
        translate_corpus_, reference_corpus_, numerator, denominator, trans_len, ref_len, n_gram,
        tokenizer=tokenizer,
    )
    return _bleu_score_compute(trans_len, ref_len, numerator, denominator, n_gram, smooth)
