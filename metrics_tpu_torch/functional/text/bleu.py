"""BLEU score (port of ``metrics_tpu/functional/text/bleu.py``).

N-gram counting runs on the host (strings); the accumulated numerator,
denominator and length counters are float32 sum states on the device.
"""
from collections import Counter
from typing import Callable, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _f32
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor


def _count_ngram(ngram_input_list: Sequence[str], n_gram: int) -> Counter:
    ngram_counter: Counter = Counter()
    for i in range(1, n_gram + 1):
        for j in range(len(ngram_input_list) - i + 1):
            ngram_counter[tuple(ngram_input_list[j:i + j])] += 1
    return ngram_counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    return sentence.split()


def _bleu_score_update(
    translate_corpus: Sequence[str],
    reference_corpus: Sequence[Sequence[str]],
    numerator: Tensor,
    denominator: Tensor,
    trans_len: Tensor,
    ref_len: Tensor,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Accumulate clipped n-gram matches. Returns ``(trans_len, ref_len,
    numerator, denominator)``, new tensors on the counters' device."""
    reference_corpus_ = [[tokenizer(line) if line else [] for line in reference] for reference in reference_corpus]
    translate_corpus_ = [tokenizer(line) if line else [] for line in translate_corpus]

    num_np = np.zeros(n_gram)
    den_np = np.zeros(n_gram)
    t_len = 0
    r_len = 0
    for translation, references in zip(translate_corpus_, reference_corpus_):
        t_len += len(translation)
        ref_len_list = [len(ref) for ref in references]
        ref_len_diff = [abs(len(translation) - x) for x in ref_len_list]
        r_len += ref_len_list[ref_len_diff.index(min(ref_len_diff))]
        translation_counter = _count_ngram(translation, n_gram)
        reference_counter: Counter = Counter()
        for ref in references:
            reference_counter |= _count_ngram(ref, n_gram)
        ngram_counter_clip = translation_counter & reference_counter
        for counter_clip in ngram_counter_clip:
            num_np[len(counter_clip) - 1] += ngram_counter_clip[counter_clip]
        for counter in translation_counter:
            den_np[len(counter) - 1] += translation_counter[counter]
    dev = numerator.device
    return (
        trans_len + _f32(t_len, dev),
        ref_len + _f32(r_len, dev),
        numerator + _f32(num_np, dev),
        denominator + _f32(den_np, dev),
    )


def _bleu_score_compute(
    trans_len: Tensor,
    ref_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int = 4,
    smooth: bool = False,
) -> Tensor:
    if float(torch.min(numerator)) == 0.0:
        return torch.zeros((), dtype=torch.float32, device=numerator.device)
    if smooth:
        precision_scores = (numerator + 1.0) / (denominator + 1.0)
        precision_scores[0] = numerator[0] / denominator[0]
    else:
        precision_scores = numerator / denominator
    log_precision_scores = (1.0 / n_gram) * torch.log(precision_scores)
    geometric_mean = torch.exp(torch.sum(log_precision_scores))
    brevity_penalty = torch.where(trans_len > ref_len, torch.ones_like(trans_len), torch.exp(1 - ref_len / trans_len))
    return brevity_penalty * geometric_mean


def _bleu_counters(n_gram: int, device: torch.device) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Zeroed ``(numerator, denominator, trans_len, ref_len)`` on ``device``."""
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return zeros(n_gram), zeros(n_gram), zeros(), zeros()


def bleu_score(
    translate_corpus: Union[str, Sequence[str]],
    reference_corpus: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    device: DeviceLike = None,
) -> Tensor:
    """Corpus BLEU with uniform n-gram weights and brevity penalty.

    Example:
        >>> from metrics_tpu_torch.functional import bleu_score
        >>> score = bleu_score(['the cat sat on the mat'], [['a cat sat on the mat']], device="cpu")
        >>> print(f"{float(score):.4f}")
        0.7598
    """
    translate_corpus_ = [translate_corpus] if isinstance(translate_corpus, str) else translate_corpus
    reference_corpus_ = [
        [reference_text] if isinstance(reference_text, str) else reference_text
        for reference_text in reference_corpus
    ]
    if len(translate_corpus_) != len(reference_corpus_):
        raise ValueError(f"Corpus has different size {len(translate_corpus_)} != {len(reference_corpus_)}")

    numerator, denominator, trans_len, ref_len = _bleu_counters(n_gram, resolve_device(device))
    trans_len, ref_len, numerator, denominator = _bleu_score_update(
        translate_corpus_, reference_corpus_, numerator, denominator, trans_len, ref_len, n_gram
    )
    return _bleu_score_compute(trans_len, ref_len, numerator, denominator, n_gram, smooth)
