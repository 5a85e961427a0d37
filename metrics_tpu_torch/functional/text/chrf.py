"""chrF / chrF++ score (port of ``metrics_tpu/functional/text/chrf.py``).

The sacrebleu chrF algorithm: character n-grams up to ``n_char_order`` plus
word n-grams up to ``n_word_order``, combined with an F-beta over averaged
per-order precision and recall. The states are per-order matching, pred and
ref count tensors, all sum-reducible; n-grams are counted on the host.
"""
from collections import Counter
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _canonicalize_corpora, _f32, _resolve_corpus_aliases
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

_EPS_SMOOTHING = 1e-16


def _prepare_text(text: str, lowercase: bool, whitespace: bool) -> str:
    if lowercase:
        text = text.lower()
    if not whitespace:
        text = "".join(text.split())
    return text


def _char_ngrams(text: str, n: int) -> Counter:
    return Counter(text[i:i + n] for i in range(len(text) - n + 1))


def _word_ngrams(words: List[str], n: int) -> Counter:
    return Counter(tuple(words[i:i + n]) for i in range(len(words) - n + 1))


def _sentence_counts(
    text: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[List[Counter], List[Counter]]:
    prepared = _prepare_text(text, lowercase, whitespace)
    char_counts = [_char_ngrams(prepared, n) for n in range(1, n_char_order + 1)]
    words = text.lower().split() if lowercase else text.split()
    word_counts = [_word_ngrams(words, n) for n in range(1, n_word_order + 1)]
    return char_counts, word_counts


def _matching(pred: Counter, ref: Counter) -> int:
    return sum((pred & ref).values())


def _chrf_score_from_totals(matching: Tensor, total_pred: Tensor, total_ref: Tensor, beta: float) -> Tensor:
    """F-beta over per-order precision/recall averages (sacrebleu semantics)."""
    zero = torch.zeros((), dtype=matching.dtype, device=matching.device)
    precision = torch.where(total_pred > 0, matching / torch.clamp(total_pred, min=1), zero)
    recall = torch.where(total_ref > 0, matching / torch.clamp(total_ref, min=1), zero)
    # sacrebleu effective-order smoothing: an order counts only when BOTH sides
    # produced n-grams of that order (short references drop the high orders)
    order_mask = (total_pred > 0) & (total_ref > 0)
    n_eff = torch.clamp(torch.sum(order_mask, dtype=torch.int32), min=1)
    avg_precision = torch.sum(torch.where(order_mask, precision, zero)) / n_eff
    avg_recall = torch.sum(torch.where(order_mask, recall, zero)) / n_eff
    beta2 = beta ** 2
    denom = beta2 * avg_precision + avg_recall
    return torch.where(
        denom > 0, (1 + beta2) * avg_precision * avg_recall / torch.clamp(denom, min=_EPS_SMOOTHING), zero
    )


def _chrf_score_np(matching, total_pred, total_ref, beta: float) -> float:
    """Host twin of :func:`_chrf_score_from_totals` for best-reference
    selection and sentence scores: plain numpy, no device work in the loop."""
    precision = np.where(total_pred > 0, matching / np.maximum(total_pred, 1), 0.0)
    recall = np.where(total_ref > 0, matching / np.maximum(total_ref, 1), 0.0)
    order_mask = (total_pred > 0) & (total_ref > 0)
    n_eff = max(int(order_mask.sum()), 1)
    avg_precision = float(precision[order_mask].sum()) / n_eff
    avg_recall = float(recall[order_mask].sum()) / n_eff
    beta2 = beta ** 2
    denom = beta2 * avg_precision + avg_recall
    if denom <= 0:
        return 0.0
    return (1 + beta2) * avg_precision * avg_recall / max(denom, _EPS_SMOOTHING)


def _chrf_update(
    preds: Sequence[str],
    targets: Sequence[str],
    matching: Tensor,
    total_pred: Tensor,
    total_ref: Tensor,
    n_char_order: int = 6,
    n_word_order: int = 2,
    lowercase: bool = False,
    whitespace: bool = False,
    beta: float = 2.0,
    sentence_scores: Optional[List[float]] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Accumulate per-order n-gram statistics over a batch of sentence pairs;
    each pair's sentence score goes to ``sentence_scores`` as a Python float."""
    n_order = n_char_order + n_word_order

    m_np = np.zeros(n_order)
    p_np = np.zeros(n_order)
    r_np = np.zeros(n_order)
    for pred, refs in zip(preds, targets):
        p_char, p_word = _sentence_counts(pred, n_char_order, n_word_order, lowercase, whitespace)
        # multi-reference: evaluate every reference and keep the statistics of
        # the best-matching one; the common single-reference case skips the
        # selection scoring entirely
        cands = []
        for ref in ([refs] if isinstance(refs, str) else list(refs)):
            r_char, r_word = _sentence_counts(ref, n_char_order, n_word_order, lowercase, whitespace)
            cand_m = np.zeros(n_order)
            cand_p = np.zeros(n_order)
            cand_r = np.zeros(n_order)
            for i, (pc, rc) in enumerate(list(zip(p_char, r_char)) + list(zip(p_word, r_word))):
                cand_m[i] = _matching(pc, rc)
                # sacrebleu: a hypothesis n-gram count only stands when the
                # reference produced ANY n-gram of that order
                cand_p[i] = sum(pc.values()) if rc else 0
                cand_r[i] = sum(rc.values())
            cands.append((cand_m, cand_p, cand_r))
        if len(cands) == 1:
            sent_m, sent_p, sent_r = cands[0]
        else:  # first-wins ties, like sacrebleu's strict > comparison
            sent_m, sent_p, sent_r = max(cands, key=lambda c: _chrf_score_np(c[0], c[1], c[2], beta))
        m_np += sent_m
        p_np += sent_p
        r_np += sent_r
        if sentence_scores is not None:
            sentence_scores.append(_chrf_score_np(sent_m, sent_p, sent_r, beta))
    dev = matching.device
    return matching + _f32(m_np, dev), total_pred + _f32(p_np, dev), total_ref + _f32(r_np, dev)


def _chrf_compute(matching: Tensor, total_pred: Tensor, total_ref: Tensor, beta: float = 2.0) -> Tensor:
    return _chrf_score_from_totals(matching, total_pred, total_ref, beta)


def chrf_score(
    preds: Union[str, Sequence[str], None] = None,
    targets: Union[str, Sequence[str], Sequence[Sequence[str]], None] = None,
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    *,
    hypothesis_corpus: Union[str, Sequence[str], None] = None,
    reference_corpus: Union[str, Sequence[str], Sequence[Sequence[str]], None] = None,
    device: DeviceLike = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus chrF (chrF++ with word n-grams), on ``device`` (default ``cuda``).
    The reference's keyword names ``hypothesis_corpus``/``reference_corpus``
    are aliases of ``preds``/``targets`` (same positional order), and
    multi-reference corpora follow the reference's ``_validate_inputs`` shapes."""
    preds, targets = _resolve_corpus_aliases("chrf_score", preds, targets, hypothesis_corpus, reference_corpus)
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")

    preds_, targets_ = _canonicalize_corpora(preds, targets)

    n_order = n_char_order + n_word_order
    dev = resolve_device(device)
    matching, total_pred, total_ref = (torch.zeros(n_order, dtype=torch.float32, device=dev) for _ in range(3))
    sentence_scores: Optional[List[float]] = [] if return_sentence_level_score else None
    matching, total_pred, total_ref = _chrf_update(
        preds_, targets_, matching, total_pred, total_ref, n_char_order, n_word_order,
        lowercase, whitespace, beta, sentence_scores,
    )
    score = _chrf_compute(matching, total_pred, total_ref, beta)
    if return_sentence_level_score:
        return score, _f32(sentence_scores, dev)
    return score
