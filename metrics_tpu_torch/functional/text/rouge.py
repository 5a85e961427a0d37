"""ROUGE score, rouge1-9 / rougeL / rougeLsum (port of
``metrics_tpu/functional/text/rouge.py``).

The n-gram overlap and the LCS run in Python on the host, as in the JAX
package, with no optional package; Porter stemming (``use_stemmer``) needs
``nltk`` and raises without it.
"""
import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _f32
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device
from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE

Tensor = torch.Tensor

ALLOWED_ROUGE_KEYS = ("rouge1", "rouge2", "rouge3", "rouge4", "rouge5", "rouge6", "rouge7", "rouge8", "rouge9",
                      "rougeL", "rougeLsum")


def _tokenize(text: str, stemmer=None) -> List[str]:
    text = re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if re.match(r"^[a-z0-9]+$", x)]


def _pr_f(matches: float, pred_len: int, target_len: int) -> Dict[str, float]:
    precision = matches / pred_len if pred_len > 0 else 0.0
    recall = matches / target_len if target_len > 0 else 0.0
    if precision + recall > 0:
        fmeasure = 2 * precision * recall / (precision + recall)
    else:
        fmeasure = 0.0
    return {"precision": precision, "recall": recall, "fmeasure": fmeasure}


def _rouge_n_score(pred: List[str], target: List[str], n_gram: int) -> Dict[str, float]:
    def _ngrams(tokens: List[str]) -> Counter:
        return Counter(tuple(tokens[i:i + n_gram]) for i in range(len(tokens) - n_gram + 1))

    pred_ngrams, target_ngrams = _ngrams(pred), _ngrams(target)
    pred_len = sum(pred_ngrams.values())
    target_len = sum(target_ngrams.values())
    hits = sum((pred_ngrams & target_ngrams).values())
    return _pr_f(hits, pred_len, target_len)


def _lcs(pred: List[str], target: List[str]) -> int:
    """Longest common subsequence length (two-row DP)."""
    if not pred or not target:
        return 0
    prev = [0] * (len(target) + 1)
    for p in pred:
        cur = [0] * (len(target) + 1)
        for j, t in enumerate(target, 1):
            cur[j] = prev[j - 1] + 1 if p == t else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _rouge_l_score(pred: List[str], target: List[str]) -> Dict[str, float]:
    lcs = _lcs(pred, target)
    return _pr_f(lcs, len(pred), len(target))


def _split_sentences(text: str) -> List[str]:
    # rougeLsum semantics (rouge_score default): sentences are newline-separated
    return [s for s in text.split("\n") if s]


def _rouge_lsum_score(pred: str, target: str, stemmer=None) -> Dict[str, float]:
    """Summary-level ROUGE-L: union-LCS per target sentence, hits clipped by token
    frequency in both summaries (rouge_score semantics)."""
    pred_sents = [_tokenize(s, stemmer) for s in _split_sentences(pred)]
    target_sents = [_tokenize(s, stemmer) for s in _split_sentences(target)]
    pred_len = sum(len(s) for s in pred_sents)
    target_len = sum(len(s) for s in target_sents)

    def _union_lcs_tokens(t_sent: List[str]) -> List[str]:
        union: set = set()
        for p_sent in pred_sents:
            n, m = len(p_sent), len(t_sent)
            dp = [[0] * (m + 1) for _ in range(n + 1)]
            for i in range(1, n + 1):
                for j in range(1, m + 1):
                    dp[i][j] = dp[i - 1][j - 1] + 1 if p_sent[i - 1] == t_sent[j - 1] else max(
                        dp[i - 1][j], dp[i][j - 1]
                    )
            i, j = n, m
            while i > 0 and j > 0:
                if p_sent[i - 1] == t_sent[j - 1]:
                    union.add(j - 1)
                    i, j = i - 1, j - 1
                elif dp[i - 1][j] >= dp[i][j - 1]:
                    i -= 1
                else:
                    j -= 1
        return [t_sent[j] for j in union]

    pred_counts = Counter(tok for s in pred_sents for tok in s)
    target_counts = Counter(tok for s in target_sents for tok in s)
    hits = 0
    for t_sent in target_sents:
        for tok in _union_lcs_tokens(t_sent):
            if pred_counts[tok] > 0 and target_counts[tok] > 0:
                hits += 1
                pred_counts[tok] -= 1
                target_counts[tok] -= 1
    return _pr_f(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    targets: Sequence[str],
    rouge_keys_values: Sequence[Union[int, str]],
    accumulate: str = "best",
    stemmer=None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per key, one ``{precision, recall, fmeasure}`` dict of Python floats
    per sentence pair (the best or the average over its references)."""
    results: Dict[Union[int, str], List[Dict[str, float]]] = {k: [] for k in rouge_keys_values}
    for pred_raw, target_raw in zip(preds, targets):
        target_list = [target_raw] if isinstance(target_raw, str) else list(target_raw)
        pred_toks = _tokenize(pred_raw, stemmer)
        per_key_scores: Dict[Union[int, str], List[Dict[str, float]]] = {k: [] for k in rouge_keys_values}
        for tgt_raw in target_list:
            tgt_toks = _tokenize(tgt_raw, stemmer)
            for key in rouge_keys_values:
                if key == "L":
                    score = _rouge_l_score(pred_toks, tgt_toks)
                elif key == "Lsum":
                    score = _rouge_lsum_score(pred_raw, tgt_raw, stemmer)
                else:
                    score = _rouge_n_score(pred_toks, tgt_toks, int(key))
                per_key_scores[key].append(score)
        for key in rouge_keys_values:
            if accumulate == "best":
                best = max(per_key_scores[key], key=lambda s: s["fmeasure"])
            else:  # avg
                best = {
                    m: sum(s[m] for s in per_key_scores[key]) / len(per_key_scores[key])
                    for m in ("precision", "recall", "fmeasure")
                }
            results[key].append(best)
    return results


def _rouge_score_compute(sentence_results: Dict[str, List[Tensor]]) -> Dict[str, Tensor]:
    return {k: torch.mean(torch.stack(v)) for k, v in sentence_results.items() if v}


def _stemmer(use_stemmer: bool):
    """nltk's Porter stemmer when ``use_stemmer``, else None; raises without nltk."""
    if use_stemmer and not _NLTK_AVAILABLE:
        raise ModuleNotFoundError("Stemming requires that `nltk` is installed.")
    if not use_stemmer:
        return None
    import nltk

    return nltk.stem.porter.PorterStemmer()


def rouge_score(
    preds: Union[str, Sequence[str]],
    targets: Union[str, Sequence[str], Sequence[Sequence[str]]],
    use_stemmer: bool = False,
    accumulate: str = "best",
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device: DeviceLike = None,
) -> Dict[str, Tensor]:
    """ROUGE-N / ROUGE-L / ROUGE-Lsum with precision/recall/fmeasure per key,
    on ``device`` (default ``cuda``)."""
    stemmer = _stemmer(use_stemmer)
    dev = resolve_device(device)

    if isinstance(rouge_keys, str):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {ALLOWED_ROUGE_KEYS}")
    rouge_keys_values = [int(key[5:]) if key[5:].isdigit() else key[5:] for key in rouge_keys]

    preds_ = [preds] if isinstance(preds, str) else list(preds)
    targets_ = [targets] if isinstance(targets, str) else list(targets)
    sentence_results = _rouge_score_update(preds_, targets_, rouge_keys_values, accumulate, stemmer)

    output: Dict[str, List[Tensor]] = {
        f"rouge{k}_{m}": [] for k in rouge_keys_values for m in ("precision", "recall", "fmeasure")
    }
    for key, scores in sentence_results.items():
        for m in ("precision", "recall", "fmeasure"):
            if scores:
                output[f"rouge{key}_{m}"].append(_f32([s[m] for s in scores], dev))
    return _rouge_score_compute(output)
