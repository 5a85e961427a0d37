"""Translation edit rate (port of ``metrics_tpu/functional/text/ter.py``).

Tercom-style normalisation and a greedy shift search over the possible block
moves, each candidate scored by the beam-limited Levenshtein distance of the
port's native library (``metrics_tpu_torch/native/levenshtein.cpp``).
"""
import math
import re
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import (
    _canonicalize_corpora,
    _edit_distance_ids,
    _f32,
    _resolve_corpus_aliases,
)
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50


def _normalize_general_and_western(sentence: str) -> str:
    rules = (
        (r"\n-", ""),
        (r"\n", " "),
        (r"&quot;", '"'),
        (r"&amp;", "&"),
        (r"&lt;", "<"),
        (r"&gt;", ">"),
        (r"([{-~\[-` -&(-+:-@/])", r" \1 "),
        (r"'s ", " 's "),
        (r"'s$", " 's"),
        (r"([^0-9])([\.,])", r"\1 \2 "),
        (r"([\.,])([^0-9])", r" \1 \2"),
        (r"([0-9])(-)", r"\1 \2 "),
    )
    for pattern, replacement in rules:
        sentence = re.sub(pattern, replacement, sentence)
    return sentence


_ASIAN_PUNCTUATION = r"([\u3001\u3002\u3008-\u3011\u3014-\u301f\uff61-\uff65\u30fb])"
_FULL_WIDTH_PUNCTUATION = r"([\uff0e\uff0c\uff1f\uff1a\uff1b\uff01\uff02\uff08\uff09])"


def _normalize_asian(sentence: str) -> str:
    """Split CJK ideographs/kana down to character level (tercom asian mode)."""
    # CJK Unified Ideographs (+ext A), strokes/radicals, compatibility blocks
    sentence = re.sub(r"([\u4e00-\u9fff\u3400-\u4dbf])", r" \1 ", sentence)
    sentence = re.sub(r"([\u31c0-\u31ef\u2e80-\u2eff])", r" \1 ", sentence)
    sentence = re.sub(r"([\u3300-\u33ff\uf900-\ufaff\ufe30-\ufe4f])", r" \1 ", sentence)
    sentence = re.sub(r"([\u3200-\u3f22])", r" \1 ", sentence)
    # hiragana / katakana / katakana phonetic extensions, as runs
    sentence = re.sub(r"(^|^[\u3040-\u309f])([\u3040-\u309f]+)(?=$|^[\u3040-\u309f])", r"\1 \2 ", sentence)
    sentence = re.sub(r"(^|^[\u30a0-\u30ff])([\u30a0-\u30ff]+)(?=$|^[\u30a0-\u30ff])", r"\1 \2 ", sentence)
    sentence = re.sub(r"(^|^[\u31f0-\u31ff])([\u31f0-\u31ff]+)(?=$|^[\u31f0-\u31ff])", r"\1 \2 ", sentence)
    sentence = re.sub(_ASIAN_PUNCTUATION, r" \1 ", sentence)
    sentence = re.sub(_FULL_WIDTH_PUNCTUATION, r" \1 ", sentence)
    return sentence


def _remove_punct(sentence: str) -> str:
    # tercom removes only this specific set — NOT all of string.punctuation
    # (hyphens/apostrophes stay; sacrebleu tokenizer_ter._remove_punct)
    return re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)


def _remove_asian_punct(sentence: str) -> str:
    sentence = re.sub(_ASIAN_PUNCTUATION, "", sentence)
    sentence = re.sub(_FULL_WIDTH_PUNCTUATION, "", sentence)
    return sentence


def _preprocess_sentence(
    sentence: str, lowercase: bool, normalize: bool, no_punctuation: bool, asian_support: bool = False
) -> List[str]:
    sentence = sentence.rstrip()
    if lowercase:
        sentence = sentence.lower()
    if normalize:
        sentence = _normalize_general_and_western(sentence)
        if asian_support:
            sentence = _normalize_asian(sentence)
    if no_punctuation:
        sentence = _remove_punct(sentence)
        if asian_support:
            sentence = _remove_asian_punct(sentence)
    return sentence.split()


_MAX_SHIFT_CANDIDATES = 1000
_BEAM_WIDTH = 25


def _align_hyp_to_ref(hyp: List[str], ref: List[str]):
    """Beam-limited Levenshtein DP with an op trace, using tercom's
    tie-preference (match/substitute, then consume-hypothesis, then
    consume-reference). Returns ``(alignment, hyp_errors, ref_errors)`` where
    ``alignment[ref_pos] = hyp_pos`` for every reference position (the position
    a deleted reference word maps to is the last consumed hypothesis index) and
    the error lists flag non-match positions. Tercom's shift destinations are
    defined in terms of this alignment (reference ``ter.py:343-375`` /
    ``helper.py:398-446``); the beam matches tercom's pruning for very long
    sentences (``helper.py:131-137``)."""
    H, R = len(hyp), len(ref)
    INF = 1 << 30
    # rolling cost rows + one op byte-row per i: the beam visits only a narrow
    # band per row, so a full (H+1)x(R+1) tuple table would waste quadratic
    # memory on exactly the long sentences the beam exists for.
    # op codes: '=' match / 'S' substitute (both advance both), 'H' consume
    # hypothesis word only, 'R' consume reference word only
    prev = list(range(R + 1))
    op_rows = [bytearray(b"R" * (R + 1))]
    op_rows[0][0] = ord(" ")
    ratio = R / H if H else 1.0
    beam = math.ceil(ratio / 2 + _BEAM_WIDTH) if _BEAM_WIDTH < ratio / 2 else _BEAM_WIDTH
    for i in range(1, H + 1):
        cur = [INF] * (R + 1)
        ops_row = bytearray(b" " * (R + 1))
        diag = math.floor(i * ratio)
        lo = max(0, diag - beam)
        hi = R + 1 if i == H else min(R + 1, diag + beam)
        for j in range(lo, hi):
            if j == 0:
                cur[0] = prev[0] + 1
                ops_row[0] = ord("H")
                continue
            if hyp[i - 1] == ref[j - 1]:
                cost, op = prev[j - 1], ord("=")
            else:
                cost, op = prev[j - 1] + 1, ord("S")
            if prev[j] + 1 < cost:
                cost, op = prev[j] + 1, ord("H")
            if cur[j - 1] + 1 < cost:
                cost, op = cur[j - 1] + 1, ord("R")
            cur[j] = cost
            ops_row[j] = op
        prev = cur
        op_rows.append(ops_row)
    ops: List[str] = []
    i, j = H, R
    while i > 0 or j > 0:
        op = chr(op_rows[i][j])
        ops.append(op)
        if op in ("=", "S"):
            i, j = i - 1, j - 1
        elif op == "H":
            i -= 1
        else:
            j -= 1
    ops.reverse()
    alignment = {}
    hyp_errors: List[int] = []
    ref_errors: List[int] = []
    hp = rp = -1
    for op in ops:
        if op in ("=", "S"):
            hp += 1
            rp += 1
            alignment[rp] = hp
            err = 0 if op == "=" else 1
            hyp_errors.append(err)
            ref_errors.append(err)
        elif op == "H":
            hp += 1
            hyp_errors.append(1)
        else:  # R: reference word with no hypothesis counterpart
            rp += 1
            alignment[rp] = hp
            ref_errors.append(1)
    return alignment, hyp_errors, ref_errors


def _apply_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    """Move ``words[start:start+length]`` so it lands at ``target`` using
    tercom's three placement cases (before / after / within the moved region —
    reference ``ter.py:285-320``)."""
    block = words[start:start + length]
    if target < start:
        return words[:target] + block + words[target:start] + words[start + length:]
    if target > start + length:
        return words[:start] + words[start + length:target] + block + words[target:]
    return words[:start] + words[start + length:length + target] + block + words[length + target:]


def _ter_sentence(pred_words: List[str], ref_words: List[str]) -> float:
    """Shifts + edits for one hypothesis against one reference (tercom
    semantics — reference ``ter.py:323-446``, itself following sacrebleu's
    lib_ter). Candidate blocks are equal word spans (length 1..10, start
    offset ≤ 50) where both sides contain an error and the block is not
    already aligned in place; destinations come from the current alignment;
    candidates rank by (edit gain, block length, earliest start, earliest
    target); the search stops after 1000 candidates or when no shift helps."""
    if len(ref_words) == 0:
        # an empty reference costs one deletion per hypothesis word — the
        # reference reaches the same number because its 0-edit shortcut
        # (``ter.py:419-420``) keys on the empty HYPOTHESIS (its caller swaps
        # arguments at ``ter.py:469``); sacrebleu agrees. Returning 0 here
        # would let an empty string in a multi-reference group win best-of-min
        # and silently score the pair perfect.
        return float(len(pred_words))

    # map words to int ids once — the shift loop scores up to 1000 candidate
    # sequences per round, so per-candidate token hashing would dominate
    vocab: dict = {}
    current: List[int] = [vocab.setdefault(w, len(vocab)) for w in pred_words]
    ref_words = [vocab.setdefault(w, len(vocab)) for w in ref_words]
    ref_arr = np.asarray(ref_words, dtype=np.int32)

    def _dist(words: List[int]) -> int:
        # the beamed distance is what tercom/sacrebleu score with — parity
        # over exactness (the beam binds only on far-offset degenerate pairs)
        return _edit_distance_ids(np.asarray(words, dtype=np.int32), ref_arr, beam=_BEAM_WIDTH)

    num_shifts = 0
    checked = 0

    while True:
        base_dist = _dist(current)
        alignment, hyp_errors, ref_errors = _align_hyp_to_ref(current, ref_words)
        best = None  # (gain, length, -hyp_start, -target, shifted_words)
        stop = False
        for hyp_start in range(len(current)):
            if stop:
                break
            for ref_start in range(len(ref_words)):
                if abs(ref_start - hyp_start) > _MAX_SHIFT_DIST:
                    continue
                for length in range(1, _MAX_SHIFT_SIZE + 1):  # sacrebleu allows 10-word blocks
                    if (hyp_start + length > len(current) or ref_start + length > len(ref_words)
                            or current[hyp_start + length - 1] != ref_words[ref_start + length - 1]):
                        break
                    # corner cases (reference ``ter.py:245-283``): the block must
                    # contain an error on both sides and not already sit where
                    # the alignment puts it
                    if (sum(hyp_errors[hyp_start:hyp_start + length]) != 0
                            and sum(ref_errors[ref_start:ref_start + length]) != 0
                            and not (hyp_start <= alignment[ref_start] < hyp_start + length)):
                        prev_target = -1
                        for offset in range(-1, length):
                            if ref_start + offset == -1:
                                target = 0
                            elif ref_start + offset in alignment:
                                target = alignment[ref_start + offset] + 1
                            else:
                                break  # past the end of the reference
                            if target == prev_target:
                                continue
                            prev_target = target
                            shifted = _apply_shift(current, hyp_start, length, target)
                            candidate = (
                                base_dist - _dist(shifted),  # biggest gain
                                length,                                          # longest block
                                -hyp_start,                                      # earliest start
                                -target,                                         # earliest target
                                shifted,
                            )
                            checked += 1
                            if best is None or candidate > best:
                                best = candidate
                    if checked >= _MAX_SHIFT_CANDIDATES:
                        stop = True
                        break
                    if hyp_start + length == len(current) or ref_start + length == len(ref_words):
                        break
                if stop:
                    break
        if best is None or checked >= _MAX_SHIFT_CANDIDATES or best[0] <= 0:
            break
        num_shifts += 1
        current = best[4]

    # every break path leaves `current` unchanged since base_dist was computed
    return float(num_shifts + base_dist)


def _ter_update(
    preds: Sequence[str],
    targets: Sequence[Sequence[str]],
    total_num_edits: Tensor,
    total_ref_len: Tensor,
    lowercase: bool = True,
    normalize: bool = False,
    no_punctuation: bool = False,
    sentence_scores: Optional[List[float]] = None,
    asian_support: bool = False,
) -> Tuple[Tensor, Tensor]:
    edits_sum = 0.0
    ref_len_sum = 0.0
    for pred, refs in zip(preds, targets):
        pred_words = _preprocess_sentence(pred, lowercase, normalize, no_punctuation, asian_support)
        # multi-reference (reference ``ter.py:448-475``): the BEST (lowest) edit
        # count over all references, normalized by the AVERAGE reference length
        best_edits = None
        ref_len_total = 0.0
        for ref in refs:
            ref_words = _preprocess_sentence(ref, lowercase, normalize, no_punctuation, asian_support)
            edits = _ter_sentence(pred_words, ref_words)
            ref_len_total += len(ref_words)
            if best_edits is None or edits < best_edits:
                best_edits = edits
        avg_ref_len = ref_len_total / len(refs)
        edits_sum += best_edits
        ref_len_sum += avg_ref_len
        if sentence_scores is not None:
            # reference ``ter.py:488-495`` zero-length rule
            if avg_ref_len > 0 and best_edits > 0:
                s = best_edits / avg_ref_len
            elif avg_ref_len == 0 and best_edits > 0:
                s = 1.0
            else:
                s = 0.0
            sentence_scores.append(s)
    dev = total_num_edits.device
    return total_num_edits + _f32(edits_sum, dev), total_ref_len + _f32(ref_len_sum, dev)


def _ter_compute(total_num_edits: Tensor, total_ref_len: Tensor) -> Tensor:
    # reference ``ter.py:488-495``: zero reference length scores 1 when edits
    # remain, 0 when the hypothesis is empty too
    one, zero = torch.ones_like(total_num_edits), torch.zeros_like(total_num_edits)
    return torch.where(
        total_ref_len > 0,
        total_num_edits / torch.clamp(total_ref_len, min=1e-38),
        torch.where(total_num_edits > 0, one, zero),
    )


def translation_edit_rate(
    preds: Union[str, Sequence[str], None] = None,
    targets: Union[str, Sequence[str], Sequence[Sequence[str]], None] = None,
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    *,
    hypothesis_corpus: Union[str, Sequence[str], None] = None,
    reference_corpus: Union[str, Sequence[str], Sequence[Sequence[str]], None] = None,
    device: DeviceLike = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus TER = (shifts + edits) / reference length, on ``device`` (default
    ``cuda``). The reference's keyword names ``hypothesis_corpus``/``reference_corpus``
    are aliases of ``preds``/``targets`` (same positional order), and
    multi-reference corpora follow the reference's ``_validate_inputs`` shapes."""
    preds, targets = _resolve_corpus_aliases("translation_edit_rate", preds, targets, hypothesis_corpus, reference_corpus)
    preds_, targets_ = _canonicalize_corpora(preds, targets)

    dev = resolve_device(device)
    total_num_edits = torch.zeros((), dtype=torch.float32, device=dev)
    total_ref_len = torch.zeros((), dtype=torch.float32, device=dev)
    sentence_scores: Optional[List[float]] = [] if return_sentence_level_score else None
    total_num_edits, total_ref_len = _ter_update(
        preds_, targets_, total_num_edits, total_ref_len, lowercase, normalize, no_punctuation, sentence_scores,
        asian_support,
    )
    score = _ter_compute(total_num_edits, total_ref_len)
    if return_sentence_level_score:
        return score, _f32(sentence_scores, dev)
    return score
