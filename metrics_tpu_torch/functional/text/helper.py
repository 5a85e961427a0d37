"""Text helpers: edit distance through the port's native library, n-gram
counting and corpus canonicalisation (port of
``metrics_tpu/functional/text/helper.py``).

The edit distances run in ``metrics_tpu_torch/native/levenshtein.cpp``,
compiled with the host's C++ compiler at first use into ``build/kernels/``
(:func:`metrics_tpu_torch.ops.kernels.build.build_host_library`) and loaded
with ctypes. WER, CER and MER take the plain DP distance; TER scores its
shift candidates with tercom's beam-limited one. A failed build or load
raises ``RuntimeError`` with the compiler's output: nothing falls back to
Python. :func:`_edit_distance_py` and :func:`_edit_distance_beam_py` are the
library's plain versions, which the tests hold it against.
"""
import ctypes
import math
import threading
from collections import Counter
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.ops.kernels import build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "levenshtein.cpp"

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "edit_distance_i32": ((_I32P, ctypes.c_int64, _I32P, ctypes.c_int64), ctypes.c_int64),
    "edit_distance_beam_i32": ((_I32P, ctypes.c_int64, _I32P, ctypes.c_int64, ctypes.c_int64), ctypes.c_int64),
    "edit_distance_batch_i32": ((_I32P, _I64P, _I32P, _I64P, ctypes.c_int64, _I64P), None),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None


def native_library() -> ctypes.CDLL:
    """The loaded edit-distance library, built from :data:`SOURCE` on first use."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            path = build.build_host_library(SOURCE)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"edit-distance library {path} did not load: {e}") from e
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib, _lib_path = lib, path
        return _lib


def native_library_path() -> Path:
    """The file :func:`native_library` loaded (building it if needed)."""
    native_library()
    return _lib_path


def _ptr(arr: np.ndarray, ptr_type: type) -> "ctypes._Pointer":
    return arr.ctypes.data_as(ptr_type)


def _tokens_to_ids(seqs_a: Sequence[Sequence], seqs_b: Sequence[Sequence]) -> Tuple[np.ndarray, ...]:
    """Map arbitrary hashable tokens to int32 ids (one vocabulary per call),
    packed as ``(a_data, a_off, b_data, b_off)`` with int64 offsets."""
    vocab: dict = {}

    def _ids(seq):
        out = np.empty(len(seq), dtype=np.int32)
        for i, tok in enumerate(seq):
            out[i] = vocab.setdefault(tok, len(vocab))
        return out

    a_list = [_ids(s) for s in seqs_a]
    b_list = [_ids(s) for s in seqs_b]
    a_off = np.zeros(len(a_list) + 1, dtype=np.int64)
    b_off = np.zeros(len(b_list) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in a_list], out=a_off[1:])
    np.cumsum([len(x) for x in b_list], out=b_off[1:])
    a_data = np.concatenate(a_list) if a_list else np.zeros(0, dtype=np.int32)
    b_data = np.concatenate(b_list) if b_list else np.zeros(0, dtype=np.int32)
    return a_data.astype(np.int32), a_off, b_data.astype(np.int32), b_off


def _edit_distance_py(prediction_tokens: List, reference_tokens: List) -> int:
    """Plain DP edit distance: the library's ``edit_distance_i32`` in Python."""
    n, m = len(prediction_tokens), len(reference_tokens)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        a = prediction_tokens[i - 1]
        for j in range(1, m + 1):
            cur[j] = min(prev[j - 1] + (a != reference_tokens[j - 1]), prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return prev[m]


def _edit_distance_beam_py(a: List, b: List, beam_width: int) -> int:
    """Plain beam-limited DP: the library's ``edit_distance_beam_i32`` in
    Python (asymmetric: the beam follows the hypothesis ``a``)."""
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    ratio = m / n
    beam = math.ceil(ratio / 2 + beam_width) if beam_width < ratio / 2 else beam_width
    INF = 1 << 40
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [INF] * (m + 1)
        diag = math.floor(i * ratio)
        lo = max(0, diag - beam)
        hi = m + 1 if i == n else min(m + 1, diag + beam)
        ai = a[i - 1]
        for j in range(lo, hi):
            if j == 0:
                cur[0] = prev[0] + 1
                continue
            cur[j] = min(prev[j - 1] + (ai != b[j - 1]), prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return prev[m]


def _edit_distance(prediction_tokens: List, reference_tokens: List) -> int:
    """Edit distance between two token sequences."""
    lib = native_library()
    a_data, _, b_data, _ = _tokens_to_ids([prediction_tokens], [reference_tokens])
    return int(lib.edit_distance_i32(_ptr(a_data, _I32P), len(a_data), _ptr(b_data, _I32P), len(b_data)))


def _edit_distance_ids(a_ids: np.ndarray, b_ids: np.ndarray, beam: Optional[int] = None) -> int:
    """Edit distance on id arrays (TER's shift search scores many candidates
    against one reference this way); ``beam`` takes tercom's beam-limited
    variant, with ``a_ids`` the hypothesis."""
    lib = native_library()
    a = np.ascontiguousarray(a_ids, dtype=np.int32)
    b = np.ascontiguousarray(b_ids, dtype=np.int32)
    if beam is None:
        return int(lib.edit_distance_i32(_ptr(a, _I32P), len(a), _ptr(b, _I32P), len(b)))
    return int(lib.edit_distance_beam_i32(_ptr(a, _I32P), len(a), _ptr(b, _I32P), len(b), int(beam)))


def _edit_distance_batch(preds: Sequence[Sequence], refs: Sequence[Sequence]) -> np.ndarray:
    """int64 edit distances of the pairs ``zip(preds, refs)``, in one call."""
    n = min(len(preds), len(refs))
    lib = native_library()
    a_data, a_off, b_data, b_off = _tokens_to_ids(preds[:n], refs[:n])
    out = np.empty(n, dtype=np.int64)
    lib.edit_distance_batch_i32(_ptr(a_data, _I32P), _ptr(a_off, _I64P), _ptr(b_data, _I32P), _ptr(b_off, _I64P),
                                n, _ptr(out, _I64P))
    return out


def _f32(value, device: torch.device) -> torch.Tensor:
    """``value`` (a Python number or a numpy array) as float32 on ``device``,
    rounded once, as ``jnp.asarray`` rounds a host value into a JAX state."""
    return torch.tensor(np.asarray(value, dtype=np.float64), dtype=torch.float32, device=device)


def _ngram_counts(tokens: Sequence, n_gram: int) -> Counter:
    """Counter of all 1..n_gram grams."""
    counts: Counter = Counter()
    for n in range(1, n_gram + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i:i + n])] += 1
    return counts


def _resolve_corpus_aliases(fn_name, preds, targets, hypothesis_corpus, reference_corpus):
    """Accept the reference's keyword names (``hypothesis_corpus``/
    ``reference_corpus``) as aliases of ``preds``/``targets``; double
    specification raises like an ordinary duplicate keyword would."""
    if hypothesis_corpus is not None:
        if preds is not None:
            raise TypeError(f"{fn_name}() got multiple values for the hypothesis corpus (`preds` and `hypothesis_corpus`).")
        preds = hypothesis_corpus
    if reference_corpus is not None:
        if targets is not None:
            raise TypeError(f"{fn_name}() got multiple values for the reference corpus (`targets` and `reference_corpus`).")
        targets = reference_corpus
    if preds is None or targets is None:
        raise ValueError(f"{fn_name} requires both a hypothesis (`preds`) and a reference (`targets`) corpus.")
    return preds, targets


def _canonicalize_corpora(preds, targets):
    """Canonicalize to (hypotheses: List[str], references: List[List[str]]).

    A flat reference list with a SINGLE hypothesis means several references
    for that hypothesis; with many hypotheses it means one reference each.
    Corpora of different sizes raise, also where a reference group is empty
    (stricter than the reference's ``_validate_inputs``, which skips the
    check then). An empty reference set scores against the empty string.
    """
    hyps = [preds] if isinstance(preds, str) else list(preds)
    if isinstance(targets, str):
        refs = [[targets]]
    else:
        targets = list(targets)  # materialize once: a generator must not be consumed twice
        if all(isinstance(r, str) for r in targets):
            refs = [targets] if len(hyps) == 1 else [[r] for r in targets]
        else:
            refs = [[t] if isinstance(t, str) else list(t) for t in targets]
    if len(refs) != len(hyps):
        raise ValueError(f"Corpus has different size {len(refs)} != {len(hyps)}")
    refs = [r if r else [""] for r in refs]
    return hyps, refs
