"""BERTScore module metric (port of ``metrics_tpu/text/bert.py``).

``update`` tokenizes on the host and appends the token ids and masks to
``cat`` list states on the metric's device; ``compute`` pads every chunk to
the widest length bucket and runs the functional path's encoder and
matching (``functional/text/bert.py``).
"""
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.functional.text.bert import (
    _apply_baseline,
    _load_baseline_row,
    _resolve_baseline_path,
    _resolve_forward,
    _score_tokenized,
    _simple_whitespace_tokenizer,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


def _derive_length_buckets(max_length: int) -> Tuple[int, ...]:
    """Power-of-two token-length bucket edges up to (and including) max_length."""
    edges = []
    b = 8
    while b < max_length:
        edges.append(b)
        b *= 2
    edges.append(max_length)
    return tuple(edges)


def _bucket_pad_tokens(enc: Dict[str, np.ndarray], buckets: Sequence[int]) -> Dict[str, np.ndarray]:
    """Pad the token-length dim up to the smallest bucket edge >= L.

    Score-invariant (the masks exclude pad positions), and it bounds the set
    of sequence lengths the encoder ever sees to ``len(buckets)``."""
    ids = np.asarray(enc["input_ids"])
    mask = np.asarray(enc["attention_mask"])
    length = ids.shape[1]
    target = next((b for b in buckets if b >= length), length)
    if target > length:
        pad = ((0, 0), (0, target - length))
        ids = np.pad(ids, pad)
        mask = np.pad(mask, pad)
    return {"input_ids": ids, "attention_mask": mask}


def _x64_off(arr: np.ndarray) -> np.ndarray:
    """``arr`` in the dtype ``jnp.asarray`` gives it with x64 off (64-bit ints
    and floats narrow to 32 bits), so the states match JAX's."""
    narrow = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32, np.dtype(np.float64): np.float32}
    arr = np.asarray(arr)
    return np.ascontiguousarray(arr.astype(narrow.get(arr.dtype, arr.dtype), copy=False))


def _cat_padded(chunks: List[Tensor], length: int) -> np.ndarray:
    """Concatenate (N_i, L_i) token chunks after right-padding each to ``length``."""
    out = []
    for c in chunks:
        c = c.cpu().numpy() if isinstance(c, Tensor) else np.asarray(c)
        if c.shape[1] < length:
            c = np.pad(c, ((0, 0), (0, length - c.shape[1])))
        out.append(c)
    return np.concatenate(out, axis=0)


class BERTScore(Metric):
    """BERTScore: greedy cosine matching of contextual embeddings (P/R/F1 per pair).

    The encoder is the caller's (``user_forward_fn``, ``model``, or a local
    HF torch checkpoint, see :func:`~metrics_tpu_torch.functional.bert_score`);
    it runs on the metric's device, or on a resident ``ModelHost`` with
    ``model_host=`` (``True``, a ``ModelHostConfig`` or a host). ``mesh=``
    runs the compute-time encoder forward batch-parallel over the mesh's
    ``mesh_axis`` (``parallel.embedded.shard_batch_forward``), and a host
    built here serves on that mesh.
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Any] = None,
        user_tokenizer: Optional[Any] = None,
        user_forward_fn: Optional[Callable] = None,
        verbose: bool = False,
        idf: bool = False,
        max_length: int = 128,
        batch_size: int = 64,
        num_threads: int = 4,
        return_hash: bool = False,
        lang: str = "en",
        rescale_with_baseline: bool = False,
        baseline_path: Optional[str] = None,
        baseline_url: Optional[str] = None,
        mesh: Optional[Any] = None,
        mesh_axis: Any = "dp",
        model_host: Optional[Any] = None,
        length_buckets: Optional[Sequence[int]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        self.max_length = max_length
        self.batch_size = batch_size
        self.idf = idf
        self.user_tokenizer = user_tokenizer
        self.rescale_with_baseline = rescale_with_baseline
        # every _tokenize() pads to a bucket edge, never the per-call batch max
        self.length_buckets = (
            tuple(sorted(length_buckets)) if length_buckets is not None
            else _derive_length_buckets(max_length)
        )
        # a bad baseline config fails here, and compute() does no file IO
        path = _resolve_baseline_path(rescale_with_baseline, baseline_path, baseline_url)
        self.baseline = _load_baseline_row(path, num_layers) if path is not None else None
        # a missing encoder fails at construction
        self.forward_fn = _resolve_forward(user_forward_fn, model, model_name_or_path, self.device, mesh, mesh_axis)

        # model_host: serve the encoder from a resident ModelHost (bucketed,
        # coalesced, one captured forward a bucket on the card; shared by
        # metrics over the same encoder) -- engine/model_host.py
        self.model_host = None
        if model_host is not None and model_host is not False:
            from metrics_tpu_torch.engine.model_host import ModelHost, ModelHostConfig, encoder_host

            if isinstance(model_host, ModelHost):
                host = model_host
            else:
                config = model_host if isinstance(model_host, ModelHostConfig) else ModelHostConfig(
                    mesh=mesh, mesh_axis=mesh_axis)
                host = encoder_host(forward_fn=self.forward_fn, config=config, device=self.device)
            self.model_host = host

            def _host_forward(ids: Tensor, mask: Tensor) -> Tensor:
                return host.infer(ids, mask)

            self.forward_fn = _host_forward

        self.add_state("preds_input_ids", [], dist_reduce_fx="cat")
        self.add_state("preds_attention_mask", [], dist_reduce_fx="cat")
        self.add_state("target_input_ids", [], dist_reduce_fx="cat")
        self.add_state("target_attention_mask", [], dist_reduce_fx="cat")

    def _tokenize(self, sentences: List[str]) -> Dict[str, np.ndarray]:
        if self.user_tokenizer is not None:
            enc = self.user_tokenizer(sentences, self.max_length)
        else:
            enc = _simple_whitespace_tokenizer(sentences, self.max_length)
        return _bucket_pad_tokens(enc, self.length_buckets)

    def update(self, predictions: List[str], references: List[str]) -> None:
        enc_pred = self._tokenize(predictions)
        enc_tgt = self._tokenize(references)
        for name, enc in (("preds", enc_pred), ("target", enc_tgt)):
            for field in ("input_ids", "attention_mask"):
                getattr(self, f"{name}_{field}").append(torch.from_numpy(_x64_off(enc[field])).to(self.device))

    def compute(self) -> Dict[str, List[float]]:
        # updates may have landed on different length buckets: pad every chunk
        # to the widest, so the whole compute runs at one sequence length
        length = max(int(c.shape[1]) for c in self.preds_input_ids + self.target_input_ids)
        precision, recall, f1 = _score_tokenized(
            self.forward_fn,
            _cat_padded(self.preds_input_ids, length),
            _cat_padded(self.preds_attention_mask, length),
            _cat_padded(self.target_input_ids, length),
            _cat_padded(self.target_attention_mask, length),
            idf=self.idf,
            batch_size=self.batch_size,
            device=self.device,
            # the whitespace tokenizer adds no [CLS]/[SEP] to strip
            strip_special=self.user_tokenizer is not None,
        )
        if self.rescale_with_baseline:
            precision, recall, f1 = _apply_baseline(precision, recall, f1, self.baseline)
        return {
            "precision": [float(x) for x in precision],
            "recall": [float(x) for x in recall],
            "f1": [float(x) for x in f1],
        }
