"""BERTScore: contextual-embedding similarity with greedy matching (port of
``metrics_tpu/functional/text/bert.py``).

The encoder is the caller's: ``user_forward_fn(input_ids, attention_mask)
-> (N, L, D)``, a ``model`` (an ``nn.Module`` or any callable on ``(ids,
mask)``, or a HF torch model), or ``model_name_or_path``, a LOCAL HF torch
checkpoint loaded through ``transformers.AutoModel`` (no weight is ever
downloaded). It runs eagerly under ``torch.inference_mode()`` with ids and
mask on the metric's device, ``encoder batch`` rows at a time. The matching
is one batched cosine ``bmm`` per corpus, the ``-inf`` masking and a max on
each axis, then the weighted means and F1: plain tensor ops on that device.

:func:`bert_state_dict_from_flax` carries the JAX package's Flax BERT
checkpoint (its parameter tree as numpy arrays) into HF torch ``BertModel``
key names and layouts, so the same weights score the same text in both.

``mesh=`` runs the encoder batch-parallel over the mesh's ``mesh_axis``
(``parallel.embedded.shard_batch_forward``, the embeddings gathered onto the
first shard's device): ids and mask are split over the shards, and a
``model`` (or a loaded checkpoint) has one replica a device of the mesh; a
``user_forward_fn`` is called on each shard's block on that shard's device.
"""
import os
import sys
import zlib
from collections import Counter, OrderedDict
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.utils.device import DeviceLike, resolve_device
from metrics_tpu_torch.utils.imports import _TRANSFORMERS_AVAILABLE

Tensor = torch.Tensor

# loaded-from-path HF models, by (path, device): bounded, so a checkpoint
# sweep does not pin every model in memory
_LOADED_MODEL_CACHE_MAX = 4
_LOADED_MODEL_CACHE: "OrderedDict[Tuple[str, str], Any]" = OrderedDict()


def _simple_whitespace_tokenizer(sentences: List[str], max_length: int) -> Dict[str, np.ndarray]:
    """Whitespace tokens hashed into int32 ids by crc32 (no vocabulary file),
    bit-identical to the JAX package's: crc32, not the builtin ``hash``,
    whose salt differs per process."""
    ids = np.zeros((len(sentences), max_length), dtype=np.int32)
    mask = np.zeros((len(sentences), max_length), dtype=np.int32)
    for i, s in enumerate(sentences):
        toks = s.split()[:max_length]
        for j, t in enumerate(toks):
            ids[i, j] = (zlib.crc32(t.encode("utf-8")) % 30000) + 1
        mask[i, : len(toks)] = 1
    return {"input_ids": ids, "attention_mask": mask}


def _strip_special_positions(mask: np.ndarray) -> np.ndarray:
    """Zero the [CLS] (first) and [SEP] (last real) positions of each row.

    The matching and the idf weights exclude the special tokens; the encoder
    still attends to them. The last real position comes from the reference's
    ``cumsum(mask - 0.1).argmax`` (an all-pad row resolves to position 0,
    already zeroed)."""
    out = np.asarray(mask).copy()
    if out.shape[1] == 0:
        return out
    last = np.cumsum(out - 0.1, axis=-1).argmax(-1)
    out[np.arange(out.shape[0]), last] = 0
    out[:, 0] = 0
    return out


def _get_tokens_idf(target_ids: np.ndarray, target_mask: np.ndarray) -> Dict[int, float]:
    """Natural-log IDF over the reference corpus."""
    num_docs = target_ids.shape[0]
    doc_freq: Counter = Counter()
    for row, m in zip(target_ids, target_mask):
        doc_freq.update(set(int(t) for t, mm in zip(row, m) if mm))
    return {tok: float(np.log((num_docs + 1) / (df + 1))) for tok, df in doc_freq.items()}


def _idf_weights(ids: np.ndarray, mask: np.ndarray, idf_map: Dict[int, float]) -> np.ndarray:
    """float32 idf weight of each unmasked position; ``log(2)`` for a token
    the references never had."""
    w = np.zeros(ids.shape, dtype=np.float32)
    for i in range(ids.shape[0]):
        for j in range(ids.shape[1]):
            if mask[i, j]:
                w[i, j] = idf_map.get(int(ids[i, j]), float(np.log((1 + 1) / 1)))
    return w


def _bert_score_from_embeddings(
    pred_emb: Tensor,
    pred_mask: Tensor,
    target_emb: Tensor,
    target_mask: Tensor,
    pred_weights: Optional[Tensor] = None,
    target_weights: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Greedy-matching P/R/F1 per sentence pair."""
    pred_norm = pred_emb / torch.clamp(torch.linalg.vector_norm(pred_emb, dim=-1, keepdim=True), min=1e-12)
    target_norm = target_emb / torch.clamp(torch.linalg.vector_norm(target_emb, dim=-1, keepdim=True), min=1e-12)
    sim = torch.bmm(pred_norm, target_norm.transpose(1, 2))  # (N, L_pred, L_tgt)
    pair_mask = pred_mask[:, :, None] * target_mask[:, None, :]
    sim = torch.where(pair_mask > 0, sim, torch.full((), -torch.inf, dtype=sim.dtype, device=sim.device))

    zero = torch.zeros((), dtype=sim.dtype, device=sim.device)
    best_for_pred = torch.where(pred_mask > 0, sim.amax(dim=2), zero)  # (N, L_pred)
    best_for_target = torch.where(target_mask > 0, sim.amax(dim=1), zero)  # (N, L_tgt)

    pw = pred_weights if pred_weights is not None else pred_mask.to(best_for_pred.dtype)
    tw = target_weights if target_weights is not None else target_mask.to(best_for_target.dtype)
    pw = pw * (pred_mask > 0)
    tw = tw * (target_mask > 0)

    precision = torch.sum(best_for_pred * pw, dim=1) / torch.clamp(torch.sum(pw, dim=1), min=1e-12)
    recall = torch.sum(best_for_target * tw, dim=1) / torch.clamp(torch.sum(tw, dim=1), min=1e-12)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return precision, recall, f1


def _score_embeddings(
    emb_batches: List[Tensor],
    inverse: Tensor,
    pred_mask: Tensor,
    target_mask: Tensor,
    pred_weights: Optional[Tensor],
    target_weights: Optional[Tensor],
) -> Tensor:
    """Gather, split and match in one function, returning ``(3, N)``.

    ``inverse`` maps each pred row, then each reference row, to its
    embedding row: an identity for a corpus encoded row by row, or the dedup
    map when distinct rows were encoded once."""
    emb_u = torch.cat(emb_batches, dim=0) if len(emb_batches) > 1 else emb_batches[0]
    all_emb = emb_u[inverse]
    n_pred = pred_mask.shape[0]
    p, r, f1 = _bert_score_from_embeddings(
        all_emb[:n_pred], pred_mask, all_emb[n_pred:], target_mask, pred_weights, target_weights
    )
    return torch.stack([p, r, f1])


def _is_hf_torch_model(model: Any) -> bool:
    """True only for HF torch models (``PreTrainedModel``), which take
    keyword inputs and return ``last_hidden_state``; anything else keeps
    its documented ``model(ids, mask)`` call. Such a model exists only once
    ``transformers`` is imported, so this never imports it (an import that
    can take many seconds)."""
    transformers = sys.modules.get("transformers")
    return transformers is not None and isinstance(model, transformers.PreTrainedModel)


def _hf_forward(hf_model: Any) -> Callable[[Tensor, Tensor], Tensor]:
    def forward(ids: Tensor, mask: Tensor) -> Tensor:
        return hf_model(input_ids=ids.long(), attention_mask=mask).last_hidden_state

    return forward


def _module_forward(model: Any) -> Callable[[Tensor, Tensor], Tensor]:
    """A ``model``'s encoder call: a HF torch model's keyword form, else the
    documented ``model(ids, mask)``."""
    return _hf_forward(model) if _is_hf_torch_model(model) else (lambda ids, mask: model(ids, mask))


def _sharded_encoder(fn: Callable, module: Any, mesh: Any, mesh_axis: Any) -> Callable[[Any, Any], Tensor]:
    """``fn`` batch-parallel over ``mesh`` (``shard_batch_forward`` with
    ``out_axis=None``: the embeddings gathered onto the first shard's device).
    A ``torch.nn.Module`` encoder is a replicated argument, placed once: one
    replica a device of the mesh (its own device keeps the original); any
    other callable runs on each shard's block as it is."""
    from metrics_tpu_torch.parallel.embedded import shard_batch_forward

    def shard(replica: Any, ids: Tensor, mask: Tensor) -> Tensor:
        with torch.inference_mode():
            out = (fn if replica is None else _module_forward(replica))(ids, mask)
        return out if isinstance(out, Tensor) else torch.from_numpy(np.asarray(out)).to(ids.device)

    sharded = shard_batch_forward(shard, mesh, mesh_axis, out_axis=None, replicated_argnums=(0,))
    placed = sharded.place(module if isinstance(module, torch.nn.Module) else None)
    return lambda ids, mask: sharded(placed, ids, mask)


def _load_local_model(model_name_or_path: str, device: torch.device) -> Any:
    """A local HF torch checkpoint through ``transformers.AutoModel``, in
    eval mode on ``device``; cached by (path, device), at most four."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`model_name_or_path` loads a HF checkpoint through `transformers`, which is not installed;"
            " pass `model` or `user_forward_fn` instead."
        )
    key = (model_name_or_path, str(device))
    hit = _LOADED_MODEL_CACHE.get(key)
    if hit is None:
        from transformers import AutoModel

        hit = AutoModel.from_pretrained(model_name_or_path).eval().to(device)
        _LOADED_MODEL_CACHE[key] = hit
    _LOADED_MODEL_CACHE.move_to_end(key)
    while len(_LOADED_MODEL_CACHE) > _LOADED_MODEL_CACHE_MAX:
        _LOADED_MODEL_CACHE.popitem(last=False)
    return hit


def _resolve_forward(
    user_forward_fn: Optional[Callable],
    model: Optional[Any],
    model_name_or_path: Optional[str],
    device: torch.device,
    mesh: Optional[Any] = None,
    mesh_axis: Any = "dp",
) -> Callable[[Tensor, Tensor], Tensor]:
    """The encoder ``(ids, mask) -> (N, L, D)`` tensor on ``device``, in the
    order ``user_forward_fn``, ``model``, ``model_name_or_path``. It runs
    under ``torch.inference_mode()``; an output that is not a tensor (a
    numpy array) becomes one on ``device``. With ``mesh`` it runs
    batch-parallel over the mesh's axis (:func:`_sharded_encoder`). Shared by
    the functional and the module."""
    module = None
    if user_forward_fn is not None:
        fn = user_forward_fn
    elif model is not None:
        module = model
    elif model_name_or_path is not None:
        module = _load_local_model(model_name_or_path, device)
    else:
        raise ValueError(
            "BERTScore needs an encoder: pass `user_forward_fn`, `model`, or a local `model_name_or_path`"
            " (this build cannot download pretrained weights)."
        )
    if module is not None:
        fn = _module_forward(module)
    if mesh is not None:
        fn = _sharded_encoder(fn, module, mesh, mesh_axis)

    def forward(ids: Tensor, mask: Tensor) -> Tensor:
        with torch.inference_mode():
            out = fn(ids, mask)
        if not isinstance(out, Tensor):
            out = torch.from_numpy(np.asarray(out))
        return out.to(device)

    return forward


def _score_tokenized(
    forward: Callable[[Tensor, Tensor], Tensor],
    pred_ids: np.ndarray,
    pred_mask: np.ndarray,
    tgt_ids: np.ndarray,
    tgt_mask: np.ndarray,
    idf: bool,
    batch_size: int,
    device: torch.device,
    dedup: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    strip_special: bool = True,
) -> np.ndarray:
    """Embed and match tokenized pred/ref rows; returns ``(3, N)`` numpy P/R/F1.

    ``strip_special`` excludes [CLS]/[SEP] from the matching and the idf
    weights; the whitespace tokenizer adds neither, so its path turns it off.

    When both sides share one padded length, the encoder takes the two sides
    together in full batches; when they differ, each side is encoded alone.
    Duplicate rows (shared references, repeated candidates) are encoded once
    when at most half the rows are distinct: ``bert_score`` passes its
    text-level map as ``dedup=(u_ids, u_mask, inverse)``, and the module's
    tokenized path finds row duplicates with ``np.unique``.
    """
    def _to(x: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def _embed(ids: np.ndarray, mask: np.ndarray) -> List[Tensor]:
        return [forward(_to(ids[i:i + batch_size]), _to(mask[i:i + batch_size]))
                for i in range(0, ids.shape[0], batch_size)]

    # the matching and idf masks exclude special tokens; the ENCODER gets the full masks
    pred_mmask = _strip_special_positions(pred_mask) if strip_special else pred_mask
    tgt_mmask = _strip_special_positions(tgt_mask) if strip_special else tgt_mask

    pred_w = tgt_w = None
    if idf:
        idf_map = _get_tokens_idf(tgt_ids, tgt_mask)
        pred_w = _to(_idf_weights(pred_ids, pred_mmask, idf_map))
        tgt_w = _to(_idf_weights(tgt_ids, tgt_mmask, idf_map))

    if pred_ids.shape[1] == tgt_ids.shape[1]:
        n_rows = pred_ids.shape[0] + tgt_ids.shape[0]
        length = pred_ids.shape[1]
        if dedup is None:
            all_ids = np.concatenate([pred_ids, tgt_ids], axis=0)
            all_mask = np.concatenate([pred_mask, tgt_mask], axis=0)
            key = np.concatenate([all_ids, all_mask], axis=1)
            uniq, inverse = np.unique(key, axis=0, return_inverse=True)
            u_ids, u_mask = uniq[:, :length], uniq[:, length:]
        else:
            u_ids, u_mask, inverse = dedup
        if u_ids.shape[0] <= n_rows // 2:
            # pad the unique set to whole encoder batches (the pad rows are never gathered back)
            pad = (-u_ids.shape[0]) % min(batch_size, max(u_ids.shape[0], 1))
            if pad:
                u_ids = np.concatenate([u_ids, np.zeros((pad, length), u_ids.dtype)])
                u_mask = np.concatenate([u_mask, np.zeros((pad, length), u_mask.dtype)])
            outs = _embed(u_ids, u_mask)
            inverse = np.asarray(inverse, dtype=np.int64).reshape(-1)
        else:
            outs = _embed(np.concatenate([pred_ids, tgt_ids], axis=0), np.concatenate([pred_mask, tgt_mask], axis=0))
            inverse = np.arange(n_rows, dtype=np.int64)
        prf = _score_embeddings(outs, _to(inverse), _to(pred_mmask), _to(tgt_mmask), pred_w, tgt_w)
    else:
        pred_emb = torch.cat(_embed(pred_ids, pred_mask), dim=0)
        tgt_emb = torch.cat(_embed(tgt_ids, tgt_mask), dim=0)
        prf = torch.stack(_bert_score_from_embeddings(
            pred_emb, _to(pred_mmask), tgt_emb, _to(tgt_mmask), pred_w, tgt_w))
    return prf.cpu().numpy()


def _resolve_baseline_path(
    rescale_with_baseline: bool, baseline_path: Optional[str], baseline_url: Optional[str]
) -> Optional[str]:
    """The local baseline csv, or None when rescaling is off. A
    ``baseline_url`` is honoured only as a local file (optionally
    ``file://``-prefixed): nothing is downloaded."""
    if not rescale_with_baseline:
        return None
    if baseline_url is not None and baseline_path is None:
        local = baseline_url[7:] if baseline_url.startswith("file://") else baseline_url
        if not os.path.exists(local):
            raise ValueError(
                "`baseline_url` cannot be downloaded in this build; pass a local csv via "
                "`baseline_path` (or a file:// url)."
            )
        baseline_path = local
    if baseline_path is None:
        raise ValueError("Baseline rescaling requires a local `baseline_path` csv (no downloads in this build).")
    if not os.path.exists(baseline_path):
        raise ValueError(f"Baseline csv not found: {baseline_path!r}")
    return baseline_path


def _load_baseline_row(baseline_path: str, num_layers: Optional[int]) -> np.ndarray:
    table = np.atleast_2d(np.loadtxt(baseline_path, delimiter=",", skiprows=1))
    row = num_layers if num_layers is not None else -1
    if row >= table.shape[0]:
        raise ValueError(
            f"Baseline csv {baseline_path!r} has {table.shape[0]} rows; no row for num_layers={num_layers}."
        )
    return table[row][1:]


def _apply_baseline(precision, recall, f1, baseline: np.ndarray):
    precision = (precision - baseline[0]) / (1 - baseline[0])
    recall = (recall - baseline[1]) / (1 - baseline[1])
    f1 = (f1 - baseline[2]) / (1 - baseline[2])
    return precision, recall, f1


def bert_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, Tensor]:
    """HF torch ``BertModel`` weights from a Flax BERT parameter tree.

    ``params`` is a ``FlaxBertModel``'s parameter tree (``model.params``,
    optionally under a top-level ``"params"`` key) with numpy leaves: what
    ``tools/convert_weights.py bert`` writes for the JAX package. Keys
    become the torch model's (``encoder.layer.0.attention.self.query.weight``);
    a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), an
    ``embedding`` becomes ``weight``, a LayerNorm ``scale`` becomes
    ``weight``. The tensors are exact copies; ``transformers`` is not needed.
    """
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, Tensor] = {}

    def visit(node: Mapping[str, Any], path: Tuple[str, ...]) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                visit(value, path + (str(key),))
                continue
            arr = np.asarray(value)
            if key == "kernel":
                if arr.ndim != 2:
                    raise ValueError(f"{'.'.join(path)}: a Dense kernel of shape {arr.shape}, not 2-D")
                name, arr = "weight", arr.T
            elif key in ("embedding", "scale"):
                name = "weight"
            elif key == "bias":
                name = "bias"
            else:
                raise ValueError(f"{'.'.join(path + (str(key),))}: not a Flax BERT parameter name")
            out[".".join(path + (name,))] = torch.from_numpy(np.ascontiguousarray(arr).copy())

    visit(params, ())
    return out


def bert_score(
    predictions: List[str],
    references: List[str],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Any] = None,
    user_tokenizer: Optional[Any] = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    device: DeviceLike = None,
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
) -> Dict[str, Union[List[float], str]]:
    """BERTScore P/R/F1 per sentence pair, the encoder and the matching on
    ``device`` (default ``cuda``).

    The encoder resolves in the order ``user_forward_fn`` ``(ids, mask) ->
    emb``, ``model``, ``model_name_or_path`` (a LOCAL HF torch checkpoint).
    Tokenization uses ``user_tokenizer`` (``tok(texts, max_length)``
    returning ``input_ids``/``attention_mask``) or a whitespace tokenizer.
    ``mesh=`` shards the encoder's batch over the mesh's ``mesh_axis``
    (module docstring).
    """
    if len(predictions) != len(references):
        raise ValueError("Number of predicted and reference sentences must be the same!")
    dev = resolve_device(device)
    baseline_path = _resolve_baseline_path(rescale_with_baseline, baseline_path, baseline_url)

    # tokenize each DISTINCT sentence once, both sides in one call: one padded geometry
    texts = list(predictions) + list(references)
    uniq_of: Dict[str, int] = {}
    inverse = np.empty(len(texts), dtype=np.int64)
    uniq_texts: List[str] = []
    for i, s in enumerate(texts):
        j = uniq_of.setdefault(s, len(uniq_texts))
        if j == len(uniq_texts):
            uniq_texts.append(s)
        inverse[i] = j
    if user_tokenizer is not None:
        enc = user_tokenizer(uniq_texts, max_length)
    else:
        enc = _simple_whitespace_tokenizer(uniq_texts, max_length)
    ids_u, mask_u = np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])
    n = len(predictions)
    pred_ids, pred_mask = ids_u[inverse[:n]], mask_u[inverse[:n]]
    tgt_ids, tgt_mask = ids_u[inverse[n:]], mask_u[inverse[n:]]

    forward = _resolve_forward(user_forward_fn, model, model_name_or_path, dev, mesh, mesh_axis)
    precision, recall, f1 = _score_tokenized(
        forward, pred_ids, pred_mask, tgt_ids, tgt_mask, idf=idf, batch_size=batch_size, device=dev,
        dedup=(ids_u, mask_u, inverse),
        strip_special=user_tokenizer is not None,  # the whitespace tokenizer adds no [CLS]/[SEP]
    )

    if rescale_with_baseline:
        precision, recall, f1 = _apply_baseline(
            precision, recall, f1, _load_baseline_row(baseline_path, num_layers)
        )

    output: Dict[str, Union[List[float], str]] = {
        "precision": [float(x) for x in precision],
        "recall": [float(x) for x in recall],
        "f1": [float(x) for x in f1],
    }
    if return_hash:
        output["hash"] = f"metrics_tpu-bert_score-{model_name_or_path}"
    return output
