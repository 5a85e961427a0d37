"""Block-scaled int8 codec for state at rest: the stream pager's compressed
spill rows, and compressed state trees.

Port of ``metrics_tpu/engine/quantize.py``. The ``sync_precision`` policy
decides what compresses: float ``sum`` states a metric declared
``"q8_block"``; counts and min/max states stay verbatim. One encode→decode
round trip costs at most ``block_absmax / 254`` per element.

* **Tree form** (:func:`encode_state_tree`/:func:`decode_state_tree`): a
  logical state tree, nested metrics' ``"_children"`` included. A quantized
  leaf becomes a self-describing dict (marker, codes, scales, shape, dtype),
  so decoding needs no metric; the JAX package's dicts decode here and the
  other way round. A compressed engine snapshot stores it
  (``engine/snapshot.py``).
* **Buffer form** (:class:`ArenaRowCodec`): the per-dtype arena vectors the
  pager spills. The quantized leaves' element positions within each dtype
  buffer split into a coded section (``<dtype>#q8c`` codes + ``<dtype>#q8s``
  scales) and a verbatim remainder (``<dtype>#ex``). The positions come from
  the metric's :class:`~metrics_tpu_torch.engine.arena.ArenaLayout`, which
  takes leaves in the JAX package's order, so a row encoded by either
  package decodes in the other.

Everything here is host numpy.
"""
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.parallel.collectives import Q8_BLOCK, Q8_FLUSH
from metrics_tpu_torch.utils.tree import tree_leaves

__all__ = [
    "ArenaRowCodec",
    "CODEC_ID",
    "decode_state_tree",
    "encode_state_tree",
    "host_dtype",
    "is_q8_leaf",
    "q8_decode_array",
    "q8_encode_array",
]

#: the codec id: the scheme and its block size
CODEC_ID = f"q8b{Q8_BLOCK}"

_MARKER = "__q8b__"


def host_dtype(key: str) -> np.dtype:
    """The numpy dtype a host row of arena buffer ``key`` is kept in: numpy
    has no bfloat16, so bf16 rows widen (losslessly) to float32 on the host."""
    return np.dtype(np.float32) if key == "bfloat16" else np.dtype(key)


def _encode_blocks(flat: np.ndarray, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows of a ``(rows, n)`` f32 matrix -> (codes int8 (rows, nb*block),
    scales f32 (rows, nb)) with per-row per-block absmax scales."""
    rows, n = flat.shape
    nb = -(-n // block)
    padded = np.zeros((rows, nb * block), np.float32)
    padded[:, :n] = flat
    blocks = padded.reshape(rows, nb, block)
    absmax = np.abs(blocks).max(axis=2)
    scales = np.where(absmax >= Q8_FLUSH, absmax / 127.0, 0.0).astype(np.float32)
    inv = np.zeros_like(scales)
    np.divide(1.0, scales, out=inv, where=scales > 0)
    codes = np.clip(np.rint(blocks * inv[:, :, None]), -127, 127).astype(np.int8)
    return codes.reshape(rows, nb * block), scales


def _decode_blocks(codes: np.ndarray, scales: np.ndarray, n: int, block: int) -> np.ndarray:
    """Inverse of :func:`_encode_blocks`: ``(rows, n)`` f32. One exact int8→f32
    convert and ONE f32 multiply per element: the K7 kernel's seed decode runs
    the same arithmetic, bit for bit."""
    rows = codes.shape[0]
    nb = scales.shape[1]
    vals = codes.astype(np.float32).reshape(rows, nb, block) * scales[:, :, None]
    return vals.reshape(rows, nb * block)[:, :n]


def q8_encode_array(arr: Any, block: int = Q8_BLOCK) -> Dict[str, Any]:
    """One array -> its self-describing compressed leaf dict."""
    a = _host_array(arr)
    codes, scales = _encode_blocks(a.astype(np.float32).reshape(1, -1), block)
    return {_MARKER: int(block), "codes": codes[0], "scales": scales[0],
            "shape": np.asarray(a.shape, np.int64), "dtype": str(a.dtype)}


def q8_decode_array(leaf: Dict[str, Any]) -> np.ndarray:
    """Inverse of :func:`q8_encode_array`."""
    block = int(np.asarray(leaf[_MARKER]))
    shape = tuple(int(d) for d in np.asarray(leaf["shape"]))
    n = int(np.prod(shape, dtype=np.int64))
    codes = np.asarray(leaf["codes"]).reshape(1, -1)
    scales = np.asarray(leaf["scales"]).reshape(1, -1)
    flat = _decode_blocks(codes, scales, n, block)[0]
    return flat.reshape(shape).astype(np.dtype(str(leaf["dtype"])))


def is_q8_leaf(x: Any) -> bool:
    return isinstance(x, dict) and _MARKER in x


def _host_array(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):  # numpy has no bf16, which widens losslessly
        x = x.detach().cpu()
        x = x.float() if x.dtype == torch.bfloat16 else x
    return np.asarray(x)


def encode_state_tree(metric: Any, state: Any) -> Any:
    """Wrap the quantized-policy leaves of a logical state tree in compressed
    leaf dicts, recursing into nested metrics; everything else passes
    verbatim. ``metric`` (a Metric or a MetricCollection) supplies the
    policy."""
    if not isinstance(state, dict):
        return state
    if hasattr(metric, "items") and not hasattr(metric, "_defaults"):
        return {k: encode_state_tree(m, state.get(k, {})) for k, m in metric.items(keep_base=True)}
    out: Dict[str, Any] = {}
    for k, v in state.items():
        if k == metric._CHILD_KEY:
            out[k] = metric._map_children(encode_state_tree, v)
        elif metric._sync_precision.get(k, "exact") == "q8_block" and not isinstance(v, list):
            out[k] = q8_encode_array(v)
        else:
            out[k] = v
    return out


def decode_state_tree(tree: Any) -> Any:
    """Unwrap every compressed leaf anywhere in a tree (self-describing: no
    metric needed)."""
    if is_q8_leaf(tree):
        return q8_decode_array(tree)
    if isinstance(tree, dict):
        return {k: decode_state_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [decode_state_tree(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(decode_state_tree(v) for v in tree)
    return tree


class ArenaRowCodec:
    """Buffer-form codec over a metric's per-dtype arena vectors, on any
    leading shape: one spilled row ``(n,)``, a spill matrix ``(K, n)``."""

    CODES = "#q8c"
    SCALES = "#q8s"
    EXACT = "#ex"

    def __init__(self, q_mask: Dict[str, np.ndarray], block: int = Q8_BLOCK):
        #: dtype key -> boolean element mask of the quantized section
        self._q_mask = {k: np.asarray(v, bool) for k, v in q_mask.items()}
        self._block = int(block)

    @classmethod
    def for_metric(cls, metric: Any, block: int = Q8_BLOCK) -> Optional["ArenaRowCodec"]:
        """The codec for ``metric``'s per-stream arena layout, or None when the
        policy quantizes nothing."""
        precisions = _flat_precisions(metric)
        if not any(p == "q8_block" for p in precisions):
            return None
        layout = metric.arena_layout()
        slices = layout.leaf_slices()
        if len(slices) != len(precisions):  # pragma: no cover - same flatten order
            raise ValueError(f"precision list ({len(precisions)}) does not align with the arena "
                             f"layout ({len(slices)} leaves)")
        masks = {k: np.zeros((n,), bool) for k, n in layout.buffer_sizes().items()}
        for (key, off, size, _shape, _dtype), prec in zip(slices, precisions):
            if prec == "q8_block":
                masks[key][off : off + size] = True
        return cls({k: m for k, m in masks.items() if m.any()}, block)

    @property
    def q_mask(self) -> Dict[str, np.ndarray]:
        """dtype key -> boolean mask of the quantized columns."""
        return dict(self._q_mask)

    def is_encoded(self, bufs: Dict[str, Any]) -> bool:
        return any(str(k).endswith(self.CODES) for k in bufs)

    def encode_buffers(self, bufs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Per-dtype buffers (elements on the LAST axis) -> their compressed
        form. Buffers without quantized elements pass through under their own
        key; an all-quantized buffer has no ``#ex`` entry."""
        out: Dict[str, np.ndarray] = {}
        for k, buf in bufs.items():
            mask = self._q_mask.get(k)
            arr = np.asarray(buf)
            if mask is None:
                out[k] = arr
                continue
            lead = arr.shape[:-1]
            flat = arr.reshape(-1, arr.shape[-1]).astype(np.float32)
            codes, scales = _encode_blocks(flat[:, mask], self._block)
            out[k + self.CODES] = codes.reshape(lead + (codes.shape[-1],))
            out[k + self.SCALES] = scales.reshape(lead + (scales.shape[-1],))
            exact = arr.reshape(-1, arr.shape[-1])[:, ~mask]
            if exact.shape[-1]:
                out[k + self.EXACT] = exact.reshape(lead + (exact.shape[-1],))
        return out

    def stage_buffers(self, enc: Dict[str, Any], keys: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, tuple]]:
        """Split an encoded buffer dict for DEVICE-side decode of ``keys``'s
        quantized sections (the K7 q8-resident path).

        Returns ``(seed, stage)``: ``seed`` is :meth:`decode_buffers`' output
        except each staged key's quantized columns are left ZERO;
        ``stage[key] = (codes_elem, scales_elem)`` are per-ELEMENT ``(..., n)``
        int8/f32 expansions aligned to the buffer columns (zero outside the
        quantized mask), so ``(codes_elem.astype(f32) * scales_elem)`` cast
        to the dtype over the mask reproduces :meth:`decode_buffers` bit for
        bit."""
        keys = tuple(keys)
        sub = dict(enc)
        stage: Dict[str, tuple] = {}
        for k in keys:
            mask = self._q_mask[k]
            codes = np.asarray(sub.pop(k + self.CODES))
            scales = np.asarray(sub.pop(k + self.SCALES), np.float32)
            lead = codes.shape[:-1]
            nq = int(mask.sum())
            n = mask.size
            codes_elem = np.zeros(lead + (n,), np.int8)
            scales_elem = np.zeros(lead + (n,), np.float32)
            codes_elem[..., mask] = codes[..., :nq]
            scales_elem[..., mask] = np.repeat(scales, self._block, axis=-1)[..., :nq]
            stage[k] = (codes_elem, scales_elem)
        seed = self.decode_buffers(sub)
        for k in keys:
            mask = self._q_mask[k]
            lead = stage[k][0].shape[:-1]
            n = mask.size
            full = np.zeros(lead + (n,), host_dtype(k))
            ek = k + self.EXACT
            if ek in enc:
                full[..., ~mask] = np.asarray(enc[ek]).reshape(lead + (n - int(mask.sum()),))
            seed[k] = full
        return seed, stage

    def decode_buffers(self, enc: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Inverse of :meth:`encode_buffers`."""
        out: Dict[str, np.ndarray] = {}
        for k, v in enc.items():
            key = str(k)
            if key.endswith((self.CODES, self.SCALES, self.EXACT)):
                continue
            out[key] = np.asarray(v)
        for k, mask in self._q_mask.items():
            ck, sk, ek = k + self.CODES, k + self.SCALES, k + self.EXACT
            if ck not in enc:
                continue
            codes = np.asarray(enc[ck])
            scales = np.asarray(enc[sk])
            lead = codes.shape[:-1]
            nq = int(mask.sum())
            vals = _decode_blocks(codes.reshape(-1, codes.shape[-1]), scales.reshape(-1, scales.shape[-1]), nq,
                                  self._block)
            n = mask.size
            full = np.zeros((vals.shape[0], n), host_dtype(k))
            full[:, mask] = vals.astype(host_dtype(k))
            if ek in enc:
                full[:, ~mask] = np.asarray(enc[ek]).reshape(-1, n - nq)
            out[k] = full.reshape(lead + (n,))
        return out


def _flat_precisions(metric: Any) -> List[str]:
    """Per-leaf precision strings in ``abstract_state`` flatten order, nested
    metrics' included."""

    def ptree(m: Any) -> Any:
        if hasattr(m, "items") and not hasattr(m, "_defaults"):
            return {k: ptree(mm) for k, mm in m.items(keep_base=True)}
        out: Dict[str, Any] = {k: m._sync_precision.get(k, "exact") for k in m._defaults}
        children = m._map_children(ptree)
        if children:
            out[m._CHILD_KEY] = children
        return out

    return [str(p) for p in tree_leaves(ptree(metric))]
