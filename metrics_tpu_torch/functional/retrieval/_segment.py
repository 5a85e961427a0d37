"""Grouped retrieval compute on the device.

Port of ``metrics_tpu/functional/retrieval/_segment.py``. The whole corpus is
handled in one device computation, with no per-query host loop:

  1. two stable sorts put every query's documents contiguous, best first
     (the JAX package's one ``lexsort`` on (query index, descending
     prediction): the secondary key is sorted first, then the primary);
  2. per-query metrics are segment reductions over rank/cumsum arrays
     (``scatter_add``/``scatter_reduce`` into fixed-size outputs), with no
     data-dependent shape;
  3. one device-to-host transfer returns what the host needs.

:func:`_segment_scores` is written once, batched over a leading axis (every
sort, cumsum and segment reduction runs along the last dim), so the corpus
mean (one row), the per-group read and the batched group scores of the
ragged engine (one row per group) share one body. Sort keys are made
canonical first (``-0.0`` becomes ``+0.0``, every NaN the one positive quiet
NaN), so a radix sort on the card orders them as the comparison sort here
does: ties keep their input order, ``+-0`` compare equal and NaN goes last.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import (
    _CODE_EMPTY_QUERY_RETRIEVAL,
    _is_traced,
    defer_value_check,
    deferred_message,
)

Tensor = torch.Tensor

KINDS = ("map", "mrr", "precision", "recall", "r_precision", "hit_rate", "fall_out", "ndcg")


def _canonical_key(x: Tensor) -> Tensor:
    """``x`` with ``-0.0`` as ``+0.0`` and every NaN as one positive NaN:
    equal under comparison to ``x``, and equal in bits where it compares
    equal (so a radix sort ties them)."""
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x + 0.0)


def _group_order(indexes: Tensor, score: Tensor) -> Tensor:
    """Per row of the ``(B, n)`` inputs, the permutation ordering documents by
    ``indexes`` ascending, then ``score`` descending, ties in input order:
    the JAX package's ``lexsort((-score, indexes))`` as two stable sorts."""
    by_score = torch.sort(_canonical_key(-score), dim=-1, stable=True).indices
    by_index = torch.sort(torch.gather(indexes, -1, by_score), dim=-1, stable=True).indices
    return torch.gather(by_score, -1, by_index)


def _segment_scores(preds: Tensor, target: Tensor, indexes: Tensor, *, kind: str,
                    k: Optional[int]) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-query scores of every row of a ``(B, n)`` batch of corpora.

    Returns ``(values, empty, valid)``, each ``(B, n)`` (the static query
    bound is the document count): ``valid[b, q]`` flags segments that exist,
    ``empty[b, q]`` degenerate queries (no positive target; no NEGATIVE for
    fall-out), ``values[b, q]`` the metric of valid, non-degenerate queries.
    Segment ``q`` is the ``q``-th distinct index in ascending order.
    """
    b, n = preds.shape
    f32 = torch.float32
    dev = preds.device
    indexes = indexes.to(torch.int64)

    order = _group_order(indexes, preds)
    t = torch.gather(target, -1, order).to(f32)
    idx = torch.gather(indexes, -1, order)

    start = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev), idx[:, 1:] != idx[:, :-1]], dim=-1)
    seg = torch.cumsum(start.to(torch.int64), dim=-1) - 1  # dense 0-based query id, in sorted order
    pos = torch.arange(n, device=dev).expand(b, n)
    seg_start = torch.cummax(torch.where(start, pos, 0), dim=-1).values
    rank = (pos - seg_start + 1).to(f32)  # 1-based rank within the query

    def sum_seg(x: Tensor) -> Tensor:
        return torch.zeros((b, n), dtype=x.dtype, device=dev).scatter_add_(-1, seg, x)

    rel = (t > 0).to(f32)
    n_docs = sum_seg(torch.ones_like(rel))
    n_rel = sum_seg(rel)
    valid = n_docs > 0
    if kind == "fall_out":
        empty = valid & (n_docs - n_rel == 0)
    else:
        empty = valid & (n_rel == 0)

    # effective cutoff: explicit k, else the query's own document count
    kk = torch.full((b, n), float(k), dtype=f32, device=dev) if k is not None else n_docs
    in_k = rank <= torch.gather(kk, -1, seg)

    if kind in ("precision", "recall", "hit_rate"):
        hits = sum_seg(rel * in_k)
        if kind == "precision":
            values = hits / torch.clamp_min(kk, 1.0)
        elif kind == "recall":
            values = hits / torch.clamp_min(n_rel, 1.0)
        else:
            values = (hits > 0).to(f32)
    elif kind == "fall_out":
        neg = 1.0 - rel
        values = sum_seg(neg * in_k) / torch.clamp_min(sum_seg(neg), 1.0)
    elif kind == "r_precision":
        in_r = rank <= torch.gather(n_rel, -1, seg)
        values = sum_seg(rel * in_r) / torch.clamp_min(n_rel, 1.0)
    elif kind == "map":
        # within-query cumulative relevant count: the cumsum minus what was
        # carried in from before the query's first document (exact: 0/1 sums)
        c = torch.cumsum(rel, dim=-1)
        carried = torch.gather(c, -1, seg_start) - torch.gather(rel, -1, seg_start)
        cum_rel = c - carried
        values = sum_seg(torch.where(rel > 0, cum_rel / rank, 0.0)) / torch.clamp_min(n_rel, 1.0)
    elif kind == "mrr":
        first = torch.full((b, n), float("inf"), dtype=f32, device=dev).scatter_reduce_(
            -1, seg, torch.where(rel > 0, rank, float("inf")), "amin", include_self=True)
        values = torch.where(torch.isfinite(first), 1.0 / torch.clamp_min(first, 1.0), 0.0)
    elif kind == "ndcg":
        from metrics_tpu_torch.functional.retrieval.ndcg import log2_position_discounts

        discount = log2_position_discounts(n, dev)[pos - seg_start]
        dcg = sum_seg(torch.where(in_k, t * discount, 0.0))
        # the ideal ordering: the same segments, documents by descending relevance
        t2 = torch.gather(target, -1, _group_order(indexes, target.to(f32))).to(f32)
        idcg = sum_seg(torch.where(in_k, t2 * discount, 0.0))
        values = torch.where(idcg > 0, dcg / torch.clamp_min(idcg, 1e-38), 0.0)
    else:
        raise ValueError(f"unknown retrieval kind: {kind}")
    return values, empty, valid


def segment_retrieval_mean(
    preds: Tensor,
    target: Tensor,
    indexes: Tensor,
    *,
    kind: str,
    k: Optional[int] = None,
    empty_target_action: str = "neg",
) -> Tensor:
    """Mean-over-queries retrieval score, on the device.

    ``empty_target_action`` follows the reference: degenerate queries raise
    (``error``), score 1 (``pos``), score 0 (``neg``), or drop out of the
    mean (``skip``). Eagerly, ``error`` fetches the (result, flag) pair in ONE
    transfer and raises on the host; traced, the result is NaN-poisoned and a
    deferred code is emitted inside a ``deferred_value_checks`` context.
    """
    values, empty, valid = _segment_scores(preds[None], target[None], indexes[None], kind=kind, k=k)
    values, empty, valid = values[0], empty[0], valid[0]
    if empty_target_action == "skip":
        keep, fill = valid & ~empty, 0.0
    elif empty_target_action == "pos":
        keep, fill = valid, 1.0
    else:  # "neg", and "error" (which inspects the empty flag below)
        keep, fill = valid, 0.0
    values = torch.where(empty, fill, values)
    count = keep.sum()
    total = torch.where(keep, values, 0.0).sum()
    result = torch.where(count > 0, total / torch.clamp_min(count, 1), 0.0)
    if empty_target_action != "error":
        return result
    any_empty = empty.any()
    if _is_traced(result) or _is_traced(any_empty):
        defer_value_check(lambda: any_empty, _CODE_EMPTY_QUERY_RETRIEVAL)
        return torch.where(any_empty, float("nan"), result)
    fetched = torch.stack([result, any_empty.to(result.dtype)]).tolist()  # ONE transfer
    if fetched[1]:
        raise ValueError(deferred_message(_CODE_EMPTY_QUERY_RETRIEVAL))
    return result


def _prefix_scores(preds: Tensor, target: Tensor, count: Tensor, *, kind: str,
                   k: Optional[int]) -> Tuple[Tensor, Tensor]:
    """The score and the degenerate flag of each row's valid prefix: ``(G,
    capacity)`` buffers whose first ``min(count, capacity)`` slots are a
    group's rows. The prefix is segment 0 of :func:`_segment_scores` (pad
    slots get the key 1), so the per-kind math is the corpus path's."""
    cap = preds.shape[-1]
    row_valid = torch.arange(cap, device=preds.device)[None, :] < torch.clamp_max(count, cap)[:, None]
    indexes = torch.where(row_valid, 0, 1).to(torch.int32)
    values, empty, _ = _segment_scores(preds.to(torch.float32), target.to(torch.float32), indexes, kind=kind, k=k)
    return values[:, 0], empty[:, 0]


def batched_group_scores(
    preds: Tensor,
    target: Tensor,
    counts: Tensor,
    *,
    kind: str,
    k: Optional[int] = None,
    empty_target_action: str = "neg",
) -> Tuple[Tensor, Tensor, Tensor]:
    """Every group's score from the stacked ragged buffers, batched.

    ``preds``/``target`` are the ``(G, capacity)`` stacked capacity buffers,
    ``counts`` the ``(G,)`` TRUE row totals. Returns per-group vectors the
    ragged engine folds on the device:

    * ``value`` ``(G,)``: the group's score, degenerate groups holding the
      action's fill (``skip`` groups hold 0 but are masked out);
    * ``keep`` ``(G,)`` bool: groups that enter the corpus mean. Empty
      groups (``count == 0``) and overflowed ones (``count > capacity``)
      drop out, as in the eager corpus path (overflow also raises on the
      host, off the count vector, before any folded value escapes);
    * ``flag`` ``(G,)`` bool: degenerate groups under
      ``empty_target_action="error"`` (all False otherwise).

    ``value`` summed under ``keep`` and divided by the kept count is
    :func:`segment_retrieval_mean` over the concatenated corpus, up to the
    order of the f32 sums.
    """
    cap = int(preds.shape[1])
    counts = counts.to(torch.int32)
    value, empty = _prefix_scores(preds, target, counts, kind=kind, k=k)
    valid = (counts > 0) & (counts <= cap)
    empty = empty & valid
    if empty_target_action == "skip":
        keep, fill = valid & ~empty, 0.0
    elif empty_target_action == "pos":
        keep, fill = valid, 1.0
    else:  # "neg", and "error" (the host finish inspects the flag vector)
        keep, fill = valid, 0.0
    value = torch.where(empty, fill, value)
    flag = empty if empty_target_action == "error" else torch.zeros_like(empty)
    return value, keep, flag


def grouped_query_score(
    preds: Tensor,
    target: Tensor,
    count: Tensor,
    *,
    kind: str,
    k: Optional[int] = None,
    empty_target_action: str = "neg",
) -> Tensor:
    """Each group's score from its ragged capacity buffers: ``preds``/
    ``target`` ``(..., capacity)``, ``count`` ``(...)`` the TRUE row totals
    (past capacity: overflow). One group (``(capacity,)`` and a 0-d count)
    is the per-group read of ``result(gid)``; a stack of them ``results()``.

    Sentinels (the per-group read has no mean to hide in): ``count == 0`` ->
    0.0 (no rows, as the eager metric's empty compute); a degenerate query ->
    the action's value, ``skip`` and ``error`` scoring NaN (``error`` also
    defers the value check when traced, and raises eagerly); overflow -> NaN
    (rows past capacity were dropped, any score would be made up).
    """
    lead = tuple(count.shape)
    cap = preds.shape[-1]
    count = count.reshape(-1).to(torch.int32)
    value, empty = _prefix_scores(preds.reshape(-1, cap), target.reshape(-1, cap), count, kind=kind, k=k)
    is_empty = empty & (count > 0)
    if empty_target_action == "pos":
        fill = 1.0
    elif empty_target_action == "neg":
        fill = 0.0
    else:  # "skip" and "error": no defined per-group value
        fill = float("nan")
    value = torch.where(is_empty, fill, value)
    value = torch.where(count == 0, 0.0, value)
    value = torch.where(count > cap, float("nan"), value).reshape(lead)
    if empty_target_action != "error":
        return value
    if _is_traced(value) or _is_traced(is_empty):
        defer_value_check(lambda: is_empty.any(), _CODE_EMPTY_QUERY_RETRIEVAL)
        return value
    if bool(is_empty.any()):
        raise ValueError(deferred_message(_CODE_EMPTY_QUERY_RETRIEVAL))
    return value
