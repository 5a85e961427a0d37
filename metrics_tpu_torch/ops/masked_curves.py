"""Masked exact curve metrics over static-capacity buffers.

Port of ``metrics_tpu/ops/masked_curves.py``. ``AUROC(capacity=N)``,
``AveragePrecision(capacity=N)``, ``ROC(capacity=N)`` and
``PrecisionRecallCurve(capacity=N)`` keep ``(capacity, ...)`` score buffers
whose ``valid`` entries are real; the functions here compute EXACT
(sort-based, tie-aware) values over them with static shapes and no host read,
so a compute runs under ``torch.func.vmap`` (the engines' batched
``results()``):

* ``masked_binary_auroc`` — Mann-Whitney U with average-rank tie handling,
  algebraically the trapezoidal ROC integral the eager path computes;
* ``masked_binary_average_precision`` — step integration at distinct
  thresholds;
* ``masked_binary_roc`` / ``masked_binary_pr_curve`` — fixed-length curves
  whose points overlay the classic distinct-threshold curve.

Degenerate inputs (a single class) give NaN, the sentinel for the eager
path's error. The sorts and segment sums are library calls, as the JAX
package computes them outside any Pallas kernel. Sorts copy JAX's
``argsort(-keys, stable=True)`` literally, so ties order the same way.
"""
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _segment_sum(x: Tensor, seg: Tensor, n: int) -> Tensor:
    """``jax.ops.segment_sum(x, seg, num_segments=n)``."""
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add(0, seg, x)


def _segment_max(x: Tensor, seg: Tensor, n: int) -> Tensor:
    """``jax.ops.segment_max(x, seg, num_segments=n)`` (empty segments hold
    the identity; callers read only occupied ones)."""
    init = torch.full((n,), float("-inf"), dtype=x.dtype, device=x.device)
    return init.scatter_reduce(0, seg, x, reduce="amax", include_self=False)


def _tie_segments(s: Tensor) -> Tuple[Tensor, Tensor]:
    """(group-start mask, segment ids) for runs of equal values in sorted ``s``."""
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=s.device), s[1:] != s[:-1]])
    return start, torch.cumsum(start.to(torch.int64), 0) - 1


def _desc_sorted(scores: Tensor, labels: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Descending-score sort with invalid entries last: returns (scores,
    valid, positive-indicator), each sorted, as f32/bool/f32."""
    keys = torch.where(valid, scores.to(torch.float32), float("-inf"))
    order = torch.argsort(-keys, stable=True)
    v = valid[order]
    t = torch.where(v, (labels[order] > 0).to(torch.float32), 0.0)
    return keys[order], v, t


def _masked_average_ranks(scores: Tensor, valid: Tensor) -> Tensor:
    """1-based average ranks (ascending) among valid entries; 0 for invalid.
    Ties receive the mean of the positions they span."""
    n = scores.shape[0]
    keys = torch.where(valid, scores, float("inf"))  # invalid sort last
    order = torch.argsort(keys, stable=True)
    s = keys[order]
    v = valid[order]
    pos = torch.arange(1, n + 1, dtype=torch.float32, device=scores.device)
    _, seg = _tie_segments(s)
    sum_pos = _segment_sum(torch.where(v, pos, 0.0), seg, n)
    cnt = _segment_sum(v.to(torch.float32), seg, n)
    avg = sum_pos / torch.clamp(cnt, min=1.0)
    ranks_sorted = torch.where(v, avg[seg], 0.0)
    return torch.zeros(n, dtype=torch.float32, device=scores.device).scatter(0, order, ranks_sorted)


def masked_binary_auroc(scores: Tensor, labels: Tensor, valid: Tensor) -> Tensor:
    """Exact binary AUROC over the valid entries of a capacity buffer:
    ``(sum of positive ranks - P(P+1)/2) / (P * N)``; NaN when either class
    is absent."""
    valid = valid.to(torch.bool)
    pos = valid & (labels > 0)
    ranks = _masked_average_ranks(scores.to(torch.float32), valid)
    p = torch.sum(pos.to(torch.float32))
    nn = torch.sum(valid.to(torch.float32)) - p
    s_pos = torch.sum(torch.where(pos, ranks, 0.0))
    denom = p * nn
    return torch.where(denom > 0, (s_pos - p * (p + 1) / 2) / torch.clamp(denom, min=1.0), float("nan"))


def masked_binary_average_precision(scores: Tensor, labels: Tensor, valid: Tensor) -> Tensor:
    """Exact binary average precision (step integration at distinct
    thresholds) over the valid entries of a capacity buffer; NaN when no
    positives."""
    n = scores.shape[0]
    valid = valid.to(torch.bool)
    s, v, t = _desc_sorted(scores, labels, valid)
    tp = torch.cumsum(t, 0)
    fp = torch.cumsum(torch.where(v, 1.0 - t, 0.0), 0)
    # distinct-threshold runs; precision at each run END
    _, seg = _tie_segments(s)
    run_tp = _segment_sum(t, seg, n)[seg]
    end = torch.cat([s[1:] != s[:-1], torch.ones(1, dtype=torch.bool, device=s.device)])
    prec = tp / torch.clamp(tp + fp, min=1.0)
    contrib = torch.where(end & v, run_tp * prec, 0.0)
    p_total = torch.sum(t)
    return torch.where(p_total > 0, torch.sum(contrib) / torch.clamp(p_total, min=1.0), float("nan"))


def _masked_clf_curve(scores: Tensor, labels: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-position cumulative ``(fps, tps, thresholds)`` in descending-score
    order over the valid entries: the static-shape ``_binary_clf_curve``.
    Every slot emits a point; tie-group interiors interpolate linearly
    between the group's endpoints in count space, and invalid slots repeat
    the final totals with the lowest valid threshold."""
    n = scores.shape[0]
    f32 = torch.float32
    s, v_bool, t = _desc_sorted(scores, labels, valid)
    v = v_bool.to(f32)
    w = v - t  # negatives
    tps_raw = torch.cumsum(t, 0)
    fps_raw = torch.cumsum(w, 0)
    pos = torch.arange(n, device=scores.device)
    start, seg = _tie_segments(s)
    seg_start = torch.cummax(torch.where(start, pos, 0), 0).values
    grp_tp = _segment_sum(t, seg, n)[seg]
    grp_fp = _segment_sum(w, seg, n)[seg]
    grp_len = _segment_sum(torch.ones_like(t), seg, n)[seg]
    tp_end = _segment_max(tps_raw, seg, n)[seg]
    fp_end = _segment_max(fps_raw, seg, n)[seg]
    frac = (pos - seg_start + 1).to(f32) / torch.clamp(grp_len, min=1.0)
    tps = (tp_end - grp_tp) + frac * grp_tp
    fps = (fp_end - grp_fp) + frac * grp_fp
    lowest = torch.min(torch.where(valid, scores.to(f32), float("inf")))
    thresholds = torch.where(torch.isfinite(s), s, lowest)
    return fps, tps, thresholds


def masked_binary_roc(scores: Tensor, labels: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Static-shape exact ROC: ``(fpr, tpr, thresholds)``, each ``(n+1,)``,
    in the eager path's point order with its prepended origin; a class with
    no positives (negatives) gives a zero tpr (fpr), without the eager
    warning."""
    fps, tps, thresholds = _masked_clf_curve(scores, labels, valid)
    tps = torch.cat([torch.zeros(1, dtype=tps.dtype, device=tps.device), tps])
    fps = torch.cat([torch.zeros(1, dtype=fps.dtype, device=fps.device), fps])
    thresholds = torch.cat([thresholds[0:1] + 1, thresholds])
    fpr = torch.where(fps[-1] > 0, fps / torch.clamp(fps[-1], min=1.0), torch.zeros_like(fps))
    tpr = torch.where(tps[-1] > 0, tps / torch.clamp(tps[-1], min=1.0), torch.zeros_like(tps))
    return fpr, tpr, thresholds


def masked_binary_pr_curve(scores: Tensor, labels: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Static-shape exact PR curve: ``(precision, recall, thresholds)`` of
    lengths ``(n+1, n+1, n)`` in the eager path's layout (recall
    non-increasing, thresholds ascending, a final ``(1, 0)`` point). Group
    endpoints are exact; interiors interpolate the counts linearly; points
    past the first full-recall position and padding repeat that point."""
    n = scores.shape[0]
    fps, tps, thresholds = _masked_clf_curve(scores, labels, valid)
    p_total_raw = tps[-1]
    first_full = torch.argmax((tps >= p_total_raw).to(torch.int32))
    after = torch.arange(n, device=scores.device) > first_full
    keep = p_total_raw > 0
    at = first_full.reshape(1)
    fps = torch.where(after & keep, fps.index_select(0, at), fps)
    tps = torch.where(after & keep, p_total_raw, tps)
    thresholds = torch.where(after & keep, thresholds.index_select(0, at), thresholds)
    precision = tps / torch.clamp(tps + fps, min=1e-38)
    p_total = tps[-1]
    recall = torch.where(p_total > 0, tps / torch.clamp(p_total, min=1.0), torch.ones_like(tps))
    precision = torch.cat([precision.flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall.flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    return precision, recall, thresholds.flip(0)


def average_per_class(per_class: Tensor, support: Tensor, average: Optional[str]) -> Tensor:
    """Average a per-class vector, ignoring NaN (unobserved) classes, as the
    eager path does (nanmean, NaN-zeroed weights)."""
    if average in ("none", None):
        return per_class
    if average == "macro":
        return torch.nanmean(per_class)
    if average != "weighted":
        raise ValueError(f"unknown average for capacity mode: {average}")
    nan = torch.isnan(per_class)
    w = torch.where(nan, 0.0, support.to(torch.float32))
    vals = torch.where(nan, 0.0, per_class)
    total_w = torch.sum(w)
    # all classes degenerate: the NaN sentinel, not a confident-looking 0.0
    return torch.where(total_w > 0, torch.sum(vals * w) / torch.clamp(total_w, min=1.0), float("nan"))


def _per_column(kernel, probs: Tensor, labels: Tensor, valid: Tensor):
    """``kernel(column scores, column labels, valid)`` for every column of
    ``(capacity, C)`` buffers: one ``torch.func.vmap`` over the columns."""
    return torch.func.vmap(lambda p_col, t_col: kernel(p_col, t_col, valid), in_dims=(1, 1))(probs, labels)


def _support(labels: Tensor, valid: Tensor) -> Tensor:
    return torch.sum(torch.where(valid[:, None], labels, 0), dim=0)


def masked_multilabel_auroc(probs: Tensor, labels: Tensor, valid: Tensor, average: Optional[str] = "macro") -> Tensor:
    """Per-column AUROC over ``(capacity, C)`` probabilities and binary labels
    (one-hot for multiclass one-vs-rest: the same layout)."""
    return average_per_class(_per_column(masked_binary_auroc, probs, labels, valid), _support(labels, valid), average)


def masked_multilabel_average_precision(
    probs: Tensor, labels: Tensor, valid: Tensor, average: Optional[str] = "macro"
) -> Tensor:
    """Per-column AP over ``(capacity, C)`` probabilities and binary labels."""
    per_class = _per_column(masked_binary_average_precision, probs, labels, valid)
    return average_per_class(per_class, _support(labels, valid), average)
