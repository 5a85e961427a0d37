"""Whole-step megakernel plan: one kernel launch per arena dtype.

Port of ``metrics_tpu/engine/megastep.py``. The arena (``engine/arena.py``)
packs every state leaf of one dtype into a single buffer; this module walks
its slice metadata, gives every COLUMN of each dtype buffer its owning leaf's
reduction opcode, and at step time packs all leaves' row deltas into one
column-aligned ``(N, F)`` matrix per dtype, folded by ONE
:func:`~metrics_tpu_torch.ops.kernels.megastep_fold` (K5) launch, or, for the
paged multi-stream engine, one :func:`megastep_segment` (K6, or K7 with q8
staging) launch. The per-leaf unpack → fold → repack of the per-leaf path
never happens for an eligible dtype.

Eligibility is per dtype and static:

* every leaf of the dtype folds by ``sum``/``min``/``max`` through the
  generic delta path — reason ``"strategy"`` otherwise;
* the dtype is one the kernels take (f32/bf16/i32) — reason ``"dtype"``.

The TPU's ``"vmem"`` reason has no counterpart: the CUDA kernels take every S
and F. An ineligible dtype degrades to the per-leaf kernels (K1, K4), and
every degraded dtype is counted in the engine's ``kernel_fallbacks``.
"""
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.ops.kernels import (
    REDUCE_OPS,
    fold_rows_masked,
    megastep_fold,
    megastep_segment,
    segment_reduce_masked,
    supported_dtype,
)
from metrics_tpu_torch.ops.kernels.dispatch import OpRow, _op_row_info
from metrics_tpu_torch.utils.tree import tree_leaves

__all__ = ["MegastepPlan", "flat_reductions"]

#: per-leaf marker for "this leaf cannot ride the generic delta fold"
NO_FOLD = "none"


def _is_collection(m: Any) -> bool:
    return hasattr(m, "items") and not hasattr(m, "_defaults")


def _metric_fx_tree(m: Any, foldable: bool) -> Dict[str, Any]:
    """Per-leaf reduction names, congruent to ``m``'s state tree: a foldable
    (delta-strategy) member gives each state's own reduction, recursing into
    nested metrics with THEIRS (the leaves ``Metric._masked_reduce_into``
    folds); anything else marks every leaf :data:`NO_FOLD`."""
    out: Dict[str, Any] = {k: (m._reductions[k] if foldable and m._reductions[k] in REDUCE_OPS else NO_FOLD)
                           for k in m._defaults}
    children = m._map_children(lambda c: _metric_fx_tree(c, foldable))
    if children:
        out[m._CHILD_KEY] = children
    return out


def flat_reductions(metric: Any) -> List[str]:
    """Per-leaf reduction names (``"sum"``/``"min"``/``"max"``/``"none"``)
    in ``abstract_state`` flatten order — the opcode source for
    :meth:`ArenaLayout.column_ops`. A member off the delta strategy marks all
    its leaves ``"none"``."""

    def ptree(m: Any) -> Any:
        if _is_collection(m):
            return {k: ptree(mm) for k, mm in m.items(keep_base=True)}
        return _metric_fx_tree(m, m.masked_update_strategy() == "delta")

    return [str(f) for f in tree_leaves(ptree(metric))]


class MegastepPlan:
    """Static megastep plan for one metric/collection over its arena layout."""

    def __init__(self, metric: Any, layout: Any):
        self._metric = metric
        self._layout = layout
        self._fx = flat_reductions(metric)
        slices = layout.leaf_slices()
        if len(self._fx) != len(slices):  # nested leaves the op row missed would fold with the wrong ops
            raise ValueError(f"reduction list ({len(self._fx)}) does not align with the arena "
                             f"layout ({len(slices)} leaves)")
        #: dtype key -> [(leaf_index, offset, size, shape, dtype)]
        self._by_key: Dict[str, List[Tuple[int, int, int, Tuple[int, ...], torch.dtype]]] = {}
        for i, (key, off, size, shape, dtype) in enumerate(slices):
            self._by_key.setdefault(key, []).append((i, off, size, shape, dtype))
        self._ops = layout.column_ops([REDUCE_OPS.index(f) if f in REDUCE_OPS else 0 for f in self._fx])
        #: (dtype key, device) -> the op row on the device and its shared op,
        #: canonicalized at the first step and not on every one
        self._op_rows: Dict[Tuple[str, torch.device], OpRow] = {}
        self._reasons: Dict[str, str] = {}
        for key, items in self._by_key.items():
            if any(self._fx[i] not in REDUCE_OPS for i, *_ in items):
                self._reasons[key] = "strategy"
            elif not supported_dtype(items[0][4]):
                self._reasons[key] = "dtype"
        # member name -> rides the packed-delta path (None key = bare metric)
        self._member_delta: Dict[Optional[str], bool] = {}
        if _is_collection(metric):
            for k, m in metric.items(keep_base=True):
                self._member_delta[k] = m.masked_update_strategy() == "delta"
        else:
            self._member_delta[None] = metric.masked_update_strategy() == "delta"

    # ------------------------------------------------------------------ queries

    @property
    def layout(self) -> Any:
        return self._layout

    def eligible_keys(self) -> Tuple[str, ...]:
        """Dtype keys whose whole buffer updates in one megastep launch."""
        return tuple(k for k in sorted(self._by_key) if k not in self._reasons)

    def fallback_reasons(self) -> Dict[str, str]:
        """Per-dtype degradation reasons of the ineligible keys (the segment
        form has the same: no VMEM bound on the card)."""
        return dict(self._reasons)

    # ------------------------------------------------------------- step bodies

    def _mixed_deltas(self, tree: Any, args: Any, kwargs: Any, mask: torch.Tensor) -> Any:
        """The state-congruent "mixed" tree: delta members contribute their
        row-stacked deltas ``(N, *leaf)``, everything else its full
        masked-updated state."""
        m = self._metric
        n = int(mask.shape[0])
        if _is_collection(m):
            out: Dict[str, Any] = {}
            for k, mm in m.items(keep_base=True):
                fkw = mm._filter_kwargs(**kwargs)
                if self._member_delta[k]:
                    out[k] = mm._stacked_row_deltas(args, fkw, n)
                else:
                    out[k] = mm.update_state_masked(tree[k], *args, mask=mask, **fkw)
            return out
        if self._member_delta[None]:
            return m._stacked_row_deltas(args, kwargs, n)
        return m.update_state_masked(tree, *args, mask=mask, **kwargs)

    def _op_row(self, key: str, device: torch.device) -> OpRow:
        op_row = self._op_rows.get((key, device))
        if op_row is None:
            op_row = self._op_rows[(key, device)] = _op_row_info(self._ops[key], len(self._ops[key]), device)
        return op_row

    def _packed_rows(self, key: str, mixed_leaves: List[Any], n: int) -> torch.Tensor:
        """Column-aligned ``(N, F)`` delta matrix for dtype ``key``."""
        parts = [mixed_leaves[i].to(dtype).reshape(n, size) for i, _off, size, _shape, dtype in self._by_key[key]]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def apply_masked(self, arena: Dict[str, torch.Tensor], args: Any, kwargs: Any,
                     mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One masked collection step over the packed arena: eligible dtypes
        take one :func:`megastep_fold` launch each; ineligible dtypes fold
        per leaf (K1) and repack."""
        n = int(mask.shape[0])
        tree = self._layout.unpack(arena)
        mixed_leaves = tree_leaves(self._mixed_deltas(tree, args, kwargs, mask))
        state_leaves = tree_leaves(tree)
        out: Dict[str, torch.Tensor] = {}
        for key, items in self._by_key.items():
            if key not in self._reasons:
                out[key] = megastep_fold(arena[key], self._packed_rows(key, mixed_leaves, n), mask,
                                         self._op_row(key, arena[key].device))
                continue
            parts = []
            for i, _off, _size, _shape, dtype in items:
                fx = self._fx[i]
                leaf = fold_rows_masked(state_leaves[i], mixed_leaves[i], mask, fx) if fx in REDUCE_OPS \
                    else mixed_leaves[i]
                parts.append(leaf.to(dtype).reshape(-1))
            out[key] = parts[0] if len(parts) == 1 else torch.cat(parts)
        return out

    def apply_segmented(
        self,
        bufs: Dict[str, torch.Tensor],
        args: Any,
        kwargs: Any,
        mask: torch.Tensor,
        segment_ids: torch.Tensor,
        num_segments: int,
        q8_stage: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]] = None,
        q8_cols: Optional[Dict[str, np.ndarray]] = None,
    ) -> Dict[str, torch.Tensor]:
        """One segmented (multi-stream) step over the slot-stacked arena
        buffers ``(S, F)``: pager slot ids are the segment ids. ``q8_stage``
        maps eligible dtype keys to ``(flags, codes, scales)`` of staged
        q8-resident slots, decoded on touch inside the kernel (``q8_cols``
        carries each key's quantized-column mask, host bool or int32 on the
        arena's device)."""
        m = self._metric
        n = int(mask.shape[0])
        num_segments = int(num_segments)
        if q8_stage:
            bad = sorted(set(q8_stage) & set(self._reasons))
            if bad:  # pragma: no cover - the engine stages eligible dtypes only
                raise ValueError(f"q8 staging on megastep-ineligible dtypes: {bad}")
        if _is_collection(m):
            mixed = {k: mm._stacked_row_deltas(args, mm._filter_kwargs(**kwargs), n)
                     for k, mm in m.items(keep_base=True)}
        else:
            mixed = m._stacked_row_deltas(args, kwargs, n)
        mixed_leaves = tree_leaves(mixed)
        out: Dict[str, torch.Tensor] = {}
        for key, items in self._by_key.items():
            if key not in self._reasons:
                q8 = None
                if q8_stage and key in q8_stage:
                    q8 = (*q8_stage[key], q8_cols[key])
                out[key] = megastep_segment(bufs[key], self._packed_rows(key, mixed_leaves, n), mask, segment_ids,
                                            num_segments, self._op_row(key, bufs[key].device), q8=q8)
                continue
            parts = []
            for i, off, size, shape, dtype in items:
                fx = self._fx[i]
                if fx not in REDUCE_OPS:  # pragma: no cover - the engine gates earlier
                    raise ValueError(f"leaf {i} has no segmented reduction (fx={fx!r})")
                state_leaf = bufs[key][..., off : off + size].reshape((num_segments,) + shape)
                new_leaf = segment_reduce_masked(state_leaf, mixed_leaves[i], mask, segment_ids, num_segments, fx)
                parts.append(new_leaf.to(dtype).reshape(num_segments, size))
            out[key] = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return out
