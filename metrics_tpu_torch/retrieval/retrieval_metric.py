"""RetrievalMetric template base (port of ``metrics_tpu/retrieval/retrieval_metric.py``).

The built-in subclasses compute on the device: two stable sorts group every
query's documents, per-query metrics are segment reductions, and one scalar
crosses to the host (``functional/retrieval/_segment.py``). A subclass that
overrides ``_metric`` with its own logic takes the per-group host loop
instead (``_compute_host``), which is also the oracle the segment path is
tested against.

A query id is a group key: the built-in subclasses declare grouped state, so
the ragged engine (``engine/ragged.py``) serves them. Per-query ``(preds,
target)`` rows land in capacity buffers, the per-group read runs
:func:`grouped_query_score`, the device aggregate folds
:func:`batched_group_scores` through the masked row kernel, and the oracle
rebuilds these eager list states and runs ``compute()``.
"""
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.functional.retrieval._segment import (
    batched_group_scores,
    grouped_query_score,
    segment_retrieval_mean,
)
from metrics_tpu_torch.metric import GroupedAggregateSpec, GroupedField, GroupedUpdateSpec, Metric
from metrics_tpu_torch.utils.checks import _CODE_EMPTY_QUERY_RETRIEVAL, _check_retrieval_inputs, deferred_message
from metrics_tpu_torch.utils.data import dim_zero_cat, get_group_indexes
from metrics_tpu_torch.utils.device import as_input

Tensor = torch.Tensor


def check_metric_k(k: Optional[int]) -> Optional[int]:
    """A metric's ``k``: None or a positive int."""
    if (k is not None) and not (isinstance(k, int) and k > 0):
        raise ValueError("`k` has to be a positive integer or None")
    return k


class RetrievalMetric(Metric, ABC):
    """Base for retrieval metrics: per-query ``_metric`` averaged over queries."""

    higher_is_better = True
    # set on built-in subclasses to route compute through the segment path;
    # None (or a user override of _metric / _is_empty_query) takes the host loop
    _segment_kind: Optional[str] = None
    #: per-group row budget for engine serving (or pass capacity= to RaggedEngine)
    grouped_capacity: int = 256

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.allow_non_binary_target = False
        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index
        self.add_state("indexes", default=[], dist_reduce_fx=None)
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)

    def _checked(self, preds: Any, target: Any, indexes: Any) -> Tuple[Tensor, Tensor, Tensor]:
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = (as_input(x, self.device) for x in (indexes, preds, target))
        return _check_retrieval_inputs(indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target,
                                       ignore_index=self.ignore_index)

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:
        indexes, preds, target = self._checked(preds, target, indexes)
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    def _is_empty_query(self, mini_target: Tensor) -> bool:
        return not float(torch.sum(mini_target))

    def _segment_dispatch(self) -> Optional[str]:
        """The segment kind to use, or None for the host loop. A subclass that
        overrides ``_metric`` (or ``_is_empty_query``) without declaring its
        own ``_segment_kind`` gets the host loop: the class that OWNS the
        override decides, not an inherited kind."""
        mro = type(self).__mro__
        metric_owner = next(c for c in mro if "_metric" in c.__dict__)
        kind = metric_owner.__dict__.get("_segment_kind")
        if kind is None:
            return None
        empty_owner = next(c for c in mro if "_is_empty_query" in c.__dict__)
        if empty_owner is not RetrievalMetric and "_segment_kind" not in empty_owner.__dict__:
            return None
        return kind

    def compute(self) -> Tensor:
        indexes = dim_zero_cat(self.indexes)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        kind = self._segment_dispatch()
        if kind is not None and indexes.shape[0] > 0:
            return segment_retrieval_mean(preds, target, indexes, kind=kind, k=getattr(self, "k", None),
                                          empty_target_action=self.empty_target_action)
        return self._compute_host(indexes, preds, target)

    # ----------------------------------------------------------- ragged serving

    def grouped_update_spec(self) -> Optional[GroupedUpdateSpec]:
        if self._segment_dispatch() is None:
            # a custom _metric needs the host loop per group: the engine
            # cannot run arbitrary Python per group
            return None
        return GroupedUpdateSpec(
            fields=(GroupedField("preds", (), torch.float32), GroupedField("target", (), torch.float32)),
            capacity=int(self.grouped_capacity),
        )

    def grouped_encode(self, preds: Any, target: Any, indexes: Any) -> Tuple[Any, ...]:
        """One eager ``update`` call as ``(group_ids, preds, target)`` rows,
        through ``update``'s own validation (shapes, integer indexes, the
        eager ``ignore_index`` filter): the engine ingests exactly the rows
        the eager metric would append."""
        indexes, preds, target = self._checked(preds, target, indexes)
        return (
            indexes.cpu().numpy().astype(np.int32),
            preds.cpu().numpy().astype(np.float32),
            target.cpu().numpy().astype(np.float32),
        )

    def grouped_group_value(self, fields: Dict[str, Tensor], count: Tensor, capacity: int) -> Tensor:
        return grouped_query_score(fields["preds"], fields["target"], count, kind=self._segment_dispatch(),
                                   k=getattr(self, "k", None), empty_target_action=self.empty_target_action)

    def grouped_aggregate_spec(self) -> Optional[GroupedAggregateSpec]:
        """The corpus ``result()`` is a masked mean of independent per-query
        scores, so the engine folds it on the device; a custom ``_metric``
        (no segment kind) stays on the host oracle."""
        if self._segment_dispatch() is None:
            return None
        return GroupedAggregateSpec(kind="fold")

    def grouped_batch_scores(self, counts: Tensor, fields: Dict[str, Tensor], capacity: int) -> Dict[str, Tensor]:
        """Batched per-group scores for the device aggregate:
        ``{"value", "keep", "flag"}``, each ``(G,)``
        (:func:`~metrics_tpu_torch.functional.retrieval._segment.batched_group_scores`)."""
        value, keep, flag = batched_group_scores(fields["preds"], fields["target"], counts,
                                                 kind=self._segment_dispatch(), k=getattr(self, "k", None),
                                                 empty_target_action=self.empty_target_action)
        return {"value": value, "keep": keep, "flag": flag}

    def grouped_aggregate_finish(self, value: float, kept: int, flagged: int) -> Tensor:
        """Host finish of the device fold: the deferred value check of
        ``empty_target_action="error"`` (the eager path's type and message),
        else the folded mean."""
        if flagged:
            raise ValueError(deferred_message(_CODE_EMPTY_QUERY_RETRIEVAL))
        return torch.tensor(value, dtype=torch.float32, device=self.device)

    def grouped_finalize(self, counts: Any, fields: Dict[str, Any], group_ids: Any) -> Dict[str, Any]:
        """The eager list states from per-group rows: one ``(indexes, preds,
        target)`` part per non-empty group, in group-id order. Queries with no
        rows never existed (the eager semantics); a corpus with no rows gives
        one empty part, so ``dim_zero_cat`` still sees tensors. The parts are
        views of one upload per field."""
        gids = np.asarray(group_ids)
        preds, target = np.asarray(fields["preds"])[gids], np.asarray(fields["target"])[gids]
        c = np.minimum(np.asarray(counts)[gids].astype(np.int64), preds.shape[1])
        live = c > 0
        gids, c = gids[live], c[live]
        sizes = c.tolist()
        if not sizes:
            return {"indexes": [torch.zeros((0,), dtype=torch.int32, device=self.device)],
                    "preds": [torch.zeros((0,), dtype=torch.float32, device=self.device)],
                    "target": [torch.zeros((0,), dtype=torch.float32, device=self.device)]}
        take = np.arange(preds.shape[1])[None, :] < c[:, None]
        flat = {"preds": preds[live][take], "target": target[live][take]}
        out = {"indexes": np.repeat(gids, c).astype(np.int32), "preds": flat["preds"].astype(np.float32),
               "target": flat["target"].astype(np.float32)}
        return {k: list(torch.split(torch.from_numpy(v).to(self.device), sizes)) for k, v in out.items()}

    def _compute_host(self, indexes: Tensor, preds: Tensor, target: Tensor) -> Tensor:
        """The reference's per-group host loop (the oracle, and the path of a
        subclass with its own ``_metric``)."""
        res: List[Tensor] = []
        for group in get_group_indexes(indexes):
            mini_preds = preds[group]
            mini_target = target[group]
            if self._is_empty_query(mini_target):
                if self.empty_target_action == "error":
                    raise ValueError("`compute` method was provided with a query with no positive target.")
                if self.empty_target_action == "pos":
                    res.append(torch.tensor(1.0, device=self.device))
                elif self.empty_target_action == "neg":
                    res.append(torch.tensor(0.0, device=self.device))
            else:
                res.append(self._metric(mini_preds, mini_target))
        return torch.mean(torch.stack(res)) if res else torch.tensor(0.0, device=self.device)

    @abstractmethod
    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        """The metric of one query's ``(preds, target)``."""
