"""Ragged serving: group-keyed metrics through the multi-stream engine.

Port of ``metrics_tpu/engine/ragged.py``. A retrieval metric's
eager state is a BAG OF ROWS per query (``dist_reduce_fx=None`` cat lists),
which every other engine refuses. Given a static shape, the grouped state is
the multi-stream state at a finer grain (a query id is a small stream id), so
the multi-stream machinery serves it: the segmented step, megabatch
coalescing, window pane rings and the paged form that pages cold groups to
host RAM.

* **Capacity buffers**: each group carries ``capacity`` rows per payload
  field plus a ``count``. A step sorts the batch's rows by group key (one
  stable sort) and writes each row at ``count + rank``; masked rows and rows
  past capacity go to one scratch cell that no read sees (never to an
  out-of-range index: on the card that is a device-side assert), and
  ``count`` keeps the TRUE total, so an overflow is reported (NaN per group,
  a typed refusal at the aggregate read), never truncated silently. The
  step has fixed shapes only (no boolean indexing, no host read), so it is
  the captured CUDA graph of the multi-stream engine; it launches no kernel
  of K1-K7, as the JAX package's takes none.
* **Group keys ride the stream ids**: a submitted item carries a per-row
  int32 group-id array (or one scalar id); the megabatch merge broadcasts
  scalars and concatenates arrays alike.
* **Reads**: ``result(gid)``/``results()`` run the metric's
  ``grouped_group_value`` over a group's ``(capacity, ...)`` buffers
  (``results()`` batched over every group at once, with no ``vmap``). The
  aggregate ``result()`` batches the per-group scores over the stacked
  ``(G, capacity, ...)`` buffers and folds them with the masked row kernel
  (K1, four launches) into one ``(4,)`` bundle, one transfer to the host.
  Under ``group_shard`` the touched groups (resident slots and spilled rows)
  sweep in ``_AGG_BLOCK_ROWS``-row blocks, each scattered into a ``(G, 3)``
  accumulator by the segment kernel (K4), then folded by K1. The host eager
  replay (``grouped_finalize`` then the unmodified eager ``compute``) stays
  as the oracle behind ``aggregate(oracle=True)``. Every row carries its
  ingest rank in an engine-owned ``_seq`` field, and every read orders a
  group's rows by it, so rows with equal sort keys tie-break in submission
  order whatever merge or pane interleaving produced the buffers.
* **The corpus aggregate** (detection's ``MAP``, a ``"corpus"``
  :class:`~metrics_tpu_torch.metric.GroupedAggregateSpec`): the metric plans
  the device pass off the host counts and its scan fields; one
  ``grouped_corpus_device`` over the stacked buffers in ingest order (the
  greedy matcher K9 over every (class, image) problem in one launch), one
  copy of its bundle to the host, and the metric's host finish. A plan that
  declines (an empty corpus, a bundle past the metric's budget) and
  ``group_shard`` (groups paged out) take the oracle.

On a mesh (``EngineConfig(mesh=..., mesh_sync="deferred")``): each shard
carries the ``(G, capacity, ...)`` buffers of the rows it was sent, and a
read merges them at the boundary through
:meth:`GroupedStateMetric.sync_states`, one fused ``all_gather`` of every
leaf then the replica-major compaction, so the per-group reads, the fold
aggregate and the corpus aggregate run on the merged state. Under
``group_shard`` group ``g`` lives on shard ``g % W`` and pages through that
shard's slots (``resident_groups`` a shard), and the paged sweep takes every
shard's touched rows. The same merge runs over a process group. The JAX
package's aggregate jaxpr audit has no counterpart.
"""
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.engine.aot import AotCache
from metrics_tpu_torch.engine.multistream import MultiStreamEngine, _values_to_host
from metrics_tpu_torch.engine.pipeline import EngineConfig, resolve_kernel_backend
from metrics_tpu_torch.metric import GroupedUpdateSpec, Metric, distributed_available
from metrics_tpu_torch.ops.kernels import fold_rows_masked, segment_reduce_masked
from metrics_tpu_torch.utils.checks import traced_rows
from metrics_tpu_torch.utils.device import as_input
from metrics_tpu_torch.parallel.collectives import fused_axis_sync
from metrics_tpu_torch.parallel.mesh import MeshAxis
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

# the paged aggregate sweep's fixed block: one block shape serves any touched
# population (the last block pads with ok=False rows)
_AGG_BLOCK_ROWS = 1024

# what _aggregate_corpus returns when the metric's plan declines the device
# pass (an empty corpus, a class universe past the device budget): the
# aggregate reroutes to the host oracle
_CORPUS_FALLBACK = object()

__all__ = ["GroupedStateMetric", "RaggedEngine"]


def _bundle_to_host(bundle: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A dict of device tensors as numpy arrays of the same dtypes and
    shapes, through ONE device-to-host copy: each tensor's bytes are laid end
    to end in one uint8 buffer and read back as views."""
    parts, layout = [], []
    for name, t in bundle.items():
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        parts.append(flat)
        layout.append((name, torch.empty((0,), dtype=t.dtype).numpy().dtype, tuple(t.shape), flat.numel()))
    host = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.uint8)
    out, offset = {}, 0
    for name, dtype, shape, nbytes in layout:
        out[name] = host[offset:offset + nbytes].view(dtype).reshape(shape)
        offset += nbytes
    return out


class GroupedStateMetric(Metric):
    """Engine-internal wrapper giving a group-keyed metric a STATIC state.

    One group's state is ``count`` (0-d int32, the TRUE number of rows ever
    ingested; past capacity is the overflow signal) plus one
    ``(capacity,) + field.shape`` buffer per spec field, and the
    engine-owned ``_seq`` buffer of ingest ranks. The engine stacks a
    leading group axis over it like any multi-stream state.

    The wrapped metric is kept in ``__dict__`` under ``__grouped_inner__``,
    not as a child module: its LIST states stay out of this wrapper's state
    (the ingest step depends only on the capacity and the fields).
    """

    full_state_update = False

    def __init__(self, metric: Any, capacity: Optional[int] = None) -> None:
        super().__init__(device=metric.device)
        spec = metric.grouped_update_spec()
        if spec is None or not isinstance(spec, GroupedUpdateSpec):
            raise MetricsTPUUserError(
                f"{type(metric).__name__} declares no grouped_update_spec(); only group-keyed metrics (retrieval, "
                "detection) serve through the ragged path"
            )
        cap = int(capacity) if capacity is not None else int(spec.capacity)
        if cap <= 0:
            raise MetricsTPUUserError(f"ragged capacity must be a positive int, got {capacity!r}")
        self._capacity = cap
        # the engine-owned "_seq" field rides last: each row's global ingest
        # rank, the stable secondary key every read orders a group's rows by
        self._user_field_names: Tuple[str, ...] = spec.field_names()
        self._field_names: Tuple[str, ...] = self._user_field_names + ("_seq",)
        shapes = tuple(tuple(int(d) for d in f.shape) for f in spec.fields) + ((),)
        dtypes = tuple(f.dtype for f in spec.fields) + (torch.int32,)
        # count declares fx=None, as in the JAX package: a merge needs the
        # per-replica counts (they are the buffers' validity)
        self.add_state("count", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx=None)
        for name, shape, dtype in zip(self._field_names, shapes, dtypes):
            self.add_state("buf_" + name, default=torch.zeros((cap,) + shape, dtype=dtype), dist_reduce_fx=None)
        self.__dict__["__grouped_inner__"] = metric

    def _inner(self) -> Any:
        return self.__dict__["__grouped_inner__"]

    @property
    def capacity(self) -> int:
        return self._capacity

    def update(self, *args: Any, **kwargs: Any) -> None:
        raise MetricsTPUUserError(
            "GroupedStateMetric ingests through the ragged engine's segmented step only; call the wrapped "
            "metric's update() for eager use"
        )

    def compute(self) -> Any:
        """ONE group's value from its capacity buffers (the per-group read of
        ``result(gid)``), its rows in ingest order."""
        tree = {"count": self.count[None], **{"buf_" + n: getattr(self, "buf_" + n)[None] for n in self._field_names}}
        fields = {k: v[0] for k, v in self.seq_ordered_fields(tree).items()}
        return self._inner().grouped_group_value(fields, self.count, self._capacity)

    def group_values(self, tree: Dict[str, Any]) -> Any:
        """Every group's per-group read from a ``(G, ...)``-stacked tree, in
        one batched computation."""
        return self._inner().grouped_group_value(self.seq_ordered_fields(tree), tree["count"], self._capacity)

    def seq_ordered_fields(self, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The user-named field buffers with every group's valid rows in
        ingest (``_seq``) order: ``tree`` leaves lead with the group axis
        (``count`` ``(G,)``, buffers ``(G, capacity, ...)``). Valid rows hold
        unique ranks, so the gather permutes the valid prefix; invalid slots
        key to the int32 maximum and sink to the tail (every consumer masks
        them by ``count``)."""
        cap = self._capacity
        counts = tree["count"].to(torch.int32)
        valid = torch.arange(cap, device=counts.device)[None, :] < torch.clamp_max(counts, cap)[:, None]
        key = torch.where(valid, tree["buf__seq"].to(torch.int32), torch.iinfo(torch.int32).max)
        order = torch.argsort(key, dim=1, stable=True)
        out: Dict[str, torch.Tensor] = {}
        for name in self._user_field_names:
            v = tree["buf_" + name]
            idx = order.reshape(order.shape + (1,) * (v.ndim - 2)).expand(v.shape)
            out[name] = torch.gather(v, 1, idx)
        return out

    # ------------------------------------------------------------ engine contract

    def segmented_update_unsupported_reason(self) -> Optional[str]:
        return None

    def stacked_merge_unsupported_reason(self) -> Optional[str]:
        return None

    def update_state_segmented(self, state: Dict[str, Any], *args: Any, mask: Any, segment_ids: Any,
                               num_segments: int, **kwargs: Any) -> Dict[str, Any]:
        """The grouped capacity write, fixed-shape: one stable sort of the
        rows by group key, then one gather-free write per field.

        Masked rows get the key ``num_segments``; they and the rows past
        capacity are written to a scratch cell past the buffers, which the
        result drops, while ``count`` keeps every group's true total. Within
        a batch a group's rows land in batch order (a stable sort and each
        row's rank in its run)."""
        if kwargs:
            raise MetricsTPUUserError(f"grouped ingestion takes positional field rows only; got kwargs {sorted(kwargs)}")
        if len(args) != len(self._field_names):
            raise MetricsTPUUserError(
                f"grouped ingestion expects {len(self._field_names)} field arrays "
                f"({', '.join(self._field_names)}), got {len(args)}"
            )
        count = state["count"]
        dev = count.device
        mask = as_input(mask, dev).to(torch.bool)
        ids = as_input(segment_ids, dev).to(torch.int64)
        n = mask.shape[0]
        cap = self._capacity
        seg_key = torch.where(mask, ids, num_segments)
        sseg, order = torch.sort(seg_key, stable=True)
        smask = mask[order]
        pos = torch.arange(n, device=dev)
        run_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), sseg[1:] != sseg[:-1]])
        rank = pos - torch.cummax(torch.where(run_start, pos, 0), dim=0).values  # offset in the group's run
        write_pos = count[torch.clamp_max(sseg, num_segments - 1)].to(torch.int64) + rank
        # masked rows count into the scratch cell num_segments, dropped after
        counts = torch.cat([count, count.new_zeros((1,))]).index_add(0, sseg, smask.to(count.dtype))
        out = dict(state)
        out["count"] = counts[:num_segments]
        scratch = num_segments * cap
        dest = torch.where(smask & (write_pos < cap), sseg * cap + write_pos, scratch)
        for i, name in enumerate(self._field_names):
            buf = state["buf_" + name]
            suffix = tuple(buf.shape[2:])
            rows = as_input(args[i], dev)[order].to(buf.dtype)
            flat = torch.cat([buf.reshape((scratch,) + suffix), buf.new_zeros((1,) + suffix)])
            out["buf_" + name] = flat.index_put((dest,), rows)[:scratch].reshape(buf.shape)
        return out

    def sync_states(self, state: Dict[str, Any], group: Optional[Any] = None) -> Dict[str, Any]:
        """The grouped merge over ``group`` (a process group, or a mesh axis
        whose ``state`` is the list of the W shards' states): every leaf,
        ``count`` and buffers alike, rides ONE fused ``all_gather`` bundle
        stacked ``(world, ...)`` (``fused_axis_sync`` with no reduction), then
        :meth:`merge_stacked_states` compacts each group's rows
        replica-major, in rank (shard) order, on every participant. A psum'd
        count beside world-stacked buffers would be no logical state, so the
        per-leaf default cannot serve. Outside a group of more than one rank
        the state comes back as it is."""
        group = self._group(group)
        if not distributed_available(group):
            return state
        if not isinstance(group, MeshAxis):
            keys = sorted(state)
            gathered = fused_axis_sync([(None, as_input(state[k], self.device)) for k in keys], group)
            return self.merge_stacked_states(dict(zip(keys, gathered)))
        keys = sorted(state[0])
        gathered = fused_axis_sync([(None, [s[k] for s in state]) for k in keys], group)
        merged: Dict[int, Dict[str, Any]] = {}  # one merge a distinct gathered copy (one on a one-device mesh)
        out = []
        for w in range(group.world):
            col = [g[w] for g in gathered]
            if id(col[0]) not in merged:
                merged[id(col[0])] = self.merge_stacked_states(dict(zip(keys, col)))
            out.append(merged[id(col[0])])
        return out

    def merge_stacked_states(self, stacked: Dict[str, Any]) -> Dict[str, Any]:
        """Fold a leading stack axis of grouped states: counts SUM; buffers
        COMPACT, each group's valid rows of all P replicas packed to the front
        of one capacity buffer, replica-major (the order a cat merge
        concatenates in). Any middle axes between the stack axis and the
        capacity axis (a ``(P, S, ...)`` pane ring) are kept."""
        cap = self._capacity
        count = stacked["count"]
        p = count.shape[0]
        mid = tuple(count.shape[1:])
        out: Dict[str, Any] = {"count": count.sum(dim=0).to(count.dtype)}
        cflat = count.reshape(p, -1)
        g = cflat.shape[1]
        valid = torch.arange(cap, device=count.device)[None, None, :] < torch.clamp_max(cflat, cap)[:, :, None]
        vflat = valid.permute(1, 0, 2).reshape(g, p * cap)
        # stable argsort of ~valid: per group, its valid (replica, slot)
        # indices first, in order: the compaction's gather map
        take = torch.argsort((~vflat).to(torch.int8), dim=1, stable=True)[:, :cap]
        for name in self._field_names:
            v = stacked["buf_" + name]
            suffix = tuple(v.shape[1 + len(mid) + 1:])
            rows = v.reshape((p, g, cap) + suffix).movedim(0, 1).reshape((g, p * cap) + suffix)
            idx = take.reshape((g, cap) + (1,) * len(suffix)).expand((g, cap) + suffix)
            out["buf_" + name] = torch.gather(rows, 1, idx).reshape(mid + (cap,) + suffix)
        return out


class RaggedEngine(MultiStreamEngine):
    """Serve a group-keyed metric: ``num_groups`` groups (query ids), per-row
    group keys, capacity-buffer state, the device aggregate.

    Args:
        metric: a metric declaring ``grouped_update_spec()`` (the built-in
            retrieval metrics, detection's ``MAP``).
        num_groups: the group-key universe: keys are ``0 <= gid < num_groups``.
        config: engine config; composes with ``WindowPolicy``.
        aot_cache: optional shared capture cache.
        capacity: per-group row budget (default: the metric's spec).
        group_shard: the paged form: cold groups spill to host RAM.
        resident_groups: the paged form's slot count (see
            ``resident_streams``).
        aggregate_oracle: pin the aggregate ``result()`` to the host eager
            replay (``grouped_finalize`` then the eager ``compute``); per
            call, ``aggregate(oracle=...)``.

    ``submit(group_ids, *fields)`` takes one scalar group id for a
    single-group batch or a per-row int array; ``submit_update(*eager_args)``
    takes the metric's own ``update`` signature through ``grouped_encode``.
    ``result(gid)``/``results()`` are the per-group reads; ``result()`` with
    no argument is the aggregate.
    """

    def __init__(
        self,
        metric: Any,
        num_groups: int,
        config: Optional[EngineConfig] = None,
        aot_cache: Optional[AotCache] = None,
        capacity: Optional[int] = None,
        group_shard: bool = False,
        resident_groups: Optional[int] = None,
        aggregate_oracle: bool = False,
    ):
        spec = getattr(metric, "grouped_update_spec", lambda: None)()
        if spec is None:
            raise MetricsTPUUserError(
                f"RaggedEngine serves group-keyed metrics only: {type(metric).__name__} declares no "
                "grouped_update_spec() (built-in retrieval metrics with a segment kind do)"
            )
        if config is not None and resolve_kernel_backend(config.kernel_backend) == "megastep":
            raise MetricsTPUUserError(
                "ragged serving has no megastep form: the grouped capacity write (the INGEST scatter) is a 2-d "
                "scatter outside the per-column opcode grid; the AGGREGATE takes the masked row kernels (K1, "
                "K4) — use kernel_backend=None or 'auto'"
            )
        self._user_metric = metric
        wrapped = GroupedStateMetric(metric, capacity=capacity)
        self._capacity = wrapped.capacity
        self._n_fields = len(spec.fields)
        super().__init__(wrapped, num_streams=num_groups, config=config, aot_cache=aot_cache,
                         stream_shard=group_shard, resident_streams=resident_groups)
        self._stats.ragged_groups = int(num_groups)
        self._stats.ragged_capacity = int(self._capacity)
        self._aggregate_oracle = bool(aggregate_oracle)
        # the global ingest-rank counter behind the "_seq" field; snapshotted,
        # so replayed rows after a resume order after every restored row
        self._ingest_seq = 0
        self._seq_lock = threading.Lock()

    @property
    def num_groups(self) -> int:
        return self._num_streams

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def user_metric(self) -> Any:
        return self._user_metric

    # ------------------------------------------------------------------- producers

    def _check_group_ids(self, group_ids: Any, fields: Tuple[Any, ...]) -> Tuple[Any, int]:
        if len(fields) != self._n_fields:
            raise MetricsTPUUserError(
                f"ragged submit expects {self._n_fields} field arrays "
                f"({', '.join(self._metric._user_field_names)}), got {len(fields)}"
            )
        n = int(np.shape(fields[0])[0]) if np.ndim(fields[0]) else 0
        for f in fields[1:]:
            if int(np.shape(f)[0]) != n:
                raise MetricsTPUUserError("ragged submit field arrays must share their leading (row) dim")
        if np.ndim(group_ids) == 0:
            return self._check_stream(group_ids), n
        gids = group_ids.cpu().numpy() if isinstance(group_ids, torch.Tensor) else np.asarray(group_ids)
        if gids.ndim != 1 or gids.shape[0] != n:
            raise MetricsTPUUserError(
                f"group_ids must be a scalar or a 1-d array of length {n} (one key per row), got shape {gids.shape}"
            )
        if gids.size and (int(gids.min()) < 0 or int(gids.max()) >= self._num_streams):
            raise MetricsTPUUserError(
                f"group_ids out of range [0, {self._num_streams}): min={int(gids.min())}, max={int(gids.max())}"
            )
        return gids.astype(np.int32), n

    def submit(self, group_ids: Any, *fields: Any, timeout: Optional[float] = None,  # type: ignore[override]
               **kwargs: Any) -> None:
        """Enqueue rows of one group (a scalar id) or many (a per-row id array)."""
        gids, n = self._check_group_ids(group_ids, fields)
        if n == 0:
            return
        self._raise_if_failed()
        self.start()
        # each row's global ingest rank, allocated under its own lock so
        # concurrent producers get disjoint, submission-ordered runs
        with self._seq_lock:
            seq0 = self._ingest_seq
            self._ingest_seq = seq0 + n
        fields = tuple(fields) + (np.arange(seq0, seq0 + n, dtype=np.int32),)
        n_groups = 1 if np.ndim(gids) == 0 else int(np.unique(gids).size)
        self._stats.record_ragged_submit(rows=n, groups=n_groups)
        item = (gids, fields, kwargs)
        if self._admission is not None:
            # a mixed-group batch is admitted under its FIRST row's group
            admit = int(gids) if np.ndim(gids) == 0 else int(gids[0])
            self._admitted_submit(admit, item, (fields, kwargs), timeout)
        else:
            self._submit_item(item, timeout)

    def submit_update(self, *args: Any, timeout: Optional[float] = None, **kwargs: Any) -> None:
        """Submit in the metric's own eager ``update`` signature, validated
        and flattened by its ``grouped_encode``."""
        encoded = self._user_metric.grouped_encode(*args, **kwargs)
        self.submit(encoded[0], *encoded[1:], timeout=timeout)

    def _item_context(self, item: Any) -> Dict[str, Any]:
        gids = item[0]
        if np.ndim(gids) == 0:
            return {"stream_id": int(gids)}
        return {"group_ids": [int(x) for x in np.unique(gids)[:32]]}

    def _group_context(self, group: List[Any]) -> Dict[str, Any]:
        ids: set = set()
        for it in group:
            if isinstance(it, tuple) and len(it) == 3:
                ids.update(int(x) for x in np.atleast_1d(np.asarray(it[0])).ravel())
        return {"group_ids": sorted(ids)[:64]} if ids else {}

    # --------------------------------------------------------------------- readers

    def result(self, group_id: Optional[int] = None) -> Any:  # type: ignore[override]
        """``result(gid)``: one group's value; ``result()``: the aggregate."""
        if group_id is None:
            return self.aggregate()
        return super().result(group_id)

    def results(self) -> Dict[int, Any]:
        """Every group's value, on the host, from ONE batched computation over
        the stacked buffers (the per-group read of every group at once) and
        one device-to-host copy."""
        self.flush()
        with self._device_section(), traced_rows():
            values = self._metric.group_values(self._stacked_tree())
            self._stats.result_device_calls += 1
            per_group = _values_to_host(values, self._num_streams)
        return dict(enumerate(per_group))

    def _drift_values_locked(self) -> List[Tuple[Optional[int], Any]]:
        """Every group's closing-pane value, one series per group, batched."""
        tree = self._closing_pane_tree()
        with traced_rows():
            return list(enumerate(_values_to_host(self._metric.group_values(tree), self._num_streams)))

    # ------------------------------------------------------------ the aggregate

    def aggregate_path(self) -> Tuple[str, str]:
        """Which path ``aggregate()`` takes and why: ``("device", reason)``
        or ``("oracle", reason)``; no work done."""
        if self._aggregate_oracle:
            return ("oracle", "aggregate_oracle=True pinned at construction")
        spec = getattr(self._user_metric, "grouped_aggregate_spec", lambda: None)()
        if spec is None:
            return ("oracle", f"{type(self._user_metric).__name__} declares no grouped_aggregate_spec()")
        if spec.kind == "fold":
            if self._stream_shard and self._pane_rows > 1 and self._window.kind == "sliding":
                return ("oracle", "group_shard + sliding panes: the pane ring folds through the host row universe")
            if self._stream_shard:
                return ("device", "batched fold over a capacity-blocked paged sweep")
            return ("device", "batched fold over the stacked buffers")
        if spec.kind == "corpus":
            if self._stream_shard:
                return ("oracle", "corpus aggregates need every group in one device pass; group_shard pages groups out")
            return ("device", "corpus device bundle + host curve interpolation")
        return ("oracle", f"unknown aggregate kind {spec.kind!r}")

    def aggregate(self, oracle: Optional[bool] = None) -> Any:
        """The corpus-level value: the device path by default (see
        :meth:`aggregate_path`); ``oracle=True`` forces the host eager replay
        for this call (``None`` keeps the construction flag)."""
        self.flush()
        use_oracle = self._aggregate_oracle if oracle is None else bool(oracle)
        if not use_oracle:
            use_oracle = self.aggregate_path()[0] != "device"
        if use_oracle:
            self._stats.record_ragged_aggregate("oracle")
            return self._aggregate_oracle_value()
        if self._user_metric.grouped_aggregate_spec().kind == "corpus":
            value = self._aggregate_corpus()
            if value is _CORPUS_FALLBACK:
                self._stats.record_ragged_aggregate("oracle")
                return self._aggregate_oracle_value()
            return value
        if self._stream_shard:
            return self._aggregate_fold_paged()
        return self._aggregate_fold()

    def _aggregate_oracle_value(self) -> Any:
        """The host eager replay: every group's rows in ingest order, the
        metric's eager list states rebuilt by ``grouped_finalize``, the
        unmodified eager ``compute``."""
        counts, fields = self._gather_groups()
        self._check_overflow(counts)
        state = self._user_metric.grouped_finalize(counts, fields, np.arange(self._num_streams, dtype=np.int64))
        return self._user_metric.compute_from(state)

    def _check_overflow(self, counts: np.ndarray) -> None:
        """The typed overflow raise both aggregate paths share, off the
        ``(G,)`` count vector on the host."""
        over = np.flatnonzero(counts > self._capacity)
        if over.size:
            self._stats.record_ragged_overflow(int(over.size))
            shown = ", ".join(f"{int(g)} ({int(counts[g])} rows)" for g in over[:8])
            raise MetricsTPUUserError(
                f"ragged capacity overflow: {over.size} group(s) exceeded capacity={self._capacity} — {shown}"
                f"{', ...' if over.size > 8 else ''}; rebuild the engine with a larger capacity= (rows past "
                "capacity were dropped, counts kept)"
            )

    def _batch_scores(self, tree: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(value, keep, flag, counts)`` of every group of a ``(G, ...)``
        tree, batched."""
        counts = tree["count"].to(torch.int32)
        out = self._user_metric.grouped_batch_scores(counts, self._metric.seq_ordered_fields(tree), self._capacity)
        return out["value"].to(torch.float32), out["keep"].to(torch.bool), out["flag"].to(torch.bool), counts

    @staticmethod
    def _fold_bundle(value: torch.Tensor, keep: torch.Tensor, flag: torch.Tensor,
                     overflow: torch.Tensor) -> torch.Tensor:
        """Per-group ``(G,)`` scores folded by three masked sums (K1 on the
        card) into the ``(4,)`` bundle ``[value, kept, flagged, overflow]``."""
        zero = torch.zeros((), dtype=torch.float32, device=value.device)
        ones = torch.ones_like(value)
        total = fold_rows_masked(zero, value, keep, "sum")
        kept = fold_rows_masked(zero, ones, keep, "sum")
        flagged = fold_rows_masked(zero, ones, flag, "sum")
        result = torch.where(kept > 0, total / torch.clamp_min(kept, 1.0), 0.0)
        return torch.stack([result, kept, flagged, overflow])

    def _aggregate_finish(self, bundle: torch.Tensor) -> Any:
        """The host finish of a fold bundle: the four scalars in ONE transfer,
        the overflow raise off the count vector if any group overflowed, then
        the metric's finish hook."""
        value, kept, flagged, overflow = bundle.cpu().tolist()
        if overflow:
            with self._device_section():
                self._check_overflow(self._stacked_tree()["count"].cpu().numpy())
        return self._user_metric.grouped_aggregate_finish(value, int(kept), int(flagged))

    def _aggregate_fold(self) -> Any:
        """The unsharded fold aggregate: one batched computation over the
        logical state (the window's fold included), four K1 folds, one
        transfer."""
        with self._device_section():
            value, keep, flag, counts = self._batch_scores(self._stacked_tree())
            zero = torch.zeros((), dtype=torch.float32, device=value.device)
            overflow = fold_rows_masked(zero, torch.ones_like(value), counts > self._capacity, "sum")
            bundle = self._fold_bundle(value, keep, flag, overflow)
            self._stats.result_device_calls += 1
        value = self._aggregate_finish(bundle)
        self._stats.record_ragged_aggregate("device")
        return value

    # ---------------------------------------------------------- the corpus aggregate

    def _aggregate_corpus(self) -> Any:
        """Detection's corpus aggregate, eagerly: the host counts and the
        metric's scan fields, the metric's plan (``_CORPUS_FALLBACK`` when it
        declines), one ``grouped_corpus_device`` over the stacked buffers (the
        window's fold included) in ingest order, ONE copy of its bundle to
        the host, then the metric's host finish."""
        user = self._user_metric
        with self._device_section():
            tree = self._stacked_tree()
            counts = tree["count"].cpu().numpy()
            scan = {name: tree["buf_" + name].cpu().numpy() for name in user.grouped_corpus_scan_fields()}
            self._check_overflow(counts)
            plan = user.grouped_corpus_plan(counts, scan)
            if plan is None:
                return _CORPUS_FALLBACK
            classes = np.asarray(plan["classes_padded"], np.int32)
            cls_valid = np.arange(classes.shape[0]) < int(plan["n_classes"])
            dev = tree["count"].device
            bundle = user.grouped_corpus_device(tree["count"], self._metric.seq_ordered_fields(tree),
                                                torch.from_numpy(classes).to(dev), torch.from_numpy(cls_valid).to(dev),
                                                self._capacity)
            self._stats.result_device_calls += 1
            fetched = _bundle_to_host(bundle)
        self._stats.record_ragged_aggregate("device")
        return user.grouped_corpus_finish(fetched, plan)

    # ------------------------------------------------------ the paged fold sweep

    def _swept_rows_locked(self) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """The paged sweep's work list: ``(gids (M,), {dtype: (M, n)})``, the
        packed rows of every TOUCHED group (resident slots from the arena,
        spilled groups from the pager's host store), never the dense ``(G,
        n)`` universe. A group both resident and spilled keeps the spilled
        copy, as the row reassembly does."""
        carried = self._stacked_carried() if self._mesh is not None else {k: v[None] for k, v in self._state.items()}
        arena = {k: v.cpu().numpy() for k, v in carried.items()}  # (W, resident, n)
        payload = self._decoded_pager_payload(self._pager.snapshot_payload(), self._row_codec)
        world, num = self._world, self._num_streams
        parts_g: List[np.ndarray] = []
        parts_r: Dict[str, List[np.ndarray]] = {k: [] for k in arena}
        slots = np.asarray(payload["slots"])
        w_idx, j_idx = np.nonzero(slots >= 0)
        if w_idx.size:
            sid, pane = self._ext_to_sid_pane(slots[w_idx, j_idx].astype(np.int64) * world + w_idx)
            keep = (sid < num) & self._pane_open(pane)
            parts_g.append(sid[keep])
            for k in arena:
                parts_r[k].append(arena[k][w_idx[keep], j_idx[keep]])
        coords = np.asarray(payload.get("spill_coords", np.zeros((0, 2), np.int64))).reshape(-1, 2)
        if coords.size:
            sid, pane = self._ext_to_sid_pane(coords[:, 1].astype(np.int64) * world + coords[:, 0].astype(np.int64))
            keep = (sid < num) & self._pane_open(pane)
            parts_g.append(sid[keep])
            for k in arena:
                parts_r[k].append(np.asarray(payload[f"spill_{k}"])[keep])
        if not parts_g:
            return np.zeros((0,), np.int64), {k: np.zeros((0, v.shape[-1]), v.dtype) for k, v in arena.items()}
        gids = np.concatenate(parts_g)
        rows = {k: np.concatenate(parts_r[k], axis=0) for k in arena}
        # keep the LAST copy of a repeated gid (the spilled one)
        _, last = np.unique(gids[::-1], return_index=True)
        sel = np.sort(gids.size - 1 - last)
        return gids[sel], {k: v[sel] for k, v in rows.items()}

    def _ext_to_sid_pane(self, ext: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Extended row ids (``row * W + shard``, the pager row
        ``(sid // W) * panes + pane`` under a ring) back to ``(sid, pane)``."""
        if self._pane_rows == 1:
            return ext, np.zeros_like(ext)
        w = ext % self._world
        q = ext // self._world
        return (q // self._pane_rows) * self._world + w, q % self._pane_rows

    def _pane_open(self, pane: np.ndarray) -> np.ndarray:
        """The rows of the aggregate's pane view: all of them unwindowed, the
        open pane of a tumbling ring (sliding + ``group_shard`` takes the
        oracle)."""
        if self._pane_rows == 1:
            return np.ones_like(pane, dtype=bool)
        return pane == self._pane_cursor

    def _aggregate_fold_paged(self) -> Any:
        """The ``group_shard`` fold aggregate: every touched group's packed
        row sweeps through ``_AGG_BLOCK_ROWS``-row blocks (one block per
        1024 touched groups, never one dispatch per group): each block's
        scores scatter into the ``(G, 3)`` accumulator ``[value, kept,
        flagged]`` through K4 (each touched group owns one swept row, so the
        scatter-sum is an assignment), its overflow count folds through K1,
        and the accumulator closes with three K1 folds into the bundle."""
        b_rows = _AGG_BLOCK_ROWS
        g, dev = self._num_streams, self._device
        with self._device_section():
            gids, rows = self._swept_rows_locked()
            acc = torch.zeros((g, 3), dtype=torch.float32, device=dev)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            n_over = zero
            m = int(gids.shape[0])
            n_blocks = max(1, -(-m // b_rows))
            for b in range(n_blocks):
                lo = b * b_rows
                k = max(0, min(b_rows, m - lo))
                blk_g = np.zeros((b_rows,), np.int32)
                blk_ok = np.zeros((b_rows,), bool)
                blk_g[:k] = gids[lo:lo + k]
                blk_ok[:k] = True
                blk = {}
                for key, v in rows.items():
                    pad = np.zeros((b_rows, v.shape[-1]), v.dtype)
                    pad[:k] = v[lo:lo + k]
                    blk[key] = torch.from_numpy(pad).to(dev, self._state_dtype(key))
                ok = torch.from_numpy(blk_ok).to(dev)
                value, keep, flag, counts = self._batch_scores(self._layout.unpack_stacked(blk))
                keep, flag, over = keep & ok, flag & ok, (counts > self._capacity) & ok
                cols = torch.stack([torch.where(keep, value, 0.0), keep.to(torch.float32), flag.to(torch.float32)],
                                   dim=1)
                acc = segment_reduce_masked(acc, cols, keep | flag | over, torch.from_numpy(blk_g).to(dev), g, "sum")
                n_over = n_over + fold_rows_masked(zero, torch.ones_like(value), over, "sum")
                self._stats.result_device_calls += 1
            bundle = self._fold_bundle(acc[:, 0], acc[:, 1] > 0, acc[:, 2] > 0, n_over)
            self._stats.result_device_calls += 1
        value = self._aggregate_finish(bundle)
        self._stats.record_ragged_aggregate("device", blocks=n_blocks)
        return value

    def _gather_groups(self) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Host numpy ``(counts (G,), {field: (G, capacity, ...)})`` of the
        logical per-group state, window panes folded (a tumbling ring's open
        pane, a sliding ring's compaction merge), each group's valid rows in
        ingest order; the engine-owned ``_seq`` field is not returned."""
        with self._device_section():
            tree = self._stacked_tree()
            counts = tree["count"].cpu().numpy()
            raw = {name: tree["buf_" + name].cpu().numpy() for name in self._metric._field_names}
        cap = self._capacity
        seq = raw.pop("_seq")
        filled = np.minimum(counts, cap)
        key = np.where(np.arange(cap)[None, :] < filled[:, None], seq, np.iinfo(np.int32).max)
        order = np.argsort(key, axis=1, kind="stable")
        fields = {}
        for name, v in raw.items():
            fields[name] = np.take_along_axis(v, order.reshape(order.shape + (1,) * (v.ndim - 2)), axis=1)
        return counts, fields

    # --------------------------------------------------------- snapshot provenance

    def _snapshot_meta_extra(self) -> Dict[str, Any]:
        extra = super()._snapshot_meta_extra()
        # the ingest-rank counter: restored rows keep their ranks (all below
        # it), replayed and new rows allocate from here on
        extra.update(ragged=1, ragged_capacity=self._capacity, ragged_groups=self._num_streams,
                     ragged_seq=int(self._ingest_seq))
        return extra

    def _restore_commit(self, state: Any, meta: Dict[str, Any]) -> None:
        if not bool(int(meta.get("ragged", 0) or 0)):
            raise MetricsTPUUserError(
                "snapshot was not written by a ragged engine: plain stream rows carry no group-key provenance a "
                "RaggedEngine could seat — restore it into the engine kind that wrote it"
            )
        cap = int(meta.get("ragged_capacity", 0) or 0)
        if cap != self._capacity:
            raise MetricsTPUUserError(
                f"ragged snapshot was written at capacity={cap}, this engine serves capacity={self._capacity}; "
                "per-group buffer columns only mean row slots under the capacity that wrote them — restore with "
                "a matching capacity= engine"
            )
        g = int(meta.get("ragged_groups", 0) or 0)
        if g != self._num_streams:
            raise MetricsTPUUserError(f"ragged snapshot serves {g} groups, this engine {self._num_streams}")
        with self._seq_lock:
            self._ingest_seq = max(self._ingest_seq, int(meta.get("ragged_seq", 0) or 0))
        super()._restore_commit(state, meta)
