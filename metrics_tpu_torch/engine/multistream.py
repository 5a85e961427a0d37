"""Multi-stream serving: S independent evaluation streams through one engine.

Port of the synchronous core of ``metrics_tpu/engine/multistream.py``. Two
forms:

* **Unsharded** (default): every state leaf gains a leading stream axis of
  length ``num_streams``; a step takes ``(state, (stream_ids,) + batch,
  mask)`` and the vmapped per-row deltas fold into the addressed stream rows
  with each state's own reduction (``Metric.update_state_segmented``: one K4
  launch per leaf on the card). The stream-stacked arena packs the stream axis
  inside each leaf's columns, so no op row describes it: under
  ``kernel_backend="megastep"`` this form records ``engine:stacked_layout``
  and keeps K4.
* **Paged** (``stream_shard=True``): the JAX package's stream-sharded engine.
  The carried state is one ``(resident, n)`` slot-stacked buffer per dtype
  per shard, where ``n`` is one stream's packed arena row; an LRU pager
  (``engine/paging.py``) spills cold streams' rows to host RAM and faults
  them back in on their next submit, so device memory is bounded by the
  working set, not by S. Pager slot ids are the segment ids. Under
  ``"megastep"`` the step is :meth:`MegastepPlan.apply_segmented`: one K6
  launch per eligible dtype, and with ``compress_payloads=True`` the dtypes
  the q8 codec compresses take K7 on every step, which decodes the slots
  paged in as int8 codes on touch ("q8-resident" rows: the host never
  dequantizes them). Without a mesh it runs at world 1; on a mesh
  (``mesh_sync="deferred"``) stream ``sid`` lives on shard ``sid % W`` as
  local stream ``sid // W``, the host routes each round's rows to their
  shards (each shard's block padded to ``bucket / W``) and every shard's
  step folds only its own streams, with no collective.
* **Deferred on a mesh** (the unsharded form with ``mesh_sync="deferred"``):
  each shard carries its own ``(S, ...)`` state of the rows it was sent;
  reads merge them at the boundary (``pipeline.py``).

``submit(stream_id, ...)`` enqueues ``(stream_id, args, kwargs)`` for the
dispatcher thread of :class:`~metrics_tpu_torch.engine.pipeline.StreamingEngine`.
Stream ids never block coalescing: queued batches of different streams form
one megabatch whose per-row id column carries them, and the paged form routes
it in rounds of at most ``resident`` distinct streams. The pager's plan,
spills and page-ins and the q8 flag clearing run on the engine stream outside
any graph; only the segment step is captured (its slot ids are a fixed device
buffer, its q8 staging a fixed set of buffers). ``results()`` computes every
stream's value in ONE batched computation for any S (``torch.func.vmap`` of
the metric's ``compute_from`` over the stream axis; the paged form first
assembles every stream's row on the device) and copies the values to the
host once.

Snapshots (``engine/pipeline.py``): the paged form's snapshot is its arena
(as the JAX package's ``(world, resident, n)`` buffers, encoded through the
row codec under ``compress_payloads``) plus the pager's payload (slot table
and spilled rows), so rows living in host RAM survive a kill; staged q8 rows
are seated first. ``restore`` follows the JAX package's stream-shard restore
matrix: a paged snapshot of the same world and residency restores verbatim;
of another world or residency (a JAX engine at world 2 or 4, or another
``resident_streams``) every stream's row is reassembled and re-homed into the
spill store, faulting in on first touch; into an unsharded engine the rows
merge into the ``(S, ...)`` state; anything else is refused with JAX's
message. ``reshard()`` re-homes every stream under the new ``sid % W`` rule
the same way.

Windows (``engine/windows.py``): on the unsharded form the pane axis stacks
OUTSIDE the stream axis (``(panes, S, ...)`` logical state; a step writes the
current pane's ``(S, ...)`` row; under deferred sync every shard carries its
own ring, ``(W, panes, n)``), and a drift detector records one series per
stream at each rotation. On the paged form the pane extends the pager's
local stream coordinate (stream ``sid`` on shard ``sid % W`` at row
``(sid // W) * panes + pane``): each (stream, pane) pair is its own pager
row, so cold panes spill like cold streams, a step touches only the current
pane's rows, and a rotation expires the incoming pane's rows of every
shard's tables (``StreamPager.pane_expiry_plan``) with no device work. A
read reassembles rows by JAX's extended id ``row * W + shard``. A sliding ``result(sid)``
stacks the stream's pane rows and folds them. EWMA and drift are refused
there, with the JAX package's messages.

Observability and overload (``engine/pipeline.py``): every span of a batch's
journey carries its ``stream_id`` (the megabatch span all its
``stream_ids``); the paged form adds ``route``, ``page_out`` and ``page_in``
spans and their ``route_us``, ``page_out_us`` and ``page_in_us`` histograms.
Admission is per stream (its own token bucket and priority class). Under the
ladder's ``defer_cold_reads`` rung, ``result()`` of a COLD stream (not
resident; any stream of the unsharded form) serves the last value computed
for it, counted as a deferred read; the rung's release clears the cache.

The fault layer (``engine/pipeline.py``) reaches the pager and the codec
where the JAX package's does: a spill consults ``page_out`` (and
``quant_encode``), a fault-in ``page_in`` (and ``quant_decode`` per staged
seat), each inside the bounded retry before any byte moves, and every
decode or encode of spilled or snapshot rows its codec site. Demoted
(``megastep -> auto``), a q8-staging engine's next step seats its staged
slots with the codec's arithmetic before K4, and staging stops.
"""
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.engine.aot import AotCache
from metrics_tpu_torch.engine.arena import ArenaLayout, gather_rows, scatter_rows
from metrics_tpu_torch.engine.bucketing import ROWS, WHOLE, classify_leaves
from metrics_tpu_torch.engine.paging import StreamPager
from metrics_tpu_torch.engine.pipeline import EngineConfig, StreamingEngine, _add_committed
from metrics_tpu_torch.engine.quantize import ArenaRowCodec
from metrics_tpu_torch.engine.trace import ENGINE_TRACE
from metrics_tpu_torch.engine.windows import WindowPolicy
from metrics_tpu_torch.metric import StateSpec
from metrics_tpu_torch.parallel.mesh import Mesh
from metrics_tpu_torch.utils.checks import traced_rows
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.state_bridge import _pager_row, _payload_row, _tensor_from_numpy, state_to_numpy
from metrics_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["MultiStreamEngine"]

def _spill_part(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The spilled-row matrices of a pager payload, by buffer key (the slot
    table and the coordinates left out)."""
    return {k[len("spill_"):]: v for k, v in payload.items() if k.startswith("spill_") and k != "spill_coords"}


def _with_spill(payload: Dict[str, Any], spill: Dict[str, Any]) -> Dict[str, Any]:
    """``payload`` with its spilled-row matrices replaced by ``spill``."""
    out = {k: v for k, v in payload.items() if not (k.startswith("spill_") and k != "spill_coords")}
    out.update({f"spill_{k}": v for k, v in spill.items()})
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A device row as host numpy (bf16 widens to f32: numpy has no bf16)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _values_to_host(values: Any, num_streams: int) -> List[Any]:
    """Per-stream host copies of a values tree whose every leaf leads with
    the stream axis, through ONE device-to-host transfer: each leaf's bytes
    side by side in one ``(S, bytes)`` uint8 buffer, split again on the host."""
    leaves, treedef = tree_flatten(values)
    rows = [leaf.detach().contiguous().reshape(num_streams, -1) for leaf in leaves]
    raw = torch.cat([r.view(torch.uint8) for r in rows], dim=1).cpu()
    host, at = [], 0
    for leaf, r in zip(leaves, rows):
        width = r.shape[1] * r.element_size()
        part = raw[:, at:at + width].contiguous().view(leaf.dtype).reshape(leaf.shape)
        host.append(part.unbind(0))
        at += width
    return [tree_unflatten(treedef, list(per_stream)) for per_stream in zip(*host)]


class MultiStreamEngine(StreamingEngine):
    """Serve ``num_streams`` independent accumulations of one metric.

    Args:
        metric: the served metric/collection (segmented update path required).
        num_streams: S — independent accumulations.
        config: engine config; ``stream_shard`` requires ``use_arena=True``.
        aot_cache: the captured-step cache, as for ``StreamingEngine``.
        stream_shard: the paged form (one device): per-stream arena rows in
            ``resident_streams`` slots, cold streams spilled to host RAM.
        resident_streams: slot count of the paged form (default S: everything
            resident, paging never fires).
    """

    def __init__(
        self,
        metric: Any,
        num_streams: int,
        config: Optional[EngineConfig] = None,
        aot_cache: Optional[AotCache] = None,
        stream_shard: bool = False,
        resident_streams: Optional[int] = None,
    ):
        if not isinstance(num_streams, int) or num_streams <= 0:
            raise MetricsTPUUserError(f"num_streams must be a positive int, got {num_streams!r}")
        if config is not None and config.mesh is not None and config.mesh_sync != "deferred":
            raise MetricsTPUUserError(
                "MultiStreamEngine has no step-sync mesh form: the segmented scatter has no exact per-step "
                "shard-and-merge; serve the mesh with EngineConfig(mesh_sync='deferred') (shard-local stream "
                "states, boundary merge) or use one StreamingEngine per mesh"
            )
        self._num_streams = num_streams
        self._stream_shard = bool(stream_shard)
        self._pager: Optional[StreamPager] = None
        if self._stream_shard:
            if config is not None and not config.use_arena:
                raise MetricsTPUUserError(
                    "stream_shard=True requires use_arena=True: the paged per-stream arena rows are the unit "
                    "the pager spills and faults"
                )
            # the pane EXTENDS the stream coordinate: each (stream, pane) pair
            # is its own pager row
            win = config.window if config is not None and isinstance(config.window, WindowPolicy) else None
            if win is not None and win.kind == "ewma":
                raise MetricsTPUUserError(
                    "ewma windows are not supported under stream_shard=True: the decay would have to scale "
                    "resident arena rows AND every host-spilled row in place — serve ewma on an unsharded engine, "
                    "or use a tumbling/sliding ring"
                )
            self._pane_rows = win.panes if (win is not None and win.stacked) else 1
            # shard w owns the streams sid % world == w, ceil(S / world) of them
            world = config.mesh.axis(config.axis).world if config is not None and isinstance(config.mesh, Mesh) else 1
            self._local_streams = -(-num_streams // world) * self._pane_rows
            r = int(resident_streams) if resident_streams is not None else self._local_streams
            if r <= 0:
                raise MetricsTPUUserError(f"resident_streams must be positive, got {resident_streams!r}")
            self._resident = min(r, self._local_streams)
        else:
            if resident_streams is not None:
                raise MetricsTPUUserError(
                    "resident_streams only applies to stream_shard=True engines (the unsharded engine carries "
                    "every stream resident)"
                )
            self._resident = 0
            self._pane_rows = 1
        super().__init__(metric, config=config, aot_cache=aot_cache)
        self._row_codec: Optional[ArenaRowCodec] = None
        if self._stream_shard:
            # the JAX package's stream-sharded engine: no steady-state
            # collective, boundary reads per row
            self._stats.mesh_sync = "stream_shard"
            self._pager = StreamPager(self._world, self._resident)
            self._shard_pages = [[0, 0] for _ in range(self._world)]  # (page-ins, page-outs) per shard
            # one stream's packed init row per dtype, host numpy: the fault-in
            # source for never-touched (and reset) streams
            self._init_row = self._host_init_row(self._metric)
            # decode capability exists whenever the policy quantizes anything;
            # ENCODING spilled rows is gated on compress_payloads
            self._row_codec = ArenaRowCodec.for_metric(self._metric)
        # q8-RESIDENT cold rows: under "megastep" a compressing paged engine
        # seats faulted-in spilled rows without the host dequant for the
        # eligible dtypes: their quantized columns stay ZERO in the arena
        # while the int8 codes and per-element f32 scales sit in device
        # staging buffers, and K7 decodes them on the next step's touch. A
        # staging lives for exactly one round.
        self._q8_enabled = (
            self._stream_shard and self._compress and self._row_codec is not None
            and self._megastep_plan is not None
        )
        self._q8_keys: Tuple[str, ...] = ()
        self._q8_stage: Dict[str, Any] = {}
        self._q8_reset_stage()

    # -------------------------------------------------------------- capability checks

    def _update_path_unsupported_reason(self, metric: Any) -> Optional[str]:
        return metric.segmented_update_unsupported_reason()

    def _megastep_unsupported_reason(self) -> Optional[str]:
        if self._layout is None:
            return "no_arena"
        if not self._stream_shard:
            # the (S, ...)-stacked arena packs the stream axis INSIDE each
            # leaf's columns: no per-column op row describes that buffer
            return "stacked_layout"
        return None

    # ----------------------------------------------------------------- state plumbing

    @property
    def num_streams(self) -> int:
        return self._num_streams

    @property
    def stream_shard(self) -> bool:
        return self._stream_shard

    @property
    def resident_streams(self) -> Optional[int]:
        """Slot count of the paged form (None for the unsharded engine)."""
        return self._resident if self._stream_shard else None

    def _kind_init_state_tree(self) -> Any:
        base = self._metric.init_state()
        if self._stream_shard:
            return base  # ONE stream's row: _put_state tiles it over the slots
        return tree_map(lambda x: x.unsqueeze(0).repeat((self._num_streams,) + (1,) * x.ndim), base)

    def _kind_abstract_state_tree(self) -> Any:
        base = self._metric.abstract_state()
        if self._stream_shard:
            return base  # the layout describes one row, the pager's spill unit
        return tree_map(lambda s: StateSpec((self._num_streams,) + s.shape, s.dtype), base)

    def _put_state(self, tree: Any) -> Any:
        """The paged form's carried state: every slot the packed row of
        ``tree``, ``(resident, n)`` per dtype; on a mesh each shard's slots,
        ``(W, resident, n)`` on one device or one ``(resident, n)`` set per
        device."""
        if not self._stream_shard:
            return super()._put_state(tree)
        row = self._pack_row(tree_map(lambda x: torch.as_tensor(x).to(self._device), tree))
        slots = {k: v.reshape(1, -1).repeat(self._resident, 1) for k, v in row.items()}
        if self._mesh is None:
            return slots
        if self._nccl:
            return [{k: v.to(dev) for k, v in slots.items()} for dev in self._shard_devices]
        return {k: v.unsqueeze(0).repeat(self._world, 1, 1) for k, v in slots.items()}

    def _shard_bufs(self, shard: int) -> Dict[str, torch.Tensor]:
        """Shard ``shard``'s ``(resident, n)`` slot buffers (views of the
        carried state)."""
        return self._state if self._mesh is None else self._shard_view(shard)

    def _sync_tag(self) -> str:
        # the stream-sharded step carries another state than plain deferred ones
        return "stream_shard" if self._stream_shard else super()._sync_tag()

    def _payload_leaf_info(self) -> Optional[List[Any]]:
        # the unsharded merge syncs the (S, ...)-stacked state: every leaf
        # carries the stream axis
        info = super()._payload_leaf_info()
        if not info or self._stream_shard:
            return info
        return [(fx, StateSpec((self._num_streams,) + tuple(leaf.shape), leaf.dtype), prec)
                for fx, leaf, prec in info]

    def _fleet_leaf_info(self) -> Optional[List[Any]]:
        # the fold moves this host's LOGICAL state: the paged form's
        # reassembled (S, ...) tree, (panes, S, ...) under a ring, so its
        # fleet accounting scales by S although its per-mesh one does not
        if not self._stream_shard:
            return super()._fleet_leaf_info()
        info = StreamingEngine._payload_leaf_info(self)
        if not info:
            return info
        lead = (self._num_streams,) if self._pane_rows == 1 else (self._pane_rows, self._num_streams)
        return [(fx, StateSpec(lead + tuple(leaf.shape), leaf.dtype), prec) for fx, leaf, prec in info]

    # -------------------------------------------------------------------- the step

    def _traced_update(self, state_tree: Any, payload: Any, mask: torch.Tensor, shard: int = 0) -> Any:
        a, kw = payload
        ids, rest = a[0], a[1:]
        # paged mode addresses pager SLOTS, unsharded mode stream rows
        num = self._resident if self._stream_shard else self._num_streams
        return self._shard_metric(shard).update_state_segmented(state_tree, *rest, mask=mask, segment_ids=ids,
                                                                num_segments=num, **kw)

    def _step_aux(self, shard: int = 0) -> Any:
        return self._q8_payload(shard)

    def _step_state(self, state: Any, aux: Any, a: Tuple[Any, ...], kw: Dict[str, Any], mask: torch.Tensor,
                    shard: int = 0) -> Any:
        if not self._stream_shard:
            return super()._step_state(state, aux, a, kw, mask, shard=shard)
        cols = self._q8_cols_dev.get(self._shard_devices[shard]) if self._q8_cols_dev else None
        plan = self._shard_plan(shard)
        if plan is not None:
            return plan.apply_segmented(state, a[1:], kw, mask, a[0], self._resident, q8_stage=aux, q8_cols=cols)
        if aux:
            # the demoted body of a q8-staging engine: seat the staged slots
            # with the codec's own arithmetic first (int8 -> f32, one f32
            # multiply, one cast), as K7's seed does, then the per-leaf K4
            state = dict(state)
            for k, (flags, codes, scales) in aux.items():
                on = (flags.reshape(-1, 1) != 0) & (cols[k].reshape(1, -1) != 0)
                state[k] = torch.where(on, (codes.to(torch.float32) * scales).to(state[k].dtype), state[k])
        tree = self._layout.unpack_stacked(state)
        return self._layout.pack_stacked(self._traced_update(tree, (a, kw), mask, shard))

    def _update_kind(self) -> str:
        return f"paged.{self._resident}" if self._stream_shard else f"segmented.{self._num_streams}"

    def _graph_keepalive(self) -> Tuple[Any, ...]:
        return super()._graph_keepalive() + (self._q8_cols_dev,)

    def _check_stream(self, stream_id: Any) -> int:
        sid = int(stream_id)
        if not 0 <= sid < self._num_streams:
            raise MetricsTPUUserError(f"stream_id {sid} out of range for num_streams={self._num_streams}")
        return sid

    def submit(self, stream_id: int, *args: Any, timeout: Optional[float] = None,  # type: ignore[override]
               **kwargs: Any) -> None:
        """Enqueue one (ragged) batch for ``stream_id``; blocks and times out
        as ``StreamingEngine.submit`` does."""
        sid = self._check_stream(stream_id)
        item = (sid, args, kwargs)
        if self._admission is not None:
            # per-STREAM admission: the stream's own token bucket and class
            self._raise_if_failed()
            self.start()
            self._admitted_submit(sid, item, (args, kwargs), timeout)
        else:
            self._submit_item(item, timeout)

    # ------------------------------------------------------------ dispatcher hooks

    def _item_rows(self, item: Any) -> int:
        return super()._item_rows(item[1:])

    def _coalescible(self, ref: Any, item: Any) -> bool:
        # stream ids NEVER block coalescing: cross-stream megabatches are the
        # point; only the (args, kwargs) payloads must concatenate
        return super()._coalescible(ref[1:], item[1:])

    def _merge_sized(self, nonempty: List[Tuple[Any, int]]) -> Optional[Tuple[Tuple[Any, ...], Dict[str, Any]]]:
        """The megabatch with its per-row stream-id column leading the args.
        An item's id is a scalar stream id, broadcast over its rows, or
        already a per-row id array of its length (the ragged engine's group
        keys)."""
        if not nonempty:
            return None
        ids = np.concatenate([np.broadcast_to(np.asarray(sid, np.int32), (n,)) for (sid, _, _), n in nonempty])
        args, kwargs = self._concat_sized([((a, kw), n) for (_, a, kw), n in nonempty])
        return (ids,) + tuple(args), kwargs

    def _latch_payload(self, merged: Any) -> Tuple[Tuple[Any, ...], Dict[str, Any]]:
        args, kwargs = merged
        return tuple(args[1:]), kwargs

    def _group_context(self, group: List[Any]) -> Dict[str, Any]:
        # the sticky error names every stream whose traffic rode the group (an
        # item's ids may be a per-row array)
        sids = sorted({int(x) for it in group if isinstance(it, tuple) and len(it) == 3
                       for x in np.atleast_1d(np.asarray(it[0])).ravel()})
        return {"stream_ids": sids} if sids else {}

    def _screen_payload(self, item: Any) -> Any:
        # the policy sees what the metric's update sees: no stream id
        return (item[1], item[2])

    def _item_context(self, item: Any) -> Dict[str, Any]:
        return {"stream_id": item[0]}

    def _execute_payload(self, merged: Tuple[Tuple[Any, ...], Dict[str, Any]], n: int, coalesced: int,
                         queue_wait_us: float = 0.0) -> None:
        if not self._stream_shard:
            super()._execute_payload(merged, n, coalesced, queue_wait_us)
            return
        args, kwargs = merged
        self._execute_routed(args[0], tuple(args[1:]), kwargs, n, coalesced, queue_wait_us)

    # ------------------------------------------------------------ the paged form

    def _execute_routed(self, sids: np.ndarray, args: Tuple[Any, ...], kwargs: Dict[str, Any], n: int,
                        coalesced: int, queue_wait_us: float = 0.0) -> None:
        """Route a batch to the stream shards on the host (the JAX package's
        routed execution): rows order by home shard (``sid % W``, stable, so
        each stream keeps its arrival order), then run in ROUNDS, each taking
        up to ``bucket / W`` rows a shard and at most ``resident`` distinct
        streams a shard (so the pager can always seat it): the round's
        streams page resident, and ONE padded step runs, shard ``w`` folding
        its segment with its pager slot indices as segment ids. The bucket is
        the smallest whose per-shard block covers the round's longest
        segment. A non-transient ``shard_loss`` under ``elastic_min_world``
        reshards the engine and re-routes what the group has not committed.
        With a recorder, the group's routing is one ``route`` span (its rows
        and rounds)."""
        t_route0 = time.perf_counter()
        world = self._world
        sids = np.asarray(sids, np.int64)
        order = np.argsort(sids % world, kind="stable")
        leaves, treedef = tree_flatten((tuple(args), kwargs))
        kinds = classify_leaves(leaves, n, self._policy.buckets[-1], world)
        perm = leaves if world == 1 else [leaf[order] if kind == ROWS else leaf for leaf, kind in zip(leaves, kinds)]
        a_perm, kw_perm = tree_unflatten(treedef, perm)
        sids_o = sids[order]
        home_o = sids_o % world
        # the pager rows of the CURRENT pane, for the whole group at once: the
        # cursor is constant across the call (rotations fall between groups)
        locs = self._route_locs(sids_o)
        starts = np.searchsorted(home_o, np.arange(world))
        stops = np.searchsorted(home_o, np.arange(world), side="right")
        per_top = self._policy.buckets[-1] // world
        route_us = (time.perf_counter() - t_route0) * 1e6
        cursors, committed = starts.copy(), 0
        try:
            while bool(np.any(cursors < stops)):
                t0 = time.perf_counter()
                segs: List[Tuple[int, int]] = []
                for w in range(world):
                    s0, s1 = int(cursors[w]), int(stops[w])
                    end, distinct = s0, set()
                    while end < s1 and end - s0 < per_top:
                        loc = int(locs[end])
                        if loc not in distinct and len(distinct) >= self._resident:
                            break
                        distinct.add(loc)
                        end += 1
                    segs.append((s0, end))
                bucket = self._policy.bucket_for(max(e - b for b, e in segs) * world)
                per = bucket // world
                step_kinds = [WHOLE] + classify_leaves(leaves, n, bucket, world)
                self._page_round({w: [int(x) for x in locs[b:e]] for w, (b, e) in enumerate(segs)})
                parts = []
                for w, (b, e) in enumerate(segs):
                    slot_ids = np.zeros((per,), np.int32)  # pad rows address slot 0, masked
                    if e > b:
                        uniq = np.unique(locs[b:e])
                        slots = np.asarray([self._pager.slot_of(w, int(u)) for u in uniq], np.int32)
                        slot_ids[:e - b] = slots[np.searchsorted(uniq, locs[b:e])]
                    # the slot ids lead the args as one whole (per,) leaf
                    step_leaves, step_def = tree_flatten(((slot_ids,) + tuple(a_perm), kw_perm))
                    parts.append((step_leaves, step_kinds, step_def, b, e))
                try:
                    self._run_padded_step(*parts[0], bucket, coalesced if committed == 0 else 1,
                                          queue_wait_us if committed == 0 else 0.0, t0, parts=parts)
                except BaseException as e:
                    # a failed step never ran the kernel's decode: seat the staged
                    # slots through the host decode before anything reads them
                    self._q8_flush()
                    if not self._lost_shard_resharded(e):
                        raise
                    # the routing tables were built for the lost topology:
                    # re-route everything this group has not committed
                    rem = np.concatenate([np.arange(int(cursors[w]), int(stops[w])) for w in range(world)])
                    rest = tree_unflatten(treedef, [leaf[rem] if kind == ROWS else leaf
                                                    for leaf, kind in zip(perm, kinds)])
                    self._execute_routed(sids_o[rem], tuple(rest[0]), rest[1], int(rem.size),
                                         coalesced if committed == 0 else 1,
                                         queue_wait_us if committed == 0 else 0.0)
                    return
                self._q8_clear()  # the step decoded every staged slot
                if self._q8_keys and self._megastep_plan is None:
                    # demoted, and this step seated the last staged slots:
                    # later page-ins decode on the host, and the steps lose
                    # their staging argument (a new signature)
                    self._q8_enabled = False
                    self._q8_reset_stage()
                    self._carried_sig = None
                    self._program_memo.clear()
                committed += 1
                self._stats.routed_steps += 1
                for w, (b, e) in enumerate(segs):
                    cursors[w] = e
                    if e > b:
                        self._pager.touch(w, [int(x) for x in locs[b:e]])
        except Exception as e:
            _add_committed(e, committed)
            raise
        tr = self._trace
        if tr is not None:
            tr.complete("route", trace=self._group_tid or ENGINE_TRACE, dur_us=route_us, rows=int(n),
                        rounds=committed)
            tr.observe("route_us", route_us)

    def _home_row(self, sid: int, pane: Optional[int] = None) -> Tuple[int, int]:
        """Stream id (+ pane under a ring window) -> its home ``(shard, pager
        row)``: shard ``sid % W``, local stream ``sid // W``. The pane EXTENDS
        the local index (``loc * panes + pane``): each (stream, pane) pair
        owns its own row, so cold panes page like cold streams. ``pane``
        defaults to the current one."""
        w, loc = sid % self._world, sid // self._world
        if self._pane_rows == 1:
            return w, loc
        return w, loc * self._pane_rows + (self._pane_cursor if pane is None else int(pane))

    def _route_locs(self, sids: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`_home_row` rows for the current pane (a step only
        ever touches the pane being written)."""
        locs = np.asarray(sids, np.int64) // self._world
        return locs * self._pane_rows + self._pane_cursor if self._pane_rows > 1 else locs

    def _row_universe(self) -> int:
        """The extended row ids a paged engine can address (JAX's
        ``_ext_universe``): the streams, or under a ring window every (shard,
        pager row) pair as ``row * W + shard``, ``ceil(S / W) * panes`` rows a
        shard, ids past S included (never touched, read as init rows)."""
        return self._local_streams * self._world if self._pane_rows > 1 else self._num_streams

    def _pane_index(self, panes: Any) -> np.ndarray:
        """The ``(len(panes), S)`` extended row ids of every stream in each
        listed pane, pane-major like the logical ``(panes, S, ...)`` state
        (JAX's ``_ext_ids``)."""
        sids = np.arange(self._num_streams, dtype=np.int64)
        base = (sids // self._world) * self._pane_rows * self._world + sids % self._world
        return base[None, :] + np.asarray(list(panes), np.int64)[:, None] * self._world

    # ------------------------------------------------------------- pane rotation

    def _plan_rotation(self, incoming: int) -> Any:
        """The paged rotation's plan: every pager row of the INCOMING pane,
        resident or spilled (``StreamPager.pane_expiry_plan``). Those rows
        expire (a tumbling pane restarts, a sliding ring drops its oldest
        pane) and their next touch faults in the init row: no device work.
        Pure, behind the ``pane_rotate`` site and the bounded retry."""
        if not self._stream_shard:
            return super()._plan_rotation(incoming)

        def plan() -> Any:
            self._fault("pane_rotate")
            return self._pager.pane_expiry_plan(incoming, self._pane_rows)

        return self._retry_transient(plan)

    def _commit_rotation(self, planned: Any, incoming: int) -> None:
        if not self._stream_shard:
            super()._commit_rotation(planned, incoming)
            return
        for shard, row in planned:
            self._pager.drop(shard, row)
        self._refresh_gauges()

    def _drift_values_locked(self) -> List[Tuple[Optional[int], Any]]:
        """Every stream's closing-pane value, one series per stream: ONE
        batched (vmapped) computation over the stream axis of the closing
        pane's row (the whole state under EWMA), copied to the host at once."""
        tree = self._closing_pane_tree()
        with traced_rows():
            values = torch.func.vmap(self._metric.compute_from)(tree)
            return list(enumerate(_values_to_host(values, self._num_streams)))

    def _page_round(self, needed: Dict[int, List[int]]) -> None:
        """Make every stream in ``needed`` (shard -> pager rows) resident on
        its shard: plan with the pager, spill the evicted rows to host RAM
        (encoded under ``compress_payloads``; the ``page_out`` and
        ``quant_encode`` sites), write the faulted-in rows (spilled, staged or
        init) into their slots (``page_in``, ``quant_decode``), then commit
        the bookkeeping. Each phase retries a transient fault through the
        engine's bounded retry, its sites consulted before any byte moves;
        the arena is written in place only after the rows to seat are known,
        and the staged flags, ``page_outs``/``page_ins`` and the pager's
        tables only after the rows landed."""
        ops: List[Any] = []
        for w in sorted(needed):
            if needed[w]:
                shard_ops, hits, faults = self._pager.plan_residency(w, needed[w])
                ops.extend(shard_ops)
                self._stats.page_hits += hits
                self._stats.page_faults += faults
        evicts = [op for op in ops if op.kind == "evict"]
        loads = [op for op in ops if op.kind == "load"]
        tr = self._trace
        gid = self._group_tid or ENGINE_TRACE
        spilled: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        if evicts:
            def spill_once() -> Tuple[List[Dict[str, np.ndarray]], float]:
                self._fault("page_out")
                t0 = time.perf_counter()
                rows = []
                for w, group in self._by_shard(evicts):
                    bufs = self._shard_bufs(w)
                    js = torch.tensor([op.slot for op in group], device=self._shard_devices[w])
                    got = {k: _host(gather_rows(v, js)) for k, v in bufs.items()}  # one gather per dtype
                    rows += [{k: got[k][i] for k in got} for i in range(len(group))]
                if self._compress and self._row_codec is not None:
                    # quantize BEFORE host RAM holds them; pure in ``rows``
                    self._fault("quant_encode")
                    enc = self._row_codec.encode_buffers({k: np.stack([r[k] for r in rows]) for k in rows[0]})
                    rows = [{k: v[i] for k, v in enc.items()} for i in range(len(rows))]
                return rows, t0

            rows, t0 = self._retry_transient(spill_once)
            dur = (time.perf_counter() - t0) * 1e6
            for op, row in zip([op for _, g in self._by_shard(evicts) for op in g], rows):
                spilled[(op.shard, op.stream)] = {k: np.array(v) for k, v in row.items()}
                self._shard_pages[op.shard][1] += 1
            self._stats.page_outs += len(evicts)
            if tr is not None:
                tr.complete("page_out", trace=gid, dur_us=dur, rows=len(evicts))
                tr.observe("page_out_us", dur)
        if loads:
            t_load = time.perf_counter()

            def load_once() -> Tuple[List[Dict[str, np.ndarray]], List[Any]]:
                nonlocal t_load
                self._fault("page_in")
                t_load = time.perf_counter()
                src_rows: List[Dict[str, np.ndarray]] = []
                staged: List[Any] = []
                for op in loads:
                    raw = self._pager.spilled_row(op.shard, op.stream) if self._q8_keys else None
                    if raw is not None and self._row_codec.is_encoded(raw):
                        # q8-resident seat: the staged dtypes' quantized columns
                        # stay zero here; K7 decodes them on the next step
                        self._fault("quant_decode")
                        seed, st = self._row_codec.stage_buffers(raw, self._q8_keys)
                        src_rows.append(seed)
                        staged.append(st)
                    else:
                        src_rows.append(self._decoded_spill_row(op.shard, op.stream) or self._init_row)
                        staged.append(None)
                return src_rows, staged

            src_rows, staged = self._retry_transient(load_once)
            by_op = {id(op): (row, st) for op, row, st in zip(loads, src_rows, staged)}
            for w, group in self._by_shard(loads):
                dev = self._shard_devices[w]
                js = torch.tensor([op.slot for op in group], device=dev)
                for k, buf in self._shard_bufs(w).items():
                    scatter_rows(buf, js, torch.from_numpy(np.stack([by_op[id(op)][0][k] for op in group])).to(dev))
                for op in group:
                    st = by_op[id(op)][1]
                    if st is None:
                        continue
                    self._stats.q8_staged_rows += 1
                    stage = self._q8_stage[w]
                    stage["flags"][op.slot] = 1
                    for k in self._q8_keys:
                        codes, scales = stage[k]
                        codes[op.slot] = torch.from_numpy(st[k][0]).to(dev)
                        scales[op.slot] = torch.from_numpy(st[k][1]).to(dev)
            self._stats.page_ins += len(loads)
            for op in loads:
                self._shard_pages[op.shard][0] += 1
            if tr is not None:
                dur = (time.perf_counter() - t_load) * 1e6
                tr.complete("page_in", trace=gid, dur_us=dur, rows=len(loads))
                tr.observe("page_in_us", dur)
        if ops:
            self._pager.commit(ops, spilled)
        self._refresh_gauges()

    def pages_by_shard(self) -> List[Dict[str, int]]:
        """Page-ins and page-outs of each shard of the current topology."""
        return [{"page_ins": i, "page_outs": o} for i, o in self._shard_pages]

    @staticmethod
    def _by_shard(ops: List[Any]) -> List[Tuple[int, List[Any]]]:
        """Page ops grouped by shard, in shard order (each group in plan order)."""
        groups: Dict[int, List[Any]] = {}
        for op in ops:
            groups.setdefault(op.shard, []).append(op)
        return sorted(groups.items())

    def _refresh_gauges(self) -> None:
        """The paging gauges of the telemetry: occupied slots, spilled
        streams and the spill store's bytes in host RAM."""
        self._stats.resident_streams = self._pager.resident_count()
        self._stats.spilled_streams = self._pager.spilled_count()
        self._stats.spilled_bytes = self._pager.spill_nbytes()

    # -------------------------------------------------------- q8-resident staging

    def _q8_reset_stage(self) -> None:
        """Judge the staged dtype set (megastep-eligible dtypes the codec
        compresses) and allocate each shard's staging buffers on its device:
        flags ``(resident,)`` int32 plus per dtype codes ``(resident, n)``
        int8 and scales ``(resident, n)`` f32."""
        self._q8_cols: Optional[Dict[str, np.ndarray]] = None
        self._q8_cols_dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self._q8_stage: List[Dict[str, Any]] = []
        self._q8_keys: Tuple[str, ...] = ()
        if not self._q8_enabled:
            return
        q_mask = self._row_codec.q_mask
        self._q8_keys = tuple(k for k in self._megastep_plan.eligible_keys() if k in q_mask)
        if not self._q8_keys:
            return
        sizes = self._layout.buffer_sizes()
        r = self._resident
        for dev in self._shard_devices:
            stage: Dict[str, Any] = {"flags": torch.zeros((r,), dtype=torch.int32, device=dev)}
            for k in self._q8_keys:
                stage[k] = (torch.zeros((r, sizes[k]), dtype=torch.int8, device=dev),
                            torch.zeros((r, sizes[k]), dtype=torch.float32, device=dev))
            self._q8_stage.append(stage)
            # the same masks on each device, made once: K7 reads them on every step
            self._q8_cols_dev[dev] = {k: torch.from_numpy(q_mask[k].astype(np.int32)).to(dev) for k in self._q8_keys}
        self._q8_cols = {k: q_mask[k] for k in self._q8_keys}

    def _q8_payload(self, shard: int = 0) -> Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]]:
        """The staging every step of a q8 engine passes to K7 for shard
        ``shard`` (all flags zero when nothing is staged); None when staging
        is off."""
        if not self._q8_keys:
            return None
        stage = self._q8_stage[shard]
        return {k: (stage["flags"],) + tuple(stage[k]) for k in self._q8_keys}

    def _q8_clear(self) -> None:
        for stage in self._q8_stage if self._q8_keys else ():
            stage["flags"].zero_()

    def _q8_flush(self) -> None:
        """Seat any PENDING staged slots through the host decode (the codec's
        own arithmetic: int8→f32, one f32 multiply, one cast), for a step that
        never ran the kernel's seed."""
        if not self._q8_keys:
            return
        for w, stage in enumerate(self._q8_stage):
            js = torch.nonzero(stage["flags"]).reshape(-1)
            if not js.numel():
                continue
            bufs = self._shard_bufs(w)
            for k in self._q8_keys:
                codes, scales = (_host(t[js]) for t in stage[k])
                mask = self._q8_cols[k]
                rows = _host(bufs[k][js])
                rows[:, mask] = (codes.astype(np.float32) * scales)[:, mask]
                bufs[k][js] = torch.from_numpy(rows).to(bufs[k].device, bufs[k].dtype)
        self._q8_clear()

    # --------------------------------------------------------------------- readers

    def _decoded_spill_row(self, shard: int, row: int) -> Optional[Dict[str, np.ndarray]]:
        """One spilled pager row of ``shard`` from host RAM, decoded when
        stored compressed (the ``quant_decode`` site; pure in the stored row,
        so a transient retries clean)."""
        got = self._pager.spilled_row(shard, row)
        if got is not None and self._row_codec is not None and self._row_codec.is_encoded(got):
            got = self._codec_call("quant_decode", self._row_codec.decode_buffers, got)
        return got

    def _fetch_row(self, sid: int, pane: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """ONE (stream, pane) packed arena row on the engine's device: its
        slot when resident, the host-spilled copy when paged out (no
        eviction), else the init row. ``pane`` defaults to the current one."""
        w, loc = self._home_row(sid, pane)
        slot = self._pager.slot_of(w, loc)
        if slot is not None:
            return {k: v[slot].to(self._device) for k, v in self._shard_bufs(w).items()}
        row = self._decoded_spill_row(w, loc) or self._init_row
        return {k: torch.from_numpy(np.asarray(v)).to(self._device, self._state_dtype(k)) for k, v in row.items()}

    def _state_dtype(self, key: str) -> torch.dtype:
        return self._shard_bufs(0)[key].dtype

    def _all_rows(self) -> Dict[str, torch.Tensor]:
        """Every pager row, ``(S, n)`` per dtype on the engine's device
        (the extended ``(ceil(S / W) * panes * W, n)`` universe under a ring
        window, :meth:`_row_universe`):
        the init row tiled, the spilled rows (decoded when stored compressed)
        written in one upload per dtype, then the resident slots, one device
        gather per dtype and shard (a resident row has no spill entry).
        Shard ``w``'s local row ``loc`` is global row ``loc * W + w``."""
        dev, s, world = self._device, self._row_universe(), self._world
        out = {k: torch.from_numpy(self._init_row[k]).to(dev, self._state_dtype(k)).expand(s, -1).clone()
               for k in self._init_row}
        encoded: List[Tuple[int, Dict[str, np.ndarray]]] = []
        plain: List[Tuple[int, Dict[str, np.ndarray]]] = []
        for w in range(world):
            for loc in self._pager.spilled_streams(w):
                row = self._pager.spilled_row(w, loc)
                is_enc = self._row_codec is not None and self._row_codec.is_encoded(row)
                (encoded if is_enc else plain).append((loc * world + w, row))
        for group, decode in ((encoded, True), (plain, False)):
            if not group:
                continue
            sids = torch.from_numpy(np.asarray([g[0] for g in group], np.int64)).to(dev)
            stacked = {key: np.stack([g[1][key] for g in group]) for key in group[0][1]}
            if decode:
                stacked = self._codec_call("quant_decode", self._row_codec.decode_buffers, stacked)
            for k in out:
                scatter_rows(out[k], sids, torch.from_numpy(stacked[k]).to(dev))
        for w in range(world):
            resident = self._pager.resident_streams(w)
            if not resident:
                continue
            bufs = self._shard_bufs(w)
            sids = torch.from_numpy(np.asarray(resident, np.int64) * world + w).to(dev)
            slots = torch.from_numpy(np.asarray([self._pager.slot_of(w, r) for r in resident], np.int64)).to(
                bufs[next(iter(bufs))].device)
            for k, buf in bufs.items():
                scatter_rows(out[k], sids, gather_rows(buf, slots).to(dev))
        return out

    def _stream_ring(self, sid: int) -> Any:
        """One stream's logical state tree (views of the live state when
        unsharded): ``(panes, ...)``-stacked under a ring window."""
        if self._stream_shard:
            if self._pane_rows == 1:
                return self._layout.unpack(self._fetch_row(sid))
            rows = [self._fetch_row(sid, pane=p) for p in range(self._pane_rows)]
            return self._layout.unpack_stacked({k: torch.stack([r[k] for r in rows]) for k in rows[0]})
        pick = (lambda x: x[:, sid]) if self._win_stacked else (lambda x: x[sid])
        return tree_map(pick, self._unsharded_tree())

    def _unsharded_tree(self) -> Any:
        """The unsharded form's ``(S, ...)`` logical state: views of the
        carried state, or the boundary merge of the shards' states under
        deferred sync."""
        return self._merged_state() if self._deferred else self._unpack(self._state)

    def _stream_tree(self, sid: int) -> Any:
        """One stream's RESULT view: its state, or under a window the open
        pane of a tumbling ring or the fold of a sliding ring's panes."""
        if self._stream_shard:
            if self._pane_rows == 1 or self._window.kind == "tumbling":
                return self._layout.unpack(self._fetch_row(sid))
            return self._metric.merge_stacked_states(self._stream_ring(sid))
        tree = self._unsharded_tree()
        if not self._win_stacked:
            return tree_map(lambda x: x[sid], tree)
        if self._window.kind == "tumbling":
            return tree_map(lambda x: x[self._pane_cursor, sid], tree)
        return self._metric.merge_stacked_states(tree_map(lambda x: x[:, sid], tree))

    def _paged_rows(self, panes: Any) -> Dict[str, torch.Tensor]:
        """The paged form's ``(len(panes), S, n)`` row matrices of the listed
        panes, out of one reassembly of every pager row."""
        rows = self._all_rows()
        idx = torch.from_numpy(self._pane_index(panes)).to(self._device)
        return {k: gather_rows(v, idx) for k, v in rows.items()}

    def _stacked_ring(self) -> Any:
        """The logical state of every stream, ``(S, ...)``, or ``(panes, S,
        ...)`` under a ring window, the pane axis outermost (views of the live
        state when unsharded; the paged form assembles it afresh)."""
        if not self._stream_shard:
            return self._unsharded_tree()
        if self._pane_rows == 1:
            return self._layout.unpack_stacked(self._all_rows())
        return self._layout.unpack_stacked(self._paged_rows(range(self._pane_rows)), lead=2)

    def _stacked_tree(self) -> Any:
        """The ``(S, ...)``-stacked RESULT view of every stream: the state, or
        under a window its open pane or the fold of its panes."""
        if not self._stream_shard:
            return self._window_tree(self._unsharded_tree())
        if self._pane_rows == 1:
            return self._layout.unpack_stacked(self._all_rows())
        if self._window.kind == "tumbling":
            return self._layout.unpack_stacked({k: v[0] for k, v in self._paged_rows([self._pane_cursor]).items()})
        return self._metric.merge_stacked_states(self._stacked_ring())

    def result(self, stream_id: int) -> Any:  # type: ignore[override]
        """``stream_id``'s value (after a flush): the paged form reads ONLY
        that stream's row. Computed traced, as :meth:`StreamingEngine.result`.
        While the ladder's ``defer_cold_reads`` rung is engaged, a cold
        stream with a cached value gets that value, with no flush and no
        device work."""
        sid = self._check_stream(stream_id)
        tr = self._trace
        if self._defer_cold_reads:
            # cold = not resident (the pager's own notion); the unsharded form
            # defers any repeat read. The staleness window closes when the
            # rung is released (the cache is cleared)
            with self._state_lock:
                cached = self._result_cache.get(sid)
                cold = self._pager.slot_of(*self._home_row(sid)) is None if self._stream_shard else True
            if cached is not None and cold:
                self._stats.record_deferred_read()
                if tr is not None:
                    tr.event("deferred_read", trace=ENGINE_TRACE, stream_id=sid)
                return cached
        handle = tr.begin("result", trace=ENGINE_TRACE, stream_id=sid) if tr is not None else None
        self.flush()
        with self._device_section(), traced_rows():
            value = self._owned(self._metric.compute_from(self._stream_tree(sid)))
            self._stats.result_device_calls += 1
            if self._ladder is not None:
                # the defer rung's source: only ladder-armed engines keep it
                self._result_cache[sid] = value
        if handle is not None:
            self._value_in_hand()
            tr.observe("result_latency_us", tr.end(handle))
        return value

    def results(self) -> Dict[int, Any]:
        """Every stream's value, on the host, from ONE batched computation for
        any S: after one flush, ``torch.func.vmap`` of the metric's
        ``compute_from`` over the stream axis of the stacked state, then one
        device-to-host copy of the values, sliced per stream."""
        self.flush()
        with self._device_section(), traced_rows():
            values = torch.func.vmap(self._metric.compute_from)(self._stacked_tree())
            self._stats.result_device_calls += 1
            per_stream = _values_to_host(values, self._num_streams)
        return dict(enumerate(per_stream))

    def stream_state(self, stream_id: int) -> Any:
        """A copy of one stream's LOGICAL state tree (after a flush):
        ``(panes, ...)``-stacked under a ring window."""
        sid = self._check_stream(stream_id)
        self.flush()
        with self._device_section():
            return tree_map(torch.clone, self._stream_ring(sid))

    def state(self) -> Any:
        """The (S, ...)-stacked LOGICAL state of all streams, ``(panes, S,
        ...)`` under a ring window (the paged form reassembles it from
        resident, spilled and init rows)."""
        if not self._stream_shard:
            return super().state()
        self.flush()
        with self._device_section():
            return self._stacked_ring()

    def reset_stream(self, stream_id: int) -> None:
        """Zero ONE stream's accumulation (after a flush), in every live pane
        of a ring: "forget this tenant" leaves no history pane serving a stale
        window. The paged form simply forgets the stream's rows (slots freed,
        spill entries dropped) and its next access faults in the init row."""
        sid = self._check_stream(stream_id)
        self.flush()
        with self._device_section():
            self._result_cache.pop(sid, None)
            if self._stream_shard:
                for p in range(self._pane_rows):
                    self._pager.drop(*self._home_row(sid, p))
                self._refresh_gauges()
                return
            init = tree_leaves(self._metric.init_state())
            # every shard's local state under deferred sync: the merge would
            # fold a stale shard's rows back in
            trees = ([self._unpack(v) for v in self._shard_states()] if self._deferred
                     else [self._unpack(self._state)])
            for tree in trees:
                for leaf, fresh in zip(tree_leaves(tree), init):
                    # in place: the leaves view the arena (the stream axis sits
                    # under the pane axis of a ring)
                    if self._win_stacked:
                        leaf[:, sid] = fresh.to(leaf.device)
                    else:
                        leaf[sid] = fresh.to(leaf.device)
            self._state_version += 1

    def _reset_locked(self) -> None:
        if self._pager is not None:
            self._pager.reset()
            self._q8_clear()
        super()._reset_locked()
        if self._pager is not None:
            self._refresh_gauges()

    # ------------------------------------------------------------- snapshot/restore

    def _snapshot_state(self) -> Any:
        if not self._stream_shard:
            return super()._snapshot_state()
        # the paged form's payload: the resident arena AND the pager's spilled
        # rows and slot table, so rows living in host RAM survive a kill.
        # Staged q8 rows are seated first: their quantized columns are still
        # zero in the arena until a step decodes them
        self._q8_flush()
        if self._mesh is None:
            arena: Dict[str, Any] = {k: v[None] for k, v in state_to_numpy(self._state).items()}  # (world=1, R, n)
        else:
            arena = state_to_numpy(self._stacked_carried())  # (W, R, n)
        if self._compress and self._row_codec is not None:
            arena = self._codec_call("quant_encode", self._row_codec.encode_buffers, arena)
        # spilled rows are already in their at-rest form (encoded on the way
        # to host RAM); a bf16 buffer's narrow back from the pager's f32
        pager = {k: _payload_row(k, v) for k, v in self._pager.snapshot_payload().items()}
        return {"arena": arena, "pager": pager}

    def _snapshot_meta_extra(self) -> Dict[str, Any]:
        if not self._stream_shard:
            return {}
        return {"stream_shard": 1, "num_streams": self._num_streams, "resident": self._resident, "world": self._world}

    def _decoded_pager_payload(self, payload: Dict[str, Any], codec: Optional[ArenaRowCodec]) -> Dict[str, Any]:
        """A pager payload with its spilled rows decoded when they are stored
        compressed (the slot table and coordinates pass through)."""
        spill = _spill_part(payload)
        if codec is None or not spill or not codec.is_encoded(spill):
            return payload
        return _with_spill(payload, self._codec_call("quant_decode", codec.decode_buffers, spill))

    def _normalized_pager_payload(self, payload: Dict[str, Any], snap_codec: Optional[ArenaRowCodec]) -> Dict[str, Any]:
        """A restored pager payload in THIS engine's spill-store form: a
        compressed snapshot into a verbatim-storing engine decodes, a
        verbatim one into a compressing engine encodes (a mixed store would
        break the per-key stacking of ``snapshot_payload``)."""
        spill = _spill_part(payload)
        if not spill:
            return payload
        is_encoded = snap_codec is not None and snap_codec.is_encoded(spill)
        want_encoded = self._compress and self._row_codec is not None
        if is_encoded == want_encoded:
            return payload
        if is_encoded:
            return self._decoded_pager_payload(payload, snap_codec)
        return _with_spill(payload, self._codec_call("quant_encode", self._row_codec.encode_buffers,
                                                     {k: np.asarray(v) for k, v in spill.items()}))

    @staticmethod
    def _rows_from_parts(arena: Dict[str, Any], pager_payload: Dict[str, Any], init_row: Dict[str, np.ndarray],
                         num_streams: int, world: int) -> Dict[str, np.ndarray]:
        """``(S, n)`` per-dtype row matrices (host numpy) from a snapshot's
        ``(world, R, n)`` arena and pager payload: init rows, then the
        resident slots, then the spilled rows; stream ``sid`` lives on shard
        ``sid % world`` as local stream ``sid // world``."""
        out = {k: np.tile(np.asarray(init_row[k])[None], (num_streams, 1)) for k in arena}
        slots = np.asarray(pager_payload["slots"])
        w_idx, j_idx = np.nonzero(slots >= 0)
        if w_idx.size:
            g = slots[w_idx, j_idx].astype(np.int64) * world + w_idx
            keep = g < num_streams
            for k in out:
                out[k][g[keep]] = np.asarray(arena[k])[w_idx[keep], j_idx[keep]]
        coords = np.asarray(pager_payload.get("spill_coords", np.zeros((0, 2), np.int64))).reshape(-1, 2)
        if coords.size:
            g = coords[:, 1].astype(np.int64) * world + coords[:, 0].astype(np.int64)
            keep = g < num_streams
            for k in out:
                out[k][g[keep]] = np.asarray(pager_payload[f"spill_{k}"])[keep]
        return out

    def _seeded_pager_payload(self, rows: Dict[str, np.ndarray], init_row: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """A pager payload for THIS engine (its world, ``resident`` slots): an
        empty slot table and every non-init stream row in the spill store at
        its home, so each faults in on its first touch. A row holding NaN compares
        unequal and spills: conservative, never lossy."""
        payload: Dict[str, Any] = {"slots": np.full((self._world, self._resident), -1, np.int64)}
        keys = sorted(rows)
        diff = np.zeros((self._row_universe(),), bool)
        for k in keys:
            diff |= ~np.all(np.asarray(rows[k]) == np.asarray(init_row[k])[None], axis=1)
        sids = np.nonzero(diff)[0].astype(np.int64)
        if sids.size:
            # stream sid's home: shard sid % W, local row sid // W
            payload["spill_coords"] = np.stack([sids % self._world, sids // self._world], axis=1)
            for k in keys:
                payload[f"spill_{k}"] = np.asarray(rows[k])[sids]
        return payload

    @staticmethod
    def _host_init_row(metric: Any) -> Dict[str, np.ndarray]:
        """One stream's packed init row per dtype, host numpy."""
        return {k: _host(v) for k, v in ArenaLayout.for_state(metric.abstract_state()).pack(metric.init_state()).items()}

    @staticmethod
    def sshard_piece_logical(metric: Any, state: Any, meta: Dict[str, Any]) -> Any:
        """One stream-shard snapshot piece -> its LOGICAL state tree:
        ``(S, ...)``, or ``(panes, S, ...)`` for a pane-stacked ring. Resident
        slots, spilled rows and init rows reassemble as the merged restore
        does; a compressed piece decodes through the metric's own row codec
        (the caller checks ``meta["codec_fp"]``)."""
        arena = state.get("arena") if isinstance(state, dict) else None
        pager_payload = state.get("pager") if isinstance(state, dict) else None
        if arena is None or pager_payload is None:
            raise MetricsTPUUserError("stream-shard snapshot payload is missing arena/pager parts")
        world = int(meta.get("world", 1))
        s_snap = int(meta.get("num_streams", 0))
        pane_rows = (int(meta.get("panes", 0) or 0) if str(meta.get("window", "") or "") else 1) or 1
        if str(meta.get("codec", "") or ""):
            codec = ArenaRowCodec.for_metric(metric)
            if codec is not None and codec.is_encoded(arena):
                arena = codec.decode_buffers({k: np.asarray(v) for k, v in arena.items()})
            spill = _spill_part(pager_payload)
            if spill and codec is not None and codec.is_encoded(spill):
                pager_payload = _with_spill(pager_payload, codec.decode_buffers(spill))
        layout = ArenaLayout.for_state(metric.abstract_state())
        init_row = MultiStreamEngine._host_init_row(metric)
        if pane_rows == 1:
            rows = MultiStreamEngine._rows_from_parts(arena, pager_payload, init_row, s_snap, world)
            return layout.unpack_stacked({k: _tensor_from_numpy(v) for k, v in rows.items()})
        # a pane-extended ring: every (pane, stream) row through the ext-id
        # bijection the JAX engine routes by, a pure function of (world, panes)
        num_rows = -(-s_snap // world) * pane_rows * world
        rows = MultiStreamEngine._rows_from_parts(arena, pager_payload, init_row, num_rows, world)
        sids = np.arange(s_snap, dtype=np.int64)
        ext = ((sids // world) * pane_rows + np.arange(pane_rows, dtype=np.int64)[:, None]) * world + (sids % world)[None, :]
        return layout.unpack_stacked({k: _tensor_from_numpy(np.asarray(v)[ext]) for k, v in rows.items()}, lead=2)

    def _restore_commit(self, state: Any, meta: Dict[str, Any]) -> None:
        """The stream-shard restore matrix (the JAX package's):

        * paged snapshot -> paged engine of the same world and residency
          (same S): verbatim, arena rows into their slots and the pager's
          slot table and spill store as written, so replay is bit-exact;
        * paged snapshot -> paged engine of another world or residency: every
          stream's row is reassembled on the host and SEEDS this engine's
          spill store; the slots start empty and rows fault in on first
          touch, bit-exactly;
        * paged snapshot -> unsharded engine (same S): resident, spilled and
          init rows merge into the ``(S, ...)`` state.

        A plain snapshot into a paged engine, another stream count, a
        differing codec policy or layout are refused; nothing is written
        before every check passed."""
        snap_shard = bool(int(meta.get("stream_shard", 0) or 0))
        if not snap_shard and not self._stream_shard:
            super()._restore_commit(state, meta)
            return
        self._check_host_topology(meta)
        # pager rows MEAN (stream, pane) only under the policy that wrote them
        self._check_window_provenance(meta)
        if snap_shard and str(meta.get("window", "") or ""):
            # a windowed paged snapshot restores into a paged engine of the
            # same world (any residency: the pane-extended row id is a function
            # of the world and the panes); a world change or a merge into an
            # unsharded engine would re-interleave mid-ring coordinates
            w_snap = int(meta.get("world", 1))
            if not self._stream_shard or w_snap != self._world:
                raise MetricsTPUUserError(
                    "a WINDOWED stream-shard snapshot restores into a same-world stream-sharded topology only "
                    f"(snapshot world {w_snap}): pane-extended pager rows have no exact cross-world re-homing — "
                    "restore into a same-world engine (any resident_streams), or snapshot from an unwindowed one"
                )
        if not snap_shard:
            raise MetricsTPUUserError(
                "snapshot was not written by a stream-sharded engine; the stream-shard restore matrix covers "
                "{sharded+paged -> same-world, -> single-device merged} exactly — restore it into a non-sharded "
                "MultiStreamEngine"
            )
        s_snap = int(meta.get("num_streams", 0))
        world_snap = int(meta.get("world", 1))
        r_snap = int(meta.get("resident", 0))
        if s_snap != self._num_streams:
            raise MetricsTPUUserError(f"snapshot serves {s_snap} streams, this engine {self._num_streams}")
        arena = state.get("arena") if isinstance(state, dict) else None
        pager_payload = state.get("pager") if isinstance(state, dict) else None
        if arena is None or pager_payload is None:
            raise MetricsTPUUserError("stream-shard snapshot payload is missing arena/pager parts")
        # the buffer-form codec is not self-describing (positions come from
        # layout and policy): the snapshot's policy fingerprint must match
        snap_codec: Optional[ArenaRowCodec] = None
        if str(meta.get("codec", "") or ""):
            if str(meta.get("codec_fp", "") or "") != self._precision_tag:
                raise MetricsTPUUserError(
                    "compressed stream-shard snapshot was written under sync_precision policy "
                    f"{meta.get('codec_fp')!r}, this engine's metric declares {self._precision_tag!r}; restore it "
                    "with the matching policy"
                )
            snap_codec = self._row_codec or ArenaRowCodec.for_metric(self._metric)
            if snap_codec is not None and snap_codec.is_encoded(arena):
                arena = self._codec_call("quant_decode", snap_codec.decode_buffers,
                                         {k: np.asarray(v) for k, v in arena.items()})
        row_layout = ArenaLayout.for_state(self._metric.abstract_state())
        sizes = row_layout.buffer_sizes()
        if set(arena) != set(sizes) or any(
                tuple(np.shape(arena[k])) != (world_snap, r_snap, n) for k, n in sizes.items()):
            raise MetricsTPUUserError(
                "stream-shard snapshot arena does not match this metric's per-stream layout; was the metric "
                "reconfigured since the snapshot?"
            )
        if not self._stream_shard:
            decoded = {"arena": arena, "pager": self._decoded_pager_payload(pager_payload, snap_codec)}
            logical = self.sshard_piece_logical(self._metric, decoded, meta)
            carried = self._put_shards(self._shard0_trees(logical)) if self._deferred else self._put_state(logical)
            self._finish_restore(carried, meta)
            return
        init_row = self._host_init_row(self._metric)
        if world_snap == self._world and r_snap == self._resident:
            dtypes = {k: self._state_dtype(k) for k in arena}
            stacked = {k: _tensor_from_numpy(np.asarray(arena[k])).to(dtypes[k]) for k in arena}
            carried = ({k: v[0].to(self._device) for k, v in stacked.items()} if self._mesh is None
                       else self._put_stacked_carried(stacked))
            payload = self._normalized_pager_payload(pager_payload, snap_codec)
        else:
            # another topology: slot tables are topology-local, the rows are
            # not; every non-init row seeds the spill store
            rows = self._rows_from_parts(arena, self._decoded_pager_payload(pager_payload, snap_codec), init_row,
                                         self._row_universe(), world_snap)
            payload = self._normalized_pager_payload(self._seeded_pager_payload(rows, init_row), None)
            carried = self._put_state(self._metric.init_state())
        payload = {k: _pager_row(v) for k, v in payload.items()}  # the pager's host form: bf16 rows as f32
        with self._device_section():
            self._finish_restore(carried, meta)
            self._pager.load_payload(payload)
            self._q8_clear()
            self._refresh_gauges()

    # ------------------------------------------------------------ elastic reshard

    def _topology_state(self) -> Dict[str, Any]:
        t = super()._topology_state()
        if self._stream_shard:
            t.update(pager=self._pager, resident=self._resident, local_streams=self._local_streams,
                     q8=(self._q8_stage, self._q8_cols_dev), pages=self._shard_pages)
        return t

    def _apply_topology_state(self, t: Dict[str, Any]) -> None:
        super()._apply_topology_state(t)
        if self._stream_shard:
            self._pager, self._resident, self._local_streams = t["pager"], t["resident"], t["local_streams"]
            self._q8_stage, self._q8_cols_dev = t["q8"]
            self._shard_pages = t["pages"]
            self._refresh_gauges()

    def _apply_topology(self, mesh: Mesh, world: int, policy: Any, resident_streams: Optional[int] = None) -> None:
        if self._stream_shard:
            # the stream-shard factor IS the world: the per-shard stream census
            # and a FRESH pager; the restore right after re-homes every row
            self._local_streams = -(-self._num_streams // world) * self._pane_rows
            r = int(resident_streams) if resident_streams is not None else self._resident
            self._resident = min(max(1, r), self._local_streams)
            self._pager = StreamPager(world, self._resident)
            self._shard_pages = [[0, 0] for _ in range(world)]
        super()._apply_topology(mesh, world, policy, resident_streams)
        if self._stream_shard:
            self._q8_reset_stage()
            self._refresh_gauges()

    @property
    def pager(self) -> Optional[StreamPager]:
        return self._pager
