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
* **Paged** (``stream_shard=True``): the JAX package's stream-sharded engine
  on a one-device mesh (world = 1). The carried state is one ``(resident, n)``
  slot-stacked buffer per dtype, where ``n`` is one stream's packed arena row;
  an LRU pager (``engine/paging.py``) spills cold streams' rows to host RAM
  and faults them back in on their next submit, so device memory is bounded
  by the working set, not by S. Pager slot ids are the segment ids. Under
  ``"megastep"`` the step is :meth:`MegastepPlan.apply_segmented`: one K6
  launch per eligible dtype, and with ``compress_payloads=True`` the dtypes
  the q8 codec compresses take K7 on every step, which decodes the slots
  paged in as int8 codes on touch ("q8-resident" rows: the host never
  dequantizes them).

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
message. Multi-GPU stream sharding over ``torch.distributed`` is not ported
yet (ROADMAP §A).

Windows (``engine/windows.py``): on the unsharded form the pane axis stacks
OUTSIDE the stream axis (``(panes, S, ...)`` logical state; a step writes the
current pane's ``(S, ...)`` row), and a drift detector records one series per
stream at each rotation. On the paged form the pane extends the pager's
stream coordinate (``row = stream * panes + pane``): each (stream, pane) pair
is its own pager row, so cold panes spill like cold streams, a step touches
only the current pane's rows, and a rotation expires the incoming pane's
rows in the pager's tables with no device work. A sliding ``result(sid)``
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
from metrics_tpu_torch.engine.bucketing import WHOLE, classify_leaves
from metrics_tpu_torch.engine.paging import StreamPager
from metrics_tpu_torch.engine.pipeline import EngineConfig, StreamingEngine, _add_committed
from metrics_tpu_torch.engine.quantize import ArenaRowCodec
from metrics_tpu_torch.engine.trace import ENGINE_TRACE
from metrics_tpu_torch.engine.windows import WindowPolicy
from metrics_tpu_torch.metric import StateSpec
from metrics_tpu_torch.utils.checks import traced_rows
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.state_bridge import _pager_row, _payload_row, _tensor_from_numpy, state_to_numpy
from metrics_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["MultiStreamEngine"]

_SHARD = 0  # the one shard of the world-1 pager


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
            rows = num_streams * self._pane_rows
            r = int(resident_streams) if resident_streams is not None else rows
            if r <= 0:
                raise MetricsTPUUserError(f"resident_streams must be positive, got {resident_streams!r}")
            self._resident = min(r, rows)
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
            # the JAX package's stream-sharded engine at world 1: no
            # steady-state collective, boundary reads per row
            self._stats.mesh_sync = "stream_shard"
            self._pager = StreamPager(1, self._resident)
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
        if not self._stream_shard:
            return super()._put_state(tree)
        row = super()._put_state(tree)
        return {k: v.reshape(1, -1).repeat(self._resident, 1) for k, v in row.items()}

    # -------------------------------------------------------------------- the step

    def _traced_update(self, state_tree: Any, payload: Any, mask: torch.Tensor) -> Any:
        a, kw = payload
        ids, rest = a[0], a[1:]
        # paged mode addresses pager SLOTS, unsharded mode stream rows
        num = self._resident if self._stream_shard else self._num_streams
        return self._metric.update_state_segmented(state_tree, *rest, mask=mask, segment_ids=ids,
                                                   num_segments=num, **kw)

    def _step_aux(self) -> Any:
        return self._q8_payload()

    def _step_state(self, state: Any, aux: Any, a: Tuple[Any, ...], kw: Dict[str, Any], mask: torch.Tensor) -> Any:
        if not self._stream_shard:
            return super()._step_state(state, aux, a, kw, mask)
        if self._megastep_plan is not None:
            return self._megastep_plan.apply_segmented(state, a[1:], kw, mask, a[0], self._resident,
                                                       q8_stage=aux, q8_cols=self._q8_cols_dev)
        if aux:
            # the demoted body of a q8-staging engine: seat the staged slots
            # with the codec's own arithmetic first (int8 -> f32, one f32
            # multiply, one cast), as K7's seed does, then the per-leaf K4
            state = dict(state)
            for k, (flags, codes, scales) in aux.items():
                on = (flags.reshape(-1, 1) != 0) & (self._q8_cols_dev[k].reshape(1, -1) != 0)
                state[k] = torch.where(on, (codes.to(torch.float32) * scales).to(state[k].dtype), state[k])
        tree = self._layout.unpack_stacked(state)
        return self._layout.pack_stacked(self._traced_update(tree, (a, kw), mask))

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
        """Run a batch through the pager in ROUNDS (the JAX package's routed
        execution at world 1): each round takes up to the top bucket's rows
        and at most ``resident`` distinct streams (so the pager can always
        seat it), pages those streams resident, and runs ONE padded step
        whose segment ids are the pager's slot indices. With a recorder, the
        group's routing is one ``route`` span (its rows and rounds)."""
        t_route0 = time.perf_counter()
        leaves, _ = tree_flatten((tuple(args), kwargs))
        # the pager rows of the CURRENT pane, for the whole group at once: the
        # cursor is constant across the call (rotations fall between groups)
        locs = self._route_locs(sids)
        per_top = self._policy.buckets[-1]
        route_us = (time.perf_counter() - t_route0) * 1e6
        cursor, committed = 0, 0
        try:
            while cursor < n:
                t0 = time.perf_counter()
                end, distinct = cursor, set()
                while end < n and end - cursor < per_top:
                    loc = int(locs[end])
                    if loc not in distinct and len(distinct) >= self._resident:
                        break
                    distinct.add(loc)
                    end += 1
                valid = end - cursor
                bucket = self._policy.bucket_for(valid)
                round_locs = locs[cursor:end]
                kinds = classify_leaves(leaves, n, bucket)
                self._page_round([int(x) for x in round_locs])
                uniq = np.unique(round_locs)
                slots = np.asarray([self._pager.slot_of(_SHARD, int(u)) for u in uniq], np.int32)
                slot_ids = np.zeros((bucket,), np.int32)  # pad rows address slot 0, masked
                slot_ids[:valid] = slots[np.searchsorted(uniq, round_locs)]
                # the slot ids lead the args as one whole (bucket,) leaf
                step_leaves, step_def = tree_flatten(((slot_ids,) + tuple(args), kwargs))
                try:
                    self._run_padded_step(step_leaves, [WHOLE] + kinds, step_def, cursor, end, bucket,
                                          coalesced if cursor == 0 else 1, queue_wait_us if cursor == 0 else 0.0,
                                          t0)
                except BaseException:
                    # a failed step never ran the kernel's decode: seat the staged
                    # slots through the host decode before anything reads them
                    self._q8_flush()
                    raise
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
                self._pager.touch(_SHARD, [int(x) for x in round_locs])
                cursor = end
        except Exception as e:
            _add_committed(e, committed)
            raise
        tr = self._trace
        if tr is not None:
            tr.complete("route", trace=self._group_tid or ENGINE_TRACE, dur_us=route_us, rows=int(n),
                        rounds=committed)
            tr.observe("route_us", route_us)

    def _home_row(self, sid: int, pane: Optional[int] = None) -> int:
        """Stream id (+ pane under a ring window) -> its pager row coordinate
        (world 1). The pane EXTENDS the stream index (``sid * panes + pane``):
        each (stream, pane) pair owns its own row, so cold panes page like
        cold streams. ``pane`` defaults to the current one."""
        if self._pane_rows == 1:
            return sid
        return sid * self._pane_rows + (self._pane_cursor if pane is None else int(pane))

    def _route_locs(self, sids: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`_home_row` for the current pane (a step only ever
        touches the pane being written)."""
        locs = np.asarray(sids, np.int64)
        return locs * self._pane_rows + self._pane_cursor if self._pane_rows > 1 else locs

    def _row_universe(self) -> int:
        """Pager rows a paged engine can address: one per (stream, pane)."""
        return self._num_streams * self._pane_rows

    def _pane_index(self, panes: Any) -> np.ndarray:
        """The ``(len(panes), S)`` pager rows of every stream in each listed
        pane, pane-major like the logical ``(panes, S, ...)`` state."""
        sids = np.arange(self._num_streams, dtype=np.int64)
        return sids[None, :] * self._pane_rows + np.asarray(list(panes), np.int64)[:, None]

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
        tree = self._unpack_row(self._pane_row(self._pane_cursor)) if self._win_stacked else self._unpack(self._state)
        with traced_rows():
            values = torch.func.vmap(self._metric.compute_from)(tree)
            return list(enumerate(_values_to_host(values, self._num_streams)))

    def _page_round(self, streams: List[int]) -> None:
        """Make every stream in ``streams`` resident: plan with the pager,
        spill the evicted rows to host RAM (encoded under
        ``compress_payloads``; the ``page_out`` and ``quant_encode`` sites),
        write the faulted-in rows (spilled, staged or init) into their slots
        (``page_in``, ``quant_decode``), then commit the bookkeeping. Each
        phase retries a transient fault through the engine's bounded retry,
        its sites consulted before any byte moves; the arena is written in
        place only after the rows to seat are known, and the staged flags,
        ``page_outs``/``page_ins`` and the pager's tables only after the rows
        landed."""
        ops, hits, faults = self._pager.plan_residency(_SHARD, streams)
        self._stats.page_hits += hits
        self._stats.page_faults += faults
        evicts = [op for op in ops if op.kind == "evict"]
        loads = [op for op in ops if op.kind == "load"]
        tr = self._trace
        gid = self._group_tid or ENGINE_TRACE
        spilled: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        if evicts:
            js = torch.tensor([op.slot for op in evicts], device=self._device)

            def spill_once() -> Tuple[Dict[str, np.ndarray], float]:
                self._fault("page_out")
                t0 = time.perf_counter()
                rows = {k: _host(gather_rows(v, js)) for k, v in self._state.items()}  # one gather per dtype
                if self._compress and self._row_codec is not None:
                    # quantize BEFORE host RAM holds them; pure in ``rows``
                    self._fault("quant_encode")
                    rows = self._row_codec.encode_buffers(rows)
                return rows, t0

            rows, t0 = self._retry_transient(spill_once)
            dur = (time.perf_counter() - t0) * 1e6
            for i, op in enumerate(evicts):
                spilled[(op.shard, op.stream)] = {k: rows[k][i].copy() for k in rows}
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
                    raw = self._pager.spilled_row(_SHARD, op.stream) if self._q8_keys else None
                    if raw is not None and self._row_codec.is_encoded(raw):
                        # q8-resident seat: the staged dtypes' quantized columns
                        # stay zero here; K7 decodes them on the next step
                        self._fault("quant_decode")
                        seed, st = self._row_codec.stage_buffers(raw, self._q8_keys)
                        src_rows.append(seed)
                        staged.append(st)
                    else:
                        src_rows.append(self._decoded_spill_row(op.stream) or self._init_row)
                        staged.append(None)
                return src_rows, staged

            src_rows, staged = self._retry_transient(load_once)
            js = torch.tensor([op.slot for op in loads], device=self._device)
            for k, buf in self._state.items():
                scatter_rows(buf, js, torch.from_numpy(np.stack([r[k] for r in src_rows])).to(self._device))
            for op, st in zip(loads, staged):
                if st is not None:
                    self._stats.q8_staged_rows += 1
                    self._q8_stage["flags"][op.slot] = 1
                    for k in self._q8_keys:
                        codes, scales = self._q8_stage[k]
                        codes[op.slot] = torch.from_numpy(st[k][0]).to(self._device)
                        scales[op.slot] = torch.from_numpy(st[k][1]).to(self._device)
            self._stats.page_ins += len(loads)
            if tr is not None:
                dur = (time.perf_counter() - t_load) * 1e6
                tr.complete("page_in", trace=gid, dur_us=dur, rows=len(loads))
                tr.observe("page_in_us", dur)
        if ops:
            self._pager.commit(ops, spilled)
        self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        """The paging gauges of the telemetry: occupied slots, spilled
        streams and the spill store's bytes in host RAM."""
        self._stats.resident_streams = self._pager.resident_count()
        self._stats.spilled_streams = self._pager.spilled_count()
        self._stats.spilled_bytes = self._pager.spill_nbytes()

    # -------------------------------------------------------- q8-resident staging

    def _q8_reset_stage(self) -> None:
        """Judge the staged dtype set (megastep-eligible dtypes the codec
        compresses) and allocate the device staging buffers: flags
        ``(resident,)`` int32 plus per dtype codes ``(resident, n)`` int8 and
        scales ``(resident, n)`` f32."""
        self._q8_cols: Optional[Dict[str, np.ndarray]] = None
        self._q8_cols_dev: Optional[Dict[str, torch.Tensor]] = None
        if not self._q8_enabled:
            self._q8_keys, self._q8_stage = (), {}
            return
        q_mask = self._row_codec.q_mask
        self._q8_keys = tuple(k for k in self._megastep_plan.eligible_keys() if k in q_mask)
        if not self._q8_keys:
            self._q8_stage = {}
            return
        sizes = self._layout.buffer_sizes()
        r, dev = self._resident, self._device
        self._q8_stage = {"flags": torch.zeros((r,), dtype=torch.int32, device=dev)}
        for k in self._q8_keys:
            self._q8_stage[k] = (torch.zeros((r, sizes[k]), dtype=torch.int8, device=dev),
                                 torch.zeros((r, sizes[k]), dtype=torch.float32, device=dev))
        self._q8_cols = {k: q_mask[k] for k in self._q8_keys}
        # the same masks on the device, made once: K7 reads them on every step
        self._q8_cols_dev = {k: torch.from_numpy(q_mask[k].astype(np.int32)).to(dev) for k in self._q8_keys}

    def _q8_payload(self) -> Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]]:
        """The staging every step of a q8 engine passes to K7 (all flags zero
        when nothing is staged); None when staging is off."""
        if not self._q8_keys:
            return None
        flags = self._q8_stage["flags"]
        return {k: (flags,) + tuple(self._q8_stage[k]) for k in self._q8_keys}

    def _q8_clear(self) -> None:
        if self._q8_keys:
            self._q8_stage["flags"].zero_()

    def _q8_flush(self) -> None:
        """Seat any PENDING staged slots through the host decode (the codec's
        own arithmetic: int8→f32, one f32 multiply, one cast), for a step that
        never ran the kernel's seed."""
        if not self._q8_keys:
            return
        js = torch.nonzero(self._q8_stage["flags"]).reshape(-1)
        if js.numel():
            for k in self._q8_keys:
                codes, scales = (_host(t[js]) for t in self._q8_stage[k])
                mask = self._q8_cols[k]
                rows = _host(self._state[k][js])
                rows[:, mask] = (codes.astype(np.float32) * scales)[:, mask]
                self._state[k][js] = torch.from_numpy(rows).to(self._device, self._state[k].dtype)
        self._q8_clear()

    # --------------------------------------------------------------------- readers

    def _decoded_spill_row(self, stream: int) -> Optional[Dict[str, np.ndarray]]:
        """One stream's spilled row from host RAM, decoded when stored
        compressed (the ``quant_decode`` site; pure in the stored row, so a
        transient retries clean)."""
        row = self._pager.spilled_row(_SHARD, stream)
        if row is not None and self._row_codec is not None and self._row_codec.is_encoded(row):
            row = self._codec_call("quant_decode", self._row_codec.decode_buffers, row)
        return row

    def _fetch_row(self, sid: int, pane: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """ONE (stream, pane) packed arena row on the device: its slot when
        resident, the host-spilled copy when paged out (no eviction), else the
        init row. ``pane`` defaults to the current one."""
        loc = self._home_row(sid, pane)
        slot = self._pager.slot_of(_SHARD, loc)
        if slot is not None:
            return {k: v[slot] for k, v in self._state.items()}
        row = self._decoded_spill_row(loc) or self._init_row
        return {k: torch.from_numpy(np.asarray(v)).to(self._device, self._state[k].dtype) for k, v in row.items()}

    def _all_rows(self) -> Dict[str, torch.Tensor]:
        """Every pager row, ``(S, n)`` per dtype on the device (``(S * panes,
        n)`` under a ring window, row ``sid * panes + pane``): the init row
        tiled, the spilled rows (decoded when stored compressed) written in
        one upload per dtype, then the resident slots in one device gather per
        dtype (a resident row has no spill entry)."""
        dev, s = self._device, self._row_universe()
        out = {k: torch.from_numpy(self._init_row[k]).to(dev, buf.dtype).expand(s, -1).clone()
               for k, buf in self._state.items()}
        encoded: List[Tuple[int, Dict[str, np.ndarray]]] = []
        plain: List[Tuple[int, Dict[str, np.ndarray]]] = []
        for sid in self._pager.spilled_streams(_SHARD):
            row = self._pager.spilled_row(_SHARD, sid)
            is_enc = self._row_codec is not None and self._row_codec.is_encoded(row)
            (encoded if is_enc else plain).append((sid, row))
        for group, decode in ((encoded, True), (plain, False)):
            if not group:
                continue
            sids = torch.from_numpy(np.asarray([g[0] for g in group], np.int64)).to(dev)
            stacked = {key: np.stack([g[1][key] for g in group]) for key in group[0][1]}
            if decode:
                stacked = self._codec_call("quant_decode", self._row_codec.decode_buffers, stacked)
            for k in self._state:
                scatter_rows(out[k], sids, torch.from_numpy(stacked[k]).to(dev))
        resident = self._pager.resident_streams(_SHARD)
        if resident:
            sids = torch.from_numpy(np.asarray(resident, np.int64)).to(dev)
            slots = torch.from_numpy(np.asarray([self._pager.slot_of(_SHARD, r) for r in resident], np.int64)).to(dev)
            for k, buf in self._state.items():
                scatter_rows(out[k], sids, gather_rows(buf, slots))
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
        return tree_map(pick, self._unpack(self._state))

    def _stream_tree(self, sid: int) -> Any:
        """One stream's RESULT view: its state, or under a window the open
        pane of a tumbling ring or the fold of a sliding ring's panes."""
        if self._stream_shard:
            if self._pane_rows == 1 or self._window.kind == "tumbling":
                return self._layout.unpack(self._fetch_row(sid))
            return self._metric.merge_stacked_states(self._stream_ring(sid))
        tree = self._unpack(self._state)
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
            return self._unpack(self._state)
        if self._pane_rows == 1:
            return self._layout.unpack_stacked(self._all_rows())
        return self._layout.unpack_stacked(self._paged_rows(range(self._pane_rows)), lead=2)

    def _stacked_tree(self) -> Any:
        """The ``(S, ...)``-stacked RESULT view of every stream: the state, or
        under a window its open pane or the fold of its panes."""
        if not self._stream_shard:
            return self._window_tree(self._unpack(self._state))
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
                cold = self._pager.slot_of(_SHARD, sid) is None if self._stream_shard else True
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
                    self._pager.drop(_SHARD, self._home_row(sid, p))
                self._refresh_gauges()
                return
            init = tree_leaves(self._metric.init_state())
            for leaf, fresh in zip(tree_leaves(self._unpack(self._state)), init):
                # in place: the leaves view the arena (the stream axis sits
                # under the pane axis of a ring)
                if self._win_stacked:
                    leaf[:, sid] = fresh.to(leaf.device)
                else:
                    leaf[sid] = fresh.to(leaf.device)

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
        arena: Dict[str, Any] = {k: v[None] for k, v in state_to_numpy(self._state).items()}  # (world=1, R, n)
        if self._compress and self._row_codec is not None:
            arena = self._codec_call("quant_encode", self._row_codec.encode_buffers, arena)
        # spilled rows are already in their at-rest form (encoded on the way
        # to host RAM); a bf16 buffer's narrow back from the pager's f32
        pager = {k: _payload_row(k, v) for k, v in self._pager.snapshot_payload().items()}
        return {"arena": arena, "pager": pager}

    def _snapshot_meta_extra(self) -> Dict[str, Any]:
        if not self._stream_shard:
            return {}
        return {"stream_shard": 1, "num_streams": self._num_streams, "resident": self._resident, "world": 1}

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
        """A pager payload for THIS engine (world 1, ``resident`` slots): an
        empty slot table and every non-init stream row in the spill store,
        so each faults in on its first touch. A row holding NaN compares
        unequal and spills: conservative, never lossy."""
        payload: Dict[str, Any] = {"slots": np.full((1, self._resident), -1, np.int64)}
        keys = sorted(rows)
        diff = np.zeros((self._row_universe(),), bool)
        for k in keys:
            diff |= ~np.all(np.asarray(rows[k]) == np.asarray(init_row[k])[None], axis=1)
        sids = np.nonzero(diff)[0].astype(np.int64)
        if sids.size:
            payload["spill_coords"] = np.stack([np.zeros_like(sids), sids], axis=1)
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
        """The stream-shard restore matrix (the JAX package's, at world 1):

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
        # pager rows MEAN (stream, pane) only under the policy that wrote them
        self._check_window_provenance(meta)
        if snap_shard and str(meta.get("window", "") or ""):
            # a windowed paged snapshot restores into a paged engine of the
            # same world (any residency: the pane-extended row id is a function
            # of the world and the panes); a world change or a merge into an
            # unsharded engine would re-interleave mid-ring coordinates
            w_snap = int(meta.get("world", 1))
            if not self._stream_shard or w_snap != 1:
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
            self._finish_restore(self._put_state(self.sshard_piece_logical(self._metric, decoded, meta)), meta)
            return
        init_row = self._host_init_row(self._metric)
        if world_snap == 1 and r_snap == self._resident:
            carried = {k: _tensor_from_numpy(np.asarray(arena[k])[0]).to(self._device, buf.dtype)
                       for k, buf in self._state.items()}
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

    @property
    def pager(self) -> Optional[StreamPager]:
        return self._pager
