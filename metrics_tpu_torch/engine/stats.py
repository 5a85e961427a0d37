"""Ring-buffer telemetry for the streaming engine.

Port of ``metrics_tpu/engine/stats.py``, whole. Serving observability without
unbounded host memory: a fixed-capacity ring of per-step records plus
monotonic counters, exported as one JSON document in the JAX package's shape
(``tools/engine_report.py`` pretty-prints either package's). Records carry
HOST-side observables only — queue depth at dispatch, padding waste, ingest
time, and the sync latency of the steps that actually blocked (the in-flight
bound means most steps don't) — the device's own time lives in
``torch.profiler`` traces (``engine/trace.py``'s ``device_trace_session``).

Each layer's block returns None while nothing records into it, as in the
JAX package: the ``fleet`` block only for an engine a
:class:`~metrics_tpu_torch.engine.fleet.FleetEngine` manages, so a
single-process engine's document stays byte-stable. The port adds counters of its own: ``warmup_steps`` (steps run once on a copy of the
state before a CUDA graph capture), ``q8_staged_rows`` (paged-in rows seated
as int8 codes for K7 to decode) and ``result_device_calls`` in
:meth:`EngineStats.summary`, and in the ``mesh_sync`` block a mesh engine's
``transport`` and ``shard_losses``.
"""
import json
import math
import os
import threading
from typing import Any, Dict, List, Optional

from metrics_tpu_torch.engine.bucketing import BucketPolicy

__all__ = ["EngineStats"]


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    k = (len(sorted_vals) - 1) * q
    lo, hi = math.floor(k), math.ceil(k)
    if lo == hi:
        return sorted_vals[lo]
    return sorted_vals[lo] * (hi - k) + sorted_vals[hi] * (k - lo)


class EngineStats:
    """Fixed-capacity per-step telemetry ring + lifetime counters."""

    def __init__(self, capacity: int = 1024):
        if capacity <= 0:
            raise ValueError(f"telemetry capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._ring: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self.steps = 0
        self.batches_submitted = 0
        self.batches_coalesced = 0  # submitted batches folded into a shared step
        self.megasteps = 0          # steps that carried > 1 submitted batch
        self.warmup_steps = 0  # steps run once on a copy of the state before a capture
        self.rows_in = 0
        self.rows_padded = 0
        self.snapshots = 0
        self.resumes = 0
        # mesh sync accounting: "step" engines pay a collective inside every
        # step (its latency shows up as the per-step sync_us when the
        # dispatcher blocks); "deferred" engines pay collectives only at
        # explicit merge boundaries, recorded here. None = no mesh. The
        # *_us_total counters are LIFETIME sums (unlike the bounded ring), so
        # collective_share compares like with like on runs longer than the
        # ring window.
        self.mesh_sync: Optional[str] = None
        # the mesh's collective transport ("nccl" across devices,
        # "one_device" for shards on one device), fixed at construction
        self.mesh_transport: Optional[str] = None
        self.merges = 0
        self.merge_us_total = 0.0
        # non-transient shard losses the engine survived by resharding
        self.shard_losses = 0
        self.wall_us_total = 0.0
        self.sync_us_total = 0.0
        # quantized-sync payload accounting: bytes one shard
        # contributed to the fused sync's collectives, split by rider —
        # exact (f32 psum bundle / digit riders / verbatim carrier) vs
        # quantized (block-scaled int8 codes + scales). Counted per boundary
        # merge under deferred sync, per step under step sync; analytic from
        # the state signature (parallel/collectives.py::fused_sync_plan), so
        # the counters cost no device work. Rendered as the OpenMetrics
        # sync_payload_bytes{kind=...} counters.
        self.sync_payload_exact_bytes = 0
        self.sync_payload_quant_bytes = 0
        # fault-tolerance accounting: injected faults by site, and
        # every recovery action the engine took — retries with backoff,
        # pre-step rollbacks, ``megastep -> auto`` kernel demotions, coalesce
        # degradations/shrinks, watchdog expiries, quarantined (dead-
        # lettered) batches, snapshot write failures and restore fallbacks.
        # All lifetime counters; rendered by tools/engine_report.py.
        self.faults_injected: Dict[str, int] = {}
        # kernel-dispatch fallbacks by reason: every time the
        # engine's megastep plan (or the per-leaf dispatcher on its behalf)
        # declined the fused path, keyed by WHY — ``engine:<reason>`` for
        # whole-engine ineligibility (no arena, replicated mesh, stacked
        # multistream layout), ``dtype.<key>:<reason>`` for a single arena
        # dtype that fell back per-leaf (strategy/dtype/vmem). Construction-
        # time plan verdicts count ONCE (the plan is static), so the counter
        # reads as "how much of this engine's state runs off the fused path",
        # not a per-step rate. Rendered as the OpenMetrics
        # ``kernel_fallbacks_total{reason=...}`` counter.
        self.kernel_fallbacks: Dict[str, int] = {}
        self.retries = 0
        self.rollbacks = 0
        self.kernel_demotions = 0
        self.coalesce_degraded = 0
        self.coalesce_shrinks = 0
        self.watchdog_timeouts = 0
        self.quarantined_batches = 0
        self.quarantined_rows = 0
        self.snapshot_failures = 0
        self.snapshot_fallbacks = 0
        # stream-sharded serving: host-side routing + LRU paging.
        # page_hits = submitted rows' streams already resident; page_faults =
        # streams faulted into an arena slot (from host spill or init);
        # page_ins/page_outs = row movements between HBM and host RAM. The
        # *_streams values are point-in-time gauges the engine refreshes at
        # scrape boundaries (resident = occupied arena slots across shards,
        # spilled = rows currently living in host RAM).
        self.routed_steps = 0
        # device computations issued by MultiStreamEngine.result()/results():
        # the dispatch-count observable — results() must add exactly ONE per
        # call, for any S (the batched all-streams program)
        self.result_device_calls = 0
        self.page_hits = 0
        self.page_faults = 0
        self.page_ins = 0
        self.page_outs = 0
        self.q8_staged_rows = 0  # page-ins seated as int8 codes for K7 to decode
        self.resident_streams = 0
        self.spilled_streams = 0
        # host-RAM bytes of the spill store at the last gauge refresh — the
        # footprint compress_payloads quantizes
        self.spilled_bytes = 0
        # cross-thread counter lock : every
        # counter that PRODUCER threads bump concurrently with the dispatcher
        # — admission outcomes by priority class, retries, deferred reads,
        # submitted batches, fault firings — goes through a record_* method
        # under this lock: a bare `+=`/`dict[k] += 1` is a read-modify-write
        # the GIL does not make atomic.
        self._counter_lock = threading.Lock()
        self.admission_admitted: Dict[int, int] = {}
        self.admission_rejected: Dict[int, int] = {}
        self.admission_shed: Dict[int, int] = {}
        # ladder_level is a gauge (current rung count engaged); transitions a
        # lifetime counter; deferred_reads counts result() calls served from
        # the stale-read cache while the defer_cold_reads rung was engaged.
        self.ladder_level = 0
        self.ladder_transitions = 0
        self.deferred_reads = 0
        # live elastic resharding: count + the last transition's coordinates
        # (from/to world, replay cursor) — what engine_report surfaces
        self.reshards = 0
        self.reshard_last: Optional[Dict[str, Any]] = None
        # windowed semantics: pane-ring rotation accounting.
        # window_policy is the canonical policy tag (set at engine
        # construction, None for cumulative engines — their telemetry
        # documents stay byte-stable); live_panes/pane_cursor are gauges
        # refreshed at each rotation, the counters are lifetime totals.
        self.window_policy: Optional[str] = None
        self.pane_rotations = 0
        self.ewma_decays = 0
        self.live_panes = 0
        self.pane_cursor = 0
        self.drift_evals = 0
        self.drift_alarms = 0
        # fleet serving: host-topology gauges + per-host boundary
        # counters. fleet_hosts None = not fleet-managed (every pre-fleet
        # telemetry document stays byte-stable). Counters move on the fleet
        # caller's thread only (ingest/result/snapshot are per-host
        # single-threaded boundaries), but ride the counter lock anyway —
        # the lock cost is one boundary op, not a hot-path step.
        self.fleet_hosts: Optional[int] = None
        self.fleet_process_id = 0
        self.fleet_streams_owned = 0
        self.fleet_ingested = 0   # plan batches homed here and submitted
        self.fleet_skipped = 0    # plan batches homed on another host
        self.fleet_merges = 0     # cross-host boundary folds (result/results)
        self.fleet_merge_us_total = 0.0
        self.fleet_barriers = 0   # snapshot-cut barrier entries
        self.fleet_cuts = 0       # globally consistent snapshot cuts written
        # the CROSS-HOST fold's own payload accounting — deliberately NOT
        # the shared sync_payload_* counters: a fleet host with a local
        # deferred mesh also pays a host-local boundary merge per fold
        # (recorded there), and summing the two surfaces would double-count
        # what actually crossed hosts
        self.fleet_payload_exact_bytes = 0
        self.fleet_payload_quant_bytes = 0
        # fleet tenancy: the hierarchical fold's INTRA-host leg
        # (bytes the host-local exact merge folds per boundary — scales with
        # this host's stream residency) vs the cross legs above (scale with
        # hosts), plus the stream pager's spill gauges — per-host device
        # residency stays flat while spilled tenants grow host RAM only
        self.fleet_payload_intra_bytes = 0
        self.fleet_spill_rows = 0
        self.fleet_spill_bytes = 0
        self.fleet_resident_rows = 0
        # ragged serving: group-keyed ingestion. ragged_groups
        # None = not a ragged engine (every prior telemetry document stays
        # byte-stable); capacity is the per-group row budget gauge. The
        # counters ride the counter lock — submits come from producer
        # threads, the overflow counter from reader threads (aggregate()).
        self.ragged_groups: Optional[int] = None
        self.ragged_capacity = 0
        self.ragged_batches = 0
        self.ragged_rows = 0
        self.ragged_groups_touched = 0
        self.ragged_overflows = 0
        # aggregate reads by path: device = the compiled fold /
        # corpus-bundle path, oracle = the host eager replay.  agg_blocks
        # counts paged-sweep block dispatches — G-independent for a fixed
        # touched population, the O(1)-dispatch observable the smoke pins.
        self.ragged_agg_device_reads = 0
        self.ragged_agg_oracle_reads = 0
        self.ragged_agg_blocks = 0

    def record_admission(self, outcome: str, priority: int) -> None:
        """One admission verdict (``"admitted"``/``"rejected"``/``"shed"``)
        for a submit in ``priority`` class — called from producer threads,
        so the bump is serialized under the admission lock."""
        target = {
            "admitted": self.admission_admitted,
            "rejected": self.admission_rejected,
            "shed": self.admission_shed,
        }[outcome]
        with self._counter_lock:
            target[int(priority)] = target.get(int(priority), 0) + 1

    def record_submitted(self) -> None:
        """One accepted submit. Locked: producers submit CONCURRENTLY, and a
        bare ``batches_submitted += 1`` on their threads loses increments —
        the same read-modify-write class the admission counters lock for."""
        with self._counter_lock:
            self.batches_submitted += 1

    def record_retry(self) -> None:
        """One bounded-retry attempt. Locked: admission-site retries come
        from PRODUCER threads concurrently with the dispatcher's step
        retries — a bare ``+=`` can lose one."""
        with self._counter_lock:
            self.retries += 1

    def record_deferred_read(self) -> None:
        """One stale read served by the defer_cold_reads rung — reader
        threads call ``result()`` concurrently, so the bump locks."""
        with self._counter_lock:
            self.deferred_reads += 1

    def record_reshard(self, from_world: int, to_world: int, cursor: int, auto: bool) -> None:
        """One live reshard transition (manual or shard-loss-triggered)."""
        self.reshards += 1
        self.reshard_last = {
            "from_world": int(from_world),
            "to_world": int(to_world),
            "cursor": int(cursor),
            "auto": bool(auto),
        }

    def admission_summary(self) -> Optional[Dict[str, Any]]:
        """The admission/ladder block for :meth:`summary` — None when the
        engine ran with neither an admission policy nor a ladder (its
        telemetry document is then unchanged). Priority keys stringify for
        JSON round-trip stability."""
        with self._counter_lock:
            admitted = dict(self.admission_admitted)
            rejected = dict(self.admission_rejected)
            shed = dict(self.admission_shed)
        if (
            not (admitted or rejected or shed)
            and not self.ladder_transitions
            and not self.ladder_level
            and not self.deferred_reads
        ):
            return None
        return {
            "admitted_by_priority": {str(k): v for k, v in sorted(admitted.items())},
            "rejected_by_priority": {str(k): v for k, v in sorted(rejected.items())},
            "shed_by_priority": {str(k): v for k, v in sorted(shed.items())},
            "ladder_level": self.ladder_level,
            "ladder_transitions": self.ladder_transitions,
            "deferred_reads": self.deferred_reads,
        }

    def record_rotation(self, cursor: int, live: int, ewma: bool) -> None:
        """One committed pane rotation (dispatcher thread only)."""
        self.pane_rotations += 1
        if ewma:
            self.ewma_decays += 1
        self.pane_cursor = int(cursor)
        self.live_panes = int(live)

    def windows_summary(self) -> Optional[Dict[str, Any]]:
        """The windowed-semantics block for :meth:`summary` — None for
        cumulative engines (no window policy was ever set), so every
        pre-window telemetry document is unchanged."""
        if self.window_policy is None:
            return None
        out: Dict[str, Any] = {
            "policy": self.window_policy,
            "pane_rotations": self.pane_rotations,
            "live_panes": self.live_panes,
            "pane_cursor": self.pane_cursor,
        }
        if self.ewma_decays:
            out["ewma_decays"] = self.ewma_decays
        if self.drift_evals or self.drift_alarms:
            out["drift"] = {
                "evals": self.drift_evals,
                "alarms": self.drift_alarms,
            }
        return out

    def record_ragged_submit(self, rows: int, groups: int) -> None:
        """One accepted ragged submit: ``rows`` payload rows spanning
        ``groups`` distinct group keys. Locked — ragged producers submit
        concurrently like any stream producers."""
        with self._counter_lock:
            self.ragged_batches += 1
            self.ragged_rows += int(rows)
            self.ragged_groups_touched += int(groups)

    def record_ragged_overflow(self, groups: int) -> None:
        """One aggregate read refused because ``groups`` group(s) exceeded
        capacity. Locked — reader threads call ``aggregate()`` concurrently
        with producers."""
        with self._counter_lock:
            self.ragged_overflows += int(groups)

    def record_ragged_aggregate(self, path: str, blocks: int = 0) -> None:
        """One aggregate ``result()`` served: ``path`` is ``"device"`` (the
        compiled fold / corpus bundle) or ``"oracle"`` (the host eager
        replay); ``blocks`` counts the paged sweep's block dispatches (0 off
        ``group_shard``). Locked — readers aggregate concurrently with
        producers."""
        with self._counter_lock:
            if path == "device":
                self.ragged_agg_device_reads += 1
            else:
                self.ragged_agg_oracle_reads += 1
            self.ragged_agg_blocks += int(blocks)

    def ragged_summary(self) -> Optional[Dict[str, Any]]:
        """The ragged-serving block for :meth:`summary` — None for engines
        that never declared a group universe (every non-ragged telemetry
        document stays byte-stable)."""
        if self.ragged_groups is None:
            return None
        with self._counter_lock:
            return {
                "groups": self.ragged_groups,
                "capacity": self.ragged_capacity,
                "batches": self.ragged_batches,
                "rows": self.ragged_rows,
                "groups_touched": self.ragged_groups_touched,
                "overflows": self.ragged_overflows,
                "agg_device_reads": self.ragged_agg_device_reads,
                "agg_oracle_reads": self.ragged_agg_oracle_reads,
                "agg_blocks": self.ragged_agg_blocks,
            }

    def record_fleet_ingest(self, owned: bool) -> None:
        """One plan batch seen by the fleet ingest path: ``owned`` batches
        were homed here (and submitted), the rest belong to another host."""
        with self._counter_lock:
            if owned:
                self.fleet_ingested += 1
            else:
                self.fleet_skipped += 1

    def record_fleet_merge(
        self,
        merge_us: float,
        exact_bytes: int = 0,
        quant_bytes: int = 0,
        intra_bytes: int = 0,
    ) -> None:
        """One cross-host boundary fold (the fleet ``result()``/``results()``
        collective), with the bytes THIS host contributed to it —
        ``intra_bytes`` is the hierarchical fold's host-LOCAL exact leg (the
        logical state this host folds before anything crosses the wire),
        exact/quant are the cross-host legs."""
        with self._counter_lock:
            self.fleet_merges += 1
            self.fleet_merge_us_total += float(merge_us)
            self.fleet_payload_exact_bytes += int(exact_bytes)
            self.fleet_payload_quant_bytes += int(quant_bytes)
            self.fleet_payload_intra_bytes += int(intra_bytes)

    def record_fleet_tenancy(
        self, resident_rows: int, spill_rows: int, spill_bytes: int
    ) -> None:
        """Refresh the per-host tenancy gauges from the stream pager (device-
        resident rows stay FLAT as the stream universe grows; spilled tenants
        cost host RAM only)."""
        with self._counter_lock:
            self.fleet_resident_rows = int(resident_rows)
            self.fleet_spill_rows = int(spill_rows)
            self.fleet_spill_bytes = int(spill_bytes)

    def record_fleet_barrier(self) -> None:
        """One snapshot-cut barrier entered (and agreed) by this host."""
        with self._counter_lock:
            self.fleet_barriers += 1

    def record_fleet_cut(self) -> None:
        """One globally consistent snapshot cut written by this host."""
        with self._counter_lock:
            self.fleet_cuts += 1

    def fleet_summary(self) -> Optional[Dict[str, Any]]:
        """The fleet block for :meth:`summary` — None unless the engine is
        fleet-managed (``FleetEngine`` set ``fleet_hosts``), so every
        single-process telemetry document stays byte-stable."""
        if self.fleet_hosts is None:
            return None
        return {
            "num_hosts": int(self.fleet_hosts),
            "process_id": int(self.fleet_process_id),
            "streams_owned": int(self.fleet_streams_owned),
            "ingested": self.fleet_ingested,
            "skipped": self.fleet_skipped,
            "merges": self.fleet_merges,
            "merge_us_total": self.fleet_merge_us_total,
            "barriers": self.fleet_barriers,
            "cuts": self.fleet_cuts,
            # the cross-host fold's OWN bytes (lifetime totals) — host-local
            # mesh merges keep the ordinary sync_payload counters, so the
            # two surfaces never double-count one boundary
            "sync_payload_bytes": {
                "exact": self.fleet_payload_exact_bytes,
                "quantized": self.fleet_payload_quant_bytes,
            },
            # hierarchical-fold legs + tenancy gauges: intra is
            # the host-local exact leg's lifetime bytes; the gauges mirror
            # the stream pager so capacity scaling is observable per host
            "payload_intra_bytes": self.fleet_payload_intra_bytes,
            "tenancy": {
                "resident_rows": self.fleet_resident_rows,
                "spill_rows": self.fleet_spill_rows,
                "spill_bytes": self.fleet_spill_bytes,
            },
        }

    def reshard_summary(self) -> Optional[Dict[str, Any]]:
        """The elastic-reshard block — None until the engine resharded."""
        if not self.reshards:
            return None
        out: Dict[str, Any] = {"reshards": self.reshards}
        if self.reshard_last is not None:
            out["last"] = dict(self.reshard_last)
        return out

    def record_fault(self, site: str) -> None:
        """One injected fault fired at ``site`` (chaos harness accounting).
        Locked: the ``admission`` site fires on PRODUCER threads
        concurrently with the dispatcher's sites — an unlocked
        ``dict[site] += 1`` can lose a firing."""
        with self._counter_lock:
            self.faults_injected[site] = self.faults_injected.get(site, 0) + 1

    def record_kernel_fallback(self, reason: str) -> None:
        """One kernel-dispatch fallback verdict under ``reason``. Locked for
        the same RMW class as :meth:`record_fault` — engines are built (and
        their plans judged) on whatever thread constructs them, concurrently
        with a dispatcher scraping another engine's shared stats object."""
        with self._counter_lock:
            self.kernel_fallbacks[str(reason)] = self.kernel_fallbacks.get(str(reason), 0) + 1

    def kernel_fallbacks_by_reason(self) -> Dict[str, int]:
        """One consistent snapshot of the per-reason fallback counts."""
        with self._counter_lock:
            return dict(self.kernel_fallbacks)

    def kernels_summary(self) -> Optional[Dict[str, Any]]:
        """The kernel-dispatch block for :meth:`summary` — None when no
        fallback was ever recorded (every fully-fused or non-megastep engine:
        its telemetry document stays byte-stable)."""
        fallbacks = self.kernel_fallbacks_by_reason()
        if not fallbacks:
            return None
        return {"fallbacks_by_reason": {k: fallbacks[k] for k in sorted(fallbacks)}}

    def faults_by_site(self) -> Dict[str, int]:
        """One consistent snapshot of the per-site fault counts. Locked: the
        admission site fires on producer threads, and an unlocked
        ``dict(...)`` copy can see the dict resize mid-iteration."""
        with self._counter_lock:
            return dict(self.faults_injected)

    def fault_summary(self) -> Optional[Dict[str, Any]]:
        """The fault/recovery block for :meth:`summary` — None when this
        engine saw no fault activity at all (the common case keeps its
        telemetry document unchanged)."""
        counters = {
            "retries": self.retries,
            "rollbacks": self.rollbacks,
            "kernel_demotions": self.kernel_demotions,
            "coalesce_degraded": self.coalesce_degraded,
            "coalesce_shrinks": self.coalesce_shrinks,
            "watchdog_timeouts": self.watchdog_timeouts,
            "quarantined_batches": self.quarantined_batches,
            "quarantined_rows": self.quarantined_rows,
            "snapshot_failures": self.snapshot_failures,
            "snapshot_fallbacks": self.snapshot_fallbacks,
        }
        injected = self.faults_by_site()
        if not injected and not any(counters.values()):
            return None
        return {"injected": injected, **counters}

    def paging_summary(self) -> Optional[Dict[str, Any]]:
        """The stream-sharding/paging block for :meth:`summary` — None for
        engines with no routing OR residency activity (every non-sharded
        engine: only stream-sharded code paths touch these fields), so their
        telemetry documents are unchanged. The gauge clause matters for a
        freshly RESTORED sharded engine: it has seated slots (and possibly
        spilled rows) before its first routed step, and its scrape must say
        so."""
        if (
            not self.routed_steps
            and not (self.page_hits or self.page_faults)
            and not (self.resident_streams or self.spilled_streams)
        ):
            return None
        total = self.page_hits + self.page_faults
        return {
            "routed_steps": self.routed_steps,
            "page_hits": self.page_hits,
            "page_faults": self.page_faults,
            "page_hit_rate": round(self.page_hits / total, 4) if total else None,
            "page_ins": self.page_ins,
            "page_outs": self.page_outs,
            "q8_staged_rows": self.q8_staged_rows,
            "resident_streams": self.resident_streams,
            "spilled_streams": self.spilled_streams,
            "spilled_bytes": self.spilled_bytes,
        }

    def record_merge(self, merge_us: float) -> None:
        """One deferred-sync boundary merge (result()/snapshot/restore): the
        fused collective bundle's host-observed latency."""
        self.merges += 1
        self.merge_us_total += float(merge_us)

    def record_sync_payload(self, exact_bytes: int, quant_bytes: int) -> None:
        """One fused sync's per-shard payload, split by rider kind."""
        self.sync_payload_exact_bytes += int(exact_bytes)
        self.sync_payload_quant_bytes += int(quant_bytes)

    def record_step(
        self,
        *,
        bucket: int,
        valid: int,
        queue_depth: int,
        ingest_us: float,
        sync_us: Optional[float] = None,
        pad_us: Optional[float] = None,
        queue_wait_us: Optional[float] = None,
        wall_us: Optional[float] = None,
        coalesced: Optional[int] = None,
    ) -> None:
        rec = {
            "step": self.steps,
            "bucket": bucket,
            "valid": valid,
            "queue_depth": queue_depth,
            "ingest_us": round(ingest_us, 1),
        }
        if sync_us is not None:
            rec["sync_us"] = round(sync_us, 1)
            self.sync_us_total += float(sync_us)
        if pad_us is not None:
            rec["pad_us"] = round(pad_us, 1)
        if queue_wait_us is not None:
            rec["queue_wait_us"] = round(queue_wait_us, 1)
        if wall_us is not None:
            rec["wall_us"] = round(wall_us, 1)
            self.wall_us_total += float(wall_us) + float(queue_wait_us or 0.0)
        if coalesced is not None:
            rec["coalesced"] = int(coalesced)
            if coalesced > 1:
                self.megasteps += 1
                self.batches_coalesced += coalesced
        self._ring[self.steps % self.capacity] = rec
        self.steps += 1
        self.rows_in += valid
        self.rows_padded += bucket

    def recent(self) -> List[Dict[str, Any]]:
        """Ring contents, oldest first."""
        n = min(self.steps, self.capacity)
        start = self.steps % self.capacity if self.steps > self.capacity else 0
        out = []
        for i in range(n):
            rec = self._ring[(start + i) % self.capacity]
            if rec is not None:
                out.append(rec)
        return out

    def summary(self, aot_stats: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        recent = self.recent()
        ingest = sorted(r["ingest_us"] for r in recent)
        syncs = sorted(r["sync_us"] for r in recent if "sync_us" in r)
        depths = [r["queue_depth"] for r in recent]
        out: Dict[str, Any] = {
            "steps": self.steps,
            "batches_submitted": self.batches_submitted,
            "rows_in": self.rows_in,
            "rows_padded": self.rows_padded,
            "padding_waste_fraction": round(
                BucketPolicy.waste_fraction(self.rows_in, self.rows_padded), 4
            ),
            "snapshots": self.snapshots,
            "resumes": self.resumes,
            "warmup_steps": self.warmup_steps,
            "result_device_calls": self.result_device_calls,
            "queue_depth_max": max(depths) if depths else 0,
            "ingest_us": {
                "p50": round(_percentile(ingest, 0.5), 1) if ingest else None,
                "p95": round(_percentile(ingest, 0.95), 1) if ingest else None,
            },
            "blocked_sync_us": {
                "count": len(syncs),
                "p50": round(_percentile(syncs, 0.5), 1) if syncs else None,
                "p95": round(_percentile(syncs, 0.95), 1) if syncs else None,
            },
            "coalesce": {
                "megasteps": self.megasteps,
                "batches_coalesced": self.batches_coalesced,
                "batches_per_step_mean": round(
                    self.batches_submitted / self.steps, 3
                ) if self.steps else None,
            },
        }
        shares = self._host_time_shares(recent, self.mesh_sync)
        if shares is not None:
            out["host_time_shares"] = shares
        paging = self.paging_summary()
        if paging is not None:
            out["paging"] = paging
        admission = self.admission_summary()
        if admission is not None:
            out["admission"] = admission
        windows = self.windows_summary()
        if windows is not None:
            out["windows"] = windows
        reshard = self.reshard_summary()
        if reshard is not None:
            out["reshard"] = reshard
        fleet = self.fleet_summary()
        if fleet is not None:
            out["fleet"] = fleet
        ragged = self.ragged_summary()
        if ragged is not None:
            out["ragged"] = ragged
        faults = self.fault_summary()
        if faults is not None:
            out["faults"] = faults
        kernels = self.kernels_summary()
        if kernels is not None:
            out["kernels"] = kernels
        if self.mesh_sync is not None:
            out["mesh_sync"] = self._mesh_sync_summary()
        if aot_stats is not None:
            out["compile_cache"] = aot_stats
        return out

    def _mesh_sync_summary(self) -> Dict[str, Any]:
        """Where this mesh engine's collective time lives: inside blocked
        steps (``step`` mode) or at explicit merge boundaries (``deferred``
        mode). ``collective_share`` uses LIFETIME totals in both modes
        (merges are boundary events the bounded step ring never sees — mixing
        a lifetime merge sum with a windowed wall would inflate the share
        without bound on long runs) — the step-vs-deferred comparison
        ``tools/engine_report.py`` renders.

        The step-mode share is an UPPER BOUND (flagged in the summary): the
        blocked wait covers the whole in-step program — masked-update compute
        AND the collective bundle — because the host cannot observe where
        device time went inside one executable. A compute-heavy metric can
        dominate that wait with update math; before attributing it to the
        collective, A/B the same stream against ``mesh_sync="deferred"`` —
        only the delta is the collective."""
        out: Dict[str, Any] = {
            "mode": self.mesh_sync,
            "merges": self.merges,
            "merge_us_total": round(self.merge_us_total, 1),
        }
        if self.mesh_transport is not None:
            out["transport"] = self.mesh_transport
            out["shard_losses"] = self.shard_losses
        if self.sync_payload_exact_bytes or self.sync_payload_quant_bytes:
            out["sync_payload_bytes"] = {
                "exact": self.sync_payload_exact_bytes,
                "quantized": self.sync_payload_quant_bytes,
            }
        if self.mesh_sync in ("deferred", "stream_shard"):
            # stream_shard engines route host-side and carry NO steady-state
            # collectives either — boundary merges (deferred) or per-read row
            # gathers (stream_shard) are the only cross-shard traffic, so the
            # deferred-style share math applies to both
            denom = self.wall_us_total + self.merge_us_total
            out["collective_share"] = (
                round(self.merge_us_total / denom, 4) if denom > 0 else None
            )
        else:
            out["collective_share"] = (
                round(self.sync_us_total / self.wall_us_total, 4)
                if self.wall_us_total > 0
                else None
            )
            out["collective_share_is_upper_bound"] = True
        return out

    @staticmethod
    def _host_time_shares(
        recent: List[Dict[str, Any]], mesh_sync: Optional[str] = None
    ) -> Optional[Dict[str, Any]]:
        """Attribute the dispatcher's wall time over the ring window: padding,
        queue wait (idle, producer-bound), blocked device sync, and the
        residual dispatch overhead (program-call + upload — the share the
        arena/coalescing optimizations exist to amortize). The ``regime``
        label is what ``tools/engine_report.py`` surfaces: a step loop is
        *dispatch-bound* when the residual dominates, *pad-bound* when host
        padding/concat does, *starved* when the queue wait does. A dominant
        blocked-sync share reads *device-bound* off-mesh and under deferred
        sync, but *sync-bound* for a step-sync mesh engine — blocked there
        means waiting on SYNCHRONIZED steps, which bundle the cross-chip
        collective WITH the update compute (the host cannot split device
        time inside one executable): treat it as "the per-step sync
        discipline is the bottleneck, up to its compute content" and confirm
        with a ``mesh_sync="deferred"`` A/B before concluding a faster
        device wouldn't help (see ``_mesh_sync_summary``)."""
        timed = [r for r in recent if "wall_us" in r]
        if not timed:
            return None
        wall = sum(r["wall_us"] for r in timed)
        wait = sum(r.get("queue_wait_us", 0.0) for r in timed)
        pad = sum(r.get("pad_us", 0.0) for r in timed)
        sync = sum(r.get("sync_us", 0.0) for r in timed)
        total = wall + wait
        if total <= 0:
            return None
        dispatch = max(0.0, wall - pad - sync)
        shares = {
            "pad": round(pad / total, 4),
            "queue_wait": round(wait / total, 4),
            "blocked_sync": round(sync / total, 4),
            "dispatch": round(dispatch / total, 4),
        }
        regime = max(("dispatch", "pad", "queue_wait", "blocked_sync"), key=lambda k: shares[k])
        shares["regime"] = {
            "dispatch": "dispatch-bound",
            "pad": "pad-bound",
            "queue_wait": "starved",
            "blocked_sync": "sync-bound" if mesh_sync == "step" else "device-bound",
        }[regime]
        shares["window_steps"] = len(timed)
        return shares

    def to_json(
        self,
        aot_stats: Optional[Dict[str, Any]] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> str:
        """The exported telemetry document. ``extra`` merges additional
        top-level sections (the engine adds ``trace`` — the flight recorder's
        SLO summary — when one is attached)."""
        doc: Dict[str, Any] = {"summary": self.summary(aot_stats), "recent_steps": self.recent()}
        if extra:
            doc.update(extra)
        return json.dumps(doc, indent=2)

    def export(
        self,
        path: str,
        aot_stats: Optional[Dict[str, Any]] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json(aot_stats, extra=extra))
