"""The streaming engine: bucket, pad and fold ragged batches into a carried
metric state on the card, on a dispatcher thread, through captured steps.

Port of ``metrics_tpu/engine/pipeline.py``'s serving core. ``submit``
enqueues a ragged batch on a bounded queue (``max_queue``; a full queue
blocks the producer, ``submit(timeout=)`` bounds the wait) and returns. A
dispatcher thread drains the queue, concatenates up to ``coalesce`` queued
compatible batches into one megabatch (waiting up to ``coalesce_window_ms``
for more), splits it into bucketed chunks (``engine/bucketing.py``), and
folds each chunk into the carried state: with ``use_arena=True`` (the
default) the per-dtype arena (``engine/arena.py``), through the metric's
masked update (per-leaf K1 folds) or, under ``kernel_backend="megastep"``,
:meth:`MegastepPlan.apply_masked` (one K5 launch per eligible arena dtype).

On the card every step runs on one engine-owned CUDA stream. Each (bucket,
payload signature) step is captured once into a CUDA graph (``engine/aot.py``)
and replayed after: the chunk's rows, pad fill and mask are copied into the
graph's fixed buffers, the carried state in and the new state back into the
engine's own buffers, which are never rebound. At most ``in_flight`` steps run
ahead of the host. A capture or replay that fails is the dispatcher's sticky
error, raised from ``flush``/``result``/``state``/``submit`` as
:class:`~metrics_tpu_torch.engine.faults.EngineDispatchError`; nothing falls
back to the eager step or to the CPU. On the CPU the step runs eagerly on the
dispatcher thread. Readers flush first: ``with engine:`` or ``flush()`` before
reading.

Recovery: ``snapshot_every > 0`` writes crash-safe periodic snapshots
(``engine/snapshot.py``) on batch boundaries, which coalesced groups never
cross; ``snapshot()`` writes one now; ``restore()`` resumes exactly, writing
the snapshot into the engine's buffers in place (captured steps keep
addressing them), so replaying the stream from the returned ``batches_done``
reproduces the uninterrupted result. Snapshots carry the packed arena (or
the logical tree, codec-wrapped under ``compress_payloads``) and the metric's
host-derived compute attributes, in the JAX package's pickle format: either
package restores the other's. ``restore()`` falls back past corrupt
generations and retries a transient read with seeded, jittered backoff; a
failed PERIODIC snapshot is counted and never sticky.

The fault layer (``engine/faults.py``), wired where the JAX package wires
it and in the same order, so one seeded ``fault_injector`` plan fires at the
same occurrences in both packages: ``screen`` dead-letters (or rejects)
batches on the host before anything is uploaded, into a bounded ledger
(``quarantine()``); a group's ``ingest`` fault retries the whole group, a
``coalesce`` fault degrades it to singletons, a fatal ``dispatcher_kill``
ends the dispatcher (``submit(timeout=)`` then raises the sticky error,
``reset()`` drains and re-arms). Steps are TRANSACTIONAL: a captured step
replays into the state's own buffers, so the state cannot be rebound to a
pre-step copy as the JAX package rebinds it; instead a shadow allocated once
per engine takes ``shadow.copy_(state)`` before each step on the engine's
stream, and a failed step rolls back with ``state.copy_(shadow)`` on the same
stream, after whatever the failed or hung replay enqueued. A failed step
(``compile``, ``kernel``, ``step``, ``watchdog``, in that order within one
step) then retries with backoff, or demotes the engine ``megastep -> auto``
on an injected ``kernel`` fault (the per-leaf kernels K1/K4 replace
K5/K6/K7; a real CUDA error stays sticky), or goes sticky with its cursor,
step and bucket. ``step_timeout_s > 0`` arms the watchdog: each step's CUDA
event is polled until the deadline, and an expiry rolls back and retries. A
megabatch that failed before any chunk committed re-runs its batches one by
one (shrink-on-retry).

Observability (``engine/stats.py``, ``engine/trace.py``): ``stats`` keeps a
ring of the last ``telemetry_capacity`` steps and lifetime counters;
``trace`` attaches a :class:`~metrics_tpu_torch.engine.trace.TraceRecorder`
that stamps every stage of a batch's journey as a span (submit, queue wait,
the coalesced megabatch linking its submits, pad, capture lookup, device
step, syncs, snapshot write/restore) and every fault firing, retry,
rollback, demotion and quarantine as an event, with the JAX package's names
and deterministic args, so one seeded chaos plan gives both packages the
same ``canonical_sequence()``. ``telemetry()``, ``export_telemetry()``,
``export_trace()`` and ``metrics_text()`` export them. Without a recorder
each site costs one ``is not None`` test.

Overload (``engine/admission.py``): an ``admission`` policy admits or
refuses each submit before it queues (a refused batch never takes a replay
cursor; a submit whose enqueue then fails is refunded), and a ``ladder``
ticks once per dispatcher group (and on a producer's shed rejection),
engaging or releasing one rung at a time: ``widen_coalesce`` moves
``coalesce_window_ms``, ``quantize_sync`` forces the q8 sync policy on a
mesh (a recorded no-op without one), ``defer_cold_reads`` serves a cold stream's cached ``result()``,
``shed`` rejects the lowest priority class.

Windows (``engine/windows.py``, ``engine/tracker.py``): ``window`` serves a
tumbling or sliding pane ring, or an EWMA accumulator, instead of cumulative
state. A ring's carried buffers gain a leading pane axis, ``(panes, n)`` per
dtype, and a step works on ONE pane row: the row is a contiguous view, which
the captured step loads into its graph's buffers and writes back, so the
graph is the cumulative engine's and a rotation changes which row is passed,
capturing nothing. Rotations land at batch boundaries (``pane_batches``, a
function of the replay cursor) or on the policy's clock (``pane_seconds``),
split plan/commit: the plan (behind the ``pane_rotate`` fault site and the
bounded retry) prepares the incoming row's init fill or the decayed
buffers without touching the state, the commit writes them in place, so a
retried rotation clears or decays exactly once. A ``drift`` detector reads
the closing pane's result at each rotation (``drift_eval``, a pure read) and
records it once. Snapshots carry the ring's provenance and restore mid-ring.

Meshes (``parallel/mesh.py``, ``parallel/embedded.py``): with ``mesh`` the
engine is one controller driving the mesh's W shards, as the JAX package's
``shard_map``-ped step is. Each padded bucket splits over the shards as
JAX's ``P(axis)`` splits it (``bucketing.shard_blocks``: W contiguous
``bucket / W``-row blocks, pad rows in the last shards), and every step runs
the world-1 step once per shard, on the shard's rows, on the shard's device
and stream: on the card a captured graph per (bucket, device), replayed W
times a step on a one-device mesh. ``mesh_sync="step"`` folds each shard's
rows into a fresh state, merges the W deltas in one fused collective bundle
and merges the global delta into the carried GLOBAL state;
``mesh_sync="deferred"`` carries each shard's LOCAL state (the ``(W, n)``
arena on one device, one arena per device across devices) and issues no
collective until a boundary (``result``, ``state``, a snapshot), where the
whole states merge in one bundle, memoized on the state version, behind the
``merge`` fault site. The mesh's layout picks the transport: NCCL group calls
across distinct CUDA devices, a reduction over a stacked shard axis on one
device. ``reshard()`` moves a live engine to another world through its own
snapshot and the restore matrix (rolling back on a refusal, behind the
``reshard_snapshot``/``reshard_restore`` sites), and ``elastic_min_world``
arms the ``shard_loss`` site's recovery: a lost shard reshards the engine to
the largest bucket-compatible smaller world and re-runs the chunk.

Windows on a mesh take ``mesh_sync="deferred"`` (step sync refuses them with
JAX's words, and ``cat`` states are refused: the world merge would flatten
the shard axis into the pane axis). Each shard carries its own pane ring,
JAX's ``(world, panes, n)`` form (one ``(panes, n)`` ring per device across
devices); a step's target is the shard's row of the OPEN pane, which the
captured graph loads and writes back, so a rotation only moves the row the
replay addresses and never captures. A rotation writes the init row into the
incoming pane of every shard at the same boundary. The boundary merge folds
the world axis first and keeps the panes (JAX's order), then the window's
fold reads them. XLA's ``compilation_cache_dir`` is not ported (ROADMAP §A):
it raises :class:`~metrics_tpu_torch.utils.exceptions.NotPortedError`.

Fleet seams: an engine serving as one host of a
:class:`~metrics_tpu_torch.engine.fleet.FleetEngine` carries its host
topology (``_fleet_hosts``, ``_fleet_pid``) into every snapshot's meta, with
the cut and plan cursor of a fleet cut, and refuses a piece of another
topology on restore; under ``_fleet_rotation`` its pane ring rotates only
when the fleet calls :meth:`StreamingEngine.rotate_pane`.
"""
import copy
import functools
import queue
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.engine.admission import AdmissionPolicy, AdmissionRejected, DegradationLadder
from metrics_tpu_torch.engine.aot import EAGER, AotCache, CapturedStep, metric_fingerprint
from metrics_tpu_torch.engine.arena import ArenaLayout
from metrics_tpu_torch.engine.bucketing import (
    BucketPolicy,
    PinnedRing,
    StepBuffers,
    classify_leaves,
    on_card,
    pad_leaves,
    padded_shape,
    shard_blocks,
    torch_dtype,
)
from metrics_tpu_torch.engine.faults import (
    BackpressureTimeout,
    EngineDispatchError,
    FaultInjector,
    InjectedFault,
    QuarantineRecord,
    ScreenPolicy,
    StepTimeoutError,
    corrupt_snapshot,
    is_transient,
)
from metrics_tpu_torch.engine.megastep import MegastepPlan
from metrics_tpu_torch.engine.quantize import CODEC_ID, decode_state_tree, encode_state_tree
from metrics_tpu_torch.engine.snapshot import load_snapshot, save_snapshot
from metrics_tpu_torch.engine.stats import EngineStats, _percentile
from metrics_tpu_torch.engine.trace import ENGINE_TRACE, TraceRecorder, render_openmetrics
from metrics_tpu_torch.engine.tracker import DriftDetector
from metrics_tpu_torch.engine.windows import WindowPolicy
from metrics_tpu_torch.metric import StateSpec
from metrics_tpu_torch.parallel.collectives import sync_payload_split
from metrics_tpu_torch.parallel.embedded import (
    boundary_merge_error,
    sharded_local_step,
    sharded_masked_step,
    sharded_state_merge,
    stream_sharded_step,
)
from metrics_tpu_torch.parallel.mesh import Mesh
from metrics_tpu_torch.utils.checks import traced_rows
from metrics_tpu_torch.utils.data import _aux_leaves_equal, infer_batch_size, is_batch_leaf
from metrics_tpu_torch.utils.exceptions import KernelBackendError, MetricsTPUUserError, NotPortedError
from metrics_tpu_torch.utils.state_bridge import _tensor_from_numpy, state_to_numpy
from metrics_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["EngineConfig", "EngineStats", "StreamingEngine"]

#: ``metrics_tpu.engine.EngineConfig`` fields the port does not have yet
_NOT_PORTED_FIELDS = ("compilation_cache_dir",)
#: the JAX package's backends that choose a lowering the port chooses by device
_DEVICE_RULE_BACKENDS = ("xla", "pallas_interpret", "megastep_interpret")


def resolve_kernel_backend(name: Optional[str]) -> str:
    """``"auto"`` (the per-leaf kernels K1/K4; None means the same) or
    ``"megastep"`` (one K5/K6/K7 launch per arena dtype)."""
    if name is None or name == "auto":
        return "auto"
    if name == "megastep":
        return name
    if name in _DEVICE_RULE_BACKENDS:
        raise KernelBackendError(
            f"kernel_backend={name!r} has no counterpart in the port: the tensor's device alone picks the "
            "hand-written CUDA kernel (a CUDA tensor) or its plain PyTorch version (a CPU tensor); use "
            "None/'auto' for the per-leaf kernels or 'megastep'"
        )
    raise ValueError(f"unknown kernel backend {name!r}; expected None, 'auto' or 'megastep'")


class EngineConfig:
    """Configuration of :class:`StreamingEngine`.

    Args:
        buckets: allowed padded batch sizes (the closed shape set).
        max_queue: bounded ingest queue capacity, in batches. ``submit``
            blocks when full: backpressure to the producer.
        in_flight: device steps allowed un-synced before the dispatcher
            blocks on the oldest (double-buffering depth).
        coalesce: max SUBMITTED batches the dispatcher may drain and
            concatenate into one megabatch step (1 disables). Compatible
            batches only (same structure, batch leaves of one trailing shape
            and dtype, equal non-batch arguments); an incompatible batch ends
            the group and runs next.
        coalesce_window_ms: how long the dispatcher may WAIT for more
            coalescible traffic once the queue runs dry (0: never wait, only
            already-queued batches coalesce).
        use_arena: carry the state as per-dtype packed arenas
            (``engine/arena.py``) instead of the per-leaf tree.
        kernel_backend: None or ``"auto"``: the per-leaf kernels (K1 in the
            masked step, K4 in the multi-stream step); ``"megastep"``: one
            whole-arena launch per dtype (K5; the paged multi-stream engine
            K6/K7). The JAX package's ``"xla"``, ``"pallas_interpret"`` and
            ``"megastep_interpret"`` raise :class:`KernelBackendError`: in the
            port the tensor's device picks kernel or plain version.
        pad_value: fill for pad rows (must pass the metric's input checks;
            masked out of every reduction regardless).
        compress_payloads: keep the paged engine's spilled rows in host RAM
            through the q8 codec (``engine/quantize.py``) for the states the
            metric's ``sync_precision`` policy marks ``"q8_block"``; under
            ``"megastep"`` such rows page back in as int8 codes that K7
            decodes on touch. Snapshots then store the logical tree with
            those states codec-wrapped (the paged engine: its arena rows
            through the row codec).
        snapshot_every: BATCHES between crash-safe snapshots (0 = off). They
            land on batch boundaries only, and a coalesced group never
            crosses one, so the cadence stays exact under coalescing.
        snapshot_dir: where snapshots live (required when snapshot_every > 0,
            and by ``snapshot()``).
        snapshot_keep: complete snapshots retained: the generation ring
            ``restore()`` falls back through when the newest is corrupt.
        fault_injector: optional seeded
            :class:`~metrics_tpu_torch.engine.faults.FaultInjector`, consulted
            at every site the engines wire (``ingest``, ``coalesce``,
            ``compile``, ``step``, ``kernel``, ``watchdog``, ``page_out``,
            ``page_in``, ``quant_encode``, ``quant_decode``, the snapshot
            sites, ``dispatcher_kill``, ``admission``, ``pane_rotate``,
            ``drift_eval``, the mesh's ``shard_loss``, ``merge``,
            ``reshard_snapshot`` and ``reshard_restore``, and the fleet's
            ``host_loss`` and ``fleet_barrier``, which a
            :class:`~metrics_tpu_torch.engine.fleet.FleetEngine` consults at
            its boundaries).
        screen: optional :class:`~metrics_tpu_torch.engine.faults.ScreenPolicy`:
            each batch is screened on the host before anything is uploaded;
            ``"quarantine"`` dead-letters it (the replay cursor still
            advances past it), ``"error"`` makes it the sticky error.
        quarantine_capacity: dead-letter ledger size (newest records kept,
            payload included); lifetime counts live in ``stats``.
        max_retries: bounded retry budget for TRANSIENT failures per step,
            group and boundary (injected transients, watchdog expiries,
            ``RESOURCE_EXHAUSTED``-family errors); deterministic errors never
            retry.
        backoff_base_ms / backoff_max_ms: jittered exponential backoff
            between retries (the jitter is seeded from the injector's seed).
        step_timeout_s: per-step watchdog (0 = off). When armed every step
            is drained before its commit (the in-flight bound no longer
            applies), and a step whose CUDA event has not completed by the
            deadline rolls back and retries.
        transactional: keep a shadow of the pre-step state, so a failed step
            rolls back in place instead of going sticky with a torn state.
            None turns it on wherever the JAX package's rule for donated
            state does, since every captured step writes the state in place
            as a donating step consumes it: on the card when a
            ``fault_injector`` is given or the watchdog is armed, and always
            on the CPU (where the shadow costs one host copy a step).
        degrade_kernel: demote the engine ``megastep -> auto`` when an
            injected ``kernel`` fault fires (the kernel tag is part of every
            step key, so the demoted steps capture anew).
        telemetry_capacity: size of the per-step telemetry ring
            (``engine/stats.py``).
        trace: optional :class:`~metrics_tpu_torch.engine.trace.TraceRecorder`,
            the flight recorder: every submitted batch gets a trace id, the
            dispatcher stamps each stage as a span (a megabatch span LINKS
            the submit spans it absorbed), every fault firing becomes an
            event, and ``export_trace(path)``/``metrics_text()`` expose the
            Perfetto and OpenMetrics views. None costs one ``is not None``
            test per site.
        admission: optional :class:`~metrics_tpu_torch.engine.admission.AdmissionPolicy`:
            per-stream token buckets with priority classes on the submit
            path; a refused submit raises
            :class:`~metrics_tpu_torch.engine.admission.AdmissionRejected`
            (with ``retry_after_s``) before the batch queues, so it never
            takes a replay cursor.
        ladder: optional :class:`~metrics_tpu_torch.engine.admission.DegradationLadder`:
            once per dispatcher group the engine feeds its overload detector
            (p99 queue residency from the recorder's ``queue_wait_us``
            histogram when one is attached, the stats ring otherwise; the
            pager's spill rate; queue fill) and applies or releases rungs on
            its transitions: widen ``coalesce_window_ms``, ``quantize_sync``
            (the q8 sync policy on a mesh; a recorded no-op without one), defer cold-stream
            ``result()`` reads, shed the lowest priority class (needs
            ``admission``). Every transition is a ``ladder`` trace event.

        window: optional :class:`~metrics_tpu_torch.engine.windows.WindowPolicy`:
            ``tumbling``/``sliding`` carry a ring of panes (a step writes the
            current pane's row; ``result()`` reads the open pane or folds the
            live ones), ``ewma`` scales the (float, sum-reducible: refused
            otherwise) states by ``1 - alpha`` at each rotation. Rotation
            cadence is ``pane_batches`` (replay-cursor exact) or
            ``pane_seconds`` of the policy's injectable clock; a coalesced
            group never crosses a batch-cadence boundary. The cumulative
            policy is the default behaviour (no pane axis). On a mesh a
            rotating window needs ``mesh_sync="deferred"`` (every shard its
            own ring) and refuses ``cat`` states.
        drift: optional :class:`~metrics_tpu_torch.engine.tracker.DriftDetector`:
            at every rotation the dispatcher records the CLOSING pane's
            result into it (the ``drift_eval`` fault site; a pure read, so a
            transient retries and the detector records once); transitions
            are ``drift_alarm`` trace events and the ``drift_alarms``
            OpenMetrics counter. Needs a rotating ``window``.
        mesh: optional :class:`~metrics_tpu_torch.parallel.mesh.Mesh`
            (``MeshConfig(...).make_mesh()``): the engine's steps shard each
            bucket over the mesh. Its first device must be the metric's.
        axis: the mesh axis (or tuple of axes) carrying the batch shards;
            the port's engines shard over every axis of their mesh.
        mesh_sync: WHEN shard contributions merge (with a mesh): ``"step"``
            merges the per-shard deltas in every step, so the carried state
            is always the global one, at one fused collective bundle a step;
            ``"deferred"`` carries shard-local states, issues no collective
            in the steady state and merges whole states at boundaries
            (``result``, ``state``, snapshots), which also serves the scan
            strategy (the capacity curves) on a mesh.
        donate: the JAX package's buffer donation. A captured step always
            writes the state in place; the field keeps JAX's default of
            ``transactional`` (on when donation is off or not possible, as
            on the CPU).
        elastic_min_world: arm shard-loss recovery: a non-transient
            ``shard_loss`` fault reshards the engine in place to the largest
            bucket-compatible world below the current one, never below this
            floor, and the chunk re-runs there. 0 (default): shard loss goes
            sticky like any other fault.

    Any other field of the JAX package's ``EngineConfig`` raises
    :class:`NotPortedError`.
    """

    def __init__(
        self,
        buckets: Tuple[int, ...] = (256, 1024),
        max_queue: int = 64,
        in_flight: int = 2,
        coalesce: int = 8,
        coalesce_window_ms: float = 0.0,
        use_arena: bool = True,
        kernel_backend: Optional[str] = None,
        pad_value: Any = 0,
        compress_payloads: bool = False,
        snapshot_every: int = 0,
        snapshot_dir: Optional[str] = None,
        snapshot_keep: int = 2,
        fault_injector: Optional[FaultInjector] = None,
        max_retries: int = 2,
        backoff_base_ms: float = 1.0,
        backoff_max_ms: float = 50.0,
        screen: Optional[ScreenPolicy] = None,
        quarantine_capacity: int = 64,
        step_timeout_s: float = 0.0,
        transactional: Optional[bool] = None,
        degrade_kernel: bool = True,
        telemetry_capacity: int = 1024,
        trace: Optional[TraceRecorder] = None,
        admission: Optional[AdmissionPolicy] = None,
        ladder: Optional[DegradationLadder] = None,
        window: Optional[WindowPolicy] = None,
        drift: Optional[DriftDetector] = None,
        mesh: Optional[Mesh] = None,
        axis: Any = "dp",
        mesh_sync: str = "step",
        donate: bool = True,
        elastic_min_world: int = 0,
        **fields: Any,
    ) -> None:
        unported = sorted(k for k in fields if k in _NOT_PORTED_FIELDS)
        if unported:
            raise NotPortedError(f"EngineConfig fields {unported} are not ported yet (see ROADMAP.md §A)")
        if fields:
            raise TypeError(f"EngineConfig got unexpected fields {sorted(fields)}")
        self.buckets = tuple(int(b) for b in buckets)
        self.max_queue = int(max_queue)
        self.in_flight = int(in_flight)
        self.coalesce = int(coalesce)
        self.coalesce_window_ms = float(coalesce_window_ms)
        self.use_arena = bool(use_arena)
        self.kernel_backend = kernel_backend
        self.pad_value = pad_value
        self.compress_payloads = bool(compress_payloads)
        self.snapshot_every = int(snapshot_every)
        self.snapshot_dir = snapshot_dir
        self.snapshot_keep = int(snapshot_keep)
        self.fault_injector = fault_injector
        self.max_retries = int(max_retries)
        self.backoff_base_ms = float(backoff_base_ms)
        self.backoff_max_ms = float(backoff_max_ms)
        self.screen = screen
        self.quarantine_capacity = int(quarantine_capacity)
        self.step_timeout_s = float(step_timeout_s)
        self.transactional = transactional
        self.degrade_kernel = bool(degrade_kernel)
        self.telemetry_capacity = int(telemetry_capacity)
        self.trace = trace
        self.admission = admission
        self.ladder = ladder
        self.window = window
        self.drift = drift
        self.mesh = mesh
        self.axis = axis
        self.mesh_sync = mesh_sync
        self.donate = bool(donate)
        self.elastic_min_world = int(elastic_min_world)

    def __repr__(self) -> str:
        return (f"EngineConfig(buckets={self.buckets}, max_queue={self.max_queue}, in_flight={self.in_flight}, "
                f"coalesce={self.coalesce}, coalesce_window_ms={self.coalesce_window_ms}, use_arena={self.use_arena}, "
                f"kernel_backend={self.kernel_backend!r}, pad_value={self.pad_value!r}, "
                f"compress_payloads={self.compress_payloads}, snapshot_every={self.snapshot_every}, "
                f"snapshot_dir={self.snapshot_dir!r}, snapshot_keep={self.snapshot_keep}, "
                f"fault_injector={self.fault_injector!r}, max_retries={self.max_retries}, "
                f"backoff_base_ms={self.backoff_base_ms}, backoff_max_ms={self.backoff_max_ms}, "
                f"screen={self.screen!r}, quarantine_capacity={self.quarantine_capacity}, "
                f"step_timeout_s={self.step_timeout_s}, transactional={self.transactional}, "
                f"degrade_kernel={self.degrade_kernel}, telemetry_capacity={self.telemetry_capacity}, "
                f"trace={self.trace!r}, admission={self.admission!r}, ladder={self.ladder!r}, "
                f"window={self.window!r}, drift={self.drift!r}, mesh={self.mesh!r}, axis={self.axis!r}, "
                f"mesh_sync={self.mesh_sync!r}, donate={self.donate}, elastic_min_world={self.elastic_min_world})")


_STOP = object()  # the dispatcher's stop sentinel
_WATCH_POLL_S = 5e-5  # the watchdog's poll of a step's CUDA event


def _add_committed(exc: BaseException, committed: int) -> None:
    """Add to the chunks an escaping error saw committed (summed, since one
    execution may run inside another)."""
    try:
        exc._committed_chunks = getattr(exc, "_committed_chunks", 0) + committed
    except Exception:  # noqa: BLE001 - exceptions with __slots__
        pass


def _attach_ctx(exc: BaseException, **kv: Any) -> None:
    """Tag an exception with engine failure context (batch cursor, step,
    bucket, stream ids) without changing its type; ``_raise_if_failed``
    folds the tags into :class:`EngineDispatchError`. The innermost value of
    a key wins."""
    ctx = getattr(exc, "_engine_ctx", None)
    if ctx is None:
        try:
            exc._engine_ctx = ctx = {}
        except Exception:  # noqa: BLE001 - exceptions with __slots__
            return
    for k, v in kv.items():
        if v is not None and (not isinstance(v, (list, tuple)) or len(v)):
            ctx.setdefault(k, v)


def _ingest_transient(exc: BaseException) -> bool:
    """The group-level retry policy: only a transient injected ``ingest`` fault."""
    return isinstance(exc, InjectedFault) and exc.site == "ingest" and exc.transient


def _same_batch_leaf(a: Any, b: Any) -> bool:
    """Two batch-carried leaves that concatenate: both numpy, or both tensors
    on one device, of one dtype and trailing shape."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a.dtype == b.dtype and a.shape[1:] == b.shape[1:]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.dtype == b.dtype and a.device == b.device and a.shape[1:] == b.shape[1:]
    return False


def _reshard_devices(home: List[torch.device], world: int) -> List[torch.device]:
    """The devices of a ``reshard(world=...)`` target. ``home`` is the
    distinct devices of the mesh the engine was built with, the metric's
    first: it repeated on a one-device engine and at world 1, else ``home``
    in order, then the machine's other CUDA devices. Shrinking and growing
    back returns to the same devices, the metric's first."""
    if world == 1 or len(home) == 1:
        return [home[0]] * world
    others = (torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    devs = list(home) + [d for d in others if d not in home]
    if world > len(devs):
        raise MetricsTPUUserError(f"reshard(world={world}) exceeds the {len(devs)} available cuda devices")
    return devs[:world]


def _norm_device(dev: torch.device) -> torch.device:
    """``cuda`` with its index (the current device's when unnamed), so equal
    devices compare and hash equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh_step_unsupported_reason(metric: Any) -> Optional[str]:
    """Step sync merges per-shard DELTAS (a masked update from a fresh
    state, synced, merged into the carry): exact for the delta and custom
    strategies, not for a scan-strategy member, whose states (the capacity
    curves' buffers) do not merge per step. Deferred sync serves those."""
    strategies = (metric.masked_update_strategies() if hasattr(metric, "masked_update_strategies")
                  else {type(metric).__name__: metric.masked_update_strategy()})
    for name, strategy in strategies.items():
        if strategy == "scan":
            return (f"member {name!r} needs the sequential masked fallback, which has no exact step-sync mesh "
                    "(shard-and-merge) form; serve it on a single device or under EngineConfig(mesh_sync='deferred')")
    return None


def _metric_device(metric: Any) -> torch.device:
    if hasattr(metric, "_defaults"):
        return metric.device
    devices = {m.device for _, m in metric.items(keep_base=True)}
    if len(devices) != 1:
        raise MetricsTPUUserError(f"an engine serves one device; the collection's members lie on {sorted(map(str, devices))}")
    return devices.pop()


class StreamingEngine:
    """Drive a ``Metric``/``MetricCollection`` as a stream of ragged batches.

    ``submit`` enqueues a batch and returns; the dispatcher thread folds it
    into the state. ``flush`` waits for every submitted batch; ``result`` and
    ``state`` flush first. ``with engine:`` starts the dispatcher and, on
    exit, drains it and raises its sticky error. The state lives on the
    metric's device (``cuda`` by default). ``aot_cache`` (an :class:`AotCache`)
    may be shared by several engines: equally configured engines share its
    captured steps.

    :data:`_LADDER_P99_EVERY` throttles the degradation ladder's p99
    queue-residency refresh (a histogram fold or a ring sort) to one read per
    that many ticks.
    """

    _LADDER_P99_EVERY = 8

    def __init__(self, metric: Any, config: Optional[EngineConfig] = None, aot_cache: Optional[AotCache] = None):
        self._metric = metric
        # a PRIVATE copy of the config: the ladder's widen rung moves
        # coalesce_window_ms, which must not reach another engine built from
        # the same config (shallow: the injector, recorder and policy objects
        # are meant to be shared)
        self._cfg = copy.copy(config) if config is not None else EngineConfig()
        self._init_mesh()
        reason = self._serving_unsupported_reason(metric)
        if reason is not None:
            raise MetricsTPUUserError(f"metric cannot be served by the streaming engine: {reason}")
        self._device = _norm_device(_metric_device(metric))
        if self._mesh is not None:
            self._check_mesh_device(self._mesh)
        # the devices a reshard(world=...) picks first: the built mesh's own, in order
        self._home_devices = ([self._device] if self._mesh is None
                              else list(dict.fromkeys(_norm_device(d) for d in self._axis.devices)))
        if self._cfg.elastic_min_world < 0:
            raise MetricsTPUUserError(f"elastic_min_world must be >= 0, got {self._cfg.elastic_min_world}")
        if self._cfg.max_retries < 0:
            raise MetricsTPUUserError(f"max_retries must be >= 0, got {self._cfg.max_retries}")
        if self._cfg.step_timeout_s < 0:
            raise MetricsTPUUserError(f"step_timeout_s must be >= 0, got {self._cfg.step_timeout_s}")
        if self._cfg.screen is not None and not isinstance(self._cfg.screen, ScreenPolicy):
            raise MetricsTPUUserError(f"config.screen must be a ScreenPolicy, got {type(self._cfg.screen).__name__}")
        inj = self._cfg.fault_injector
        if inj is not None and not isinstance(inj, FaultInjector):
            raise MetricsTPUUserError(f"config.fault_injector must be a FaultInjector, got {type(inj).__name__}")
        if self._cfg.trace is not None and not isinstance(self._cfg.trace, TraceRecorder):
            raise MetricsTPUUserError(f"config.trace must be a TraceRecorder, got {type(self._cfg.trace).__name__}")
        if self._cfg.admission is not None and not isinstance(self._cfg.admission, AdmissionPolicy):
            raise MetricsTPUUserError(
                f"config.admission must be an AdmissionPolicy, got {type(self._cfg.admission).__name__}")
        if self._cfg.ladder is not None and not isinstance(self._cfg.ladder, DegradationLadder):
            raise MetricsTPUUserError(
                f"config.ladder must be a DegradationLadder, got {type(self._cfg.ladder).__name__}")
        if self._cfg.snapshot_every > 0 and not self._cfg.snapshot_dir:
            raise MetricsTPUUserError("snapshot_every > 0 requires snapshot_dir")
        self._policy = BucketPolicy(self._cfg.buckets, pad_value=self._cfg.pad_value, divisor=self._world)
        self._stats = EngineStats(self._cfg.telemetry_capacity)
        if self._mesh is not None:
            self._stats.mesh_sync = "deferred" if self._deferred else "step"
            self._stats.mesh_transport = self._mesh.transport
        self._init_window(metric)
        # None (the default) keeps every site at one `is not None` test
        self._admission = self._cfg.admission
        self._ladder = self._cfg.ladder
        if self._ladder is not None:
            # a ladder is STATEFUL per engine (its level, streaks and the rung
            # effects it drives): two engines advancing one ladder would leave
            # rungs stuck. An AdmissionPolicy may be shared (one admission domain)
            owner = getattr(self._ladder, "_owner", None)
            if owner is not None and owner() is not None and owner() is not self:
                raise MetricsTPUUserError(
                    "this DegradationLadder is already driving another engine; a ladder is stateful per engine "
                    "— construct one per engine (share the AdmissionPolicy for a shared admission domain)"
                )
            self._ladder._owner = weakref.ref(self)
        # serializes ladder state and rung application: ticks come from the
        # dispatcher (per group) AND from producers on shed rejections
        self._ladder_lock = threading.Lock()
        self._ladder_marks = (0, 0)  # (steps, page_outs) at the last tick
        self._ladder_ticks = 0
        self._ladder_p99: Optional[float] = None  # the throttled signal
        self._ladder_saved_window = self._cfg.coalesce_window_ms
        self._ladder_quantized = False  # the quantize rung forced the q8 policy
        self._defer_cold_reads = False
        self._result_cache: Dict[Any, Any] = {}
        # the flight recorder: None means every site is one None test
        self._trace: Optional[TraceRecorder] = self._cfg.trace
        # submit-time [trace id, submit stamp] of queued items, by object
        # identity: registered BEFORE the enqueue (the dispatcher may take the
        # item at once) and popped when its group is picked up or dropped
        self._trace_ids: Dict[int, List[Any]] = {}
        self._group_tid: Optional[str] = None  # the dispatcher's current group
        self._last_aot_outcome = "hit"  # set by every _program call
        self._compress = self._cfg.compress_payloads
        # the sync-precision policy tag, pinned at construction: it is part of
        # every step key and the codec fingerprint of compressed snapshots
        self._precision_tag = metric.sync_precision_tag()
        # the retry jitter's stream, seeded so chaos runs replay exactly
        self._retry_rng = np.random.RandomState(((inj.seed if inj is not None else 0) ^ 0x5EED) & 0x7FFFFFFF)
        self._step = 0
        self._layout: Optional[ArenaLayout] = (
            ArenaLayout.for_state(self._kind_abstract_state_tree()) if self._cfg.use_arena else None
        )
        self._kernel_backend = resolve_kernel_backend(self._cfg.kernel_backend)
        # whole-step megakernel plan, judged once: an engine that cannot take
        # the path at all records engine:<reason>, each degraded dtype
        # dtype.<key>:<why>; both keep the per-leaf kernels
        self._megastep_plan: Optional[MegastepPlan] = None
        if self._kernel_backend == "megastep":
            reason = self._megastep_unsupported_reason()
            if reason is not None:
                self._stats.record_kernel_fallback(f"engine:{reason}")
            else:
                self._megastep_plan = MegastepPlan(metric, self._layout)
                for key, why in sorted(self._megastep_plan.fallback_reasons().items()):
                    self._stats.record_kernel_fallback(f"dtype.{key}:{why}")
        # -- the shards: per device a stream and, across devices, a replica
        # of the metric with its megastep plan (shard 0 runs on the metric)
        cuda = self._device.type == "cuda"
        #: every copy, replay and page-in of this engine runs on its device's stream
        self._stream: Optional[torch.cuda.Stream] = torch.cuda.Stream(self._device) if cuda else None
        self._dev_streams: Dict[torch.device, torch.cuda.Stream] = {self._device: self._stream} if cuda else {}
        self._dev_metrics: Dict[torch.device, Any] = {self._device: metric}
        self._dev_plans: Dict[torch.device, Optional[MegastepPlan]] = {self._device: self._megastep_plan}
        self._setup_shards()
        # bumped by a reshard; the dispatcher binds its per-device streams
        # anew when its own mark differs
        self._topology_epoch = 0
        self._worker_epoch = 0
        # the boundary merge's memo, keyed on the state version (bumped by
        # every commit, restore, reset and reshard)
        self._state_version = 0
        self._merged_memo: Optional[Tuple[int, Any]] = None
        self._payload_split: Optional[Tuple[int, int]] = None
        # host topology: (1, 0) is one process; a FleetEngine stamps its host's
        # (num_hosts, process_id), which every snapshot carries and restore
        # checks, and the cut and plan cursor while it writes a cut's piece
        self._fleet_hosts = 1
        self._fleet_pid = 0
        self._fleet_cut: Optional[int] = None
        self._fleet_plan_cursor = 0
        # a fleet host's ring rotates only at shared-plan positions, through
        # rotate_pane(): its own cadence counts owned batches, which differ per host
        self._fleet_rotation = False
        self._deltas: Optional[List[Any]] = None  # step sync's per-shard delta buffers
        self._delta_init: Optional[List[Any]] = None
        self._state = self._put_state(self._init_state_tree())
        # -- the dispatcher and its captured steps
        self._aot = aot_cache if aot_cache is not None else AotCache()
        # the production step on the card is the captured one; the eager step
        # stays reachable here only to compare the two (bit-equality, timing)
        self._capture = cuda
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, self._cfg.max_queue))
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._state_lock = threading.RLock()
        self._inflight: Deque[torch.cuda.Event] = deque()
        self._batches_done = 0
        # metrics that DERIVE compute attrs from data (Accuracy's input-mode
        # latch) latch them before any step key is built: a warm twin replays
        # captured steps and never runs the update's Python
        self._needs_attr_latch = any(v is None for v in metric.host_compute_attrs().values())
        self._metric_fp: Optional[str] = None
        self._carried_sig: Optional[Tuple] = None
        # payload signature -> (cache entry, pinned ring): the steady-state
        # lookup skips the structural key
        self._program_memo: Dict[Tuple, Tuple[Any, Optional[PinnedRing]]] = {}
        # transactional steps: None follows the JAX package's rule for donated
        # state, since a captured step writes the state in place as a donating
        # step consumes it: on the card with an injector or an armed
        # watchdog (whose expiry recovery needs the shadow), or with donation
        # off; always on the CPU, where JAX's shadow is a free reference and
        # the port's one host copy a step
        self._donate = self._cfg.donate and cuda
        self._transactional = (
            bool(self._cfg.transactional) if self._cfg.transactional is not None
            else (not self._donate) or inj is not None or self._cfg.step_timeout_s > 0
        )
        #: the pre-step copy a failed step rolls back from, allocated at the first step
        self._shadow: Any = None
        # dead-letter ledger of screened-out batches: newest records kept
        self._quarantine: Deque[QuarantineRecord] = deque(maxlen=max(1, int(self._cfg.quarantine_capacity)))
        # the watchdog arms when configured, or when the plan can fire its site
        self._watchdog_enabled = self._cfg.step_timeout_s > 0 or (inj is not None and inj.has_site("watchdog"))

    def _init_window(self, metric: Any) -> None:
        """Validate ``window`` and ``drift`` as the JAX package does and set up
        the ring's marks. The cumulative policy normalizes to None: it IS the
        default, and a cumulative engine's state, step keys and telemetry stay
        what they were."""
        win = self._cfg.window
        if win is not None and not isinstance(win, WindowPolicy):
            raise MetricsTPUUserError(f"config.window must be a WindowPolicy, got {type(win).__name__}")
        self._window: Optional[WindowPolicy] = win if (win is not None and win.kind != "cumulative") else None
        if self._window is not None:
            if self._mesh is not None and not self._deferred:
                raise MetricsTPUUserError(
                    "windowed serving on a mesh requires mesh_sync='deferred': a pane rotation is a state-structure "
                    "operation with no per-step delta form for the step-sync merge"
                )
            reason = self._window.unsupported_reason(metric, mesh_deferred=self._deferred)
            if reason is not None:
                raise MetricsTPUUserError(
                    f"metric cannot serve under WindowPolicy {self._window.fingerprint()!r}: {reason}")
        # the pane axis stacks on the carried state only off the paged path:
        # there the pane extends the pager's stream coordinate instead
        stream_shard = getattr(self, "_stream_shard", False)
        self._win_stacked = self._window is not None and self._window.stacked and not stream_shard
        self._panes = self._window.panes if self._window is not None else 1
        self._pane_cursor = 0
        self._rotations = 0
        self._last_rotate_batches = 0
        # the replay cursor at which the OPEN pane started: the pane fill a
        # snapshot records, and the guard that keeps an empty pane (a time
        # cadence catching up over a traffic gap) out of the drift detector
        self._pane_open_cursor = 0
        self._win_clock = self._window.time_source() if self._window is not None else time.monotonic
        self._last_rotate_time = self._win_clock() if self._window is not None else 0.0
        self._drift: Optional[DriftDetector] = self._cfg.drift
        if self._drift is not None:
            if not isinstance(self._drift, DriftDetector):
                raise MetricsTPUUserError(f"config.drift must be a DriftDetector, got {type(self._drift).__name__}")
            if self._window is None:
                raise MetricsTPUUserError(
                    "config.drift needs a rotating config.window: drift alarms evaluate per CLOSED PANE — without "
                    "rotations there is nothing to record (use DriftDetector standalone otherwise)"
                )
            if stream_shard:
                raise MetricsTPUUserError(
                    "automatic drift evaluation is not supported under stream_shard=True (a per-rotation "
                    "all-streams read would fault every cold pane back in); record per-stream pane results into "
                    "a standalone DriftDetector instead"
                )
            if self._drift.raise_on_alarm:
                raise MetricsTPUUserError(
                    "config.drift must not set raise_on_alarm: the detector records on the DISPATCHER thread, "
                    "where a raised alarm would become the sticky dispatcher error and take serving down — alarms "
                    "surface as drift_alarm trace events and counters; poll detector.alarms() (raise_on_alarm is "
                    "for standalone use)"
                )
        if self._window is not None:
            self._stats.window_policy = self._window.fingerprint()
            self._stats.live_panes = 1
        self._ring_init: Optional[Dict[torch.device, Any]] = None  # one pane's init row a device

    # -------------------------------------------------------------- capability checks

    def _update_path_unsupported_reason(self, metric: Any) -> Optional[str]:
        return metric.masked_update_unsupported_reason()

    def _serving_unsupported_reason(self, metric: Any) -> Optional[str]:
        """The update capability, then the mesh's: deferred sync needs every
        state to merge across a stack axis at the boundary; step sync needs
        an exact per-step delta merge (no scan-strategy member)."""
        reason = self._update_path_unsupported_reason(metric)
        if reason is not None or self._mesh is None:
            return reason
        if self._deferred:
            r = metric.stacked_merge_unsupported_reason()
            return None if r is None else f"deferred-sync mesh serving needs dist_reduce_fx-mergeable states: {r}"
        return _mesh_step_unsupported_reason(metric)

    # ------------------------------------------------------------------ the mesh

    def _init_mesh(self) -> None:
        """Validate the mesh fields as the JAX package does and pin the sync
        mode, the axis and the world."""
        cfg = self._cfg
        if cfg.mesh_sync not in ("step", "deferred"):
            raise MetricsTPUUserError(f"mesh_sync must be 'step' or 'deferred', got {cfg.mesh_sync!r}")
        if cfg.mesh_sync == "deferred" and cfg.mesh is None:
            raise MetricsTPUUserError(
                "mesh_sync='deferred' needs a mesh: without one there are no shard-local states to defer the merge "
                "of (drop mesh_sync or set mesh)"
            )
        if cfg.mesh is not None and not isinstance(cfg.mesh, Mesh):
            raise MetricsTPUUserError(
                f"config.mesh must be a metrics_tpu_torch.parallel.mesh.Mesh (MeshConfig(...).make_mesh()), got "
                f"{type(cfg.mesh).__name__}"
            )
        self._mesh: Optional[Mesh] = cfg.mesh
        self._deferred = self._mesh is not None and cfg.mesh_sync == "deferred"
        self._axis = self._mesh.axis(cfg.axis) if self._mesh is not None else None
        self._world = self._axis.world if self._axis is not None else 1
        self._nccl = self._mesh is not None and self._mesh.transport == "nccl"

    def _setup_shards(self) -> None:
        """Each shard's device, and per device its stream and (across
        devices) the metric replica and megastep plan its steps run on."""
        self._shard_devices: List[torch.device] = (
            [self._device] if self._mesh is None else [_norm_device(d) for d in self._axis.devices])
        for dev in self._shard_devices:
            if dev in self._dev_metrics:
                continue
            self._dev_streams[dev] = torch.cuda.Stream(dev)
            replica = copy.deepcopy(self._metric).to(dev)
            self._dev_metrics[dev] = replica
            self._dev_plans[dev] = MegastepPlan(replica, self._layout) if self._megastep_plan is not None else None

    def _shard_metric(self, shard: int) -> Any:
        return self._dev_metrics[self._shard_devices[shard]] if shard else self._metric

    def _shard_plan(self, shard: int) -> Optional[MegastepPlan]:
        """Shard ``shard``'s megastep plan (None once demoted)."""
        if self._megastep_plan is None or not shard:
            return self._megastep_plan
        return self._dev_plans[self._shard_devices[shard]]

    def _shard_stream(self, shard: int) -> Optional[torch.cuda.Stream]:
        return self._dev_streams.get(self._shard_devices[shard])

    def _streams(self) -> List[torch.cuda.Stream]:
        """The distinct streams of the engine's devices (none on the CPU)."""
        return list({id(st): st for st in (self._shard_stream(k) for k in range(self._world))
                     if st is not None}.values())

    def _bind_streams(self) -> None:
        """Make the engine's stream the current one of each of its devices on
        the calling thread (the dispatcher's; thread-local, per device: every
        launch of the thread goes there), the first device current."""
        self._worker_epoch = self._topology_epoch
        if self._stream is None:
            return
        for st in self._streams():
            torch.cuda.set_stream(st)  # also makes its device current
        torch.cuda.set_device(self._stream.device)

    def _sync_tag(self) -> str:
        """The sync mode every program key carries (JAX's ``_sync_tag``):
        step-sync and deferred steps differ over identical payloads."""
        return "deferred" if self._deferred else "step"

    def _shard_view(self, shard: int) -> Any:
        """Shard ``shard``'s LOCAL carried state under deferred sync: a row
        view of the ``(W, ...)`` buffers on one device, its own buffers across
        devices."""
        if self._nccl:
            return self._state[shard]
        return tree_map(lambda x: x[shard], self._state)

    def _shard_states(self) -> List[Any]:
        return [self._shard_view(k) for k in range(self._world)]

    def _put_shards(self, trees: List[Any]) -> Any:
        """The deferred carried form of the W shards' LOGICAL trees."""
        if self._nccl:
            return [self._pack(tree_map(lambda x: torch.as_tensor(x).to(dev), t))
                    for t, dev in zip(trees, self._shard_devices)]
        leaves = [tree_flatten(t)[0] for t in trees]
        treedef = tree_flatten(trees[0])[1]
        stacked = tree_unflatten(treedef, [torch.stack([torch.as_tensor(x).to(self._device) for x in col])
                                           for col in zip(*leaves)])
        return stacked if self._layout is None else self._layout.pack_stacked(stacked, lead=self._shard_lead())

    def _put_stacked_carried(self, stacked: Any) -> Any:
        """A snapshot's ``(W, ...)`` shard-stacked carried form, verbatim."""
        if self._nccl:
            return [tree_map(lambda x, k=k, dev=dev: torch.as_tensor(x[k]).to(dev), stacked)
                    for k, dev in enumerate(self._shard_devices)]
        return tree_map(lambda x: torch.as_tensor(x).to(self._device), stacked)

    def _stacked_carried(self) -> Any:
        """The deferred carried state as ``(W, ...)`` tensors (gathered onto
        the first device across devices): a snapshot's form."""
        if not self._nccl:
            return self._state
        leaves = [tree_flatten(s)[0] for s in self._state]
        return tree_unflatten(tree_flatten(self._state[0])[1],
                              [torch.stack([x.to(self._device) for x in col]) for col in zip(*leaves)])

    def _shard_lead(self) -> int:
        """The leading stack axes of the one-device deferred carried form:
        ``(W, ...)``, or ``(W, panes, ...)`` under a ring window."""
        return 2 if self._win_stacked else 1

    def _shard0_trees(self, tree: Any) -> List[Any]:
        """The exact deferred embedding of a GLOBAL state: shard 0 holds it,
        every other shard the init state (pane-stacked under a ring), which
        the boundary merge folds away."""
        return [tree] + [self._init_state_tree() for _ in range(self._world - 1)]

    def _delta_targets(self) -> List[Any]:
        """Step sync's per-shard delta buffers, reset to the init state: each
        shard's fold starts from a fresh state (its masked delta)."""
        if self._deltas is None:
            self._delta_init = [self._pack_row(tree_map(lambda x: torch.as_tensor(x).to(dev),
                                                         self._kind_init_state_tree()))
                                for dev in self._shard_devices]
            self._deltas = [tree_map(torch.empty_like, init) for init in self._delta_init]
        for dst, src in zip(self._deltas, self._delta_init):
            self._write_state(src, into=dst)
        return self._deltas

    def _mesh_step(self, fold: Callable[[int, Any, Any], Any], parts: List[Any]) -> Any:
        """One mesh step through its builder (``parallel/embedded.py``) over
        the shards' parts and folds (``fold(k, target, part)``, None where the graph
        wrote ``target`` in place): deferred sync the local step (the
        stream-sharded routed step on the paged engine) over the shards'
        local states; step sync the masked step, each shard's delta its fold
        into its reset delta buffer, merged into the engine's one replica
        of the global state. Returns what the commit writes: the W new
        local states (None: written), or the new global state."""
        blocks = [(part, part[4] - part[3]) for part in parts]
        if self._deferred:
            build = stream_sharded_step if getattr(self, "_stream_shard", False) else sharded_local_step
            step = build(lambda state, part, k: fold(k, state, part), self._mesh, self._cfg.axis)
            return step([self._shard_target(k) for k in range(self._world)], blocks)[0]
        deltas = self._deltas

        def delta(k: int, part: Any) -> Any:
            out = fold(k, deltas[k], part)
            if out is not None:  # delta buffers are scratch: written at once
                self._write_state(out, into=deltas[k])
            return deltas[k]

        step = sharded_masked_step(self._metric, self._mesh, self._cfg.axis, self._layout, delta_fn=delta)
        new = step([self._state], blocks)[0][0]
        self._stats.record_sync_payload(*self._sync_payload_split())
        return new

    def _payload_leaf_info(self) -> Optional[List[Any]]:
        """The ``(fx, leaf, precision)`` triples one fused sync of this
        engine's logical state moves."""
        return self._metric.sync_leaf_info()

    def _fleet_leaf_info(self) -> Optional[List[Any]]:
        """The ``(fx, leaf, precision)`` triples ONE host's logical state
        contributes to the fleet's fold, shaped as :meth:`state` returns it:
        a pane-stacked ring scales by the pane count (the fold moves the
        whole ring)."""
        info = self._payload_leaf_info()
        if not info or not self._win_stacked:
            return info
        return [(fx, StateSpec((self._panes,) + tuple(leaf.shape), leaf.dtype), prec) for fx, leaf, prec in info]

    def _payload_split_for(self, world: int, leaf_info: Optional[List[Any]] = None) -> Tuple[int, int]:
        """(exact, quantized) bytes one participant contributes to a fused
        sync over ``world`` ranks (``fused_sync_plan``): of this engine's
        state, or of ``leaf_info`` (the fleet's host-logical triples at world
        = the host count)."""
        info = leaf_info if leaf_info is not None else self._payload_leaf_info()
        return sync_payload_split(info, world) if info else (0, 0)

    def _sync_payload_split(self) -> Tuple[int, int]:
        """(exact, quantized) bytes one shard contributes to one fused sync,
        memoized per topology."""
        if self._payload_split is None:
            self._payload_split = self._payload_split_for(self._world)
        return self._payload_split

    def _merged_state(self) -> Any:
        """The deferred boundary merge (caller holds the state lock, inside
        :meth:`_device_section`): the shard-local states through one fused
        bundle into the global LOGICAL state, behind the ``merge`` fault site
        and the bounded retry, blocked on before returning, and memoized on
        the state version so reads between updates share one merge. The
        merge only reads the shard states: a failure leaves them intact."""
        if self._merged_memo is not None and self._merged_memo[0] == self._state_version:
            return self._merged_memo[1]
        merge = sharded_state_merge(self._metric, self._mesh, self._cfg.axis,
                                    unpack=self._unpack if self._layout is not None else None)

        def merge_once() -> Tuple[Any, float]:
            self._fault("merge")
            t0 = time.perf_counter()
            merged = merge(self._shard_states())
            for st in self._streams():
                torch.cuda.current_stream(st.device).synchronize()
            return merged, t0

        try:
            merged, t0 = self._retry_transient(merge_once)
        except BaseException as e:  # noqa: BLE001 - typed below
            err = boundary_merge_error(self._cfg.axis, self._world, e)
            if err is e:
                raise
            raise err from e
        merge_us = (time.perf_counter() - t0) * 1e6
        self._stats.record_merge(merge_us)
        self._stats.record_sync_payload(*self._sync_payload_split())
        if self._trace is not None:
            self._trace.complete("merge", trace=ENGINE_TRACE, dur_us=merge_us)
            self._trace.observe("merge_latency_us", merge_us)
        self._merged_memo = (self._state_version, merged)
        return merged

    def _megastep_unsupported_reason(self) -> Optional[str]:
        """Why this engine cannot take the megastep path at all (None: it can).
        The single-stream engine needs the packed arena as its carried form."""
        return "no_arena" if self._layout is None else None

    # ----------------------------------------------------------------- state plumbing

    def _kind_init_state_tree(self) -> Any:
        return self._metric.init_state()

    def _kind_abstract_state_tree(self) -> Any:
        return self._metric.abstract_state()

    def _init_state_tree(self) -> Any:
        """The fresh logical state: the engine kind's tree, pane-stacked (every
        leaf gains a leading ``panes`` axis of identical init rows) under a
        ring window."""
        tree = self._kind_init_state_tree()
        if not self._win_stacked:
            return tree
        return tree_map(lambda x: torch.stack([torch.as_tensor(x)] * self._panes), tree)

    def _carried_abstract_tree(self) -> Any:
        """The logical CARRIED tree's shapes: the engine kind's, pane-stacked
        under a ring window."""
        tree = self._kind_abstract_state_tree()
        if not self._win_stacked:
            return tree
        return tree_map(lambda s: StateSpec((self._panes,) + tuple(s.shape), s.dtype), tree)

    def _pack(self, tree: Any) -> Any:
        """Logical carried tree -> the carried form (a ring's ``(panes, n)``
        buffers under a ring window)."""
        if self._layout is None:
            return tree
        return self._layout.pack_stacked(tree) if self._win_stacked else self._layout.pack(tree)

    def _unpack(self, carried: Any) -> Any:
        if self._layout is None:
            return carried
        return self._layout.unpack_stacked(carried) if self._win_stacked else self._layout.unpack(carried)

    def _pack_row(self, tree: Any) -> Any:
        """ONE pane's logical tree -> its carried row (what a step returns)."""
        return tree if self._layout is None else self._layout.pack(tree)

    def _unpack_row(self, row: Any) -> Any:
        return row if self._layout is None else self._layout.unpack(row)

    def _pane_row(self, pane: int) -> Any:
        """Views of pane ``pane``'s row of the carried ring: each a contiguous
        slice of its ``(panes, n)`` buffer (of each ``(panes, ...)`` leaf
        without an arena)."""
        return tree_map(lambda x: x[pane], self._state)

    def _step_target(self) -> Any:
        """What a step reads and writes: the carried state, or under a ring
        window the CURRENT pane's row. The captured step loads it into the
        graph's buffers and copies the new state back into it, so the graph
        is the cumulative engine's and a rotation only changes the row."""
        return self._pane_row(self._pane_cursor) if self._win_stacked else self._state

    def _window_tree(self, tree: Any) -> Any:
        """A pane-stacked logical tree -> the window's RESULT view: a sliding
        ring folds its live panes through ``merge_stacked_states`` (sum, min,
        max elementwise; ``cat`` capacity buffers concatenated across panes),
        a tumbling ring reads the open pane; other engines pass through."""
        if not self._win_stacked:
            return tree
        if self._window.kind == "sliding":
            return self._metric.merge_stacked_states(tree)
        return tree_map(lambda x: x[self._pane_cursor], tree)

    def _put_state(self, tree: Any) -> Any:
        """The carried form of a logical state tree, on the engine's device
        (under deferred sync every shard's local state starts from it)."""
        if self._deferred:
            return self._put_shards([tree] * self._world)
        return self._pack(tree_map(lambda x: torch.as_tensor(x).to(self._device), tree))

    def _write_state(self, carried: Any, into: Any = None) -> None:
        """Copy a carried state into the engine's buffers (or into ``into``, a
        pane row of them), in place: the buffers are never rebound, so
        captured steps and the pager's page-ins keep addressing them."""
        for dst, src in zip(tree_leaves(self._state if into is None else into), tree_leaves(carried)):
            if dst is not src:
                dst.copy_(src)

    @contextmanager
    def _device_section(self) -> Iterator[None]:
        """Hold the state lock for a read or write of the carried state on the
        caller's thread: on each of the engine's devices the caller's stream
        first waits for the engine stream's work, and the engine stream's
        later work waits for the caller's."""
        with self._state_lock:
            streams = self._streams()
            if not streams:
                yield
                return
            callers = [torch.cuda.current_stream(st.device) for st in streams]
            for caller, st in zip(callers, streams):
                caller.wait_stream(st)
            try:
                yield
            finally:
                for caller, st in zip(callers, streams):
                    st.wait_stream(caller)

    # -------------------------------------------------------------------- the step

    def _traced_update(self, state_tree: Any, payload: Any, mask: torch.Tensor, shard: int = 0) -> Any:
        """The step body on the LOGICAL state tree (the multi-stream engine
        reroutes it to the segmented update), on shard ``shard``'s metric."""
        a, kw = payload
        return self._shard_metric(shard).update_state_masked(state_tree, *a, mask=mask, **kw)

    def _step_aux(self, shard: int = 0) -> Any:
        """The engine's per-step extras besides the carried state (the paged
        engine's q8 staging of shard ``shard``); None here."""
        return None

    def _step_state(self, state: Any, aux: Any, a: Tuple[Any, ...], kw: Dict[str, Any], mask: torch.Tensor,
                    shard: int = 0) -> Any:
        """One padded step of shard ``shard`` on its carried state; returns
        the new carried state and writes none of its inputs (it is what a
        graph captures)."""
        plan = self._shard_plan(shard)
        if plan is not None:
            return plan.apply_masked(state, a, kw, mask)
        return self._pack_row(self._traced_update(self._unpack_row(state), (a, kw), mask, shard))

    def _kernel_tag(self) -> str:
        return "megastep" if self._megastep_plan is not None else "auto"

    def _update_kind(self) -> str:
        return "update"

    def _graph_keepalive(self) -> Tuple[Any, ...]:
        """What a captured step reads without owning it: the metric (its
        config tensors) and the megastep plan (its op rows), replicas too."""
        return (self._metric, self._megastep_plan, tuple(self._dev_metrics.values()),
                tuple(self._dev_plans.values()))

    def _shard_target(self, shard: int) -> Any:
        """What shard ``shard``'s fold reads and writes: the step target
        without a mesh, the shard's local state under deferred sync, its
        delta buffer under step sync (reset by :meth:`_delta_targets`)."""
        if self._mesh is None:
            return self._step_target()
        if self._deferred:
            view = self._shard_view(shard)
            return tree_map(lambda x: x[self._pane_cursor], view) if self._win_stacked else view
        return self._deltas[shard]

    def _program(self, leaves: List[Any], kinds: List[Optional[str]], treedef: Any, start: int, stop: int,
                 bucket: int, shard: int = 0) -> Tuple[Any, Optional[PinnedRing]]:
        """The cache entry of this step's signature on shard ``shard``'s
        device and the engine's pinned ring for it (None without host
        leaves): one per (bucket, device). A miss on the card captures the
        step from this chunk."""
        dev = self._shard_devices[shard]
        abstract = tree_unflatten(treedef, [
            leaf if kind is None else StateSpec(padded_shape(leaf, kind, bucket), torch_dtype(leaf.dtype))
            for leaf, kind in zip(leaves, kinds)])
        host = tuple(kind is not None and not on_card(leaf) for leaf, kind in zip(leaves, kinds))
        memo_key = (AotCache.signature_of(abstract), bucket, host, dev)
        hit = self._program_memo.get(memo_key)
        if hit is not None:
            self._aot.count_hit()
            self._last_aot_outcome = "hit"
            return hit
        if self._metric_fp is None:
            self._metric_fp = metric_fingerprint(self._metric)
        target = self._shard_target(shard)
        if self._carried_sig is None:
            self._carried_sig = AotCache.signature_of((target, self._step_aux(shard)))
        key = self._aot.program_key(
            f"{self._update_kind()}+k.{self._kernel_tag()}", self._metric_fp,
            arg_tree=(self._carried_sig, abstract, tuple(kinds), StateSpec((bucket,), torch.bool)),
            layout=self._layout, backend=self._kernel_tag(), device=dev, precision=self._precision_tag,
            mesh=self._mesh.describe() if self._mesh is not None else None,
            sync=self._sync_tag() if self._mesh is not None else None,
        )
        # this engine's own outcome (under a shared cache, another engine's
        # capture between the test and the lookup can only mislabel a duel)
        self._last_aot_outcome = "hit" if self._aot.contains(key) else "miss"
        if not self._capture:
            entry, ring = self._aot.get_or_capture(key, lambda: EAGER), None
        else:
            specs = {i: (padded_shape(leaf, kind, bucket), torch_dtype(leaf.dtype))
                     for i, (leaf, kind, on_host) in enumerate(zip(leaves, kinds, host)) if on_host}
            # the shards of a one-device mesh fill the same ring in turn
            fills = self._world if not self._nccl else 1
            ring = PinnedRing(specs, (self._cfg.in_flight + 1) * fills) if specs else None
            stream = self._shard_stream(shard)
            step_fn = functools.partial(self._step_state, shard=shard)

            def build() -> CapturedStep:
                inputs = StepBuffers(leaves, kinds, treedef, bucket, dev)
                prog = CapturedStep(target, self._step_aux(shard), inputs, self._graph_keepalive())
                inputs.fill(leaves, start, stop, self._cfg.pad_value, ring, stream)
                prog.load(target, self._step_aux(shard))  # the warm-up runs on this copy, never the live state
                self._aot.capture(prog, step_fn, dev)
                self._stats.warmup_steps += 1
                return prog

            entry = self._aot.get_or_capture(key, build)
        self._program_memo[memo_key] = (entry, ring)
        return entry, ring

    def _padded_tensors(self, leaves: List[Any], kinds: List[Optional[str]], treedef: Any, start: int, stop: int,
                        bucket: int, device: Optional[torch.device] = None
                        ) -> Tuple[Tuple[Any, ...], Dict[str, Any], torch.Tensor]:
        """The uncaptured step's padded chunk, as fresh tensors on ``device``
        (the engine's by default)."""
        dev = device if device is not None else self._device
        out = pad_leaves(leaves, kinds, start, stop, bucket, self._cfg.pad_value)
        out = [leaf if kind is None else torch.as_tensor(np.array(leaf) if isinstance(leaf, np.ndarray) else leaf)
               .to(dev) for leaf, kind in zip(out, kinds)]
        a, kw = tree_unflatten(treedef, out)
        mask = torch.arange(bucket, device=dev) < (stop - start)
        return a, kw, mask

    def _shard_parts(self, leaves: List[Any], kinds: List[Optional[str]], treedef: Any, start: int, stop: int,
                     bucket: int) -> List[Tuple[List[Any], List[Optional[str]], Any, int, int]]:
        """One padded chunk as the shards' parts ``(leaves, kinds, treedef,
        start, stop)``: itself without a mesh, else JAX's ``P(axis)`` split of
        the bucket (:func:`~metrics_tpu_torch.engine.bucketing.shard_blocks`)."""
        if self._mesh is None:
            return [(leaves, kinds, treedef, start, stop)]
        return [(leaves, kinds, treedef, lo, hi) for lo, hi in shard_blocks(start, stop, bucket, self._world)]

    def _run_padded_step(self, leaves: List[Any], kinds: List[Optional[str]], treedef: Any, start: int, stop: int,
                         bucket: int, coalesced: int, queue_wait_us: float = 0.0,
                         t0: Optional[float] = None, parts: Optional[List[Any]] = None) -> None:
        """One padded step, transactionally: rows ``[start, stop)`` of the ROWS
        leaves padded to ``bucket``, the other leaves as they are (on a mesh,
        each shard's block of them, or the routed ``parts`` given). The
        shadow takes the pre-step state; a failed attempt rolls back onto it
        and :meth:`_recover_step` retries it, demotes the kernels or lets it
        go sticky with the step and bucket attached. ``t0`` is when the host
        began building this chunk (the paged form: its round, paging
        included): the ``pad`` span and the telemetry record start there."""
        t_pad = time.perf_counter()
        if t0 is None:
            t0 = t_pad
        if parts is None:
            parts = self._shard_parts(leaves, kinds, treedef, start, stop, bucket)
        tr = self._trace
        if tr is not None:
            tr.complete("pad", trace=self._group_tid or ENGINE_TRACE, dur_us=(t_pad - t0) * 1e6, bucket=bucket,
                        rows=sum(p[4] - p[3] for p in parts))
        attempt = 0
        while True:
            shadow = self._step_shadow()
            try:
                self._do_step(parts, bucket, coalesced, queue_wait_us, t0, t_pad)
                return
            except Exception as e:
                if not self._recover_step(e, shadow, attempt):
                    _attach_ctx(e, step=self._step, bucket=bucket)
                    raise
                attempt += 1

    def _do_step(self, parts: List[Any], bucket: int, coalesced: int, queue_wait_us: float, t0: float,
                 t_pad: float) -> None:
        """One attempt of a step, and its commit. Its fault sites fire in the
        JAX package's order: ``compile``, ``kernel`` (while on the megastep
        kernels), ``shard_loss`` (on a mesh, before anything runs), the step
        itself, then ``step`` (the device work is enqueued and, on the card,
        has written the state in place: the rollback's case) and
        ``watchdog``. Each shard's fold replays its captured graph on the
        card (capturing it on a miss) and runs eagerly elsewhere; step sync
        then merges the shards' deltas (one fused bundle) into the global
        state. New state that was not written in place is written at the
        commit. With a recorder attached the capture lookup is an ``aot``
        span (``cache`` hit or miss) and the device work a ``device_step``
        span, enqueued under the profiler label ``device_step:<step>``."""
        tr = self._trace
        gid = self._group_tid or ENGINE_TRACE
        valid = sum(p[4] - p[3] for p in parts)
        per = bucket // self._world
        self._fault("compile")
        if self._kernel_tag() == "megastep":
            # a runtime failure of the whole-arena kernels: meaningless once
            # the engine is on the per-leaf ones
            self._fault("kernel")
        if self._mesh is not None:
            # a shard dying: consulted before the step runs, so nothing has
            # folded when it fires (elastic_min_world's recovery re-runs the chunk)
            self._fault("shard_loss")
        if self._mesh is not None and not self._deferred:
            self._delta_targets()
        progs: List[Any] = [(None, None)] * len(parts)
        if self._capture or self._stream is None:
            aot_handle = tr.begin("aot", trace=gid, bucket=bucket) if tr is not None else None
            progs = [self._program(*part, per, shard=k) for k, part in enumerate(parts)]
            if aot_handle is not None:
                tr.end(aot_handle, cache=self._last_aot_outcome)
        depth = self._queue.qsize()
        step_handle = None
        label: Any = nullcontext()
        if tr is not None:
            step_handle = tr.begin("device_step", trace=gid, step=self._step, bucket=bucket, valid=valid)
            label = torch.profiler.record_function(f"device_step:{self._step}")

        def fold(k: int, target: Any, part: Any) -> Any:
            """Shard ``k``'s fold of its block into ``target``: the captured
            graph's replay, in place (None), or the eager step's new state."""
            leaves, kinds, treedef, start, stop = part
            prog, ring = progs[k]
            if self._capture:
                stream = self._shard_stream(k)
                # a graph replays on its device's current stream: across
                # devices, make shard k's the current one
                on_shard = torch.cuda.stream(stream) if self._nccl else nullcontext()
                with on_shard, self._aot.exclusive(stream):
                    prog.inputs.fill(leaves, start, stop, self._cfg.pad_value, ring, stream)
                    prog.replay(target, self._step_aux(k))
                return None
            a, kw, mask = self._padded_tensors(leaves, kinds, treedef, start, stop, per, self._shard_devices[k])
            return self._step_state(target, self._step_aux(k), a, kw, mask, shard=k)

        with label:
            if self._mesh is None:
                new = fold(0, self._step_target(), parts[0])
            else:
                new = self._mesh_step(fold, parts)
        self._fault("step")
        sync_us: Optional[float] = None
        if self._watchdog_enabled:
            self._fault("watchdog")
            t_sync = time.perf_counter()
            self._watch()
            sync_us = (time.perf_counter() - t_sync) * 1e6
            if tr is not None:
                tr.complete("watchdog_sync", trace=gid, dur_us=sync_us)
        if new is not None:
            if self._deferred:
                for k, out in enumerate(new):
                    if out is not None:
                        self._write_state(out, into=self._shard_target(k))
            else:
                self._write_state(new, into=self._step_target() if self._mesh is None else None)
        self._step += 1
        self._state_version += 1
        if not self._watchdog_enabled:  # a watched step was drained before its commit
            sync_us = self._bound_inflight()
            if sync_us is not None and tr is not None:
                tr.complete("inflight_sync", trace=gid, dur_us=sync_us)
        wall_us = (time.perf_counter() - t0) * 1e6
        if step_handle is not None:
            tr.end(step_handle)
            tr.observe("step_latency_us", wall_us)
        pad_us = (t_pad - t0) * 1e6
        self._stats.record_step(bucket=bucket, valid=valid, queue_depth=depth, ingest_us=pad_us, sync_us=sync_us,
                                pad_us=pad_us, queue_wait_us=queue_wait_us, wall_us=wall_us, coalesced=coalesced)

    def _record_events(self) -> List[torch.cuda.Event]:
        """One CUDA event on each of the engine's streams, after its work."""
        events = []
        for st in self._streams():
            ev = torch.cuda.Event()
            ev.record(st)
            events.append(ev)
        return events

    def _watch(self) -> None:
        """The watchdog's wait: poll the step's CUDA events (one per device
        stream; the step is done when every one is) until they complete or
        ``step_timeout_s`` passes (no waiter thread; the hung work keeps
        running on the engine streams, and the rollback is ordered after
        it). Without a timeout it drains the step. On the CPU the step has
        run."""
        events = self._record_events()
        if not events:
            return
        timeout = self._cfg.step_timeout_s
        if timeout > 0:
            deadline = time.monotonic() + timeout
            while not all(ev.query() for ev in events):
                if time.monotonic() >= deadline:
                    raise StepTimeoutError(f"device step did not complete within the {timeout:.3f}s watchdog")
                time.sleep(_WATCH_POLL_S)
        else:
            for ev in events:
                ev.synchronize()
        self._inflight.clear()

    def _shadow_target(self) -> Any:
        """What a step writes, and so what the shadow covers: a ring's current
        pane row or the state without a mesh, every shard's state (deferred)
        or the global state (step sync) on one."""
        return self._step_target() if self._mesh is None else self._state

    def _step_shadow(self) -> Any:
        """The pre-step state a failed step rolls back onto, or None when the
        engine is not transactional (a failure then goes sticky). The shadow
        is allocated once and refreshed in place before every step, on the
        engine's streams; it covers what the step writes."""
        if not self._transactional:
            return None
        target = self._shadow_target()
        if self._shadow is None:
            self._shadow = tree_map(torch.empty_like, target)
        for dst, src in zip(tree_leaves(self._shadow), tree_leaves(target)):
            dst.copy_(src)
        return self._shadow

    def _recover_step(self, e: Exception, shadow: Any, attempt: int) -> bool:
        """Roll a failed step back and classify it: True retries it (after
        backoff) or, for an injected ``kernel`` fault, demotes the engine to
        the per-leaf kernels and retries at once; False lets it go sticky."""
        if shadow is None:
            return False
        try:
            # in place, on the engine streams: after whatever the failed or
            # hung attempt enqueued, so no late write lands on the rolled-back state
            for dst, src in zip(tree_leaves(self._shadow_target()), tree_leaves(shadow)):
                dst.copy_(src)
        except RuntimeError:  # a broken device: the original error goes sticky
            return False
        self._merged_memo = None
        self._stats.rollbacks += 1
        tr = self._trace
        if tr is not None:
            tr.event("rollback", trace=self._group_tid or ENGINE_TRACE, cause=type(e).__name__)
        if isinstance(e, StepTimeoutError):
            self._stats.watchdog_timeouts += 1
        if (isinstance(e, InjectedFault) and e.site == "kernel" and self._cfg.degrade_kernel
                and self._kernel_tag() == "megastep"):
            # megastep -> auto, one way: the per-leaf kernels (K1; K4 on the
            # paged engine) replace K5/K6/K7. The arena and its layout stay;
            # the tag changes in every step key, so the demoted steps capture anew
            self._megastep_plan = None
            self._program_memo.clear()
            self._stats.kernel_demotions += 1
            if tr is not None:
                tr.event("kernel_demotion", trace=self._group_tid or ENGINE_TRACE, backend="auto")
            return True
        if not is_transient(e) or attempt >= self._cfg.max_retries:
            return False
        self._stats.record_retry()
        if tr is not None:
            tr.event("retry", trace=self._group_tid or ENGINE_TRACE, attempt=attempt + 1)
        self._backoff(attempt + 1)
        return True

    def _bound_inflight(self) -> Optional[float]:
        """At most ``in_flight`` steps run ahead of the host: past that, wait
        for the oldest (every device stream's event of it); returns the µs
        the dispatcher waited, or None when it did not have to. The count is
        the JAX package's (one token a step, cleared by the watchdog,
        ``reset`` and ``restore``), so its ``inflight_sync`` spans fall on the
        same steps; on the CPU a step has run when it returns, and its token
        is empty."""
        self._inflight.append(self._record_events())
        if len(self._inflight) <= max(1, self._cfg.in_flight):
            return None
        oldest = self._inflight.popleft()
        t0 = time.perf_counter()
        for ev in oldest:
            ev.synchronize()
        return (time.perf_counter() - t0) * 1e6

    def _execute_payload(self, merged: Tuple[Tuple[Any, ...], Dict[str, Any]], n: int, coalesced: int,
                         queue_wait_us: float = 0.0) -> None:
        """Run one merged (args, kwargs) batch of ``n`` rows through its
        bucketed chunks; the first chunk's step counts the coalesced batches
        and the group's queue wait. A non-transient ``shard_loss`` under
        ``elastic_min_world`` reshards the engine to the surviving world and
        re-runs the chunk there (nothing of it had folded). An escaping error
        carries ``_committed_chunks`` (summed over nested calls), which tells
        the caller whether re-running the batches one by one would fold a row
        twice."""
        leaves, treedef = tree_flatten(merged)
        committed = 0
        try:
            for i, (start, stop, bucket) in enumerate(self._policy.chunks(n)):
                t0 = time.perf_counter()
                while True:
                    kinds = classify_leaves(leaves, n, bucket, self._policy.divisor)
                    try:
                        self._run_padded_step(leaves, kinds, treedef, start, stop, bucket,
                                              coalesced if i == 0 else 1, queue_wait_us if i == 0 else 0.0, t0)
                        break
                    except InjectedFault as e:
                        if not self._lost_shard_resharded(e):
                            raise
                committed += 1
        except Exception as e:
            _add_committed(e, committed)
            raise

    def _lost_shard_resharded(self, e: BaseException) -> bool:
        """A non-transient ``shard_loss`` under ``elastic_min_world``: reshard
        to the surviving world (True: re-run what failed); anything else
        stays an error (False)."""
        target = (self._shard_loss_target()
                  if isinstance(e, InjectedFault) and e.site == "shard_loss" and not e.transient else None)
        if target is None:
            return False
        self._stats.shard_losses += 1
        self._reshard_locked(world=target, auto=True)
        return True

    def _latch_payload(self, merged: Any) -> Tuple[Tuple[Any, ...], Dict[str, Any]]:
        """The (args, kwargs) a host-attr latch row is cut from (the
        multi-stream engine strips its stream ids)."""
        return merged

    def _latch_host_attrs(self, merged: Any) -> None:
        """Latch host-derived compute attrs (Accuracy's input mode) with ONE
        eager 1-row update of the members that declare them, before any step
        key is built: the latched values are part of the metric's fingerprint,
        and an engine whose steps are all cache hits never runs the update's
        Python. The row's state is discarded."""
        args, kwargs = self._latch_payload(merged)
        leaves, treedef = tree_flatten((args, kwargs))
        n = infer_batch_size(leaves)
        a, kw = tree_unflatten(treedef, [leaf[:1] if is_batch_leaf(leaf, n) else leaf for leaf in leaves])
        members = self._metric.items(keep_base=True) if not hasattr(self._metric, "_defaults") else [(None, self._metric)]
        for _, m in members:
            if any(v is None for v in m.host_compute_attrs().values()):
                m.update_state(m.init_state(), *a, **m._filter_kwargs(**kw))
        self._needs_attr_latch = False
        self._metric_fp = None

    # ------------------------------------------------------------------ dispatcher

    def start(self) -> "StreamingEngine":
        """Start the dispatcher thread (a no-op while it runs)."""
        if self._worker is None or not self._worker.is_alive():
            for st in self._streams():  # what the caller's streams made (the state) comes first
                st.wait_stream(torch.cuda.current_stream(st.device))
            self._worker = threading.Thread(target=self._run, name="metrics-tpu-torch-engine", daemon=True)
            self._worker.start()
        return self

    def stop(self) -> None:
        """Drain the queue and stop the dispatcher (idempotent); the device
        has finished every step when it returns."""
        if self._worker is not None:
            while self._worker.is_alive():
                try:
                    self._queue.put(_STOP, timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._worker.join()
            self._worker = None
        with self._state_lock:
            self._sync()

    def __enter__(self) -> "StreamingEngine":
        return self.start()

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        self.stop()
        if exc_type is None:
            self._raise_if_failed()
        return False

    def _raise_if_failed(self) -> None:
        if self._error is None:
            return
        ctx = getattr(self._error, "_engine_ctx", None) or {}
        detail = "".join(f"; {k}={v}" for k, v in sorted(ctx.items()))
        raise EngineDispatchError(
            f"streaming engine dispatcher failed: {type(self._error).__name__}: {self._error}{detail}",
            context=ctx,
        ) from self._error

    def _run(self) -> None:
        try:
            self._bind_streams()
            torch.set_grad_enabled(False)
        except Exception as e:  # noqa: BLE001 - no batch may be dropped unreported
            self._error = e
        pending: Optional[Any] = None
        while True:
            if pending is not None:
                first, wait_us, pending = pending, 0.0, None
            else:
                t0 = time.perf_counter()
                first = self._queue.get()
                wait_us = (time.perf_counter() - t0) * 1e6
            if first is _STOP:
                self._queue.task_done()
                return
            group, saw_stop, fatal = [first], False, False
            if self._error is None:
                group, pending, saw_stop, drain_wait_us = self._coalesce_group(first)
                wait_us += drain_wait_us  # the coalesce window's blocking is queue wait too
            tids = self._pop_trace_ids(group)  # even when draining: no leaks
            try:
                if self._error is None:  # after a failure: drain without work
                    self._process_group(group, wait_us, tids)
                    if self._ladder is not None:
                        # once per processed group, BEFORE task_done: a flush()
                        # that joined the queue sees the settled ladder level
                        self._ladder_tick()
            except Exception as e:  # noqa: BLE001 - surfaced via _raise_if_failed
                _attach_ctx(e, cursor=self._batches_done, **self._group_context(group))
                self._error = e
                fatal = isinstance(e, InjectedFault) and e.fatal
            finally:
                for _ in group:
                    self._queue.task_done()
            if fatal:
                # the dispatcher dies outright, without draining: producers
                # learn of it from submit(timeout=)'s sticky raise, and
                # reset()/restore()/flush() drain the backlog themselves.
                # What this loop already dequeued (the coalescer's look-ahead,
                # a consumed stop) is done here, or every later join hangs
                if pending is not None:
                    self._pop_trace_ids([pending])  # a dropped item: free its id
                    self._queue.task_done()
                if saw_stop:
                    self._queue.task_done()
                return
            if saw_stop:
                self._queue.task_done()
                return

    def _group_context(self, group: List[Any]) -> Dict[str, Any]:
        """Extra failure context for a group (the multi-stream engine adds
        stream ids)."""
        return {}

    def _pop_trace_ids(self, group: List[Any]) -> Optional[List[Tuple[str, float]]]:
        """Release the submit trace ids of a picked-up (or dropped) group —
        the links its megabatch span carries — each with the batch's QUEUE
        RESIDENCY in µs (pickup minus submit stamp). None without a
        recorder."""
        if self._trace is None:
            return None
        now = time.perf_counter()
        out: List[Tuple[str, float]] = []
        for it in group:
            entry = self._trace_ids.pop(id(it), None)
            if entry is not None:
                out.append((entry[0], (now - entry[1]) * 1e6))
        return out

    def _process_group(self, group: List[Any], queue_wait_us: float = 0.0,
                       tids: Optional[List[Tuple[str, float]]] = None) -> None:
        with self._state_lock:
            # only an INGEST fault retries at this level: it fires before
            # anything folds, so the whole group re-runs from untouched state
            tr = self._trace
            if tr is None:
                self._retry_transient(lambda: self._process_group_locked(group, queue_wait_us),
                                      transient=_ingest_transient)
                return
            # the megabatch ("coalesce") span: its trace id derives from the
            # first absorbed submit, and its links are all of them
            links = [t for t, _ in tids or ()]
            waits = [w for _, w in tids or ()]
            gid = TraceRecorder.group_trace(links)
            self._group_tid = gid
            # the group's queue_wait is its LONGEST member residency (members
            # wait concurrently); the histogram sees every member
            tr.complete("queue_wait", trace=gid, dur_us=max(waits, default=0.0))
            for w in waits:
                tr.observe("queue_wait_us", w)
            handle = tr.begin("coalesce", trace=gid, links=links, batches=len(group), **self._group_context(group))
            try:
                self._retry_transient(lambda: self._process_group_locked(group, queue_wait_us),
                                      transient=_ingest_transient)
            finally:
                self._group_tid = None
                tr.end(handle)

    def _process_group_locked(self, group: List[Any], queue_wait_us: float = 0.0) -> None:
        if self._worker_epoch != self._topology_epoch:
            # a reshard brought devices this thread has no stream bound for
            self._bind_streams()
        # a FATAL fault here models the dispatcher dying outright
        self._fault("dispatcher_kill")
        if self._window is not None and self._window.pane_seconds > 0:
            # TIME-cadence panes rotate BEFORE the group folds: a batch that
            # arrives after the pane's deadline belongs to the NEW pane (a
            # batch-cadence boundary rotates after its group, below)
            self._maybe_rotate_locked()
        self._fault("ingest")  # the host ingestion boundary: nothing folded yet
        sized = [(it, self._item_rows(it)) for it in group]
        kept = self._screen_group(sized)
        nonempty = [(it, n) for it, n in kept if n > 0]
        merged = self._merge_sized(nonempty)
        if merged is not None:
            if self._needs_attr_latch:
                self._latch_host_attrs(merged)
            try:
                self._execute_payload(merged, sum(n for _, n in nonempty), len(nonempty), queue_wait_us)
            except Exception as e:
                # shrink-on-retry: a failed megabatch that committed no chunk
                # re-runs its batches one by one, so good traffic lands and the
                # sticky error names the poisoned batch's cursor. It needs the
                # shadow (the failed step rolled back onto it); after a partial
                # commit, splitting would fold the committed rows twice
                if len(nonempty) <= 1 or getattr(e, "_committed_chunks", 1) != 0 or not self._transactional:
                    raise
                self._stats.coalesce_shrinks += 1
                cursors = {id(it): self._batches_done + j for j, (it, _) in enumerate(sized)}
                for it, n_it in nonempty:
                    try:
                        self._execute_payload(self._merge_sized([(it, n_it)]), n_it, 1, 0.0)
                    except Exception as se:
                        _attach_ctx(se, cursor=cursors.get(id(it)), **self._item_context(it))
                        raise
        self._batches_done += len(group)
        if self._window is not None and self._window.pane_batches > 0:
            # before the snapshot cadence: a boundary snapshot carries the
            # rotated ring, so a restored engine never rotates it again
            self._maybe_rotate_locked()
        if self._cfg.snapshot_every > 0 and self._batches_done % self._cfg.snapshot_every == 0:
            self._sync()  # the copy to the host reads the state after every in-flight step folded
            try:
                self._save_snapshot()
            except Exception:  # noqa: BLE001 - counted, never sticky
                # a failed PERIODIC snapshot must not take serving down:
                # the state is intact and the previous generation still
                # backs restore()
                self._stats.snapshot_failures += 1

    # -------------------------------------------------------------- pane rotation

    def _maybe_rotate_locked(self) -> None:
        """Rotate the ring when the cadence is due at this batch boundary
        (dispatcher thread, state lock held). Batch cadence is a function of
        the replay cursor, so kill/resume rotates at the same boundaries;
        time cadence reads the policy's clock and advances by
        ``pane_seconds`` per rotation, so a stalled dispatcher catches up
        pane by pane."""
        w = self._window
        if w is None or self._fleet_rotation:  # a fleet host rotates when its FleetEngine says so
            return
        due = w.rotations_due(self._batches_done, self._last_rotate_batches, self._win_clock(),
                              self._last_rotate_time)
        for _ in range(due):
            self._rotate_once_locked()

    def rotate_pane(self) -> None:
        """Rotate the ring NOW, at a batch boundary the caller chooses: every
        batch submitted before the call folds into the closing pane first
        (a flush), then the rotation runs as the cadence's does."""
        if self._window is None:
            raise MetricsTPUUserError(
                "rotate_pane() needs a rotating config.window (tumbling/sliding/ewma); this engine serves "
                "cumulative state"
            )
        self.flush()
        with self._device_section():
            self._rotate_once_locked()

    def _rotate_once_locked(self) -> None:
        """One rotation, split plan/commit so that a retried one never clears
        or decays twice. Plan: read the closing pane's result for the drift
        detector (a pure read: a ``drift_eval`` transient reads again) and
        prepare the rotation without touching the state (a ``pane_rotate``
        transient prepares again). Commit: write it in place, move the
        cursor and the marks, record once."""
        drift_values: Optional[List[Tuple[Optional[int], Any]]] = None
        # an EMPTY pane (a time cadence catching up over a traffic gap) is no
        # drift observation: its init-state result would raise false alarms
        # and, under the first/mean baselines, poison the reference
        if self._drift is not None and self._batches_done > self._pane_open_cursor:
            def eval_once() -> List[Tuple[Optional[int], Any]]:
                self._fault("drift_eval")
                return self._drift_values_locked()

            drift_values = self._retry_transient(eval_once)
        incoming = (self._pane_cursor + 1) % self._panes if self._window.stacked else 0
        ewma = self._window.kind == "ewma"
        planned = self._plan_rotation(incoming)
        # ---- commit: nothing below is consulted by a fault site
        self._commit_rotation(planned, incoming)
        # the commit wrote the state in place: a deferred merge memoized before
        # it (the drift read's, or a read's) would hand out the old panes
        self._state_version += 1
        self._result_cache.clear()
        self._pane_cursor = incoming
        self._rotations += 1
        self._pane_open_cursor = self._batches_done
        if self._window.pane_batches > 0:
            self._last_rotate_batches += self._window.pane_batches
        else:
            self._last_rotate_time += self._window.pane_seconds
        self._stats.record_rotation(cursor=self._pane_cursor, live=min(self._rotations + 1, self._panes), ewma=ewma)
        if self._trace is not None:
            self._trace.event("pane_rotate", trace=ENGINE_TRACE, rotation=self._rotations, cursor=self._pane_cursor,
                              kind=self._window.kind)
        if drift_values is not None:
            self._record_drift(drift_values)

    def _plan_rotation(self, incoming: int) -> Any:
        """The fallible half of a rotation, behind the ``pane_rotate`` site and
        the bounded retry, pure in the state: a ring's plan is the init row
        the incoming pane takes, an EWMA's the decayed buffers, made anew
        (each element times the decay rounded to its dtype, as the JAX
        package multiplies). The paged engine plans the rows it expires."""
        def rotate_once() -> Any:
            self._fault("pane_rotate")
            if self._win_stacked:
                return [self._ring_init_row(dev) for dev in self._shard_devices] if self._deferred \
                    else self._ring_init_row(self._device)
            return tree_map(lambda x: x * torch.tensor(self._window.decay, dtype=x.dtype, device=x.device), self._state)

        return self._retry_transient(rotate_once)

    def _ring_init_row(self, dev: torch.device) -> Any:
        """One pane's carried init row on ``dev``, made once a device and
        only ever read."""
        if self._ring_init is None:
            self._ring_init = {}
        if dev not in self._ring_init:
            self._ring_init[dev] = self._pack_row(tree_map(lambda x: torch.as_tensor(x).to(dev),
                                                           self._kind_init_state_tree()))
        return self._ring_init[dev]

    def _commit_rotation(self, planned: Any, incoming: int) -> None:
        """The infallible half: write the plan into the state, in place (the
        incoming pane's row, of every shard on a deferred mesh, all at the
        same boundary; or every decayed buffer)."""
        if not self._win_stacked:
            self._write_state(planned)
        elif self._deferred:
            for k, row in enumerate(planned):
                self._write_state(row, into=tree_map(lambda x: x[incoming], self._shard_view(k)))
        else:
            self._write_state(planned, into=self._pane_row(incoming))

    def _closing_pane_tree(self) -> Any:
        """The CLOSING pane's global logical tree (the whole decayed state
        under EWMA): what the drift detector reads before a rotation."""
        tree = self._carried_logical()
        return tree_map(lambda x: x[self._pane_cursor], tree) if self._win_stacked else tree

    def _drift_values_locked(self) -> List[Tuple[Optional[int], Any]]:
        """The CLOSING pane's result, ``(series key, value)`` pairs: one
        anonymous series here, one per stream on the multi-stream engine. A
        pure read, computed traced as ``result()`` is, owning its memory: the
        commit that follows writes the state in place."""
        tree = self._closing_pane_tree()
        with traced_rows():
            return [(None, self._owned(self._metric.compute_from(tree)))]

    def _record_drift(self, values: List[Tuple[Optional[int], Any]]) -> None:
        """Record each series exactly once (after the plan's retries) and
        surface the transitions as ``drift_alarm`` trace events and counters."""
        pane = self._rotations - 1  # the pane that just closed, 0-based
        for key, value in values:
            transitions = self._drift.record(value, key=key, pane=pane)
            self._stats.drift_evals += 1
            for a in transitions:
                if a.kind == "raise":
                    self._stats.drift_alarms += 1
                if self._trace is not None:
                    self._trace.event("drift_alarm", trace=ENGINE_TRACE, kind=a.kind, series=a.name, pane=pane,
                                      **({"stream_id": a.key} if a.key is not None else {}))

    # ------------------------------------------------------------------- quarantine

    def quarantine(self) -> List[QuarantineRecord]:
        """The dead-letter ledger: the batches the screen policy rejected,
        newest ``quarantine_capacity`` kept with their payloads (lifetime
        counts: ``stats.quarantined_batches``/``quarantined_rows``)."""
        with self._state_lock:
            return list(self._quarantine)

    def clear_quarantine(self) -> None:
        with self._state_lock:
            self._quarantine.clear()

    def _screen_payload(self, item: Any) -> Any:
        """The (args, kwargs) of a queue item that the screen policy sees
        (the multi-stream engine strips its stream id)."""
        return item

    def _item_context(self, item: Any) -> Dict[str, Any]:
        """Per-item failure and quarantine context (the multi-stream engine
        adds the stream id)."""
        return {}

    def _record_quarantine(self, item: Any, rows: int, cursor: int, reason: str) -> None:
        self._quarantine.append(QuarantineRecord(cursor=cursor, rows=int(rows), reason=reason,
                                                 stream_id=self._item_context(item).get("stream_id"), payload=item))
        self._stats.quarantined_batches += 1
        self._stats.quarantined_rows += int(rows)
        if self._trace is not None:
            sid = self._item_context(item).get("stream_id")
            extra = {"stream_id": sid} if sid is not None else {}
            self._trace.event("quarantine", trace=self._group_tid or ENGINE_TRACE, cursor=int(cursor),
                              rows=int(rows), reason=reason, **extra)

    def _screen_group(self, sized: List[Tuple[Any, int]]) -> List[Tuple[Any, int]]:
        """Screen each batch on the host before anything is uploaded.
        Quarantined batches leave the group, but the replay cursor still
        counts them (``_batches_done`` advances by the whole group), so a
        kill/resume replay screens them the same way. An ``"error"`` verdict
        becomes the sticky error, with the batch's cursor."""
        policy = self._cfg.screen
        if policy is None:
            return sized
        kept: List[Tuple[Any, int]] = []
        for j, (it, n) in enumerate(sized):
            verdict = None
            if n > 0:
                try:
                    verdict = policy.screen(self._screen_payload(it), n)
                except Exception:  # noqa: BLE001 - what a probe cannot inspect, it does not reject
                    verdict = None
            if verdict is None:
                kept.append((it, n))
                continue
            action, reason = verdict
            cursor = self._batches_done + j
            if action == "error":
                err = MetricsTPUUserError(f"batch rejected by screen policy: {reason}")
                _attach_ctx(err, cursor=cursor, **self._item_context(it))
                raise err
            self._record_quarantine(it, n, cursor, reason)
        return kept

    def _join_queue(self) -> None:
        """``queue.join()`` that survives a dispatcher that is gone: a live
        worker drains normally (waited on in slices, liveness re-checked);
        without one the backlog is drained here, or unfinished items would
        pin every later join."""
        while self._worker is not None and self._worker.is_alive():
            with self._queue.all_tasks_done:
                if self._queue.unfinished_tasks == 0:
                    return
                self._queue.all_tasks_done.wait(timeout=0.1)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            # a drained item is a dropped batch: free its submit trace id
            self._trace_ids.pop(id(item), None)
            self._queue.task_done()
        with self._queue.all_tasks_done:
            if self._queue.unfinished_tasks:
                self._queue.unfinished_tasks = 0
                self._queue.all_tasks_done.notify_all()

    def _sync(self) -> None:
        """Wait for every step enqueued on the engine's streams (the in-flight
        tokens stay: they count steps, as the JAX package's do)."""
        for st in self._streams():
            st.synchronize()

    # ------------------------------------------------------------------- coalescing

    def _item_rows(self, item: Any) -> int:
        n = infer_batch_size(tree_leaves(item))
        if n is None:
            raise MetricsTPUUserError("submit() needs at least one array argument with a batch dimension")
        return int(n)

    def _item_rows_safe(self, item: Any) -> Optional[int]:
        """Row count, or None for a malformed item: the coalesce path must
        never raise (errors surface through the step instead)."""
        try:
            return self._item_rows(item)
        except Exception:  # noqa: BLE001
            return None

    def _coalesce_group(self, first: Any) -> Tuple[List[Any], Optional[Any], bool, float]:
        """Drain further compatible queued batches behind ``first``. Returns
        ``(group, pending_incompatible_item, saw_stop, drain_wait_us)``, the
        last the time spent BLOCKED waiting for more traffic inside the
        window. Bounded by ``coalesce`` batches and by the top bucket's row
        count (a fuller megabatch would just re-chunk); waits up to
        ``coalesce_window_ms`` for more traffic once the queue runs dry. A
        group never crosses the next snapshot boundary nor a batch-cadence
        pane boundary (both cadences stay batch-exact)."""
        limit = max(1, self._cfg.coalesce)
        if self._cfg.snapshot_every > 0:
            limit = min(limit, self._cfg.snapshot_every - (self._batches_done % self._cfg.snapshot_every))
        if self._window is not None and self._window.pane_batches > 0:
            # nor a pane boundary: rows past it belong to the NEXT pane (time
            # cadence rotates between groups by construction)
            limit = min(limit, self._window.pane_batches - (self._batches_done - self._last_rotate_batches))
        group = [first]
        if limit <= 1:
            return group, None, False, 0.0
        inj = self._cfg.fault_injector
        if inj is not None and inj.fire("coalesce"):
            # degradation, never an error (an escape would kill the
            # dispatcher): the group is served as singletons
            self._stats.record_fault("coalesce")
            self._stats.coalesce_degraded += 1
            if self._trace is not None:
                self._trace.event("fault", site="coalesce")
            return group, None, False, 0.0
        rows = self._item_rows_safe(first)
        if rows is None:  # malformed: run alone so the error surfaces cleanly
            return group, None, False, 0.0
        top = self._policy.buckets[-1]
        deadline = time.perf_counter() + self._cfg.coalesce_window_ms / 1e3
        waited = 0.0
        ref = first if rows else None
        while len(group) < limit and rows < top:
            try:
                timeout = deadline - time.perf_counter()
                if timeout > 0:
                    t0 = time.perf_counter()
                    try:
                        item = self._queue.get(timeout=timeout)
                    finally:
                        waited += time.perf_counter() - t0
                else:
                    item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                return group, None, True, waited * 1e6
            n = self._item_rows_safe(item)
            if n is None:
                return group, item, False, waited * 1e6
            if n == 0:
                group.append(item)  # cursor-only; nothing to concatenate
                continue
            if ref is not None and not self._coalescible(ref, item):
                return group, item, False, waited * 1e6
            if ref is None:
                ref = item
            group.append(item)
            rows += n
        return group, None, False, waited * 1e6

    def _coalescible(self, ref: Any, item: Any) -> bool:
        """Can ``item`` concatenate behind ``ref`` into one megabatch? Same
        structure, batch-carried leaves agreeing on trailing shape, dtype and
        kind (numpy, or tensors on one device), and non-batch (broadcast)
        leaves EQUAL: a differing broadcast argument changes the math and runs
        as its own step. Never raises: a leaf that breaks a probe just does
        not coalesce."""
        try:
            ref_leaves, ref_def = tree_flatten(ref)
            leaves, treedef = tree_flatten(item)
            if treedef != ref_def or len(leaves) != len(ref_leaves):
                return False
            n_ref, n_item = infer_batch_size(ref_leaves), infer_batch_size(leaves)
            for rl, il in zip(ref_leaves, leaves):
                rb, ib = is_batch_leaf(rl, n_ref), is_batch_leaf(il, n_item)
                if rb != ib:
                    return False
                if rb:
                    if not _same_batch_leaf(rl, il):
                        return False
                elif not _aux_leaves_equal(rl, il):
                    return False
            return True
        except Exception:  # noqa: BLE001 - don't coalesce what we can't probe
            return False

    def _merge_sized(self, nonempty: List[Tuple[Any, int]]) -> Optional[Tuple[Tuple[Any, ...], Dict[str, Any]]]:
        """One (args, kwargs) megabatch of pre-sized non-empty items (None
        when there are none)."""
        return self._concat_sized(nonempty)

    @staticmethod
    def _concat_sized(nonempty: List[Tuple[Any, int]]) -> Optional[Tuple[Tuple[Any, ...], Dict[str, Any]]]:
        """Concatenate the batch-carried leaves of the items in order (numpy
        on the host, tensors on their device: a CUDA concatenation runs on the
        dispatcher's stream), taking the first item's other leaves."""
        if not nonempty:
            return None
        if len(nonempty) == 1:
            return nonempty[0][0]
        flat = [tree_flatten(it) for it, _ in nonempty]
        treedef = flat[0][1]
        n0 = nonempty[0][1]
        out_leaves: List[Any] = []
        for i, leaf0 in enumerate(flat[0][0]):
            if is_batch_leaf(leaf0, n0):
                parts = [leaves[i] for leaves, _ in flat]
                out_leaves.append(torch.cat(parts) if isinstance(leaf0, torch.Tensor) else np.concatenate(parts))
            else:
                out_leaves.append(leaf0)
        return tree_unflatten(treedef, out_leaves)

    # ------------------------------------------------------------------ producers

    def _order_inputs(self, item: Any) -> None:
        """Order the engine stream after the producer's work on the item's
        CUDA tensors, and keep their memory from reuse until the engine
        stream is done with them."""
        if self._stream is None:
            return
        events: Dict[Any, torch.cuda.Event] = {}
        for leaf in tree_leaves(item):
            if on_card(leaf):
                leaf.record_stream(self._stream)
                producer = torch.cuda.current_stream(leaf.device)
                if producer not in events:
                    events[producer] = ev = torch.cuda.Event()
                    ev.record(producer)
                    self._stream.wait_event(ev)

    def _submit_item(self, item: Any, timeout: Optional[float]) -> None:
        """Enqueue one queue item, tracing the submit when a recorder is on:
        the span's duration is the enqueue wait (backpressure made visible),
        and the trace id registered here is what the dispatcher's megabatch
        span links back to."""
        self._raise_if_failed()
        self.start()
        self._order_inputs(item)
        tr = self._trace
        if tr is None:
            self._enqueue(item, timeout)
        else:
            tid = tr.new_trace()
            # the stamp starts the batch's queue residency clock
            self._trace_ids[id(item)] = [tid, time.perf_counter()]
            ctx = {k: v for k, v in self._item_context(item).items() if v is not None}
            handle = tr.begin("submit", trace=tid, **ctx)
            try:
                self._enqueue(item, timeout)
            except BaseException:
                # a refused submit is no batch: a later item reusing the object
                # identity must not inherit the id
                self._trace_ids.pop(id(item), None)
                raise
            tr.end(handle)
        self._stats.record_submitted()

    def submit(self, *args: Any, timeout: Optional[float] = None, **kwargs: Any) -> None:
        """Enqueue one (ragged) batch: tensors or numpy arrays. Blocks while
        the queue is full; ``timeout`` (seconds) bounds the wait, after which
        the sticky dispatcher error is raised if there is one, else
        :class:`BackpressureTimeout`. A batch of zero rows only advances the
        cursor.

        With ``config.admission`` set, the batch must clear the admission
        policy FIRST: a refusal raises :class:`AdmissionRejected` (with
        ``retry_after_s``) before anything queues, so a rejected batch never
        takes a replay cursor."""
        item = (args, kwargs)
        if self._admission is not None:
            self._raise_if_failed()
            self.start()
            self._admitted_submit(None, item, item, timeout)
        else:
            self._submit_item(item, timeout)

    def _admitted_submit(self, stream_id: Optional[int], item: Any, payload: Any, timeout: Optional[float]) -> None:
        """The armed submit path: admit, enqueue, and only then count the
        batch admitted — a REFUSED enqueue (:class:`BackpressureTimeout`, a
        sticky dispatcher raise) refunds the consumed tokens, so a producer
        that times out under pressure is not charged twice on its retry."""
        prio, rows = self._admit(stream_id, payload)
        try:
            self._submit_item(item, timeout)
        except BaseException:
            self._admission.refund(stream_id, rows, prio)
            raise
        self._stats.record_admission("admitted", prio)

    def _admit(self, stream_id: Optional[int], payload: Any) -> Tuple[int, int]:
        """Run one submit through the admission policy; returns ``(priority,
        rows)``. The ``admission`` fault site models a transient control-plane
        failure, retried here on the producer's thread without jitter (the
        seeded jitter stream belongs to the dispatcher); a rejection is
        counted by outcome and priority and raised to the producer."""
        pol = self._admission
        try:
            rows = int(infer_batch_size(tree_leaves(payload)) or 0)
        except Exception:  # noqa: BLE001 - a malformed batch surfaces through the step
            rows = 0
        inj = self._cfg.fault_injector
        tr = self._trace

        def admit_once() -> int:
            if inj is not None:
                try:
                    inj.check("admission")
                except BaseException:
                    self._stats.record_fault("admission")
                    if tr is not None:
                        tr.event("fault", trace=ENGINE_TRACE, site="admission")
                    raise
            return pol.admit(stream_id, rows)

        attempt = 0
        while True:
            try:
                return admit_once(), rows
            except AdmissionRejected as e:
                self._stats.record_admission("shed" if e.shed else "rejected", e.priority)
                if tr is not None:
                    tr.event("admission_rejected", trace=ENGINE_TRACE, priority=e.priority, shed=e.shed,
                             stream_id=stream_id)
                if e.shed and self._ladder is not None:
                    # liveness: when only the shed class still sends, no group
                    # forms and the dispatcher never ticks; a shed rejection
                    # ticks instead, so a recovered engine de-escalates
                    self._ladder_tick()
                raise
            except BaseException as e:  # noqa: BLE001 - classified by policy
                if not is_transient(e) or attempt >= self._cfg.max_retries:
                    raise
                attempt += 1
                self._stats.record_retry()
                if tr is not None:
                    tr.event("retry", trace=ENGINE_TRACE, attempt=attempt)
                delay = min(max(0.0, self._cfg.backoff_max_ms),
                            max(0.0, self._cfg.backoff_base_ms) * (2 ** (attempt - 1))) / 1e3
                if delay > 0:
                    time.sleep(delay)

    def _enqueue(self, item: Any, timeout: Optional[float]) -> None:
        if timeout is None:
            self._queue.put(item)
            return
        deadline = time.monotonic() + float(timeout)
        while True:
            # poll the sticky error each slice: a producer blocked on a full
            # queue must learn the dispatcher failed
            self._raise_if_failed()
            try:
                self._queue.put_nowait(item)  # timeout=0 still tries once
                return
            except queue.Full:
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._raise_if_failed()
                alive = self._worker is not None and self._worker.is_alive()
                raise BackpressureTimeout(
                    f"submit() timed out after {timeout}s: queue full "
                    f"({self._queue.qsize()}/{max(1, self._cfg.max_queue)} batches), "
                    f"{len(self._inflight)} device steps in flight, and the dispatcher is "
                    f"{'alive but not draining' if alive else 'not running'}"
                )
            try:
                self._queue.put(item, timeout=min(0.05, remaining))
                return
            except queue.Full:
                continue

    # --------------------------------------------------------------------- readers

    def flush(self) -> None:
        """Block until every submitted batch is folded into the state and the
        device has finished its steps; raises the sticky dispatcher error."""
        self._raise_if_failed()
        self._join_queue()
        with self._state_lock:
            self._sync()
        self._raise_if_failed()

    def result(self) -> Any:
        """The metric's value over everything submitted since the last reset.

        The compute runs as the JAX package's compiled compute program does:
        traced (``traced_rows``), so no value check reads the state on the
        host, and a compute that must read it (``R2Score``) raises. Under a
        window it is the window's value: the open pane of a tumbling ring,
        the fold of a sliding ring's live panes, the decayed accumulation."""
        tr = self._trace
        handle = tr.begin("result", trace=ENGINE_TRACE) if tr is not None else None
        self.flush()
        with self._device_section(), traced_rows():
            value = self._owned(self._metric.compute_from(self._logical_state()))
        if handle is not None:
            self._value_in_hand()
            tr.observe("result_latency_us", tr.end(handle))
        return value

    def _logical_state(self) -> Any:
        """The global LOGICAL state a result reads (inside
        :meth:`_device_section`): the deferred boundary merge on a deferred
        mesh, else the carried state unpacked, under a window its result
        view."""
        return self._window_tree(self._carried_logical())

    def _carried_logical(self) -> Any:
        """The global LOGICAL carried tree (inside :meth:`_device_section`),
        pane-stacked under a ring window: the deferred boundary merge on a
        deferred mesh (the world axis folded first, the panes kept), else the
        carried state unpacked."""
        return self._merged_state() if self._deferred else self._unpack(self._state)

    def _owned(self, value: Any) -> Any:
        """``value`` with every tensor that shares memory with the carried
        state cloned: a compute may return a state leaf itself (the confusion
        matrix does), and the engine's later steps write the state in place,
        so a value handed out must not be a view of it (the JAX package's
        values are immutable)."""
        held = tree_leaves(self._state) + (tree_leaves(self._merged_memo[1]) if self._merged_memo else [])
        live = {t.untyped_storage().data_ptr() for t in held}
        return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                        and x.untyped_storage().data_ptr() in live else x, value)

    def _value_in_hand(self) -> None:
        """Wait for the caller's stream: a traced read's latency is the
        value's, not its enqueue's."""
        if self._stream is not None:
            torch.cuda.current_stream(self._device).synchronize()

    def state(self) -> Any:
        """A copy of the accumulated LOGICAL state tree (arenas unpacked;
        pane-stacked, ``(panes, ...)``, under a ring window)."""
        self.flush()
        with self._device_section():
            return tree_map(torch.clone, self._merged_state() if self._deferred else self._unpack(self._state))

    def reset(self) -> None:
        """Fresh accumulation, written into the state's buffers in place;
        captured steps are kept. Also the recovery path after a dispatcher
        failure: the backlog is drained unfolded and the error cleared."""
        self._join_queue()
        with self._device_section():
            self._error = None
            self._sync()
            self._reset_locked()

    def _reset_locked(self) -> None:
        self._inflight.clear()
        self._result_cache.clear()
        self._write_state(self._put_state(self._init_state_tree()))
        self._state_version += 1
        self._step = 0
        self._batches_done = 0
        if self._window is not None:
            self._pane_cursor = 0
            self._rotations = 0
            self._last_rotate_batches = 0
            self._pane_open_cursor = 0
            self._last_rotate_time = self._win_clock()
            self._stats.pane_cursor = 0
            self._stats.live_panes = 1

    # ---------------------------------------------------------------------- recovery

    def snapshot(self) -> str:
        """Flush and write one crash-safe snapshot now; a failure raises."""
        if not self._cfg.snapshot_dir:
            raise MetricsTPUUserError("snapshot() requires config.snapshot_dir")
        self.flush()
        return self._save_snapshot()

    def _save_snapshot(self) -> str:
        with self._device_section():
            return self._save_snapshot_locked()

    def _save_snapshot_locked(self) -> str:
        # a write-site fault fires BEFORE any bytes land: LATEST still names
        # the previous complete generation
        tr = self._trace
        snap_handle = tr.begin("snapshot_write", trace=ENGINE_TRACE, step=self._step) if tr is not None else None
        self._fault("snapshot_write")
        host_state, meta = self._snapshot_doc()
        path = save_snapshot(self._cfg.snapshot_dir, host_state, meta, keep=self._cfg.snapshot_keep,
                             host_attrs=self._metric.host_compute_attrs())
        self._stats.snapshots += 1
        if snap_handle is not None:
            tr.end(snap_handle)
        inj = self._cfg.fault_injector
        if inj is not None and inj.fire("snapshot_corrupt"):
            # bit rot: the save SUCCEEDED (LATEST names it), then the payload
            # rots on disk, the case restore()'s generation fallback is for
            self._stats.record_fault("snapshot_corrupt")
            if tr is not None:
                tr.event("fault", site="snapshot_corrupt")
            corrupt_snapshot(path, inj.snapshot_rng())
        return path

    def _snapshot_doc(self) -> Tuple[Any, Dict[str, Any]]:
        """``(host_state, meta)``: the engine's durable form and its
        provenance, with the JAX package's meta keys: ``mesh_sync`` (the
        sync mode on a mesh, ``"single"`` without one) and ``world`` (the
        shard count of a deferred engine's shard-stacked state, else 1);
        one host. Shared by the snapshot writer and :meth:`reshard`'s
        in-memory capture."""
        host_state = self._snapshot_state()
        meta: Dict[str, Any] = {
            "step": self._step,
            "batches_done": self._batches_done,
            "rows_in": self._stats.rows_in,
            "rows_padded": self._stats.rows_padded,
            # a compressed snapshot stores the LOGICAL tree with codec-wrapped
            # leaves, never the raw arena
            "packed": int(self._layout is not None and not self._compress),
            "arena_fp": self._layout.fingerprint() if self._layout is not None else "",
            "mesh_sync": self._sync_tag() if self._mesh is not None else "single",
            "world": self._world if self._deferred else 1,
            # a fleet host's piece names which host of how many wrote it, and
            # the cut it belongs to; absent fields read back as one process
            "num_hosts": self._fleet_hosts,
            "process_id": self._fleet_pid,
        }
        if self._fleet_hosts > 1:
            meta["host_homing"] = "sid_mod_num_hosts"
        if self._fleet_cut is not None:
            meta["fleet_cut"] = int(self._fleet_cut)
            meta["fleet_plan_cursor"] = int(self._fleet_plan_cursor)
        if self._compress:
            meta["codec"] = CODEC_ID
            meta["codec_fp"] = self._precision_tag
        if self._window is not None:
            # the ring's provenance: the policy fingerprint is the cross-policy
            # refusal key; the cursor and marks let a restore resume mid-ring
            # without rotating the boundary again (pane_fill: the batches
            # folded into the open pane)
            meta["window"] = self._window.fingerprint()
            meta["panes"] = self._panes
            meta["pane_cursor"] = self._pane_cursor
            meta["rotations"] = self._rotations
            meta["pane_fill"] = self._batches_done - self._pane_open_cursor
        meta.update(self._snapshot_meta_extra())
        return host_state, meta

    def _snapshot_state(self) -> Any:
        """The host-side state a snapshot carries: the carried form itself
        (the packed arena, or the logical tree without one), or under
        ``compress_payloads`` the logical tree with the metric's
        quantized-policy leaves codec-wrapped (``engine/quantize.py``)."""
        if self._deferred:
            # every shard's LOCAL state, ``(W, ...)``: the merged view is
            # derivable from it, the locals are not from the merge
            stacked = self._stacked_carried()
            if not self._compress:
                return state_to_numpy(stacked)
            tree = self._layout.unpack_stacked(stacked, lead=self._shard_lead()) if self._layout is not None \
                else stacked
            return self._codec_call("quant_encode", encode_state_tree, self._metric, state_to_numpy(tree))
        if not self._compress:
            return state_to_numpy(self._state)
        return self._codec_call("quant_encode", encode_state_tree, self._metric,
                                state_to_numpy(self._unpack(self._state)))

    def _snapshot_meta_extra(self) -> Dict[str, Any]:
        """Provenance a subclass adds to every snapshot (the paged engine: its
        stream and residency topology)."""
        return {}

    def restore(self, directory_or_path: Optional[str] = None) -> Dict[str, Any]:
        """Resume from the newest complete snapshot (the engine must be idle).

        Returns the snapshot's meta; ``batches_done`` is the replay cursor:
        re-submit the stream from that batch on and the result is exactly the
        uninterrupted one. Host-derived compute attributes are restored too,
        so ``result()`` works at once. The state is written into the
        engine's buffers in place.

        Also the recovery path after a sticky dispatcher failure: the backlog
        is drained unfolded and the error cleared once the state is committed
        (a failed restore leaves the engine, error included, as it was). A
        corrupt newest payload falls back to the newest valid generation
        (counted in ``stats.snapshot_fallbacks``; the returned cursor is the
        older one), and a transient read failure is retried with backoff."""
        target = directory_or_path or self._cfg.snapshot_dir
        if not target:
            raise MetricsTPUUserError("restore() requires a snapshot path or config.snapshot_dir")
        self._join_queue()  # drain; a sticky-failed (or dead) dispatcher discards
        tr = self._trace
        restore_handle = tr.begin("snapshot_restore", trace=ENGINE_TRACE) if tr is not None else None

        def load_once() -> Tuple[Any, Dict[str, Any]]:
            self._fault("snapshot_read")
            return load_snapshot(target, fallback=True)

        state, meta = self._retry_transient(load_once)
        self._restore_commit(state, meta)
        if restore_handle is not None:
            tr.end(restore_handle, generations_skipped=int(meta.get("generations_skipped", 0) or 0),
                   cursor=self._batches_done)
        return meta

    def _check_window_provenance(self, meta: Dict[str, Any]) -> None:
        """The cross-policy refusal: a pane ring is replayable only under the
        policy that built it (its boundaries, depth and decay are what the
        buffers MEAN). A snapshot without window provenance is cumulative,
        so the refusal is symmetric. The JAX package's message."""
        snap_win = str(meta.get("window", "") or "")
        eng_win = self._window.fingerprint() if self._window is not None else ""
        if snap_win != eng_win:
            raise MetricsTPUUserError(
                f"snapshot window policy {snap_win or 'cumulative'!r} does not match this engine's "
                f"{eng_win or 'cumulative'!r}: pane rings are only replayable under the policy that built them — "
                "restore into an engine constructed with the same WindowPolicy"
            )

    def _check_host_topology(self, meta: Dict[str, Any]) -> None:
        """A fleet host's piece is PARTIAL state: it restores only into the
        same host of a same-size fleet (a snapshot without the fields is one
        process's). The JAX package's message."""
        snap_hosts = int(meta.get("num_hosts", 1) or 1)
        snap_pid = int(meta.get("process_id", 0) or 0)
        if snap_hosts != self._fleet_hosts or snap_pid != self._fleet_pid:
            raise MetricsTPUUserError(
                f"snapshot host topology (num_hosts={snap_hosts}, process_id={snap_pid}) does not match this "
                f"engine's (num_hosts={self._fleet_hosts}, process_id={self._fleet_pid}): a fleet host piece "
                "restores only into the SAME host of a same-size fleet — merge a whole fleet snapshot into a "
                "single-process engine with engine.fleet.restore_fleet_into(), or adopt a single-process "
                "snapshot into a fleet with FleetEngine.adopt_single()"
            )

    def _fits_template(self, tree: Any) -> bool:
        """Does a logical carried tree have this engine's structure and shapes
        (pane-stacked under a ring window)?"""
        want_leaves, want_def = tree_flatten(self._carried_abstract_tree())
        leaves, treedef = tree_flatten(tree)
        return treedef == want_def and all(
            tuple(getattr(leaf, "shape", ())) == tuple(w.shape) for leaf, w in zip(leaves, want_leaves))

    def _restore_commit(self, state: Any, meta: Dict[str, Any]) -> None:
        """Validate a loaded snapshot against this engine and commit it (the
        JAX package's restore matrix): a deferred snapshot into a deferred
        engine of the same world restores verbatim, each shard its local
        state; a deferred snapshot of another world merges its shard locals
        on the host (``merge_stacked_states``), refused when the merged
        shapes do not fit (``cat`` buffers grow with the shard count); a
        single-device or step-sync snapshot seats verbatim, or into a
        deferred engine embeds into shard 0 with the init state elsewhere.
        Everything is checked before anything is written."""
        self._check_window_provenance(meta)
        if str(meta.get("codec", "") or ""):
            # codec-wrapped leaves are self-describing: decode first
            state = self._codec_call("quant_decode", decode_state_tree, state)
        self._check_host_topology(meta)
        packed = bool(int(meta.get("packed", 0)))
        snap_deferred = str(meta.get("mesh_sync", "") or "") == "deferred"
        snap_world = int(meta.get("world", 1))
        state = tree_map(lambda x: _tensor_from_numpy(x) if isinstance(x, np.ndarray) else x, state)
        if packed:
            if self._layout is None:
                raise MetricsTPUUserError(
                    "snapshot holds a packed arena but this engine runs with use_arena=False; "
                    "enable the arena (or re-snapshot unpacked) to restore it"
                )
            # buffer shapes cannot tell permuted same-dtype leaves apart; the
            # layout fingerprint (the JAX package's form) can
            saved_fp = str(meta.get("arena_fp", "") or "")
            shape_ok = isinstance(state, dict) and self._layout.matches(
                state, world=snap_world if snap_deferred else None, panes=self._panes if self._win_stacked else None)
            if not shape_ok or (saved_fp and saved_fp != self._layout.fingerprint()):
                raise MetricsTPUUserError(
                    f"snapshot arena does not match this metric's layout ({self._layout!r}); was the metric "
                    "reconfigured since the snapshot?"
                )
        if snap_deferred and self._deferred and snap_world == self._world:
            # the same world: every shard resumes with exactly its local state
            stacked = state if packed or self._layout is None else \
                self._layout.pack_stacked(state, lead=self._shard_lead())
            if not packed and self._layout is None and not self._fits_template(tree_map(lambda x: x[0], state)):
                raise MetricsTPUUserError(
                    "snapshot state does not match this metric's state structure and shapes; was the metric "
                    "reconfigured since the snapshot?"
                )
            carried = self._put_stacked_carried(stacked)
        elif snap_deferred:
            # a deferred mesh snapshot holds each shard's LOCAL state: merge
            # them into the global state (exact for mergeable reductions;
            # refused when cat buffers grew with the shard count)
            stacked = self._layout.unpack_stacked(state, lead=2 if self._win_stacked else 1) if packed else state
            logical = self._metric.merge_stacked_states(stacked)
            if not self._fits_template(logical):
                raise MetricsTPUUserError(
                    f"deferred snapshot (world={snap_world}) merges to state shapes this engine cannot carry "
                    "(cat-state buffers scale with the shard count); restore it into a deferred engine with the "
                    "same mesh size"
                )
            carried = self._put_shards(self._shard0_trees(logical)) if self._deferred else self._put_state(logical)
        elif self._deferred:
            # a global state embeds into shard 0, the init state elsewhere
            logical = self._unpack(state) if packed else state
            if not self._fits_template(logical):
                raise MetricsTPUUserError(
                    "snapshot state does not match this metric's state structure and shapes; was the metric "
                    "reconfigured since the snapshot?"
                )
            carried = self._put_shards(self._shard0_trees(logical))
        elif packed:
            carried = {k: v.to(self._device) for k, v in state.items()}
        else:
            if not self._fits_template(state):
                raise MetricsTPUUserError(
                    "snapshot state does not match this metric's state structure and shapes; was the metric "
                    "reconfigured since the snapshot?"
                )
            carried = self._put_state(state)
        self._finish_restore(carried, meta)

    def _finish_restore(self, carried: Any, meta: Dict[str, Any]) -> None:
        """Commit a validated carried state and the replay cursor, in one
        critical section: the state is written into the engine's buffers in
        place (captured steps address them), after every in-flight step."""
        with self._device_section():
            attrs = meta.get("host_attrs")
            if attrs:
                self._metric.restore_host_compute_attrs(attrs)
                # host attrs are trace constants in every step key: re-derive
                # the fingerprint at the next lookup, forget memoized entries
                self._metric_fp = None
                self._program_memo.clear()
            # a pre-traffic snapshot restores attrs still None: the first
            # batch must latch them, as on a fresh engine
            self._needs_attr_latch = any(v is None for v in self._metric.host_compute_attrs().values())
            self._sync()
            self._write_state(carried)
            self._state_version += 1
            self._merged_memo = None
            self._inflight.clear()
            self._result_cache.clear()
            self._error = None
            self._step = int(meta.get("step", 0))
            self._batches_done = int(meta.get("batches_done", self._step))
            if self._window is not None:
                # resume mid-ring: the cursor and the rotation count restore
                # as written; the batch mark derives from the pane fill, so the
                # next rotation lands on the ORIGINAL boundary; the clock of a
                # time cadence starts afresh (wall time does not replay)
                self._pane_cursor = int(meta.get("pane_cursor", 0))
                self._rotations = int(meta.get("rotations", 0))
                self._pane_open_cursor = self._batches_done - int(meta.get("pane_fill", 0))
                self._last_rotate_batches = self._pane_open_cursor
                self._last_rotate_time = self._win_clock()
                self._stats.pane_cursor = self._pane_cursor
                self._stats.live_panes = min(self._rotations + 1, self._panes)
            self._stats.rows_in = int(meta.get("rows_in", self._stats.rows_in))
            self._stats.rows_padded = int(meta.get("rows_padded", self._stats.rows_padded))
            self._stats.resumes += 1
            if int(meta.get("generations_skipped", 0) or 0) > 0:
                self._stats.snapshot_fallbacks += 1

    # ------------------------------------------------------------ elastic reshard

    def reshard(self, *, world: Optional[int] = None, mesh: Optional[Mesh] = None,
                resident_streams: Optional[int] = None, stream_shard: Optional[bool] = None) -> Dict[str, Any]:
        """Live elastic resharding: grow or shrink the mesh world (or, on the
        stream-sharded engine, the stream-shard factor) without losing state.

        Snapshot through the restore matrix, in memory: drain, capture the
        engine's durable form with its topology (the document
        :meth:`snapshot` writes, behind the ``reshard_snapshot`` site), swap
        the topology (mesh, world, bucket divisor, shard devices, fresh
        buffers, step keys), and restore the capture through the
        cross-topology restore matrix (behind ``reshard_restore``): states
        that merge merge or embed exactly; ``cat`` and scan states refuse
        across worlds, and a refusal ROLLS BACK to the captured topology, so
        the engine serves on as it was. Stream-sharded engines re-home every
        stream under the new ``sid % world`` rule through the spill store.

        Pass ``world=`` (single-axis meshes: the same device repeated on a
        one-device mesh; across devices the built mesh's own first, see
        :meth:`_target_mesh`) or an explicit ``mesh=`` starting on the
        metric's device. Returns ``{"from_world", "to_world",
        "cursor"}``; the cursor is unchanged (everything submitted folded
        before the drain). Also the recovery behind the ``shard_loss`` site
        (``config.elastic_min_world``)."""
        self._join_queue()
        with self._device_section():
            return self._reshard_locked(world=world, mesh=mesh, resident_streams=resident_streams,
                                        stream_shard=stream_shard, auto=False)

    def _reshard_locked(self, *, world: Optional[int] = None, mesh: Optional[Mesh] = None,
                        resident_streams: Optional[int] = None, stream_shard: Optional[bool] = None,
                        auto: bool = False) -> Dict[str, Any]:
        if stream_shard is not None and bool(stream_shard) != bool(getattr(self, "_stream_shard", False)):
            raise MetricsTPUUserError(
                "toggling stream sharding live is not supported: snapshot this engine and restore into a "
                "newly-constructed one with the desired stream_shard setting"
            )
        if resident_streams is not None and not getattr(self, "_stream_shard", False):
            raise MetricsTPUUserError("resident_streams only applies to stream-sharded engines")
        if resident_streams is not None and int(resident_streams) <= 0:
            raise MetricsTPUUserError(f"resident_streams must be positive, got {resident_streams!r}")
        if self._mesh is None:
            raise MetricsTPUUserError(
                "reshard() needs a mesh engine (a single-device engine has no topology to change); construct with "
                "EngineConfig(mesh=...)"
            )
        new_mesh, new_world = self._target_mesh(world, mesh)
        # bucket divisibility validates BEFORE anything mutates
        try:
            new_policy = BucketPolicy(self._cfg.buckets, pad_value=self._cfg.pad_value, divisor=new_world)
        except ValueError as e:
            raise MetricsTPUUserError(
                f"reshard(world={new_world}) is incompatible with the declared buckets {self._cfg.buckets}: {e}"
            ) from e
        old_world = self._world
        self._sync()

        def capture() -> Tuple[Any, Dict[str, Any]]:
            self._fault("reshard_snapshot")
            return self._snapshot_doc()

        state, meta = self._retry_transient(capture)
        old_topo = self._topology_state()

        def commit() -> None:
            self._fault("reshard_restore")
            self._restore_commit(state, meta)

        try:
            self._apply_topology(new_mesh, new_world, new_policy, resident_streams)
            self._retry_transient(commit)
        except BaseException:
            # refusals (a target mesh off the metric's device, a cat state
            # across worlds) stay loud AND non-destructive: back to the
            # captured topology, the same document recommitted verbatim
            self._apply_topology_state(old_topo)
            self._restore_commit(state, meta)
            raise
        self._stats.record_reshard(old_world, new_world, self._batches_done, auto)
        if self._trace is not None:
            self._trace.event("reshard", trace=ENGINE_TRACE, from_world=old_world, to_world=new_world,
                              cursor=self._batches_done, auto=auto)
        return {"from_world": old_world, "to_world": new_world, "cursor": self._batches_done}

    def _target_mesh(self, world: Optional[int], mesh: Optional[Mesh]) -> Tuple[Mesh, int]:
        """The reshard target: an explicit mesh (carrying the engine's axes;
        its first device must be the metric's, checked by :meth:`_set_mesh`),
        or ``world`` shards on the engine's layout
        (:func:`_reshard_devices`)."""
        names = self._axis.names
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise MetricsTPUUserError(f"reshard(mesh=...) takes a Mesh, got {type(mesh).__name__}")
            missing = [a for a in names if a not in mesh.axis_names]
            if missing:
                raise MetricsTPUUserError(
                    f"target mesh lacks the engine's sync axes {missing} (mesh axes: {sorted(mesh.axis_names)})")
            return mesh, mesh.axis(self._cfg.axis).world
        if world is None:
            raise MetricsTPUUserError("reshard() needs world= or mesh=")
        w = int(world)
        if w <= 0:
            raise MetricsTPUUserError(f"world must be positive, got {world!r}")
        if len(names) != 1:
            raise MetricsTPUUserError(
                "reshard(world=...) supports single-axis meshes; pass an explicit mesh= for multi-axis topologies")
        arr = np.empty((w,), dtype=object)
        arr[:] = _reshard_devices(self._home_devices, w)
        return Mesh(arr, names), w

    def _topology_state(self) -> Dict[str, Any]:
        """Everything a reshard rollback puts back (the stream-sharded engine
        adds its pager and residency)."""
        return {"mesh": self._mesh, "policy": self._policy, "state": self._state, "shadow": self._shadow,
                "deltas": (self._deltas, self._delta_init)}

    def _apply_topology_state(self, t: Dict[str, Any]) -> None:
        self._set_mesh(t["mesh"])
        self._policy = t["policy"]
        self._state, self._shadow = t["state"], t["shadow"]
        self._deltas, self._delta_init = t["deltas"]
        self._invalidate_topology_memos()

    def _apply_topology(self, mesh: Mesh, world: int, policy: BucketPolicy,
                        resident_streams: Optional[int] = None) -> None:
        """Swap the live topology (state lock held), with fresh buffers of
        the new shape; :meth:`_restore_commit` right after moves the state
        across."""
        self._set_mesh(mesh)
        if threading.current_thread() is self._worker:  # the shard-loss reshard, on the dispatcher
            self._bind_streams()
        self._policy = policy
        self._shadow = None
        self._deltas = self._delta_init = None
        self._state = self._put_state(self._init_state_tree())
        self._invalidate_topology_memos()

    def _check_mesh_device(self, mesh: Mesh) -> None:
        """Shard 0 runs on the metric itself (its state, replicas' source and
        plan): a mesh must start on the metric's device."""
        first = _norm_device(mesh.axis(self._cfg.axis).devices[0])
        if first != self._device:
            raise MetricsTPUUserError(
                f"the mesh's first device ({first}) must be the metric's ({self._device}): shard 0 runs on the "
                "metric itself"
            )

    def _set_mesh(self, mesh: Mesh) -> None:
        self._check_mesh_device(mesh)
        self._cfg.mesh = mesh
        self._init_mesh()
        self._stats.mesh_transport = mesh.transport
        self._setup_shards()
        self._topology_epoch += 1  # the dispatcher re-binds its per-device streams

    def _invalidate_topology_memos(self) -> None:
        # every step key embeds the mesh; the merge and the payload
        # accounting embed the world: all of it rebuilds lazily
        self._program_memo.clear()
        self._carried_sig = None
        self._merged_memo = None
        self._payload_split = None
        self._state_version += 1

    def _shard_loss_target(self) -> Optional[int]:
        """The world a shard-loss reshard shrinks to: the largest
        bucket-compatible world strictly below the current one, never under
        ``config.elastic_min_world`` (0 disarms). None: go sticky."""
        lo = int(self._cfg.elastic_min_world)
        if lo <= 0 or self._mesh is None:
            return None
        for w in range(self._world - 1, lo - 1, -1):
            if all(b % w == 0 for b in self._cfg.buckets):
                return w
        return None

    # ----------------------------------------------------------------- fault plumbing

    def _fault(self, site: str) -> None:
        """Consult the injector at a fault site; a fired fault is counted and
        raised."""
        inj = self._cfg.fault_injector
        if inj is None:
            return
        try:
            inj.check(site)
        except Exception as e:
            self._stats.record_fault(site)
            if self._trace is not None:
                self._trace.event("fault", trace=self._group_tid or ENGINE_TRACE, site=site,
                                  occurrence=getattr(e, "occurrence", None))
            raise

    def _codec_call(self, site: str, fn: Any, *args: Any) -> Any:
        """``fn(*args)``, a codec call pure in its arguments (so a retry never
        applies scales twice), behind the fault ``site`` and the bounded
        retry."""
        def once() -> Any:
            self._fault(site)
            return fn(*args)

        return self._retry_transient(once)

    def _backoff(self, attempt: int) -> None:
        """Jittered exponential backoff before retry ``attempt`` (1-based),
        the jitter from a seeded stream."""
        base = max(0.0, self._cfg.backoff_base_ms) / 1e3
        cap = max(base, self._cfg.backoff_max_ms / 1e3)
        delay = min(cap, base * (2 ** (attempt - 1)))
        delay *= 0.5 + 0.5 * float(self._retry_rng.rand())
        if delay > 0:
            time.sleep(delay)

    def _retry_transient(self, fn: Any, transient: Any = is_transient) -> Any:
        """Run ``fn`` up to ``1 + max_retries`` times, retrying (counted,
        backed off) the failures ``transient`` accepts and re-raising every
        other: the one retry policy of every boundary but the step (whose
        :meth:`_recover_step` adds rollback and demotion)."""
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:
                if not transient(e) or attempt >= self._cfg.max_retries:
                    raise
                attempt += 1
                self._stats.record_retry()
                if self._trace is not None:
                    self._trace.event("retry", trace=self._group_tid or ENGINE_TRACE, attempt=attempt)
                self._backoff(attempt)

    # ------------------------------------------------------- degradation ladder

    def _ladder_signals(self) -> Dict[str, float]:
        """The overload detector's feed for one tick: p99 queue residency from
        the recorder's ``queue_wait_us`` histogram when one is attached, from
        the stats ring's last 128 records otherwise (refreshed once per
        :data:`_LADDER_P99_EVERY` ticks, memoized between); the spill rate
        (the pager's page-outs per step over the tick window); queue fill."""
        s = self._stats
        self._ladder_ticks += 1
        if self._ladder_p99 is None or self._ladder_ticks % self._LADDER_P99_EVERY == 1:
            p99: Optional[float] = None
            tr = self._trace
            if tr is not None:
                for h in tr.histograms():
                    if h.name == "queue_wait_us":
                        p99 = h.quantile(0.99)
                        break
            if p99 is None:
                waits = sorted(float(r.get("queue_wait_us", 0.0)) for r in s.recent()[-128:])
                p99 = _percentile(waits, 0.99) if waits else 0.0
            self._ladder_p99 = float(p99) if p99 == p99 else 0.0  # NaN-safe
        last_steps, last_outs = self._ladder_marks
        dsteps = s.steps - last_steps
        spill_rate = (s.page_outs - last_outs) / dsteps if dsteps > 0 else 0.0
        self._ladder_marks = (s.steps, s.page_outs)
        return {
            "queue_p99_us": self._ladder_p99,
            "spill_rate": float(spill_rate),
            "queue_depth_frac": self._queue.qsize() / max(1, self._cfg.max_queue),
        }

    def _ladder_tick(self) -> None:
        """One ladder evaluation: once per processed group on the dispatcher
        thread, plus on producer-side SHED rejections, so the whole tick
        serializes under the ladder lock. A transition engages or releases
        exactly one rung under the state lock and is a ``ladder`` trace
        event. A failure becomes the sticky error, never a dead dispatcher."""
        try:
            with self._ladder_lock:
                move = self._ladder.tick(self._ladder_signals())
                if move is None:
                    return
                frm, to = move
                with self._state_lock:
                    if to > frm:
                        self._engage_rung(self._ladder.rung(to))
                    else:
                        self._release_rung(self._ladder.rung(frm))
                self._stats.ladder_transitions += 1
                self._stats.ladder_level = to
            if self._trace is not None:
                self._trace.event("ladder", trace=ENGINE_TRACE, action="escalate" if to > frm else "deescalate",
                                  level=to, rung=self._ladder.rung(max(frm, to)))
        except Exception as e:  # noqa: BLE001 - surface, don't kill silently
            _attach_ctx(e, cursor=self._batches_done)
            self._error = e

    def _engage_rung(self, rung: str) -> None:
        """Apply one rung (state lock held). Rungs are idempotent and
        reversible; one that does not apply to this engine (``shed`` without
        an admission policy, ``quantize_sync`` without a mesh) is a recorded
        no-op: the transition still counts and is traced, so the ladder's
        walk is the same on every engine kind."""
        if rung == "widen_coalesce":
            self._ladder_saved_window = self._cfg.coalesce_window_ms
            self._cfg.coalesce_window_ms = max(self._cfg.coalesce_window_ms, self._ladder.widen_window_ms)
        elif rung == "quantize_sync":
            self._engage_quantize()
        elif rung == "defer_cold_reads":
            self._defer_cold_reads = True
        elif rung == "shed":
            if self._admission is not None:
                self._admission.shed_lowest(True)

    def _release_rung(self, rung: str) -> None:
        if rung == "widen_coalesce":
            self._cfg.coalesce_window_ms = self._ladder_saved_window
        elif rung == "quantize_sync":
            self._release_quantize()
        elif rung == "defer_cold_reads":
            self._defer_cold_reads = False
            self._result_cache.clear()
        elif rung == "shed":
            if self._admission is not None:
                self._admission.shed_lowest(False)

    def _engage_quantize(self) -> None:
        """The quantize rung, as the JAX package's: the blanket ``q8_block``
        sync policy for the eligible states (float sums; counts, ``cat`` and
        min/max stay exact) while engaged, on a mesh engine only (the policy
        governs its sync bundle), from an exact policy only (an operator's
        policy is never overridden) and not under ``compress_payloads``
        (the at-rest codec's identity is pinned at construction). The policy
        is part of the metric's fingerprint and every step key, so the
        identity refreshes."""
        m = self._metric
        if self._mesh is None or self._precision_tag != "exact" or self._compress:
            return
        m.set_sync_precision("q8_block")
        if m.sync_precision_tag() != "exact":
            self._ladder_quantized = True
            self._refresh_policy_identity()

    def _release_quantize(self) -> None:
        if self._ladder_quantized:
            self._metric.set_sync_precision("exact")
            self._ladder_quantized = False
            self._refresh_policy_identity()

    def _refresh_policy_identity(self) -> None:
        self._precision_tag = self._metric.sync_precision_tag()
        self._metric_fp = None
        self._program_memo.clear()
        self._payload_split = None
        self._merged_memo = None

    # ------------------------------------------------------------------ telemetry

    def _model_host_sections(self) -> Optional[List[Dict[str, Any]]]:
        """Telemetry snapshots of the attached embedded-model hosts
        (``engine.model_host = host`` or ``engine.model_hosts = [...]``, by
        plain attribute, as in JAX), or None."""
        hosts = getattr(self, "model_hosts", None)
        if not hosts:
            host = getattr(self, "model_host", None)
            hosts = [host] if host is not None else []
        return [h.telemetry() for h in hosts] or None

    def telemetry(self) -> Dict[str, Any]:
        """The telemetry document's summary (``EngineStats.summary`` with the
        capture cache's counters as ``compile_cache``), plus the recorder's
        ``trace`` block when one is attached and the attached model hosts'
        ``model_host`` sections."""
        doc = self._stats.summary(self._aot.stats())
        if self._trace is not None:
            doc["trace"] = self._trace.summary()
        hosts = self._model_host_sections()
        if hosts:
            doc["model_host"] = hosts
        return doc

    def export_telemetry(self, path: str) -> None:
        """Write the telemetry document (summary, the ring's recent steps, the
        recorder's block and the model hosts' sections) as JSON:
        ``tools/engine_report.py`` reads it."""
        extra: Dict[str, Any] = {}
        if self._trace is not None:
            extra["trace"] = self._trace.summary()
        hosts = self._model_host_sections()
        if hosts:
            extra["model_host"] = hosts
        self._stats.export(path, self._aot.stats(), extra=extra or None)

    def export_trace(self, path: str) -> str:
        """Write the flight recorder's Chrome/Perfetto trace-event JSON to
        ``path`` (load it at https://ui.perfetto.dev). Requires
        ``EngineConfig(trace=TraceRecorder(...))``."""
        if self._trace is None:
            raise MetricsTPUUserError(
                "export_trace() requires a flight recorder: construct the engine with "
                "EngineConfig(trace=TraceRecorder(...))"
            )
        return self._trace.export(path)

    def metrics_text(self) -> str:
        """An OpenMetrics/Prometheus text snapshot of this engine, in the JAX
        package's families: lifetime counters (steps, rows, faults by site,
        recovery actions, quarantine, snapshots, the capture cache), the
        admission and ladder families when they ran, the paging families of
        a paged engine, the rotation, decay and drift families of a windowed
        one, the ragged families of a ragged engine, and — with a recorder —
        the fixed-bucket latency
        histograms, folded through ``histogram_accumulate``."""
        s = self._stats
        counters = {
            "steps": s.steps,
            "batches_submitted": s.batches_submitted,
            "batches_coalesced": s.batches_coalesced,
            "megasteps": s.megasteps,
            "rows_in": s.rows_in,
            "rows_padded": s.rows_padded,
            "snapshots": s.snapshots,
            "resumes": s.resumes,
            "merges": s.merges,
            "retries": s.retries,
            "rollbacks": s.rollbacks,
            "kernel_demotions": s.kernel_demotions,
            "coalesce_degraded": s.coalesce_degraded,
            "coalesce_shrinks": s.coalesce_shrinks,
            "watchdog_timeouts": s.watchdog_timeouts,
            "quarantined_batches": s.quarantined_batches,
            "quarantined_rows": s.quarantined_rows,
            "snapshot_failures": s.snapshot_failures,
            "snapshot_fallbacks": s.snapshot_fallbacks,
        }
        aot = self._aot.stats()
        counters["compile_cache_hits"] = aot["hits"]
        counters["compile_cache_misses"] = aot["misses"]
        labeled: Dict[str, Any] = {}
        faults = s.faults_by_site()
        if faults:
            labeled["faults_injected"] = ("site", faults)
        fallbacks = s.kernel_fallbacks_by_reason()
        if fallbacks:
            labeled["kernel_fallbacks"] = ("reason", fallbacks)
        if s.sync_payload_exact_bytes or s.sync_payload_quant_bytes:
            # mesh engines only: the bytes one shard contributed per fused sync, by rider
            labeled["sync_payload_bytes"] = ("kind", {"exact": s.sync_payload_exact_bytes,
                                                      "quantized": s.sync_payload_quant_bytes})
        gauges = {"compiled_programs": aot["programs"]}
        admission = s.admission_summary()
        if admission is not None:
            for fam, key in (("admission_admitted", "admitted_by_priority"),
                             ("admission_rejected", "rejected_by_priority"),
                             ("admission_shed", "shed_by_priority")):
                if admission[key]:
                    labeled[fam] = ("priority", admission[key])
            counters["ladder_transitions"] = admission["ladder_transitions"]
            counters["deferred_reads"] = admission["deferred_reads"]
            gauges["ladder_level"] = admission["ladder_level"]
        if s.reshards:
            counters["reshards"] = s.reshards
        if s.paging_summary() is not None:
            counters.update(routed_steps=s.routed_steps, page_hits=s.page_hits, page_faults=s.page_faults,
                            page_ins=s.page_ins, page_outs=s.page_outs)
            gauges["resident_streams"] = s.resident_streams
            gauges["spilled_streams"] = s.spilled_streams
            gauges["spilled_bytes"] = s.spilled_bytes
        if s.windows_summary() is not None:
            # rotation, decay and drift families join only for windowed
            # engines: a cumulative engine's exposition stays as it was
            counters["pane_rotations"] = s.pane_rotations
            counters["ewma_decays"] = s.ewma_decays
            counters["drift_evals"] = s.drift_evals
            counters["drift_alarms"] = s.drift_alarms
            gauges["live_panes"] = s.live_panes
            gauges["pane_cursor"] = s.pane_cursor
        ragged = s.ragged_summary()
        if ragged is not None:
            # group-keyed ingestion and the aggregate's reads join only for
            # ragged engines: every stream engine's exposition stays as it was
            for key in ("batches", "rows", "groups_touched", "overflows", "agg_device_reads", "agg_oracle_reads",
                        "agg_blocks"):
                counters[f"ragged_{key}"] = ragged[key]
            gauges["ragged_groups"] = ragged["groups"]
            gauges["ragged_capacity"] = ragged["capacity"]
        hists = self._trace.histograms() if self._trace is not None else ()
        return render_openmetrics(counters, hists, labeled_counters=labeled or None, gauges=gauges)

    @property
    def window(self) -> Optional[WindowPolicy]:
        """The active (rotating) window policy; None for cumulative serving."""
        return self._window

    @property
    def pane_cursor(self) -> int:
        """The ring's current pane (always 0 for ewma and cumulative)."""
        return self._pane_cursor

    @property
    def rotations(self) -> int:
        """Pane rotations since construction, reset or the restored base."""
        return self._rotations

    @property
    def drift(self) -> Optional[DriftDetector]:
        """The wired drift detector (None when drift tracking is off)."""
        return self._drift

    @property
    def trace(self) -> Optional[TraceRecorder]:
        """The flight recorder this engine reports to (None: off)."""
        return self._trace

    @property
    def steps(self) -> int:
        return self._step

    @property
    def stats(self) -> EngineStats:
        return self._stats

    @property
    def arena_layout(self) -> Optional[ArenaLayout]:
        return self._layout

    @property
    def aot_cache(self) -> AotCache:
        return self._aot
