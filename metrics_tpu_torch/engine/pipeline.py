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

Tracing, admission control, windows, meshes and XLA's
``compilation_cache_dir`` are not ported (ROADMAP §A): their ``EngineConfig``
fields, and an injector plan naming one of their fault sites, raise
:class:`~metrics_tpu_torch.utils.exceptions.NotPortedError`.
"""
import queue
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

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
from metrics_tpu_torch.metric import StateSpec
from metrics_tpu_torch.utils.checks import traced_rows
from metrics_tpu_torch.utils.data import _aux_leaves_equal, infer_batch_size, is_batch_leaf
from metrics_tpu_torch.utils.exceptions import KernelBackendError, MetricsTPUUserError, NotPortedError
from metrics_tpu_torch.utils.state_bridge import _tensor_from_numpy, state_to_numpy
from metrics_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["EngineConfig", "EngineStats", "StreamingEngine"]

#: ``metrics_tpu.engine.EngineConfig`` fields the port does not have yet
_NOT_PORTED_FIELDS = (
    "compilation_cache_dir", "mesh", "axis", "mesh_sync", "donate", "telemetry_capacity", "trace", "admission",
    "ladder", "elastic_min_world", "window", "drift",
)
#: the fault sites the port's engines consult (``engine/faults.py`` FAULT_SITES lists the JAX package's all)
_PORTED_FAULT_SITES = (
    "ingest", "coalesce", "compile", "step", "kernel", "watchdog", "page_out", "page_in", "quant_encode",
    "quant_decode", "snapshot_write", "snapshot_corrupt", "snapshot_read", "dispatcher_kill",
)
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
            sites and ``dispatcher_kill``); a plan naming a site of a layer
            the port does not have yet raises :class:`NotPortedError`.
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
        **fields: Any,
    ) -> None:
        unported = sorted(k for k in fields if k in _NOT_PORTED_FIELDS)
        if unported:
            raise NotPortedError(f"EngineConfig fields {unported} are not ported yet (see ROADMAP.md §A)")
        if fields:
            raise TypeError(f"EngineConfig got unexpected fields {sorted(fields)}")
        if isinstance(fault_injector, FaultInjector):  # anything else is refused by the engine
            sites = sorted(site for site in fault_injector.plan if site not in _PORTED_FAULT_SITES)
            if sites:
                raise NotPortedError(
                    f"fault injector plan names sites {sites}, which the port's engines do not consult yet "
                    f"(they consult {list(_PORTED_FAULT_SITES)}; see ROADMAP.md §A)"
                )
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
                f"degrade_kernel={self.degrade_kernel})")


class EngineStats:
    """Counters of one engine: steps, coalesced megasteps, valid and padded
    rows, capture warm-ups, kernel fallback verdicts, the pager's page
    traffic (paged multi-stream engine), and recovery: snapshots written and
    failed, restores and their generation fallbacks, injected faults by site,
    retries, pre-step rollbacks, ``megastep -> auto`` kernel demotions,
    coalesce degradations and shrinks, watchdog expiries and quarantined
    batches and rows (the JAX package's names)."""

    def __init__(self) -> None:
        # fault and retry counts are bumped from the dispatcher and from
        # callers' threads (snapshot(), restore())
        self._counter_lock = threading.Lock()
        self.steps = 0
        self.batches_submitted = 0
        self.batches_coalesced = 0  # submitted batches folded into a shared step
        self.megasteps = 0  # steps that carried > 1 submitted batch
        self.warmup_steps = 0  # steps run once on a copy of the state before a capture
        self.rows_in = 0
        self.rows_padded = 0
        self.routed_steps = 0
        # device computations of MultiStreamEngine.result()/results(): one per
        # results() call, whatever the number of streams
        self.result_device_calls = 0
        self.page_hits = 0
        self.page_faults = 0
        self.page_ins = 0
        self.page_outs = 0
        self.q8_staged_rows = 0  # page-ins seated as int8 codes for K7 to decode
        self.kernel_fallbacks: Dict[str, int] = {}
        self.snapshots = 0
        self.snapshot_failures = 0  # periodic snapshots that failed (contained, never sticky)
        self.snapshot_fallbacks = 0  # restores that walked past a corrupt generation
        self.resumes = 0
        self.retries = 0
        self.rollbacks = 0
        self.kernel_demotions = 0
        self.coalesce_degraded = 0  # groups served as singletons after a coalesce fault
        self.coalesce_shrinks = 0  # failed megabatches re-run batch by batch
        self.watchdog_timeouts = 0
        self.quarantined_batches = 0
        self.quarantined_rows = 0
        self.faults_injected: Dict[str, int] = {}

    def record_fault(self, site: str) -> None:
        """One injected fault fired at ``site``."""
        with self._counter_lock:
            self.faults_injected[site] = self.faults_injected.get(site, 0) + 1

    def faults_by_site(self) -> Dict[str, int]:
        with self._counter_lock:
            return dict(self.faults_injected)

    def record_retry(self) -> None:
        """One bounded-retry attempt."""
        with self._counter_lock:
            self.retries += 1

    def record_step(self, bucket: int, valid: int, coalesced: int = 1) -> None:
        self.steps += 1
        self.rows_in += int(valid)
        self.rows_padded += int(bucket)
        if coalesced > 1:
            self.megasteps += 1
            self.batches_coalesced += int(coalesced)

    def record_kernel_fallback(self, reason: str) -> None:
        self.kernel_fallbacks[reason] = self.kernel_fallbacks.get(reason, 0) + 1

    def kernel_fallbacks_by_reason(self) -> Dict[str, int]:
        """Per-reason counts: ``engine:<reason>`` when the engine cannot take
        the megastep path at all, ``dtype.<key>:<why>`` per degraded dtype."""
        return dict(self.kernel_fallbacks)


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
    """

    def __init__(self, metric: Any, config: Optional[EngineConfig] = None, aot_cache: Optional[AotCache] = None):
        self._metric = metric
        self._cfg = config if config is not None else EngineConfig()
        reason = self._update_path_unsupported_reason(metric)
        if reason is not None:
            raise MetricsTPUUserError(f"metric cannot be served by the streaming engine: {reason}")
        self._device = _metric_device(metric)
        if self._cfg.max_retries < 0:
            raise MetricsTPUUserError(f"max_retries must be >= 0, got {self._cfg.max_retries}")
        if self._cfg.step_timeout_s < 0:
            raise MetricsTPUUserError(f"step_timeout_s must be >= 0, got {self._cfg.step_timeout_s}")
        if self._cfg.screen is not None and not isinstance(self._cfg.screen, ScreenPolicy):
            raise MetricsTPUUserError(f"config.screen must be a ScreenPolicy, got {type(self._cfg.screen).__name__}")
        inj = self._cfg.fault_injector
        if inj is not None and not isinstance(inj, FaultInjector):
            raise MetricsTPUUserError(f"config.fault_injector must be a FaultInjector, got {type(inj).__name__}")
        if self._cfg.snapshot_every > 0 and not self._cfg.snapshot_dir:
            raise MetricsTPUUserError("snapshot_every > 0 requires snapshot_dir")
        self._policy = BucketPolicy(self._cfg.buckets, pad_value=self._cfg.pad_value)
        self._stats = EngineStats()
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
        self._state = self._put_state(self._init_state_tree())
        # -- the dispatcher and its captured steps
        self._aot = aot_cache if aot_cache is not None else AotCache()
        cuda = self._device.type == "cuda"
        #: every copy, replay and page-in of this engine runs on this stream
        self._stream: Optional[torch.cuda.Stream] = torch.cuda.Stream(self._device) if cuda else None
        # the production step on the card is the captured one; the eager step
        # stays reachable here only to compare the two (bit-equality, timing)
        self._capture = cuda
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, self._cfg.max_queue))
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._state_lock = threading.RLock()
        self._submit_lock = threading.Lock()
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
        # watchdog (whose expiry recovery needs the shadow), always on the
        # CPU, where JAX's shadow is a free reference and the port's one host
        # copy a step
        self._transactional = (
            bool(self._cfg.transactional) if self._cfg.transactional is not None
            else (not cuda) or inj is not None or self._cfg.step_timeout_s > 0
        )
        #: the pre-step copy a failed step rolls back from, allocated at the first step
        self._shadow: Any = None
        # dead-letter ledger of screened-out batches: newest records kept
        self._quarantine: Deque[QuarantineRecord] = deque(maxlen=max(1, int(self._cfg.quarantine_capacity)))
        # the watchdog arms when configured, or when the plan can fire its site
        self._watchdog_enabled = self._cfg.step_timeout_s > 0 or (inj is not None and inj.has_site("watchdog"))

    # -------------------------------------------------------------- capability checks

    def _update_path_unsupported_reason(self, metric: Any) -> Optional[str]:
        return metric.masked_update_unsupported_reason()

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
        return self._kind_init_state_tree()

    def _pack(self, tree: Any) -> Any:
        return tree if self._layout is None else self._layout.pack(tree)

    def _unpack(self, carried: Any) -> Any:
        return carried if self._layout is None else self._layout.unpack(carried)

    def _put_state(self, tree: Any) -> Any:
        """The carried form of a logical state tree, on the engine's device."""
        return self._pack(tree_map(lambda x: torch.as_tensor(x).to(self._device), tree))

    def _write_state(self, carried: Any) -> None:
        """Copy a carried state into the engine's buffers, in place: the
        buffers are never rebound, so captured steps and the pager's
        page-ins keep addressing them."""
        for dst, src in zip(tree_leaves(self._state), tree_leaves(carried)):
            if dst is not src:
                dst.copy_(src)

    @contextmanager
    def _device_section(self) -> Iterator[None]:
        """Hold the state lock for a read or write of the carried state on the
        caller's thread: the caller's stream first waits for the engine
        stream's work, and the engine stream's later work waits for the
        caller's."""
        with self._state_lock:
            if self._stream is None:
                yield
                return
            caller = torch.cuda.current_stream(self._device)
            caller.wait_stream(self._stream)
            try:
                yield
            finally:
                self._stream.wait_stream(caller)

    # -------------------------------------------------------------------- the step

    def _traced_update(self, state_tree: Any, payload: Any, mask: torch.Tensor) -> Any:
        """The step body on the LOGICAL state tree (the multi-stream engine
        reroutes it to the segmented update)."""
        a, kw = payload
        return self._metric.update_state_masked(state_tree, *a, mask=mask, **kw)

    def _step_aux(self) -> Any:
        """The engine's per-step extras besides the carried state (the paged
        engine's q8 staging); None here."""
        return None

    def _step_state(self, state: Any, aux: Any, a: Tuple[Any, ...], kw: Dict[str, Any], mask: torch.Tensor) -> Any:
        """One padded step on the carried state; returns the new carried
        state and writes none of its inputs (it is what a graph captures)."""
        if self._megastep_plan is not None:
            return self._megastep_plan.apply_masked(state, a, kw, mask)
        return self._pack(self._traced_update(self._unpack(state), (a, kw), mask))

    def _kernel_tag(self) -> str:
        return "megastep" if self._megastep_plan is not None else "auto"

    def _update_kind(self) -> str:
        return "update"

    def _graph_keepalive(self) -> Tuple[Any, ...]:
        """What a captured step reads without owning it: the metric (its
        config tensors) and the megastep plan (its op rows)."""
        return (self._metric, self._megastep_plan)

    def _program(self, leaves: List[Any], kinds: List[Optional[str]], treedef: Any, start: int, stop: int,
                 bucket: int) -> Tuple[Any, Optional[PinnedRing]]:
        """The cache entry of this step's signature and the engine's pinned
        ring for it (None without host leaves). A miss on the card captures
        the step from this chunk."""
        abstract = tree_unflatten(treedef, [
            leaf if kind is None else StateSpec(padded_shape(leaf, kind, bucket), torch_dtype(leaf.dtype))
            for leaf, kind in zip(leaves, kinds)])
        host = tuple(kind is not None and not on_card(leaf) for leaf, kind in zip(leaves, kinds))
        memo_key = (AotCache.signature_of(abstract), bucket, host)
        hit = self._program_memo.get(memo_key)
        if hit is not None:
            self._aot.count_hit()
            return hit
        if self._metric_fp is None:
            self._metric_fp = metric_fingerprint(self._metric)
        if self._carried_sig is None:
            self._carried_sig = AotCache.signature_of((self._state, self._step_aux()))
        key = self._aot.program_key(
            f"{self._update_kind()}+k.{self._kernel_tag()}", self._metric_fp,
            arg_tree=(self._carried_sig, abstract, tuple(kinds), StateSpec((bucket,), torch.bool)),
            layout=self._layout, backend=self._kernel_tag(), device=self._device,
            precision=self._precision_tag,
        )
        if not self._capture:
            entry, ring = self._aot.get_or_capture(key, lambda: EAGER), None
        else:
            specs = {i: (padded_shape(leaf, kind, bucket), torch_dtype(leaf.dtype))
                     for i, (leaf, kind, on_host) in enumerate(zip(leaves, kinds, host)) if on_host}
            ring = PinnedRing(specs, self._cfg.in_flight + 1) if specs else None

            def build() -> CapturedStep:
                inputs = StepBuffers(leaves, kinds, treedef, bucket, self._device)
                prog = CapturedStep(self._state, self._step_aux(), inputs, self._graph_keepalive())
                inputs.fill(leaves, start, stop, self._cfg.pad_value, ring, self._stream)
                prog.load(self._state, self._step_aux())  # the warm-up runs on this copy, never the live state
                self._aot.capture(prog, self._step_state, self._device)
                self._stats.warmup_steps += 1
                return prog

            entry = self._aot.get_or_capture(key, build)
        self._program_memo[memo_key] = (entry, ring)
        return entry, ring

    def _padded_tensors(self, leaves: List[Any], kinds: List[Optional[str]], treedef: Any, start: int, stop: int,
                        bucket: int) -> Tuple[Tuple[Any, ...], Dict[str, Any], torch.Tensor]:
        """The uncaptured step's padded chunk, as fresh tensors on the device."""
        out = pad_leaves(leaves, kinds, start, stop, bucket, self._cfg.pad_value)
        out = [leaf if kind is None else torch.as_tensor(np.array(leaf) if isinstance(leaf, np.ndarray) else leaf)
               .to(self._device) for leaf, kind in zip(out, kinds)]
        a, kw = tree_unflatten(treedef, out)
        mask = torch.arange(bucket, device=self._device) < (stop - start)
        return a, kw, mask

    def _run_padded_step(self, leaves: List[Any], kinds: List[Optional[str]], treedef: Any, start: int, stop: int,
                         bucket: int, coalesced: int) -> None:
        """One padded step, transactionally: rows ``[start, stop)`` of the ROWS
        leaves padded to ``bucket``, the other leaves as they are. The shadow
        takes the pre-step state; a failed attempt rolls back onto it and
        :meth:`_recover_step` retries it, demotes the kernels or lets it go
        sticky with the step and bucket attached."""
        attempt = 0
        while True:
            shadow = self._step_shadow()
            try:
                self._do_step(leaves, kinds, treedef, start, stop, bucket)
                break
            except Exception as e:
                if not self._recover_step(e, shadow, attempt):
                    _attach_ctx(e, step=self._step, bucket=bucket)
                    raise
                attempt += 1
        self._step += 1
        self._stats.record_step(bucket, stop - start, coalesced)
        if not self._watchdog_enabled:  # a watched step was drained before its commit
            self._bound_inflight()

    def _do_step(self, leaves: List[Any], kinds: List[Optional[str]], treedef: Any, start: int, stop: int,
                 bucket: int) -> None:
        """One attempt of a step. Its fault sites fire in the JAX package's
        order: ``compile``, ``kernel`` (while on the megastep kernels), the
        step itself, then ``step`` (the device work is enqueued and, on the
        card, has written the state in place: the rollback's case) and
        ``watchdog``. On the card it replays the step's captured graph
        (capturing it on a miss); elsewhere it runs eagerly and the new state
        is written only at the commit."""
        self._fault("compile")
        if self._kernel_tag() == "megastep":
            # a runtime failure of the whole-arena kernels: meaningless once
            # the engine is on the per-leaf ones
            self._fault("kernel")
        new = None
        if self._capture:
            prog, ring = self._program(leaves, kinds, treedef, start, stop, bucket)
            with self._aot.exclusive(self._stream):
                prog.inputs.fill(leaves, start, stop, self._cfg.pad_value, ring, self._stream)
                prog.replay(self._state, self._step_aux())
        else:
            if self._stream is None:
                self._program(leaves, kinds, treedef, start, stop, bucket)
            a, kw, mask = self._padded_tensors(leaves, kinds, treedef, start, stop, bucket)
            new = self._step_state(self._state, self._step_aux(), a, kw, mask)
        self._fault("step")
        if self._watchdog_enabled:
            self._fault("watchdog")
            self._watch()
        if new is not None:
            self._write_state(new)

    def _watch(self) -> None:
        """The watchdog's wait: poll the step's CUDA event until it completes
        or ``step_timeout_s`` passes (no waiter thread; the hung work keeps
        running on the engine stream, and the rollback is ordered after it).
        Without a timeout it drains the step. On the CPU the step has run."""
        if self._stream is None:
            return
        ev = torch.cuda.Event()
        ev.record(self._stream)
        timeout = self._cfg.step_timeout_s
        if timeout > 0:
            deadline = time.monotonic() + timeout
            while not ev.query():
                if time.monotonic() >= deadline:
                    raise StepTimeoutError(f"device step did not complete within the {timeout:.3f}s watchdog")
                time.sleep(_WATCH_POLL_S)
        else:
            ev.synchronize()
        self._inflight.clear()

    def _step_shadow(self) -> Any:
        """The pre-step state a failed step rolls back onto, or None when the
        engine is not transactional (a failure then goes sticky). The shadow
        is allocated once and refreshed in place before every step, on the
        engine's stream."""
        if not self._transactional:
            return None
        if self._shadow is None:
            self._shadow = tree_map(torch.empty_like, self._state)
        for dst, src in zip(tree_leaves(self._shadow), tree_leaves(self._state)):
            dst.copy_(src)
        return self._shadow

    def _recover_step(self, e: Exception, shadow: Any, attempt: int) -> bool:
        """Roll a failed step back and classify it: True retries it (after
        backoff) or, for an injected ``kernel`` fault, demotes the engine to
        the per-leaf kernels and retries at once; False lets it go sticky."""
        if shadow is None:
            return False
        try:
            # in place, on the engine stream: after whatever the failed or hung
            # attempt enqueued, so no late write lands on the rolled-back state
            for dst, src in zip(tree_leaves(self._state), tree_leaves(shadow)):
                dst.copy_(src)
        except RuntimeError:  # a broken device: the original error goes sticky
            return False
        self._stats.rollbacks += 1
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
            return True
        if not is_transient(e) or attempt >= self._cfg.max_retries:
            return False
        self._stats.record_retry()
        self._backoff(attempt + 1)
        return True

    def _bound_inflight(self) -> None:
        """At most ``in_flight`` steps run ahead of the host: past that, wait
        for the oldest."""
        if self._stream is None:
            return
        ev = torch.cuda.Event()
        ev.record(self._stream)
        self._inflight.append(ev)
        if len(self._inflight) > max(1, self._cfg.in_flight):
            self._inflight.popleft().synchronize()

    def _execute_payload(self, merged: Tuple[Tuple[Any, ...], Dict[str, Any]], n: int, coalesced: int) -> None:
        """Run one merged (args, kwargs) batch of ``n`` rows through its
        bucketed chunks; the first chunk's step counts the coalesced batches.
        An escaping error carries ``_committed_chunks`` (summed over nested
        calls), which tells the caller whether re-running the batches one by
        one would fold a row twice."""
        leaves, treedef = tree_flatten(merged)
        committed = 0
        try:
            for i, (start, stop, bucket) in enumerate(self._policy.chunks(n)):
                kinds = classify_leaves(leaves, n, bucket, self._policy.divisor)
                self._run_padded_step(leaves, kinds, treedef, start, stop, bucket, coalesced if i == 0 else 1)
                committed += 1
        except Exception as e:
            _add_committed(e, committed)
            raise

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
            if self._stream is not None:  # what the caller's stream made (the state) comes first
                self._stream.wait_stream(torch.cuda.current_stream(self._device))
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
            if self._stream is not None:
                torch.cuda.set_device(self._stream.device)
                torch.cuda.set_stream(self._stream)  # thread-local: every launch of this thread goes there
            torch.set_grad_enabled(False)
        except Exception as e:  # noqa: BLE001 - no batch may be dropped unreported
            self._error = e
        pending: Optional[Any] = None
        while True:
            if pending is not None:
                first, pending = pending, None
            else:
                first = self._queue.get()
            if first is _STOP:
                self._queue.task_done()
                return
            group, saw_stop, fatal = [first], False, False
            if self._error is None:
                group, pending, saw_stop = self._coalesce_group(first)
            try:
                if self._error is None:  # after a failure: drain without work
                    self._process_group(group)
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

    def _process_group(self, group: List[Any]) -> None:
        with self._state_lock:
            # only an INGEST fault retries at this level: it fires before
            # anything folds, so the whole group re-runs from untouched state
            self._retry_transient(lambda: self._process_group_locked(group), transient=_ingest_transient)

    def _process_group_locked(self, group: List[Any]) -> None:
        # a FATAL fault here models the dispatcher dying outright
        self._fault("dispatcher_kill")
        self._fault("ingest")  # the host ingestion boundary: nothing folded yet
        sized = [(it, self._item_rows(it)) for it in group]
        kept = self._screen_group(sized)
        nonempty = [(it, n) for it, n in kept if n > 0]
        merged = self._merge_sized(nonempty)
        if merged is not None:
            if self._needs_attr_latch:
                self._latch_host_attrs(merged)
            try:
                self._execute_payload(merged, sum(n for _, n in nonempty), len(nonempty))
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
                        self._execute_payload(self._merge_sized([(it, n_it)]), n_it, 1)
                    except Exception as se:
                        _attach_ctx(se, cursor=cursors.get(id(it)), **self._item_context(it))
                        raise
        self._batches_done += len(group)
        if self._cfg.snapshot_every > 0 and self._batches_done % self._cfg.snapshot_every == 0:
            self._sync()  # the copy to the host reads the state after every in-flight step folded
            try:
                self._save_snapshot()
            except Exception:  # noqa: BLE001 - counted, never sticky
                # a failed PERIODIC snapshot must not take serving down:
                # the state is intact and the previous generation still
                # backs restore()
                self._stats.snapshot_failures += 1

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
                self._queue.get_nowait()
            except queue.Empty:
                break
            self._queue.task_done()
        with self._queue.all_tasks_done:
            if self._queue.unfinished_tasks:
                self._queue.unfinished_tasks = 0
                self._queue.all_tasks_done.notify_all()

    def _sync(self) -> None:
        """Wait for every step enqueued on the engine stream."""
        if self._stream is not None:
            self._stream.synchronize()
        self._inflight.clear()

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

    def _coalesce_group(self, first: Any) -> Tuple[List[Any], Optional[Any], bool]:
        """Drain further compatible queued batches behind ``first``. Returns
        ``(group, pending_incompatible_item, saw_stop)``. Bounded by
        ``coalesce`` batches and by the top bucket's row count (a fuller
        megabatch would just re-chunk); waits up to ``coalesce_window_ms`` for
        more traffic once the queue runs dry. A group never crosses the next
        snapshot boundary (the cadence stays batch-exact)."""
        limit = max(1, self._cfg.coalesce)
        if self._cfg.snapshot_every > 0:
            limit = min(limit, self._cfg.snapshot_every - (self._batches_done % self._cfg.snapshot_every))
        group = [first]
        if limit <= 1:
            return group, None, False
        inj = self._cfg.fault_injector
        if inj is not None and inj.fire("coalesce"):
            # degradation, never an error (an escape would kill the
            # dispatcher): the group is served as singletons
            self._stats.record_fault("coalesce")
            self._stats.coalesce_degraded += 1
            return group, None, False
        rows = self._item_rows_safe(first)
        if rows is None:  # malformed: run alone so the error surfaces cleanly
            return group, None, False
        top = self._policy.buckets[-1]
        deadline = time.perf_counter() + self._cfg.coalesce_window_ms / 1e3
        ref = first if rows else None
        while len(group) < limit and rows < top:
            try:
                timeout = deadline - time.perf_counter()
                item = self._queue.get(timeout=timeout) if timeout > 0 else self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                return group, None, True
            n = self._item_rows_safe(item)
            if n is None:
                return group, item, False
            if n == 0:
                group.append(item)  # cursor-only; nothing to concatenate
                continue
            if ref is not None and not self._coalescible(ref, item):
                return group, item, False
            if ref is None:
                ref = item
            group.append(item)
            rows += n
        return group, None, False

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
        self._raise_if_failed()
        self.start()
        self._order_inputs(item)
        self._enqueue(item, timeout)
        with self._submit_lock:
            self._stats.batches_submitted += 1

    def submit(self, *args: Any, timeout: Optional[float] = None, **kwargs: Any) -> None:
        """Enqueue one (ragged) batch: tensors or numpy arrays. Blocks while
        the queue is full; ``timeout`` (seconds) bounds the wait, after which
        the sticky dispatcher error is raised if there is one, else
        :class:`BackpressureTimeout`. A batch of zero rows only advances the
        cursor."""
        self._submit_item((args, kwargs), timeout)

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
        host, and a compute that must read it (``R2Score``) raises."""
        self.flush()
        with self._device_section(), traced_rows():
            return self._metric.compute_from(self._unpack(self._state))

    def state(self) -> Any:
        """A copy of the accumulated LOGICAL state tree (arenas unpacked)."""
        self.flush()
        with self._device_section():
            return tree_map(torch.clone, self._unpack(self._state))

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
        self._write_state(self._put_state(self._init_state_tree()))
        self._step = 0
        self._batches_done = 0

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
        self._fault("snapshot_write")
        host_state, meta = self._snapshot_doc()
        path = save_snapshot(self._cfg.snapshot_dir, host_state, meta, keep=self._cfg.snapshot_keep,
                             host_attrs=self._metric.host_compute_attrs())
        self._stats.snapshots += 1
        inj = self._cfg.fault_injector
        if inj is not None and inj.fire("snapshot_corrupt"):
            # bit rot: the save SUCCEEDED (LATEST names it), then the payload
            # rots on disk, the case restore()'s generation fallback is for
            self._stats.record_fault("snapshot_corrupt")
            corrupt_snapshot(path, inj.snapshot_rng())
        return path

    def _snapshot_doc(self) -> Tuple[Any, Dict[str, Any]]:
        """``(host_state, meta)``: the engine's durable form and its
        provenance, with the JAX package's meta keys (a single-device,
        single-host engine: ``mesh_sync="single"``, world 1)."""
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
            "mesh_sync": "single",
            "world": 1,
            "num_hosts": 1,
            "process_id": 0,
        }
        if self._compress:
            meta["codec"] = CODEC_ID
            meta["codec_fp"] = self._precision_tag
        meta.update(self._snapshot_meta_extra())
        return host_state, meta

    def _snapshot_state(self) -> Any:
        """The host-side state a snapshot carries: the carried form itself
        (the packed arena, or the logical tree without one), or under
        ``compress_payloads`` the logical tree with the metric's
        quantized-policy leaves codec-wrapped (``engine/quantize.py``)."""
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

        def load_once() -> Tuple[Any, Dict[str, Any]]:
            self._fault("snapshot_read")
            return load_snapshot(target, fallback=True)

        state, meta = self._retry_transient(load_once)
        self._restore_commit(state, meta)
        return meta

    def _check_window_provenance(self, meta: Dict[str, Any]) -> None:
        """The port's engines are cumulative: a snapshot with window
        provenance (a pane ring) is refused, with the JAX package's message."""
        snap_win = str(meta.get("window", "") or "")
        if snap_win:
            raise MetricsTPUUserError(
                f"snapshot window policy {snap_win!r} does not match this engine's 'cumulative': pane rings are "
                "only replayable under the policy that built them — restore into an engine constructed with the "
                "same WindowPolicy"
            )

    def _fits_template(self, tree: Any) -> bool:
        """Does a logical state tree have this engine's structure and shapes?"""
        want_leaves, want_def = tree_flatten(self._kind_abstract_state_tree())
        leaves, treedef = tree_flatten(tree)
        return treedef == want_def and all(
            tuple(getattr(leaf, "shape", ())) == tuple(w.shape) for leaf, w in zip(leaves, want_leaves))

    def _restore_commit(self, state: Any, meta: Dict[str, Any]) -> None:
        """Validate a loaded snapshot against this engine and commit it (the
        restore matrix of a single-device engine): a single-device or
        step-sync snapshot seats verbatim; a deferred-sync mesh snapshot's
        shard-stacked locals merge on the host (``merge_stacked_states``).
        Everything is checked before anything is written."""
        self._check_window_provenance(meta)
        if str(meta.get("codec", "") or ""):
            # codec-wrapped leaves are self-describing: decode first
            state = self._codec_call("quant_decode", decode_state_tree, state)
        snap_hosts = int(meta.get("num_hosts", 1) or 1)
        snap_pid = int(meta.get("process_id", 0) or 0)
        if snap_hosts != 1 or snap_pid != 0:
            raise MetricsTPUUserError(
                f"snapshot host topology (num_hosts={snap_hosts}, process_id={snap_pid}) does not match this "
                "engine's (num_hosts=1, process_id=0): a fleet host piece restores only into the SAME host of a "
                "same-size fleet — merge a whole fleet snapshot into a single-process engine with "
                "engine.fleet.restore_fleet_into(), or adopt a single-process snapshot into a fleet with "
                "FleetEngine.adopt_single()"
            )
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
                state, world=snap_world if snap_deferred else None)
            if not shape_ok or (saved_fp and saved_fp != self._layout.fingerprint()):
                raise MetricsTPUUserError(
                    f"snapshot arena does not match this metric's layout ({self._layout!r}); was the metric "
                    "reconfigured since the snapshot?"
                )
        if snap_deferred:
            # a deferred mesh snapshot holds each shard's LOCAL state: merge
            # them into the global state (exact for mergeable reductions;
            # refused when cat buffers grew with the shard count)
            stacked = self._layout.unpack_stacked(state) if packed else state
            logical = self._metric.merge_stacked_states(stacked)
            if not self._fits_template(logical):
                raise MetricsTPUUserError(
                    f"deferred snapshot (world={snap_world}) merges to state shapes this engine cannot carry "
                    "(cat-state buffers scale with the shard count); restore it into a deferred engine with the "
                    "same mesh size"
                )
            carried = self._put_state(logical)
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
            self._error = None
            self._step = int(meta.get("step", 0))
            self._batches_done = int(meta.get("batches_done", self._step))
            self._stats.rows_in = int(meta.get("rows_in", self._stats.rows_in))
            self._stats.rows_padded = int(meta.get("rows_padded", self._stats.rows_padded))
            self._stats.resumes += 1
            if int(meta.get("generations_skipped", 0) or 0) > 0:
                self._stats.snapshot_fallbacks += 1

    # ----------------------------------------------------------------- fault plumbing

    def _fault(self, site: str) -> None:
        """Consult the injector at a fault site; a fired fault is counted and
        raised."""
        inj = self._cfg.fault_injector
        if inj is None:
            return
        try:
            inj.check(site)
        except Exception:
            self._stats.record_fault(site)
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
                self._backoff(attempt)

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
