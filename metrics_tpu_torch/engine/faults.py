"""Fault layer for the streaming engine: deterministic injection, input
screening, and the typed error model.

Port of ``metrics_tpu/engine/faults.py``, whole. It supplies the pieces the
engine's recovery paths stand on:

* :class:`FaultInjector` — a SEEDED, occurrence-deterministic chaos harness.
  Whether the Nth call at a site fires depends only on the seed and N (each
  site draws from its own ``np.random.RandomState``, seeded through
  ``hashlib`` exactly as the JAX package seeds it), so for the same seed and
  plan the two packages fire at the same occurrences. The port's engines
  consult it where the JAX package's do (``engine/pipeline.py``,
  ``engine/multistream.py``) and refuse a plan naming a site of a layer the
  port does not have yet (``EngineConfig``).
* :class:`ScreenPolicy` — pre-dispatch input screening with a
  QUARANTINE/dead-letter action (the ``nan_strategy`` vocabulary of
  ``aggregation.py`` plus ``"quarantine"``), which the engines apply on the
  host before anything is uploaded (``EngineConfig.screen``).
* The typed error model: :class:`InjectedFault`, :class:`EngineDispatchError`
  (the sticky dispatcher failure, carrying the failing batch's cursor, bucket
  and stream ids), :class:`SnapshotCorruptError` (a truncated or bit-flipped
  payload, naming path and generation), :class:`StepTimeoutError`,
  :class:`BackpressureTimeout` (``submit(timeout=)``) and
  :class:`BoundaryMergeError`.

Dependency-free within the engine package (no imports from ``pipeline`` or
``snapshot``): it imports numpy and the standard library only (screening
reads the port's tree and batch-leaf rules when it runs), so every engine
module can import it.
"""
import hashlib
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "BackpressureTimeout",
    "BoundaryMergeError",
    "EngineDispatchError",
    "FAULT_SITES",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "QuarantineRecord",
    "ScreenPolicy",
    "SnapshotCorruptError",
    "StepTimeoutError",
    "corrupt_snapshot",
    "is_transient",
    "wait_with_timeout",
]

# Every injection boundary of the JAX package's engine, kept whole so a plan
# (and the per-site seeding) means the same in both packages; the port's
# engines refuse a plan naming a site of a layer they do not have yet
# (admission, shard loss, merges, reshards, windows, the fleet).
FAULT_SITES = (
    "admission",        # admission-control check on the submit path
    "ingest",           # dispatcher picked up a group, nothing folded yet
    "coalesce",         # megabatch drain — degrades to singleton groups
    "compile",          # AOT program build
    "step",             # device step completed, host commit pending
    "kernel",           # kernel backend failure -> kernel demotion
    "shard_loss",       # a mesh shard dies mid-step -> elastic reshard
    "watchdog",         # per-step watchdog expiry (simulated stuck device)
    "merge",            # deferred-sync boundary merge
    "page_out",         # stream-paging spill: arena row -> host RAM
    "page_in",          # stream-paging fault-in: host RAM/init -> arena row
    "quant_encode",     # q8 state-at-rest encode (snapshot payload / spill row)
    "quant_decode",     # q8 state-at-rest decode (restore / fault-in / read)
    "reshard_snapshot", # live reshard: in-memory topology snapshot capture
    "reshard_restore",  # live reshard: restore into the target topology
    "pane_rotate",      # window pane rotation: plan phase, before any commit
    "drift_eval",       # closing-pane drift evaluation (pure read, retried)
    "host_loss",        # a fleet host dies at a boundary: transient
                        # = suspected loss, retried; sticky = FleetHostLostError
    "fleet_barrier",    # fleet snapshot-cut barrier entry (pure, pre-collective)
    "snapshot_write",   # snapshot save fails before any bytes are durable
    "snapshot_corrupt", # snapshot saved, then payload bytes rot on disk
    "snapshot_read",    # transient restore-time read failure
    "dispatcher_kill",  # dispatcher thread dies outright (fatal)
)

_SCREEN_ACTIONS = ("error", "warn", "ignore", "quarantine")


# ----------------------------------------------------------------- error model


class InjectedFault(RuntimeError):
    """A fault fired by :class:`FaultInjector`.

    ``transient`` marks it retryable (the engine's bounded-backoff retry
    loop); ``fatal`` kills the dispatcher thread outright (the
    ``dispatcher_kill`` site — models a hard host/runtime death rather than
    a per-step error).
    """

    def __init__(self, site: str, occurrence: int, transient: bool = True, fatal: bool = False):
        self.site = site
        self.occurrence = occurrence
        self.transient = transient
        self.fatal = fatal
        super().__init__(
            f"injected fault at site {site!r} (occurrence {occurrence}, "
            f"{'transient' if transient else 'sticky'}{', fatal' if fatal else ''})"
        )


class EngineDispatchError(RuntimeError):
    """The sticky dispatcher failure, surfaced to producers/readers.

    Chains the original exception (``raise ... from cause``) and carries the
    failure context the dispatcher recorded — ``cursor`` (the replay cursor
    of the failing batch: operators re-submit or inspect exactly that batch),
    ``step``, ``bucket``, and ``stream_ids`` for multi-stream engines.
    """

    def __init__(self, message: str, context: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.context = dict(context or {})
        self.cursor = self.context.get("cursor")
        self.bucket = self.context.get("bucket")
        self.stream_ids = self.context.get("stream_ids")


class SnapshotCorruptError(RuntimeError):
    """A snapshot payload failed integrity verification or deserialization.

    Names the snapshot ``path`` and its ``generation`` (the step-stamped
    directory name) so operators know exactly which generation rotted;
    ``load_snapshot(..., fallback=True)`` walks past it to the newest valid
    generation.
    """

    def __init__(self, path: str, generation: str, reason: str):
        self.path = path
        self.generation = generation
        self.reason = reason
        super().__init__(
            f"snapshot payload corrupt: generation {generation!r} at {path} ({reason})"
        )


class StepTimeoutError(RuntimeError):
    """Per-step watchdog expiry: the device step did not complete within
    ``EngineConfig.step_timeout_s`` — a stuck pipeline, not a poison batch.
    Transient for the retry loop (rollback + re-dispatch); sticky once the
    retry budget is exhausted."""


class BackpressureTimeout(TimeoutError):
    """``submit(timeout=...)`` gave up: the bounded queue stayed full for the
    whole window. Raised only when no sticky dispatcher error exists (that
    error is surfaced instead — a dead dispatcher behind a full queue must
    never read as mere backpressure)."""


class BoundaryMergeError(RuntimeError):
    """A deferred-sync boundary merge failed (chained). The carried
    shard-local state is untouched — the merge is a non-donated read — so
    ``result()`` keeps serving the last consistent state on the next call."""


# -------------------------------------------------------------- fault injector


@dataclass
class FaultSpec:
    """Per-site firing plan.

    ``schedule`` fires at exactly those occurrence indices (0-based count of
    ``check``/``fire`` calls at the site); ``rate`` fires each remaining
    occurrence with the given probability drawn from the site's own seeded
    stream. Both are deterministic in (seed, site, occurrence index).
    """

    schedule: Tuple[int, ...] = ()
    rate: float = 0.0
    transient: bool = True
    fatal: bool = False
    max_fires: Optional[int] = None  # None = unbounded


class FaultInjector:
    """Deterministic, seeded fault injection across the engine's boundaries.

    Usage::

        inj = FaultInjector(seed=7, plan={
            "step": FaultSpec(schedule=(2,)),        # 3rd step attempt fails
            "compile": FaultSpec(rate=0.25),          # 25% of builds fail
            "snapshot_corrupt": FaultSpec(schedule=(1,)),
        })
        EngineConfig(fault_injector=inj, ...)

    Determinism contract: whether the Nth call at a site fires depends only
    on (seed, site, N). Counters are thread-safe; per-site RNG streams are
    independent (site-hashed seeds), so adding calls at one site never shifts
    another site's firing pattern.
    """

    def __init__(self, seed: int = 0, plan: Optional[Dict[str, FaultSpec]] = None):
        self.seed = int(seed)
        self.plan: Dict[str, FaultSpec] = dict(plan or {})
        for site in self.plan:
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; expected one of {FAULT_SITES}"
                )
        self._lock = threading.Lock()
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}
        self._rngs: Dict[str, np.random.RandomState] = {}

    def _rng(self, site: str) -> np.random.RandomState:
        rng = self._rngs.get(site)
        if rng is None:
            digest = hashlib.sha256(f"{self.seed}:{site}".encode()).digest()
            rng = self._rngs[site] = np.random.RandomState(
                int.from_bytes(digest[:4], "little")
            )
        return rng

    def has_site(self, site: str) -> bool:
        """Whether the plan can ever fire at ``site`` (the engine uses this to
        arm site-specific machinery, e.g. the watchdog, deterministically)."""
        spec = self.plan.get(site)
        return spec is not None and (bool(spec.schedule) or spec.rate > 0.0)

    def fire(self, site: str) -> bool:
        """Count one occurrence at ``site``; True when the plan says it fails."""
        with self._lock:
            spec = self.plan.get(site)
            n = self.calls.get(site, 0)
            self.calls[site] = n + 1
            if spec is None:
                return False
            if spec.max_fires is not None and self.fired.get(site, 0) >= spec.max_fires:
                return False
            hit = n in spec.schedule
            if not hit and spec.rate > 0.0:
                # one draw per occurrence keeps the (seed, site, N) contract
                hit = bool(self._rng(site).rand() < spec.rate)
            elif spec.rate > 0.0:
                self._rng(site).rand()  # burn the draw: schedules must not shift the stream
            if hit:
                self.fired[site] = self.fired.get(site, 0) + 1
            return hit

    def check(self, site: str, **context: Any) -> None:
        """Raise :class:`InjectedFault` (or :class:`StepTimeoutError` for the
        watchdog site) when the plan fires at this occurrence."""
        if not self.fire(site):
            return
        spec = self.plan[site]
        occurrence = self.calls[site] - 1
        if site == "watchdog":
            raise StepTimeoutError(
                f"injected watchdog expiry (occurrence {occurrence}): device step "
                "did not complete within the configured step_timeout_s"
            )
        raise InjectedFault(site, occurrence=occurrence, transient=spec.transient, fatal=spec.fatal)

    def snapshot_rng(self) -> np.random.RandomState:
        """The seeded stream snapshot corruption draws from (byte offsets)."""
        return self._rng("snapshot_corrupt")

    def summary(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"calls": dict(self.calls), "fired": dict(self.fired)}


# ------------------------------------------------------------- classification


def is_transient(exc: BaseException) -> bool:
    """Is this failure worth a bounded retry (vs sticky)?

    Transient: injected faults marked so, watchdog expiries, and runtime
    errors whose status text names a transient status (``RESOURCE_EXHAUSTED``,
    ``UNAVAILABLE``, ``DEADLINE_EXCEEDED``, ``ABORTED``).
    Everything else — shape mismatches, trace errors, user errors — is a
    deterministic property of the input and retrying it would only repeat
    the failure.
    """
    if isinstance(exc, InjectedFault):
        return exc.transient
    if isinstance(exc, StepTimeoutError):
        return True
    msg = str(exc)
    return any(
        code in msg
        for code in ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED")
    )


def wait_with_timeout(fn: Callable[[], Any], timeout_s: float) -> Any:
    """Run blocking ``fn`` under a watchdog; raise :class:`StepTimeoutError`
    after ``timeout_s``. The underlying call cannot be cancelled (a hung
    device op keeps its buffers) — the waiter thread is abandoned as a
    daemon and the caller rolls back to its pre-step shadow instead.

    Cost model: one short-lived thread per invocation, abandoned on expiry.
    The port's engines do not route their watchdog through here: they poll
    the step's CUDA event until the deadline (``StreamingEngine._watch``),
    the same contract without a thread."""
    done = threading.Event()
    box: Dict[str, Any] = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - relayed to the caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, name="metrics-tpu-torch-watchdog-wait", daemon=True)
    t.start()
    if not done.wait(timeout_s):
        raise StepTimeoutError(
            f"device step did not complete within the {timeout_s:.3f}s watchdog"
        )
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _host_array(leaf: Any) -> np.ndarray:
    """A payload leaf as host numpy: a tensor is copied off its device (a
    bf16 one widened to f32, which numpy holds exactly)."""
    if hasattr(leaf, "detach"):
        t = leaf.detach().cpu()
        return (t.float() if str(t.dtype) == "torch.bfloat16" else t).numpy()
    return np.asarray(leaf)


# ----------------------------------------------------------- input screening


@dataclass
class ScreenPolicy:
    """Pre-dispatch batch screening policy.

    Action vocabulary per check — the ``nan_strategy`` set from
    ``aggregation.py`` (``"error"``, ``"warn"``, ``"ignore"``) extended with
    ``"quarantine"`` (reject into the engine's dead-letter ledger; the
    stream keeps serving and the replay cursor still advances past the
    batch, so kill/resume replay re-screens it identically):

    * ``non_finite`` — NaN/Inf anywhere in a floating batch argument.
      (A float *fill* belongs to the aggregator's own ``nan_strategy``; the
      engine screens whole batches, it does not rewrite rows.)
    * ``id_range=(lo, hi)`` — integer batch-carried leaves (labels/ids) must
      lie in ``[lo, hi]`` inclusive; action ``id_range_action``.
    * ``uniform_batch`` — every array argument must be batch-carried (leading
      dim == the batch size). Opt-in shape screening for metrics whose update
      takes only batch arrays: catches the ragged preds-vs-target mismatch
      BEFORE it becomes a trace error; action ``uniform_batch_action``.
    """

    non_finite: str = "quarantine"
    id_range: Optional[Tuple[int, int]] = None
    id_range_action: str = "quarantine"
    uniform_batch: bool = False
    uniform_batch_action: str = "quarantine"

    def __post_init__(self):
        for name in ("non_finite", "id_range_action", "uniform_batch_action"):
            v = getattr(self, name)
            if v not in _SCREEN_ACTIONS:
                raise ValueError(
                    f"ScreenPolicy.{name} must be one of {_SCREEN_ACTIONS}, got {v!r}"
                )

    def screen(self, payload: Any, n_rows: int) -> Optional[Tuple[str, str]]:
        """Screen one host-side ``(args, kwargs)`` payload of ``n_rows``.

        Returns ``(action, reason)`` for a rejection, or None to accept.
        ``"warn"`` warns and accepts; ``"ignore"`` skips the check entirely.
        Runs on the dispatcher thread against host numpy BEFORE any upload —
        one O(rows) pass per enabled check.
        """
        from metrics_tpu_torch.utils.data import is_batch_leaf
        from metrics_tpu_torch.utils.tree import tree_leaves

        for leaf in tree_leaves(payload):
            arr = leaf if isinstance(leaf, np.ndarray) else None
            if arr is None:
                shape = getattr(leaf, "shape", None)
                if shape is None:
                    continue
                arr = _host_array(leaf)
            if self.non_finite != "ignore" and arr.dtype.kind == "f" and arr.size:
                if not bool(np.isfinite(arr).all()):
                    verdict = self._verdict(
                        self.non_finite,
                        f"non-finite values in float argument (shape {arr.shape})",
                    )
                    if verdict is not None:
                        return verdict
            if (
                self.id_range is not None
                and self.id_range_action != "ignore"
                and arr.dtype.kind in "iu"
                and arr.size
                and is_batch_leaf(arr, n_rows)
            ):
                lo, hi = self.id_range
                mn, mx = int(arr.min()), int(arr.max())
                if mn < lo or mx > hi:
                    verdict = self._verdict(
                        self.id_range_action,
                        f"id/label out of range [{lo}, {hi}]: observed [{mn}, {mx}]",
                    )
                    if verdict is not None:
                        return verdict
            if (
                self.uniform_batch
                and self.uniform_batch_action != "ignore"
                and arr.ndim >= 1
                and not is_batch_leaf(arr, n_rows)
            ):
                verdict = self._verdict(
                    self.uniform_batch_action,
                    f"argument shape {arr.shape} is not batch-carried "
                    f"(expected leading dim {n_rows})",
                )
                if verdict is not None:
                    return verdict
        return None

    @staticmethod
    def _verdict(action: str, reason: str) -> Optional[Tuple[str, str]]:
        if action == "warn":
            warnings.warn(f"screened batch accepted with warning: {reason}", stacklevel=3)
            return None
        return (action, reason)


@dataclass
class QuarantineRecord:
    """One dead-lettered batch: enough for an operator to find and replay it.

    ``cursor`` is the batch's replay-cursor index (its position in the
    submitted stream — the same coordinate ``restore()`` meta uses), so the
    rejected input can be located in the upstream log exactly."""

    cursor: int
    rows: int
    reason: str
    stream_id: Optional[int] = None
    payload: Optional[Any] = None  # host payload, retained up to the ledger cap
    wall_time: float = field(default_factory=time.time)


# -------------------------------------------------------- snapshot corruption


def corrupt_snapshot(path: str, rng: np.random.RandomState, flips: int = 8) -> int:
    """Flip ``flips`` bytes of a snapshot payload in place (chaos harness for
    the restore fallback). ``path`` is a snapshot file or orbax directory;
    the largest payload file is targeted (deterministic choice), byte
    offsets come from the seeded ``rng``. Returns the number of bytes
    flipped (0 when nothing writable was found)."""
    import os

    target = path
    if os.path.isdir(path):
        best, best_size = None, -1
        for root, _, files in sorted(os.walk(path)):
            for name in sorted(files):
                full = os.path.join(root, name)
                size = os.path.getsize(full)
                if size > best_size:
                    best, best_size = full, size
        if best is None:
            return 0
        target = best
    size = os.path.getsize(target)
    if size == 0:
        return 0
    flipped = 0
    with open(target, "r+b") as f:
        for _ in range(int(flips)):
            off = int(rng.randint(0, size))
            f.seek(off)
            b = f.read(1)
            if not b:
                continue
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
            flipped += 1
    return flipped
