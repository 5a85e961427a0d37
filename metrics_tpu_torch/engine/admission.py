"""SLO-aware admission control and the graceful-degradation ladder.

Port of ``metrics_tpu/engine/admission.py``, whole (it is pure Python).
Overload is the failure mode the fault layer (``engine/faults.py``) cannot
model: nothing is broken, there is simply more traffic than the engine can
fold, and an engine without admission control turns that into unbounded
queue growth and tail-latency collapse. The engines
(``engine/pipeline.py``, ``engine/multistream.py``) wire in three pieces:

* :class:`AdmissionPolicy` — per-stream token buckets with priority classes.
  Every ``submit`` either consumes ``rows`` tokens from the stream's bucket or
  raises the typed :class:`AdmissionRejected` carrying ``retry_after_s`` (the
  bucket's own refill arithmetic). A rejection is a REFUSED batch, never a
  folded-then-discarded one, so the replay cursor and exactness are
  untouched. The SHED switch (:meth:`AdmissionPolicy.shed_lowest`) rejects
  the lowest priority class outright — the ladder's last rung.
* :class:`OverloadDetector` — the sustained-overload test, fed by the
  engine: p99 queue residency (the flight recorder's ``queue_wait_us``
  histogram when one is attached, the stats ring otherwise), the pager spill
  rate, and queue fill. Value hysteresis: overload asserts when ANY armed
  high watermark is crossed, and clears only when EVERY signal is back under
  its (lower) clear watermark.
* :class:`DegradationLadder` — the deterministic, hysteresis-guarded policy
  that walks a fixed rung sequence under sustained overload (widen
  ``coalesce_window_ms`` → force ``sync_precision`` quantization → defer
  cold-stream ``result()`` reads → shed the lowest priority class) and walks
  back down when the detector clears. ``tick()`` is a PURE function of the
  detector verdict sequence — no wall time, no randomness — so a scripted
  signal sequence replays to the identical transition list, and every
  engine-side transition is a ``ladder`` trace event.

Zero cost when disabled: no ``AdmissionPolicy`` and no ``DegradationLadder``
on the config means the submit path and the dispatcher pay one ``is not
None`` check per site and never enter this module.
"""
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "AdmissionPolicy",
    "AdmissionRejected",
    "DegradationLadder",
    "LADDER_RUNGS",
    "OverloadDetector",
    "TokenBucket",
]

# The full rung sequence, in escalation order. A ladder may run any ordered
# subset — rungs it omits are simply never engaged.
LADDER_RUNGS = ("widen_coalesce", "quantize_sync", "defer_cold_reads", "shed")


class AdmissionRejected(RuntimeError):
    """A submit refused by the admission policy (typed, producer-facing).

    ``retry_after_s`` is the bucket's own estimate of when ``rows`` tokens
    will exist again (``float("inf")`` for a SHED stream — its class is
    rejected outright until the ladder de-escalates, so there is no useful
    backoff). ``shed`` distinguishes the two: a rate rejection is transient
    backpressure, a shed rejection is the engine deliberately dropping the
    lowest priority class to protect the rest.
    """

    def __init__(
        self,
        reason: str,
        retry_after_s: float,
        stream_id: Optional[int] = None,
        priority: int = 0,
        shed: bool = False,
    ):
        self.retry_after_s = float(retry_after_s)
        self.stream_id = stream_id
        self.priority = int(priority)
        self.shed = bool(shed)
        where = "engine" if stream_id is None else f"stream {stream_id}"
        hint = (
            "shed until the degradation ladder de-escalates"
            if shed
            else f"retry_after_s={self.retry_after_s:.4f}"
        )
        super().__init__(
            f"admission rejected for {where} (priority {self.priority}): {reason} ({hint})"
        )


class TokenBucket:
    """One stream's token bucket: ``capacity`` tokens, refilled at ``rate``
    tokens/second of the policy's clock. NOT thread-safe on its own — the
    owning :class:`AdmissionPolicy` serializes access under one lock."""

    __slots__ = ("capacity", "rate", "tokens", "stamp")

    def __init__(self, capacity: float, rate: float, now: float):
        self.capacity = float(capacity)
        self.rate = float(rate)
        self.tokens = float(capacity)
        self.stamp = float(now)

    def take(self, n: float, now: float) -> float:
        """Consume ``n`` tokens; returns 0.0 on success, else the seconds
        until ``n`` tokens will exist (nothing consumed)."""
        if now > self.stamp:
            self.tokens = min(self.capacity, self.tokens + (now - self.stamp) * self.rate)
        self.stamp = max(self.stamp, now)
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        if n > self.capacity or self.rate <= 0:
            # the bucket can NEVER hold n tokens: honest inf, not a backoff
            return float("inf")
        return (n - self.tokens) / self.rate


class AdmissionPolicy:
    """Per-stream token buckets with priority classes + the shed switch.

    Args:
        rows_per_s: refill rate of each stream's bucket, in rows/second
            (scaled per priority class by ``class_rates``).
        burst_rows: bucket capacity — the largest burst one stream may land
            instantly. Size it >= the biggest single batch a producer
            submits: a batch larger than the capacity can never be admitted
            and is refused with ``retry_after_s=inf`` (the bucket can never
            hold that many tokens — an honest "resize your batches" signal,
            not a backoff hint).
        priorities: ``{stream_id: priority_class}`` (0 = highest). Streams
            not named get ``default_priority``. The base (single-stream)
            engine admits under ``stream_id=None``, one bucket, class
            ``default_priority``.
        default_priority: class for unnamed streams.
        class_rates: per-class multiplier on ``rows_per_s`` (absent = 1.0) —
            how a priority class buys more or less sustained throughput.
        clock: the time source (seconds, monotonic). Defaults to
            ``time.monotonic``; tests and deterministic harnesses inject a
            logical clock.

    Thread-safe: producers submit concurrently, and the admitted/rejected/
    shed counters must not lose increments (a plain ``+= 1`` is a
    read-modify-write the GIL does not make atomic) — every bucket op and
    counter bump happens under one lock.
    """

    def __init__(
        self,
        rows_per_s: float = 1e9,
        burst_rows: float = 1e9,
        priorities: Optional[Dict[int, int]] = None,
        default_priority: int = 1,
        class_rates: Optional[Dict[int, float]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if rows_per_s <= 0 or burst_rows <= 0:
            raise ValueError(
                f"rows_per_s and burst_rows must be positive, got {rows_per_s}, {burst_rows}"
            )
        self.rows_per_s = float(rows_per_s)
        self.burst_rows = float(burst_rows)
        self.priorities = dict(priorities or {})
        self.default_priority = int(default_priority)
        self.class_rates = dict(class_rates or {})
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._buckets: Dict[Any, TokenBucket] = {}
        self._shed_floor: Optional[int] = None  # classes >= floor are shed
        # lifetime outcome counters by priority class — the stats block's
        # admission source of truth (engine copies them at render time)
        self._admitted: Dict[int, int] = {}
        self._rejected: Dict[int, int] = {}
        self._shed: Dict[int, int] = {}

    # --------------------------------------------------------------- priority

    def priority_of(self, stream_id: Optional[int]) -> int:
        if stream_id is None:
            return self.default_priority
        return self.priorities.get(int(stream_id), self.default_priority)

    def lowest_priority(self) -> int:
        """The numerically largest (= least important) class in play."""
        return max([self.default_priority, *self.priorities.values()])

    # ------------------------------------------------------------------- shed

    def shed_lowest(self, on: bool) -> None:
        """Engage/release the ladder's shed rung: reject the lowest priority
        class outright. Idempotent; releasing restores normal admission."""
        with self._lock:
            self._shed_floor = self.lowest_priority() if on else None

    def shed_floor(self) -> Optional[int]:
        with self._lock:
            return self._shed_floor

    def is_shed(self, stream_id: Optional[int]) -> bool:
        with self._lock:
            return self._shed_floor is not None and (
                self.priority_of(stream_id) >= self._shed_floor
            )

    # ------------------------------------------------------------------ admit

    def admit(self, stream_id: Optional[int], rows: int) -> int:
        """Admit ``rows`` for ``stream_id`` or raise :class:`AdmissionRejected`.

        Returns the stream's priority class on success (for telemetry).
        Shed classes reject before touching a bucket; a rate rejection
        consumes nothing and carries the bucket's refill estimate.
        """
        prio = self.priority_of(stream_id)
        with self._lock:
            if self._shed_floor is not None and prio >= self._shed_floor:
                self._shed[prio] = self._shed.get(prio, 0) + 1
                raise AdmissionRejected(
                    f"priority class {prio} is shed under the degradation ladder",
                    retry_after_s=float("inf"),
                    stream_id=stream_id,
                    priority=prio,
                    shed=True,
                )
            now = self._clock()
            bucket = self._buckets.get(stream_id)
            if bucket is None:
                rate = self.rows_per_s * float(self.class_rates.get(prio, 1.0))
                bucket = self._buckets[stream_id] = TokenBucket(self.burst_rows, rate, now)
            wait = bucket.take(float(max(0, rows)), now)
            if wait > 0.0:
                self._rejected[prio] = self._rejected.get(prio, 0) + 1
                raise AdmissionRejected(
                    f"token bucket empty ({rows} rows over rate)",
                    retry_after_s=wait,
                    stream_id=stream_id,
                    priority=prio,
                )
            self._admitted[prio] = self._admitted.get(prio, 0) + 1
            return prio

    def refund(self, stream_id: Optional[int], rows: int, priority: Optional[int] = None) -> None:
        """Return tokens consumed by an :meth:`admit` whose batch never
        entered the engine (the enqueue was refused — a full queue's
        ``BackpressureTimeout``, or a sticky dispatcher raise): credits the
        bucket back up to capacity and reverses the admitted count, so a
        timing-out producer is not double-charged exactly when tokens are
        scarcest."""
        prio = self.priority_of(stream_id) if priority is None else int(priority)
        with self._lock:
            bucket = self._buckets.get(stream_id)
            if bucket is not None:
                bucket.tokens = min(bucket.capacity, bucket.tokens + float(max(0, rows)))
            if self._admitted.get(prio, 0) > 0:
                self._admitted[prio] -= 1

    def counters(self) -> Dict[str, Dict[int, int]]:
        """One consistent snapshot of the outcome counters, by priority."""
        with self._lock:
            return {
                "admitted": dict(self._admitted),
                "rejected": dict(self._rejected),
                "shed": dict(self._shed),
            }


class OverloadDetector:
    """The sustained-overload test the ladder consults once per dispatcher
    group. Signals come from recorder spans and engine telemetry (the engine
    assembles them — ``queue_p99_us`` from the flight recorder's
    ``queue_wait_us`` histogram when one is attached, the stats ring
    otherwise; ``spill_rate`` = pager spill-outs per routed step over the
    tick window; ``queue_depth_frac`` = ingest-queue fill).

    Value hysteresis: :meth:`assess` flips to overloaded when ANY armed high
    watermark is crossed, and back only when EVERY signal is under its clear
    watermark (default = ``clear_frac`` x high). A None threshold disarms
    that signal. Count hysteresis (how many consecutive verdicts move the
    ladder) lives in :class:`DegradationLadder`.
    """

    def __init__(
        self,
        queue_p99_us: Optional[float] = 50_000.0,
        spill_rate: Optional[float] = None,
        queue_depth_frac: Optional[float] = 0.9,
        clear_frac: float = 0.5,
    ):
        if not (0.0 < clear_frac <= 1.0):
            raise ValueError(f"clear_frac must be in (0, 1], got {clear_frac}")
        self.queue_p99_us = queue_p99_us
        self.spill_rate = spill_rate
        self.queue_depth_frac = queue_depth_frac
        self.clear_frac = float(clear_frac)
        self._overloaded = False

    def _checks(self, signals: Dict[str, float]) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for key, high in (
            ("queue_p99_us", self.queue_p99_us),
            ("spill_rate", self.spill_rate),
            ("queue_depth_frac", self.queue_depth_frac),
        ):
            if high is not None:
                out.append((float(signals.get(key, 0.0) or 0.0), float(high)))
        return out

    def assess(self, signals: Dict[str, float]) -> bool:
        """The hysteresis-guarded verdict for one tick's signals."""
        checks = self._checks(signals)
        if not checks:
            return False
        if any(v >= high for v, high in checks):
            self._overloaded = True
        elif all(v < high * self.clear_frac for v, high in checks):
            self._overloaded = False
        return self._overloaded

    def reset(self) -> None:
        self._overloaded = False


class DegradationLadder:
    """The deterministic overload→degradation policy.

    ``rungs`` is an ordered subset of :data:`LADDER_RUNGS`; level 0 = healthy,
    level k = rungs[:k] engaged. One :meth:`tick` per dispatcher group:
    ``up_after`` consecutive overloaded verdicts escalate ONE rung,
    ``down_after`` consecutive healthy verdicts release one — streaks reset
    on any opposite verdict and after each transition, so a flapping signal
    cannot oscillate the engine (count hysteresis on top of the detector's
    value hysteresis). Pure in the verdict sequence: no wall time, no
    randomness — a scripted signal sequence replays to the identical
    transition list, which is what lets same-seed serving runs emit
    identical ladder trace events.

    ``widen_window_ms`` parameterizes the first rung (what the engine sets
    ``coalesce_window_ms`` to while engaged).
    """

    def __init__(
        self,
        detector: Optional[OverloadDetector] = None,
        rungs: Tuple[str, ...] = LADDER_RUNGS,
        up_after: int = 2,
        down_after: int = 4,
        widen_window_ms: float = 5.0,
    ):
        unknown = [r for r in rungs if r not in LADDER_RUNGS]
        if unknown:
            raise ValueError(f"unknown ladder rungs {unknown}; expected from {LADDER_RUNGS}")
        order = {r: i for i, r in enumerate(LADDER_RUNGS)}
        if list(rungs) != sorted(rungs, key=order.__getitem__) or len(set(rungs)) != len(rungs):
            raise ValueError(
                f"rungs must be an ordered subset of {LADDER_RUNGS}, got {rungs}"
            )
        if up_after <= 0 or down_after <= 0:
            raise ValueError("up_after and down_after must be positive")
        self.detector = detector if detector is not None else OverloadDetector()
        self.rungs = tuple(rungs)
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self.widen_window_ms = float(widen_window_ms)
        self.level = 0
        self._hot = 0
        self._cool = 0

    def rung(self, level: int) -> str:
        """The rung engaged by moving from ``level - 1`` to ``level``."""
        return self.rungs[level - 1]

    def tick(self, signals: Dict[str, float]) -> Optional[Tuple[int, int]]:
        """One evaluation; returns ``(from_level, to_level)`` on a transition,
        None otherwise. At most one rung moves per tick."""
        if self.detector.assess(signals):
            self._hot += 1
            self._cool = 0
            if self._hot >= self.up_after and self.level < len(self.rungs):
                self._hot = 0
                self.level += 1
                return (self.level - 1, self.level)
        else:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.down_after and self.level > 0:
                self._cool = 0
                self.level -= 1
                return (self.level + 1, self.level)
        return None

    def reset(self) -> None:
        self.level = 0
        self._hot = 0
        self._cool = 0
        self.detector.reset()
