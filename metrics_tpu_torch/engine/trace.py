"""Flight recorder: bounded span tracing and an OpenMetrics surface for the
streaming engine.

Port of ``metrics_tpu/engine/trace.py``. ``engine/stats.py`` answers *how
much* (counters, a bounded per-step ring); this module answers *which batch
and where*: every submitted batch gets a **trace id** at ``submit()`` and the
dispatcher stamps every stage of that batch's journey — queue wait, coalesce
(the megabatch span LINKS the submit spans it absorbed), pad, capture lookup
(hit against capture), device step, watchdog and in-flight syncs,
retry/backoff, rollback, kernel demotion, quarantine, page-out and page-in,
snapshot write/restore — as a span in a capacity-bounded, thread-safe ring.
Every fault-site firing becomes a ``fault`` event, so a chaos trace shows
WHERE each injected failure landed in the pipeline.

Contracts (the JAX package's):

* **Off ⇒ free.** The engine consults ``EngineConfig.trace`` with one
  ``is not None`` check per site; no recorder means no work on the hot path.
* **Bounded.** The span ring holds ``capacity`` records; older spans are
  dropped (counted in :attr:`TraceRecorder.dropped`), never grown.
* **Occurrence-deterministic.** Trace ids come from a submit-ordered counter
  (``t1, t2, …``) and a megabatch's id derives from its first member
  (``g<k>``) — never from wall time or thread ids — so two same-seed chaos
  runs produce IDENTICAL :meth:`TraceRecorder.canonical_sequence` outputs
  (timestamps and durations are excluded; span args carry only
  deterministic values), in either package.

Two exporters:

* :meth:`TraceRecorder.to_chrome_trace` — Chrome/Perfetto trace-event JSON:
  host threads as named tracks, spans as complete ("X") events, fault
  firings as instants, and flow arrows from each submit span to the
  megabatch that absorbed it (``StreamingEngine.export_trace(path)`` writes
  it). For the DEVICE timeline, wrap the traffic in
  :func:`device_trace_session` (``torch.profiler``): while a recorder is
  attached, each step's device work runs under a ``record_function`` label
  ``device_step:<step>`` that matches the ``step`` arg of its
  ``device_step`` span.
* :func:`render_openmetrics` — an OpenMetrics/Prometheus text snapshot
  (``StreamingEngine.metrics_text()``): the engine's lifetime counters plus
  fixed-bucket latency histograms (step, queue, result, merge, page-in,
  page-out, route). The histograms fold through the library's own
  ``histogram_accumulate`` (:class:`FixedBucketHistogram`): on the card that
  is kernel K2, launched on a stream of the recorder's own that no engine
  and no capture uses; on the CPU its plain version.
"""
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.ops.kernels.dispatch import histogram_accumulate, kernel_fault_scope
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = [
    "DEFAULT_LATENCY_BUCKETS_US",
    "ENGINE_TRACE",
    "FixedBucketHistogram",
    "TraceRecorder",
    "device_trace_session",
    "render_openmetrics",
]

#: Default latency bucket upper bounds, in microseconds (µs): 50 µs (a warm
#: step) to 1 s (a capture or a watchdog expiry) in roughly 1-2.5-5 decades.
DEFAULT_LATENCY_BUCKETS_US = (
    50.0, 100.0, 250.0, 500.0, 1_000.0, 2_500.0, 5_000.0, 10_000.0,
    25_000.0, 50_000.0, 100_000.0, 250_000.0, 500_000.0, 1_000_000.0,
)

#: The reserved trace id for engine-level (not batch-bound) spans and events:
#: result computes, snapshot write/restore, fault firings outside a group.
ENGINE_TRACE = "engine"

#: the engines' dispatcher thread, tracked as ``dispatcher`` (the JAX package's track name)
_DISPATCHER_THREAD = "metrics-tpu-torch-engine"


class _FoldStream:
    """The CUDA stream the folds of one recorder's histograms launch on,
    made at the first fold. PyTorch hands its streams out round-robin from a
    pool of 32 per priority, and the engines' streams and the capture
    streams all come from the default priority's: so the fold's stream is
    drawn from the next priority's pool, and can never be an engine's stream
    (a scrape queued behind or ahead of serving steps) or a capture stream
    (a fold launched into another thread's capture)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def get(self, device: torch.device) -> torch.cuda.Stream:
        with self._lock:
            s = self._streams.get(device)
            if s is None:
                s = self._streams[device] = torch.cuda.Stream(device, priority=-1)
            return s


class FixedBucketHistogram:
    """A Prometheus-style fixed-bucket histogram over host observations.

    Observations buffer as raw values; :meth:`flush` folds them into the
    cumulative bucket counts through ``histogram_accumulate`` on ``device``
    (the card unless the caller asks for the CPU): K2 on a CUDA device, on a
    stream of its own; the plain version on the CPU. The fold pads its
    indices to a power of two with out-of-range values (which drop), so K2
    sees a handful of shapes. ``observe`` is an amortized-O(1) append
    (hot-path safe); folds run at render/boundary time, or inline once per
    :attr:`FOLD_PENDING_AT` observations so an engine that is never scraped
    stays memory-bounded. A fold never consults the thread's
    ``kernel_fault_scope`` hook: observability moves no fault occurrence.
    """

    #: Pending observations that trigger an inline fold: keeps an engine that
    #: is never scraped memory-BOUNDED, and the triggered fold always has one
    #: shape (4096 indices).
    FOLD_PENDING_AT = 4096

    def __init__(self, name: str, edges: Sequence[float] = DEFAULT_LATENCY_BUCKETS_US, device: DeviceLike = None,
                 _fold_stream: Optional[_FoldStream] = None):
        edges = tuple(float(e) for e in edges)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"histogram edges must be non-empty ascending, got {edges}")
        self.name = name
        self.edges = edges
        self.device = resolve_device(device)
        self._fold_stream = _fold_stream if _fold_stream is not None else _FoldStream()
        # guards _pending/_counts/_sum/_n with SHORT critical sections only:
        # the dispatcher observes while a scrape thread reads. The fold itself
        # runs under _fold_lock with _lock RELEASED, so a scrape's fold never
        # blocks the dispatcher's observe(); no lock is ever taken inside
        # another (TraceRecorder.observe resolves the histogram under the
        # recorder's lock and observes after releasing it)
        self._lock = threading.Lock()
        self._fold_lock = threading.Lock()  # serializes folds; never inside _lock
        self._counts = np.zeros(len(edges) + 1, np.int64)  # [+Inf overflow last]
        self._sum = 0.0
        self._n = 0
        self._pending: List[float] = []

    def observe(self, value: float) -> None:
        with self._lock:
            self._pending.append(float(value))
            overflow = len(self._pending) >= self.FOLD_PENDING_AT
        if overflow:
            # non-blocking: a scrape folding right now already swapped the
            # backlog out; the freshly appended tail rides the next fold
            self._flush(blocking=False)

    def flush(self) -> None:
        """Fold pending observations into the cumulative counts. The fold
        runs OUTSIDE ``_lock``: a concurrent ``observe`` appends to the fresh
        pending list. Nothing is lost or double-counted — pending is swapped
        out atomically, and the folded delta merges back under ``_lock``."""
        self._flush(blocking=True)

    def _flush(self, blocking: bool) -> None:
        if blocking:
            self._fold_lock.acquire()
        elif not self._fold_lock.acquire(blocking=False):
            return
        try:
            self._flush_under_fold_lock()
        finally:
            self._fold_lock.release()

    def _flush_under_fold_lock(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        vals = np.asarray(pending, np.float64)
        # bucket k holds v <= edges[k]; v above every edge lands in +Inf
        idx = np.searchsorted(np.asarray(self.edges), vals, side="left").astype(np.int32)
        length = len(self.edges) + 1
        # pad to the next power of two with out-of-range indices (>= length
        # DROP, per bincount semantics): the fold's shapes stay O(log n)
        n_pad = 1 << max(0, (idx.size - 1).bit_length())
        padded = np.full(n_pad, length, np.int32)
        padded[: idx.size] = idx
        counts = self._fold(padded, length)
        with self._lock:
            self._counts += counts
            self._sum += float(vals.sum())
            self._n += int(vals.size)

    def _fold(self, padded: np.ndarray, length: int) -> np.ndarray:
        """Bin counts of ``padded`` through ``histogram_accumulate`` on the
        histogram's device, with no kernel fault hook in scope."""
        with kernel_fault_scope(None), torch.no_grad():
            if self.device.type != "cuda":
                return histogram_accumulate(torch.from_numpy(padded), length=length).numpy().astype(np.int64)
            stream = self._fold_stream.get(self.device)
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                idx = torch.from_numpy(padded).to(self.device)
                counts = histogram_accumulate(idx, length=length)
                return counts.cpu().numpy().astype(np.int64)

    @property
    def count(self) -> int:
        self.flush()
        with self._lock:
            return int(self._n)

    @property
    def sum(self) -> float:
        self.flush()
        with self._lock:
            return float(self._sum)

    def bucket_counts(self) -> np.ndarray:
        """Per-bucket (non-cumulative) counts; last entry is the +Inf bucket."""
        self.flush()
        with self._lock:
            return self._counts.copy()

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile over the folded counts: the upper edge
        of the bucket where the cumulative count crosses ``q`` (the +Inf
        bucket reports the last finite edge — a floor, never an invented
        value). 0.0 when empty. The overload detector's queue-residency feed
        (``engine/admission.py``)."""
        counts = self.bucket_counts()
        total = int(counts.sum())
        if total == 0:
            return 0.0
        target = float(q) * total
        cum = 0
        for i, c in enumerate(counts):
            cum += int(c)
            if cum >= target:
                return float(self.edges[min(i, len(self.edges) - 1)])
        return float(self.edges[-1])

    def snapshot(self) -> Dict[str, Any]:
        self.flush()
        with self._lock:
            return {
                "count": int(self._n),
                "sum": round(float(self._sum), 1),
                "le": list(self.edges),
                "counts": [int(c) for c in self._counts],
            }


def _fmt_num(v: Any) -> str:
    if isinstance(v, float):
        return format(v, ".17g")
    return str(int(v))


def render_openmetrics(
    counters: Dict[str, Any],
    histograms: Iterable[FixedBucketHistogram] = (),
    labeled_counters: Optional[Dict[str, Tuple[str, Dict[str, int]]]] = None,
    gauges: Optional[Dict[str, Any]] = None,
    prefix: str = "metrics_tpu_engine_",
) -> str:
    """Render one OpenMetrics text exposition (the JAX package's families
    and prefix, so one scraper reads either package).

    ``counters`` maps family name (WITHOUT the ``_total`` suffix — it is
    appended per the OpenMetrics counter-sample rule) to value;
    ``labeled_counters`` maps family name to ``(label_name, {label: value})``;
    ``histograms`` render with cumulative ``_bucket{le=...}`` samples plus
    ``_sum``/``_count``. Ends with the mandatory ``# EOF``.
    """
    lines: List[str] = []
    for name in sorted(counters):
        full = prefix + name
        lines.append(f"# TYPE {full} counter")
        lines.append(f"{full}_total {_fmt_num(counters[name])}")
    for name in sorted(labeled_counters or {}):
        label, values = (labeled_counters or {})[name]
        full = prefix + name
        lines.append(f"# TYPE {full} counter")
        for key in sorted(values):
            lines.append(f'{full}_total{{{label}="{key}"}} {_fmt_num(values[key])}')
    for name in sorted(gauges or {}):
        full = prefix + name
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full} {_fmt_num((gauges or {})[name])}")
    for hist in histograms:
        full = prefix + hist.name
        # ONE snapshot per histogram: separate reads could interleave with an
        # observe and break the count-equals-+Inf-bucket invariant
        snap = hist.snapshot()
        lines.append(f"# TYPE {full} histogram")
        cum = 0
        for edge, n in zip(snap["le"], snap["counts"][:-1]):
            cum += int(n)
            lines.append(f'{full}_bucket{{le="{format(edge, "g")}"}} {cum}')
        cum += int(snap["counts"][-1])
        lines.append(f'{full}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{full}_sum {_fmt_num(float(snap['sum']))}")
        lines.append(f"{full}_count {snap['count']}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _track_label() -> str:
    """A STABLE track label for the calling thread: an engine's dispatcher
    thread maps to ``dispatcher``; everything else keeps its thread name
    (``MainThread`` for the typical producer/reader)."""
    name = threading.current_thread().name
    return "dispatcher" if name == _DISPATCHER_THREAD else name


class TraceRecorder:
    """Bounded, thread-safe span/event ring with deterministic trace ids.

    One recorder may be shared by several engines: the ring, the trace-id
    counter and the histograms are all lock-guarded. Spans are recorded at
    END (an abandoned ``begin`` leaves no record); events are instantaneous.
    Timestamps are µs since recorder creation. ``device`` is where the
    histograms fold (the card unless the caller asks for the CPU).
    """

    def __init__(
        self,
        capacity: int = 8192,
        latency_buckets_us: Sequence[float] = DEFAULT_LATENCY_BUCKETS_US,
        device: DeviceLike = None,
    ):
        if capacity <= 0:
            raise ValueError(f"trace capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self._fold_stream = _FoldStream()
        self._lock = threading.Lock()
        self._ring: "deque[Dict[str, Any]]" = deque()
        self._dropped = 0
        self._n_traces = 0
        self._t0 = time.perf_counter()
        # kept for lazy creation in observe(): a histogram first seen there
        # carries the recorder's configured edges, not the defaults
        self._latency_buckets = tuple(float(e) for e in latency_buckets_us)
        self._hists: Dict[str, FixedBucketHistogram] = {
            name: self._histogram(name)
            for name in ("step_latency_us", "queue_wait_us", "result_latency_us", "merge_latency_us")
        }

    def _histogram(self, name: str) -> FixedBucketHistogram:
        return FixedBucketHistogram(name, self._latency_buckets, device=self.device, _fold_stream=self._fold_stream)

    # ------------------------------------------------------------- trace ids

    def new_trace(self) -> str:
        """A fresh trace id from the submit-ordered counter (``t<N>``) —
        deterministic as long as allocation order is (single producer)."""
        with self._lock:
            self._n_traces += 1
            return f"t{self._n_traces}"

    @staticmethod
    def group_trace(links: Sequence[str]) -> str:
        """The megabatch trace id DERIVED from its first absorbed submit
        (``t7 → g7``): deterministic under any producer/dispatcher timing,
        because groups partition the submit stream."""
        for tid in links:
            if tid:
                return "g" + tid.lstrip("tg")
        return ENGINE_TRACE

    # ------------------------------------------------------------- recording

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _append(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self._dropped += 1
            self._ring.append(rec)

    def begin(self, name: str, trace: str, track: Optional[str] = None, **args: Any) -> List[Any]:
        """Open a span; returns the handle :meth:`end` closes. Nothing is
        recorded until ``end`` — a span abandoned mid-failure leaves no
        half-open record in the ring."""
        return [name, trace, track or _track_label(), time.perf_counter(), args]

    def end(self, handle: List[Any], **more_args: Any) -> float:
        """Close a span; returns its duration in µs."""
        name, trace, track, t0, args = handle
        if more_args:
            args = {**args, **more_args}
        dur_us = (time.perf_counter() - t0) * 1e6
        self._append({
            "kind": "span", "name": name, "trace": trace, "track": track,
            "ts": (t0 - self._t0) * 1e6, "dur": dur_us, "args": args,
        })
        return dur_us

    def complete(self, name: str, trace: str, dur_us: float, track: Optional[str] = None, **args: Any) -> None:
        """Record an already-measured span retroactively (e.g. queue wait:
        the duration was observed before the recorder was consulted)."""
        now_us = self._now_us()
        self._append({
            "kind": "span", "name": name, "trace": trace,
            "track": track or _track_label(),
            "ts": max(0.0, now_us - float(dur_us)), "dur": float(dur_us), "args": args,
        })

    def event(self, name: str, trace: str = ENGINE_TRACE, track: Optional[str] = None, **args: Any) -> None:
        """An instantaneous event (fault firings, retries, rollbacks)."""
        self._append({
            "kind": "event", "name": name, "trace": trace,
            "track": track or _track_label(), "ts": self._now_us(), "args": args,
        })

    def observe(self, hist: str, value_us: float) -> None:
        """One latency observation into the named fixed-bucket histogram."""
        with self._lock:
            h = self._hists.get(hist)
            if h is None:
                h = self._hists[hist] = self._histogram(hist)
        # observe OUTSIDE the recorder lock: a scrape thread holds the
        # histogram's fold lock across its fold, and blocking on it while
        # holding the recorder lock would stall every producer's submit —
        # the two locks never nest
        h.observe(value_us)

    # --------------------------------------------------------------- reading

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def records(self) -> List[Dict[str, Any]]:
        """A snapshot of the ring, oldest first. Shallow: records are never
        mutated after they are appended."""
        with self._lock:
            return list(self._ring)

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [r for r in self.records() if r["kind"] == "span" and (name is None or r["name"] == name)]

    def events(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [r for r in self.records() if r["kind"] == "event" and (name is None or r["name"] == name)]

    def fault_sites(self) -> Dict[str, int]:
        """Injected-fault firings by site, from the recorded ``fault`` events."""
        out: Dict[str, int] = {}
        for e in self.events("fault"):
            site = e["args"].get("site")
            if site:
                out[site] = out.get(site, 0) + 1
        return out

    def histograms(self) -> List[FixedBucketHistogram]:
        with self._lock:
            return list(self._hists.values())

    # --------------------------------------------------------- canonical form

    @staticmethod
    def _canon_value(v: Any) -> Any:
        if isinstance(v, (list, tuple)):
            return tuple(TraceRecorder._canon_value(x) for x in v)
        if isinstance(v, np.generic):
            return v.item()
        return v

    def canonical_sequence(self) -> Dict[str, List[Tuple]]:
        """The determinism observable: per-track ordered ``(kind, name,
        trace, sorted-args)`` tuples, timestamps and durations EXCLUDED. Two
        same-seed chaos runs must compare equal — provided nothing was
        dropped from the ring (assert :attr:`dropped` == 0 alongside)."""
        out: Dict[str, List[Tuple]] = {}
        for r in self.records():
            canon = (
                r["kind"], r["name"], r["trace"],
                tuple(sorted((k, self._canon_value(v)) for k, v in r["args"].items())),
            )
            out.setdefault(r["track"], []).append(canon)
        return out

    # ---------------------------------------------------------------- export

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Chrome/Perfetto trace-event document: spans as complete
        (``X``) events on named per-track threads, fault firings as instants,
        and flow arrows (``s``/``f``) from each submit span into the
        megabatch span that absorbed it."""
        records = self.records()
        tracks: List[str] = []
        for r in records:
            if r["track"] not in tracks:
                tracks.append(r["track"])
        # stable presentation: dispatcher first, then alphabetical
        tracks.sort(key=lambda t: (t != "dispatcher", t))
        tid = {t: i + 1 for i, t in enumerate(tracks)}
        events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": tid[t], "ts": 0, "args": {"name": t}}
            for t in tracks
        ]
        submit_at: Dict[str, Tuple[int, float]] = {}
        for r in records:
            if r["kind"] == "span" and r["name"] == "submit":
                submit_at[r["trace"]] = (tid[r["track"]], r["ts"])
        flow_n = 0
        for r in records:
            base = {"name": r["name"], "cat": "engine", "pid": 1, "tid": tid[r["track"]], "ts": round(r["ts"], 3)}
            args = {"trace": r["trace"], **r["args"]}
            if r["kind"] == "span":
                events.append({**base, "ph": "X", "dur": round(r["dur"], 3), "args": args})
                for link in r["args"].get("links", ()):  # coalesce → submit flows
                    src = submit_at.get(link)
                    if src is None:
                        continue
                    flow_n += 1
                    events.append({"ph": "s", "id": flow_n, "name": "batch", "cat": "flow", "pid": 1,
                                   "tid": src[0], "ts": round(src[1], 3)})
                    events.append({"ph": "f", "bp": "e", "id": flow_n, "name": "batch", "cat": "flow", "pid": 1,
                                   "tid": tid[r["track"]], "ts": round(r["ts"], 3)})
            else:
                events.append({**base, "ph": "i", "s": "t", "args": args})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"generator": "metrics_tpu_torch.engine.trace", "spans_dropped": self.dropped},
        }

    def export(self, path: str) -> str:
        """Write :meth:`to_chrome_trace` as JSON to ``path``."""
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
        return path

    # --------------------------------------------------------------- summary

    def summary(self, slowest: int = 5) -> Dict[str, Any]:
        """The trace/SLO block ``tools/engine_report.py`` renders: span and
        drop totals, per-name duration aggregates, histogram snapshots, and
        the slowest-N traces with their per-span breakdown. The end-to-end
        definition (root span + queue waits) is the one
        ``tools/trace_export.summarize`` applies to exported documents."""
        records = self.records()
        spans = [r for r in records if r["kind"] == "span"]
        by_name: Dict[str, Dict[str, Any]] = {}
        by_trace: Dict[str, List[Dict[str, Any]]] = {}
        for s in spans:
            agg = by_name.setdefault(s["name"], {"count": 0, "dur_us_total": 0.0, "dur_us_max": 0.0})
            agg["count"] += 1
            agg["dur_us_total"] += s["dur"]
            agg["dur_us_max"] = max(agg["dur_us_max"], s["dur"])
            by_trace.setdefault(s["trace"], []).append(s)
        roots = []
        for trace, members in by_trace.items():
            if trace == ENGINE_TRACE:
                continue
            # the megabatch span is the trace's root when present; its wall
            # time plus the queue wait is the batch journey's end-to-end
            # latency. A submit-ONLY trace is no journey: its batch lives in
            # the g-trace that absorbed it
            root = next((s for s in members if s["name"] == "coalesce"), None)
            if root is None:
                non_submit = [s for s in members if s["name"] != "submit"]
                if not non_submit:
                    continue
                root = max(non_submit, key=lambda s: s["dur"])
            total = root["dur"] + sum(s["dur"] for s in members if s["name"] == "queue_wait")
            roots.append((total, root, members))
        roots.sort(key=lambda rm: -rm[0])
        slowest_traces = []
        for total, root, members in roots[: max(0, int(slowest))]:
            breakdown: Dict[str, float] = {}
            for s in members:
                if s is not root:
                    breakdown[s["name"]] = round(breakdown.get(s["name"], 0.0) + s["dur"], 1)
            entry: Dict[str, Any] = {
                "trace": root["trace"],
                "root": root["name"],
                "dur_us": round(total, 1),
                "n_spans": len(members),
                "breakdown": breakdown,
            }
            links = root["args"].get("links")
            if links:
                entry["links"] = list(links)
            if "stream_ids" in root["args"]:
                entry["stream_ids"] = list(root["args"]["stream_ids"])
            slowest_traces.append(entry)
        return {
            "spans": len(spans),
            "events": len(records) - len(spans),
            "dropped": self.dropped,
            "capacity": self.capacity,
            "by_name": {
                k: {"count": v["count"], "dur_us_total": round(v["dur_us_total"], 1),
                    "dur_us_max": round(v["dur_us_max"], 1)}
                for k, v in sorted(by_name.items())
            },
            "histograms": {h.name: h.snapshot() for h in self.histograms() if h.count},
            "slowest_traces": slowest_traces,
        }


class device_trace_session:
    """Context manager pairing the host flight recorder with a
    ``torch.profiler`` session over every thread (CPU activity, and CUDA
    kernels when CUDA is available). On exit it writes the profiler's Chrome trace to
    ``<logdir>/device_trace.json`` (``path``). Correlate the two by step:
    an engine with a recorder attached runs each step's device work under a
    ``record_function`` label ``device_step:<step>``, the ``step`` arg of the
    step's ``device_step`` span.

    Usage::

        with device_trace_session("build/device_trace") as s:
            ... engine traffic ...
        # host spans: engine.export_trace("build/trace_host.json")
        # device timeline: s.path
    """

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path = os.path.join(logdir, "device_trace.json")
        self._prof: Any = None

    def __enter__(self) -> "device_trace_session":
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        # every thread: the labels are taken on the engines' dispatcher threads
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        self._prof = profile(activities=activities, experimental_config=config)
        self._prof.__enter__()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        self._prof.__exit__(exc_type, exc, tb)
        os.makedirs(self.logdir, exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        return False
