"""The engine's step cache: capture each bucketed step once, replay it after.

Port of ``metrics_tpu/engine/aot.py``. The JAX engine lowers and compiles each
bucket's step ahead of time and memoises the executable under a structural
key; on the card the counterpart of a compiled executable is a captured CUDA
graph. :class:`AotCache` keeps one entry per key: program kind, metric
fingerprint (:func:`metric_fingerprint`), the signature of the carried state
and the padded payload (:meth:`AotCache.signature_of`), arena layout, resolved
kernel backend, device and sync-precision tag. The key leaves object identity
out, so engines over equally configured metrics share entries: a warm twin
engine captures nothing.

* On a CUDA device an entry is a :class:`CapturedStep`: the step captured
  into a ``torch.cuda.CUDAGraph`` together with the fixed buffers it reads
  (a carried-state copy, the engine's per-step extras, the padded payload and
  mask of ``engine/bucketing.py``). One replay issues the step's whole
  sequence of launches without the Python that issues them eagerly.
* On the CPU an entry is :data:`EAGER`: the step runs eagerly, since the
  kernels' plain versions sync with the host (``ops/kernels/xla_ref.py``),
  and nothing is captured.

The cache may be shared by several engines, each with its own dispatcher
thread and stream. Its lock spans a capture, so two engines racing on one key
pay for one capture, and a graph's replays (with the copies into its
buffers) run one at a time on the device, ordered by an event: the graphs of
one cache share one memory pool and K3's zeroed scratch of the capture
stream. ``compilation_cache_dir`` (XLA's on-disk cache) has no counterpart
for a CUDA graph.
"""
import hashlib
import threading
import time
from contextlib import contextmanager
from enum import Enum
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from metrics_tpu_torch.ops.binned_update import binned_counts_cuda
from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda
from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda
from metrics_tpu_torch.ops.kernels.megastep_cuda import (
    megastep_fold_cuda,
    megastep_segment_cuda,
    megastep_segment_q8_cuda,
)
from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda
from metrics_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map

__all__ = ["AotCache", "CapturedStep", "EAGER", "LAUNCH_COUNTERS", "metric_fingerprint"]

#: the kernel wrappers K1-K7, each with its ``.launches`` count
LAUNCH_COUNTERS = (fold_rows_cuda, histogram_cuda, binned_counts_cuda, segment_reduce_cuda, megastep_fold_cuda,
                   megastep_segment_cuda, megastep_segment_q8_cuda)

# config arrays larger than this are fingerprinted by shape/dtype and a head
# and tail sample instead of their whole content
_HASH_ARRAY_BYTES_CAP = 1 << 20
# nn.Module's own bookkeeping, never metric configuration
_MODULE_ATTRS = frozenset(vars(nn.Module()))
_METRIC_SKIP = frozenset({
    "update", "compute", "_defaults", "_reductions", "_computed", "_forward_cache", "_update_called",
    "_sync_precision_spec",
})


def _fingerprint_array(arr: np.ndarray, h: "hashlib._Hash") -> None:
    h.update(f"arr{arr.shape}{arr.dtype}".encode())
    if arr.nbytes <= _HASH_ARRAY_BYTES_CAP:
        h.update(np.ascontiguousarray(arr).tobytes())
    else:
        # a deterministic head+tail sample, never id(): CPython reuses ids
        flat = arr.reshape(-1)
        h.update(np.ascontiguousarray(flat[:1024]).tobytes())
        h.update(np.ascontiguousarray(flat[-1024:]).tobytes())
        h.update(str(arr.nbytes).encode())


def _fingerprint_value(v: Any, h: "hashlib._Hash") -> None:
    if isinstance(v, (torch.Generator, np.random.RandomState, np.random.Generator)):
        # a random stream is state, not configuration (a BootStrapper's draws),
        # and its repr carries its address: its type alone
        h.update(type(v).__name__.encode())
    elif isinstance(v, (bool, int, float, str, bytes, type(None), torch.dtype, torch.device, Enum)):
        h.update(repr(v).encode())
    elif isinstance(v, np.generic):  # numpy scalars are not Python ints/floats
        h.update(f"{v.dtype}:{v!r}".encode())
    elif isinstance(v, np.ndarray):
        _fingerprint_array(v, h)
    elif isinstance(v, torch.Tensor):
        t = v.detach()
        h.update(str(t.dtype).encode())
        _fingerprint_array((t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy(), h)
    elif isinstance(v, (tuple, list, set, frozenset)):
        h.update(b"[")
        for x in (sorted(v, key=repr) if isinstance(v, (set, frozenset)) else v):
            _fingerprint_value(x, h)
        h.update(b"]")
    elif isinstance(v, dict):
        for k, val in sorted(v.items(), key=lambda kv: str(kv[0])):
            h.update(str(k).encode())
            _fingerprint_value(val, h)
    else:
        # an unknown config type must still change the fingerprint: a repr
        # that is not stable costs an extra capture, the safe direction
        h.update(repr(v)[:256].encode())


def metric_fingerprint(metric: Any) -> str:
    """Structural fingerprint of a metric's or collection's step: its class
    tree and every configuration attribute (scalars, strings, small tensors
    and arrays by content, nested metrics, collection membership). Registered
    STATE values are excluded: state travels as the step's input."""
    h = hashlib.sha256()

    def visit(m: Any) -> None:
        h.update(type(m).__name__.encode())
        if hasattr(m, "_defaults"):  # a Metric
            for name in sorted(m.__dict__):
                if name in _METRIC_SKIP or name in _MODULE_ATTRS:
                    continue
                v = m.__dict__[name]
                h.update(name.encode())
                if callable(v) and not isinstance(v, (torch.Tensor, nn.Module)):
                    h.update(getattr(v, "__qualname__", repr(type(v))).encode())
                else:
                    _fingerprint_value(v, h)
            # config tensors registered as buffers (states are excluded)
            for name, buf in sorted(m._buffers.items()):
                if name not in m._defaults and buf is not None:
                    h.update(name.encode())
                    _fingerprint_value(buf, h)
            for name, child in sorted(m._modules.items()):
                h.update(name.encode())
                visit(child)
        elif isinstance(m, nn.ModuleList):  # a wrapper's list of inner metrics
            for child in m:
                visit(child)
        elif hasattr(m, "items"):  # a MetricCollection
            for k, v in m.items(keep_base=True):
                h.update(k.encode())
                visit(v)

    visit(metric)
    return h.hexdigest()[:16]


class _Eager:
    """The CPU's cache entry: the step, run eagerly."""

    def __repr__(self) -> str:
        return "EAGER"


EAGER = _Eager()


class CapturedStep:
    """One engine step captured into a CUDA graph, with the fixed buffers it
    reads: ``state`` (a copy of the carried state's shapes), ``aux`` (the
    engine's per-step extras, e.g. the paged engine's q8 staging) and
    ``inputs`` (the padded payload and mask, :class:`~metrics_tpu_torch.
    engine.bucketing.StepBuffers`). The graph's output ``out`` is the new
    carried state; :meth:`replay` copies the engine's state and extras in and
    the new state back into the engine's own buffers, in place.

    ``keepalive`` holds what the graph reads without owning it (the metric's
    config tensors, the megastep plan's op rows): the cache may outlive the
    engine that captured the step.
    """

    def __init__(self, state: Any, aux: Any, inputs: Any, keepalive: Tuple[Any, ...] = ()):
        self.state = tree_map(torch.empty_like, state)
        self.aux = tree_map(lambda x: torch.empty_like(x) if isinstance(x, torch.Tensor) else x, aux)
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        #: launches of each kernel wrapper that one replay runs
        self.launches: Dict[Any, int] = {}
        self._keepalive = keepalive

    def load(self, state: Any, aux: Any) -> None:
        """Copy the engine's carried state and extras into the graph's
        buffers, on the current stream."""
        for dst, src in zip(tree_leaves(self.state), tree_leaves(state)):
            dst.copy_(src)
        for dst, src in zip(tree_leaves(self.aux), tree_leaves(aux)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)

    def capture(self, fn: Callable[..., Any], pool: Any, stream: torch.cuda.Stream) -> None:
        """Run ``fn(state, aux, args, kwargs, mask)`` once on the buffers (the
        warm-up: it really executes, on the copy, and makes what the step
        creates lazily, such as K3's zeroed scratch for ``stream`` and the
        plan's op rows), then capture it on ``stream`` into ``pool``. The
        kernel wrappers count the capture's launches, which ran nothing: the
        counts are taken back and credited on every replay instead. A capture
        that fails raises; nothing falls back to the eager step."""
        a, kw = self.inputs.payload
        with torch.cuda.stream(stream):
            fn(self.state, self.aux, a, kw, self.inputs.mask)
        before = [c.launches for c in LAUNCH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        try:
            # thread-local: producers on other threads keep copying and
            # allocating while this thread captures
            with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                out = fn(self.state, self.aux, a, kw, self.inputs.mask)
        finally:
            delta = [c.launches - b for c, b in zip(LAUNCH_COUNTERS, before)]
            for c, b in zip(LAUNCH_COUNTERS, before):
                c.launches = b
        self.graph, self.out = graph, out
        self.launches = {c: d for c, d in zip(LAUNCH_COUNTERS, delta) if d}

    def replay(self, state: Any, aux: Any) -> None:
        """One step on the current stream: the engine's state and extras in,
        the graph, the new state out into ``state``'s own buffers."""
        self.load(state, aux)
        self.graph.replay()
        for dst, src in zip(tree_leaves(state), tree_leaves(self.out)):
            dst.copy_(src)
        for counter, n in self.launches.items():
            counter.launches += n


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


class AotCache:
    """In-process cache of captured engine steps, with counters: a steady
    stream shows zero misses after warm-up (at most ``len(buckets)`` per
    payload signature on a cold engine, none on a warm twin)."""

    def __init__(self) -> None:
        self._programs: Dict[Tuple, Any] = {}
        # one cache may be SHARED by engines on several dispatcher threads;
        # the lock spans a capture (one capture per key) and every replay
        # section (the graphs share a memory pool)
        self._lock = threading.RLock()
        self._pools: Dict[torch.device, Any] = {}
        self._capture_streams: Dict[torch.device, torch.cuda.Stream] = {}
        # per device: the event after the last section and its stream
        self._tail: Dict[torch.device, Tuple[torch.cuda.Event, torch.cuda.Stream]] = {}
        self.hits = 0
        self.misses = 0
        self.capture_seconds = 0.0

    def __len__(self) -> int:
        return len(self._programs)

    def program_keys(self) -> Tuple[Tuple, ...]:
        """Snapshot of every entry's structural key."""
        with self._lock:
            return tuple(self._programs)

    def count_hit(self) -> None:
        """Count a hit served from an engine-local memo."""
        with self._lock:
            self.hits += 1

    def get_or_capture(self, key: Tuple, build: Callable[[], Any]) -> Any:
        """The entry for ``key``, made by ``build()`` on a miss."""
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self.hits += 1
                return prog
            self.misses += 1
            t0 = time.perf_counter()
            try:
                prog = build()
            finally:
                self.capture_seconds += time.perf_counter() - t0
            self._programs[key] = prog
            return prog

    @contextmanager
    def exclusive(self, stream: torch.cuda.Stream) -> Iterator[None]:
        """A section of device work on ``stream`` that touches this cache's
        graphs (copies into their buffers, replays, captures): it starts after
        the last section on the device, whichever stream ran it."""
        dev = stream.device
        with self._lock:
            tail = self._tail.get(dev)
            if tail is not None and tail[1] != stream:
                stream.wait_event(tail[0])
            try:
                yield
            finally:
                ev = tail[0] if tail is not None else torch.cuda.Event()
                ev.record(stream)
                self._tail[dev] = (ev, stream)

    def capture(self, prog: CapturedStep, fn: Callable[..., Any], device: torch.device) -> None:
        """Warm up and capture ``prog`` on this cache's capture stream for
        ``device``, after the caller's stream (which filled its buffers), into
        the cache's memory pool; the caller's stream then waits for it."""
        with self._lock:
            stream = self._capture_streams.get(device)
            if stream is None:
                stream = self._capture_streams[device] = torch.cuda.Stream(device)
            pool = self._pools.get(device)
            if pool is None:
                pool = self._pools[device] = torch.cuda.graph_pool_handle()
            caller = torch.cuda.current_stream(device)
            with self.exclusive(stream):
                stream.wait_stream(caller)
                prog.capture(fn, pool, stream)
            caller.wait_stream(stream)

    @staticmethod
    def signature_of(tree: Any) -> Tuple:
        """Hashable (structure, per-leaf shape and dtype) signature of a
        tree; numpy and torch dtypes of one name agree. Python values key by
        value."""
        leaves, treedef = tree_flatten(tree)
        sig = tuple(
            (tuple(int(d) for d in leaf.shape), _dtype_name(leaf.dtype))
            if hasattr(leaf, "shape") and hasattr(leaf, "dtype")
            else ((type(leaf).__name__, leaf) if isinstance(leaf, (bool, int, float, str, type(None)))
                  else (type(leaf).__name__, repr(leaf)[:64]))
            for leaf in leaves
        )
        return (treedef, sig)

    def program_key(
        self,
        kind: str,
        metric_fp: str,
        arg_tree: Any = None,
        layout: Any = None,
        backend: str = "auto",
        device: Any = None,
        precision: str = "exact",
    ) -> Tuple:
        """Structural program identity: the kind of step, the metric's
        fingerprint, the signature of its arguments (carried state, extras,
        padded payload, mask), the arena layout, the resolved kernel backend,
        the device and the sync-precision tag."""
        return (
            kind,
            metric_fp,
            self.signature_of(arg_tree) if arg_tree is not None else None,
            None if layout is None else tuple((str(k), int(o), int(s), tuple(shape), _dtype_name(dt))
                                              for k, o, s, shape, dt in layout.leaf_slices()),
            str(backend),
            str(device),
            str(precision),
        )

    def stats(self) -> Dict[str, Any]:
        return {
            "programs": len(self._programs),
            "hits": self.hits,
            "misses": self.misses,
            "capture_seconds": round(self.capture_seconds, 3),
        }
