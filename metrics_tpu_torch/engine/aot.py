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

The compiled forward (``Metric.forward``, ``MetricCollection.forward``) has
its entries here too: :func:`forward_entry` makes a :class:`CapturedForward`
on a CUDA device (the step ``update -> merge -> compute(delta)`` captured
through :class:`CapturedStep`, its replays ordered on :data:`FORWARD_CACHE`)
and an :class:`EagerForward` on the CPU.

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
import warnings
from contextlib import contextmanager
from enum import Enum
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from metrics_tpu_torch.ops.binned_update import binned_counts_cuda
from metrics_tpu_torch.ops.kernels.dispatch import kernel_fault_scope
from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda
from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda
from metrics_tpu_torch.ops.kernels.megastep_cuda import (
    megastep_fold_cuda,
    megastep_segment_cuda,
    megastep_segment_q8_cuda,
)
from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda
from metrics_tpu_torch.utils.device import as_input
from metrics_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map

__all__ = ["AotCache", "CapturedForward", "CapturedStep", "EAGER", "EagerForward", "FORWARD_CACHE", "HostSyncError",
           "ForwardCache", "LAUNCH_COUNTERS", "forward_entry", "metric_fingerprint"]

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
    "_sync_precision_spec", "_deferred_errcode", "_fwd_path_ok",
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

    With ``extra_out`` the step returns ``(new_state, extra)`` (the compiled
    forward's: its batch value and error code ride ``extra``), and each
    replay returns clones of both, leaving ``state`` as it was: the caller
    rebinds its state to the new tensors, and nothing it handed out before
    (a state tensor that ``compute()`` returned) changes. The next replay
    overwrites the graph's own outputs.
    """

    def __init__(self, state: Any, aux: Any, inputs: Any, keepalive: Tuple[Any, ...] = (),
                 extra_out: bool = False):
        self.state = tree_map(torch.empty_like, state)
        self.aux = tree_map(lambda x: torch.empty_like(x) if isinstance(x, torch.Tensor) else x, aux)
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        #: launches of each kernel wrapper that one replay runs
        self.launches: Dict[Any, int] = {}
        self._keepalive = keepalive
        self._extra_out = extra_out

    def load(self, state: Any, aux: Any) -> None:
        """Copy the engine's carried state and extras into the graph's
        buffers, on the current stream."""
        for dst, src in zip(tree_leaves(self.state), tree_leaves(state)):
            dst.copy_(src)
        for dst, src in zip(tree_leaves(self.aux), tree_leaves(aux)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)

    def capture(self, fn: Callable[..., Any], pool: Any, stream: torch.cuda.Stream,
                refuse_host_sync: bool = False) -> None:
        """Run ``fn(state, aux, args, kwargs, mask)`` once on the buffers (the
        warm-up: it really executes, on the copy, and makes what the step
        creates lazily, such as K3's zeroed scratch for ``stream`` and the
        plan's op rows), then capture it on ``stream`` into ``pool``. The
        kernel wrappers count the capture's launches, which ran nothing: the
        counts are taken back and credited on every replay instead.

        With ``refuse_host_sync`` (the compiled forward's, on the caller's
        thread: an engine captures on its dispatcher thread, where recording
        the process's warnings is not safe) a warm-up that synchronized the
        host with the device, which would break the capture, raises
        :class:`HostSyncError` and nothing is captured. A capture that fails
        all the same raises, after undoing what it left in PyTorch's
        allocator and random generator; nothing falls back to the eager step
        (the compiled forward's caller marks the signature eager-only)."""
        a, kw = self.inputs.payload
        with torch.cuda.stream(stream), _host_syncs_refused(refuse_host_sync):
            fn(self.state, self.aux, a, kw, self.inputs.mask)
        before = [c.launches for c in LAUNCH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        try:
            # thread-local: producers on other threads keep copying and
            # allocating while this thread captures
            # the kernel fault hook ran in the warm-up: once per capture
            with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"), \
                    kernel_fault_scope(None):
                out = fn(self.state, self.aux, a, kw, self.inputs.mask)
        except BaseException:
            _recover_failed_capture(stream, pool)
            raise
        finally:
            delta = [c.launches - b for c, b in zip(LAUNCH_COUNTERS, before)]
            for c, b in zip(LAUNCH_COUNTERS, before):
                c.launches = b
        self.graph, self.out = graph, out
        self.launches = {c: d for c, d in zip(LAUNCH_COUNTERS, delta) if d}

    def replay(self, state: Any, aux: Any) -> Any:
        """One step on the current stream: the engine's state and extras in,
        the graph, the new state out into ``state``'s own buffers. With
        ``extra_out``, ``state`` is left alone and clones of ``(new_state,
        extra)`` are returned instead (None otherwise)."""
        self.load(state, aux)
        self.graph.replay()
        for counter, n in self.launches.items():
            counter.launches += n
        if self._extra_out:
            return pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, self.out)
        for dst, src in zip(tree_leaves(state), tree_leaves(self.out)):
            dst.copy_(src)
        return None


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


class HostSyncError(RuntimeError):
    """A step's warm-up synchronized the host with the device: it cannot be captured."""


_SYNC_WARNING = "called a synchronizing CUDA operation"  # PyTorch's sync debug mode


@contextmanager
def _host_syncs_refused(on: bool) -> Iterator[None]:
    """Raise :class:`HostSyncError` after the body if it synchronized the host
    with the device (``.item()``, ``nonzero``, a masked index, a copy to or
    from the host). PyTorch's sync debug mode is process-wide, so it is set
    to warn, never to raise, and the warnings are recorded: a sync that
    another thread makes meanwhile is recorded too, and at worst leaves this
    step eager-only. The body's other warnings are issued again."""
    if not on:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        if not prev:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            if not prev:
                torch.cuda.set_sync_debug_mode(prev)
    syncs = [w for w in caught if _SYNC_WARNING in str(w.message)]
    for w in caught:
        if _SYNC_WARNING not in str(w.message):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    if syncs:
        raise HostSyncError(f"the step synchronizes with the host ({len(syncs)} times); it cannot be captured")


def _recover_failed_capture(stream: torch.cuda.Stream, pool: Any) -> None:
    """Undo what a capture that failed inside (an illegal op invalidates it,
    and ending it raises before PyTorch's own clean-up) leaves behind: the
    allocator still recording into ``pool``, and the device's default
    random generator still marked as capturing, where every later random op
    raises. A one-op capture on ``stream`` clears that mark as every
    capture's end does, on the same generator state, which a user's own
    graphs that draw random numbers share."""
    index = stream.device.index if stream.device.index is not None else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(index, pool)
    except RuntimeError:  # not recording
        pass
    closing = torch.cuda.CUDAGraph()
    with torch.cuda.graph(closing, stream=stream, capture_error_mode="thread_local"):
        torch.zeros((1,), device=stream.device)


def _anchored_pool(stream: torch.cuda.Stream) -> Tuple[Any, torch.cuda.CUDAGraph]:
    """A new graph memory pool and a one-op graph captured into it. The
    caller keeps the graph: PyTorch refuses to capture into a pool whose
    graphs have all died while one of its blocks is still allocated, and the
    compiled forward's graphs die with their metrics."""
    pool = torch.cuda.graph_pool_handle()
    anchor = torch.cuda.CUDAGraph()
    with torch.cuda.graph(anchor, pool=pool, stream=stream, capture_error_mode="thread_local"):
        torch.zeros((1,), device=stream.device)
    return pool, anchor


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
        self._pools: Dict[torch.device, Tuple[Any, torch.cuda.CUDAGraph]] = {}  # (pool, its anchor graph)
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

    def capture(self, prog: CapturedStep, fn: Callable[..., Any], device: torch.device,
                refuse_host_sync: bool = False) -> None:
        """Warm up and capture ``prog`` on this cache's capture stream for
        ``device``, after the caller's stream (which filled its buffers), into
        the cache's memory pool; the caller's stream then waits for it."""
        with self._lock:
            stream = self._capture_streams.get(device)
            if stream is None:
                stream = self._capture_streams[device] = torch.cuda.Stream(device)
            if device not in self._pools:
                self._pools[device] = _anchored_pool(stream)
            pool = self._pools[device][0]
            caller = torch.cuda.current_stream(device)
            try:
                with self.exclusive(stream):
                    stream.wait_stream(caller)
                    prog.capture(fn, pool, stream, refuse_host_sync)
            except HostSyncError:
                raise  # nothing was captured: the pool is sound
            except BaseException:
                # later captures take a fresh pool: PyTorch may still count this one as recording
                del self._pools[device]
                raise
            finally:
                # a failed capture too: the caller's stream may free the buffers the warm-up read
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


# ---------------------------------------------------------------- compiled forward

class ForwardCache(AotCache):
    """The compiled forwards' side of the cache: one capture stream and one
    memory pool per device, shared by every forward graph, whose replays
    :meth:`AotCache.exclusive` orders (they share K3's zeroed scratch of the
    capture stream and the pool). It keeps no programs (each metric holds its
    own entries); ``misses`` counts captures, ``hits`` replays,
    ``eager_only`` the signatures that a failed build or run left eager and
    ``host_sync_refusals`` those of them whose warm-up synchronized with the
    host, so that no capture was tried."""

    def __init__(self) -> None:
        super().__init__()
        self.eager_only = 0
        self.host_sync_refusals = 0

    def note_capture(self, seconds: float) -> None:
        with self._lock:
            self.misses += 1
            self.capture_seconds += seconds

    def note_eager_only(self) -> None:
        with self._lock:
            self.eager_only += 1

    def note_host_sync_refusal(self) -> None:
        with self._lock:
            self.host_sync_refusals += 1

    def stats(self) -> Dict[str, Any]:
        return {**super().stats(), "eager_only": self.eager_only, "host_sync_refusals": self.host_sync_refusals}


#: the process's forward graphs (see :class:`ForwardCache`)
FORWARD_CACHE = ForwardCache()


def _buffer_dtype(leaf: Any) -> torch.dtype:
    """The dtype a forward input takes on the device: a Python float is
    f32, and f64 narrows to f32 (``utils.device.as_input``)."""
    if isinstance(leaf, float):
        return torch.float32
    dt = leaf.dtype if isinstance(leaf.dtype, torch.dtype) else torch.from_numpy(np.empty((0,), leaf.dtype)).dtype
    return torch.float32 if dt == torch.float64 else dt


def _as_device_input(x: Any, device: torch.device) -> torch.Tensor:
    """One array leaf of a forward call as a tensor on ``device``."""
    if isinstance(x, float):
        return torch.full((), x, dtype=torch.float32, device=device)
    return as_input(x, device)


class _ForwardBuffers:
    """The fixed device buffers a captured forward reads: one per array leaf
    of the call at its shape and device dtype; the other leaves (ints,
    bools, None) are baked in, as the signature that keys the step holds
    them by value."""

    def __init__(self, leaves: List[Any], array_idx: Tuple[int, ...], treedef: Any, device: torch.device):
        bufs = list(leaves)
        for i in array_idx:
            bufs[i] = torch.empty(tuple(getattr(leaves[i], "shape", ())), dtype=_buffer_dtype(leaves[i]),
                                  device=device)
        self._bufs = [bufs[i] for i in array_idx]
        #: ``(args, kwargs)`` over the buffers: what the captured step is called with
        self.payload = pytree.tree_unflatten(bufs, treedef)
        self.mask = None

    def fill(self, arrays: List[Any]) -> None:
        """Copy the call's array leaves into the buffers, on the current stream."""
        for buf, x in zip(self._bufs, arrays):
            if isinstance(x, float):
                buf.fill_(x)
            else:
                buf.copy_(torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x)


class CapturedForward:
    """A compiled forward on a CUDA device: ``step(state, aux, args, kwargs,
    mask)`` returning ``(new_state, (value, code))``, captured as a
    :class:`CapturedStep` on :data:`FORWARD_CACHE`'s stream and pool. A
    state of new shapes or dtypes is captured anew, as ``jax.jit`` retraces.

    Calling it with the metric's state and the call's array leaves copies
    both into the graph's buffers, replays the graph, and returns
    ``(new_state, value, code)``, all cloned out of the graph's buffers: the
    metric rebinds its state to them, as JAX rebinds, and its old state
    tensors (and a ``compute()`` result that is one of them) keep their
    values. The first
    call of a state signature warms the step up on the capture stream and
    captures it; a capture that fails raises (the caller marks the signature
    eager-only) and leaves the state untouched.
    """

    def __init__(self, step: Callable[..., Any], leaves: List[Any], array_idx: Tuple[int, ...], treedef: Any,
                 device: torch.device, keepalive: Tuple[Any, ...] = ()):
        self._step = step
        self._leaves, self._idx, self._treedef = list(leaves), tuple(array_idx), treedef
        self._device = device
        self._keepalive = keepalive
        self._graphs: Dict[Tuple, CapturedStep] = {}
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def _capture(self, state: Any, arrays: List[Any]) -> CapturedStep:
        t0 = time.perf_counter()
        prog = CapturedStep(state, (), _ForwardBuffers(self._leaves, self._idx, self._treedef, self._device),
                            self._keepalive, extra_out=True)
        prog.inputs.fill(arrays)
        prog.load(state, ())  # the warm-up runs on these copies, never the metric's state
        try:
            # a host read in the update or compute is found in the warm-up, before any capture
            FORWARD_CACHE.capture(prog, self._step, self._device, refuse_host_sync=True)
        except HostSyncError:
            FORWARD_CACHE.note_host_sync_refusal()
            raise
        new = tree_leaves(prog.out[0])
        old = tree_leaves(state)
        if len(new) != len(old) or any(a.shape != b.shape or a.dtype != b.dtype for a, b in zip(new, old)):
            raise RuntimeError("the forward step changes the state's shapes or dtypes; it stays eager")
        seconds = time.perf_counter() - t0
        self.captures += 1
        self.capture_seconds += seconds
        FORWARD_CACHE.note_capture(seconds)
        return prog

    def __call__(self, state: Any, arrays: List[Any]) -> Tuple[Any, Any, torch.Tensor]:
        key = AotCache.signature_of(state)
        prog = self._graphs.get(key)
        if prog is None:
            prog = self._graphs[key] = self._capture(state, arrays)
        with FORWARD_CACHE.exclusive(torch.cuda.current_stream(self._device)):
            prog.inputs.fill(arrays)
            new, (value, code) = prog.replay(state, ())
        self.replays += 1
        FORWARD_CACHE.count_hit()
        return new, value, code


class EagerForward:
    """A compiled forward on the CPU: the same step, run eagerly (the
    counterpart of :data:`EAGER`), its float leaves as 0-d f32 tensors as
    the card's buffers hold them. Returns ``(new_state, value, code)``."""

    def __init__(self, step: Callable[..., Any], leaves: List[Any], array_idx: Tuple[int, ...], treedef: Any,
                 device: torch.device):
        self._step = step
        self._leaves, self._idx, self._treedef = list(leaves), tuple(array_idx), treedef
        self._device = device

    def __call__(self, state: Any, arrays: List[Any]) -> Tuple[Any, Any, torch.Tensor]:
        leaves = list(self._leaves)
        for i, x in zip(self._idx, arrays):
            leaves[i] = _as_device_input(x, self._device)
        a, kw = pytree.tree_unflatten(leaves, self._treedef)
        new, (value, code) = self._step(state, (), a, kw, None)
        return new, value, code


def forward_entry(step: Callable[..., Any], leaves: List[Any], array_idx: Tuple[int, ...], treedef: Any,
                  device: torch.device, keepalive: Tuple[Any, ...] = ()) -> Any:
    """The compiled forward's entry for one input signature on ``device``:
    a :class:`CapturedForward` on a CUDA device, an :class:`EagerForward`
    on the CPU. The device alone picks it."""
    if device.type == "cuda":
        return CapturedForward(step, leaves, array_idx, treedef, device, keepalive)
    return EagerForward(step, leaves, array_idx, treedef, device)
