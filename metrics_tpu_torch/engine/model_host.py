"""Embedded-model serving: a shared, bucketed, coalescing model host (port of ``metrics_tpu/engine/model_host.py``).

FID's InceptionV3 and BERTScore's encoder are inference workloads inside a
metric. A :class:`ModelHost` owns one resident model and serves feature
requests from any number of metric streams:

* **One resident model, many streams.** :func:`shared_host` dedupes hosts by
  a structural key (kind, a fingerprint of the weights, tap, precision,
  buckets, device), so FID and KID over the same weights resolve to ONE
  host and one copy of its weights.
* **Bucketed, coalesced requests.** A worker thread concatenates compatible
  queued requests (up to ``coalesce``, waiting ``coalesce_window_ms`` for
  more), cuts the megabatch into the chunks of the port's
  :class:`~metrics_tpu_torch.engine.bucketing.BucketPolicy`, and pads each
  to its bucket. On the card each (bucket, input signature, precision) is one
  forward captured into a CUDA graph through the host's
  :class:`~metrics_tpu_torch.engine.aot.AotCache`, on the worker thread, and
  replayed after; a warm host captures nothing (``aot.misses``). On the CPU
  the entry is eager and counts the same way.
* **Precisions.** ``"f32"`` runs the forward under :func:`full_f32` and is
  the oracle: at a padded shape its features are bit-equal to the direct
  forward at that shape. ``"bf16"`` runs the model's compute-dtype path (a
  generic forward: float inputs cast in, float outputs cast back out).
  ``"int8"`` runs the f32 forward, then sends every float output through the
  q8_block codec on the device (:func:`q8_roundtrip_traced`), so its error
  is the world-1 round trip, bounded by ``q8_sum_error_bound``.

``full_f32`` sets process-global settings (``utils/precision.py``): while the
worker runs an f32 forward, another thread's bf16 convolutions also run
strict.

Meshes (``ModelHostConfig(mesh=..., mesh_axis=...)``, ``parallel/embedded.py``):
the bucket divisor is the axis size, and the parameters are placed once, in
the layout of the mode (``param_shardings``, the forward's ``place``):

* :func:`inception_host` takes the hybrid layout, a tensor-parallel stem
  over the 128-lane padded stem (``stem_lanes=128``: the widths
  128/128/128/128/192 divide over the axis) then a data-parallel trunk; its
  only collective is ``all_gather``;
* :func:`encoder_host` with ``stage_fn``/``stage_params``/``embed_fn`` takes
  the pipeline layout, stage ``s``'s parameters on shard ``s``; its only
  collective is ``ppermute``.

The registry key holds the mesh (``_mesh_fingerprint``) and the layout
(``"stem_tensor"``, ``"pipeline"`` or ``"single"``); the telemetry says
``sharding: "mesh"``. On a mesh of one device the whole sharded forward of a
bucket is one captured graph on that device. A CUDA graph spans one device,
so across devices each shard's piece of work between two collectives is a
graph of its own on its device (:class:`ShardGraphs`: each shard's slice of
each stem layer and its trunk; each stage's microbatch step and the
embeddings), and the gathers and hand-offs run between the replays. The
on-disk compile cache (``cache_dir=``; a CUDA graph holds a process's
addresses) raises ``NotPortedError``.
"""
import functools
import hashlib
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from metrics_tpu_torch.engine.aot import EAGER, AotCache, CapturedStep, _fingerprint_value, _ForwardBuffers, \
    _mesh_fingerprint
from metrics_tpu_torch.engine.bucketing import BucketPolicy
from metrics_tpu_torch.parallel.mesh import Mesh
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device
from metrics_tpu_torch.utils.exceptions import NotPortedError
from metrics_tpu_torch.utils.precision import full_f32
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "HOST_PRECISIONS",
    "HostStats",
    "ModelHost",
    "ModelHostConfig",
    "ShardGraphs",
    "encoder_host",
    "inception_host",
    "q8_roundtrip_traced",
    "reset_host_registry",
    "shared_host",
]

Tensor = torch.Tensor

#: activation precision policies; "f32" is the default and the bit-exactness oracle
HOST_PRECISIONS = ("f32", "bf16", "int8")

CACHE_DIR_NOT_PORTED = ("ModelHostConfig(cache_dir=...) has no counterpart: a captured CUDA graph holds one "
                        "process's device addresses, so there is no on-disk compile cache")


@dataclass(frozen=True)
class ModelHostConfig:
    """Serving configuration of one resident embedded model.

    Args:
        buckets: allowed padded batch sizes (ascending; an oversized request
            splits into max-bucket chunks and a bucketed remainder).
        precision: ``"f32"``, ``"bf16"`` or ``"int8"`` (module docstring).
        coalesce: most requests concatenated into one megabatch.
        coalesce_window_ms: how long the worker waits for more compatible
            requests once it holds one (0 serves at once).
        queue_depth: bound on queued requests (a full queue blocks ``submit``).
        mesh / mesh_axis: serve the model's sharded layout over this
            :class:`~metrics_tpu_torch.parallel.mesh.Mesh` axis.
        cache_dir: has no counterpart (``NotPortedError``).
    """

    buckets: Tuple[int, ...] = (8, 32)
    precision: str = "f32"
    coalesce: int = 8
    coalesce_window_ms: float = 2.0
    queue_depth: int = 64
    mesh: Optional[Any] = None
    mesh_axis: str = "dp"
    cache_dir: Optional[str] = None

    def __post_init__(self) -> None:
        if self.precision not in HOST_PRECISIONS:
            raise ValueError(f"precision must be one of {HOST_PRECISIONS}, got {self.precision!r}")
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise ValueError(
                f"ModelHostConfig.mesh must be a metrics_tpu_torch.parallel.mesh.Mesh (MeshConfig(...).make_mesh()), "
                f"got {type(self.mesh).__name__}"
            )
        if self.cache_dir is not None:
            raise NotPortedError(CACHE_DIR_NOT_PORTED)


def q8_roundtrip_traced(x: Tensor) -> Tensor:
    """The q8_block encode -> decode of a float tensor on its device (no host
    read, capturable): the ``"int8"`` path's activation transport, equal to
    the world-1 quantized sum."""
    from metrics_tpu_torch.parallel.collectives import Q8_BLOCK, _q8_encode

    codes, scales = _q8_encode(x)
    vals = codes.to(torch.float32).reshape(-1, Q8_BLOCK) * scales[:, None]
    return vals.reshape(-1)[: x.numel()].reshape(x.shape).to(x.dtype)


class _Stop:
    pass


_STOP = _Stop()


class _Request:
    __slots__ = ("args", "n", "sig", "future")

    def __init__(self, args: Tuple[Tensor, ...], sig: Tuple) -> None:
        self.args = args
        self.n = int(args[0].shape[0])
        self.sig = sig
        self.future: "queue.Queue" = queue.Queue(maxsize=1)


class HostStats:
    """Thread-safe counters and throughput of one host (the ``model_host_*``
    OpenMetrics families)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests = 0
        self.items = 0
        self.padded_items = 0
        self.coalesced_batches = 0
        self.batches = 0
        self.bucket_hits: Dict[int, int] = {}
        self.busy_seconds = 0.0

    def record(self, requests: int, items: int, padded: int, buckets: Sequence[int], busy: float) -> None:
        with self._lock:
            self.requests += requests
            self.items += items
            self.padded_items += padded
            self.batches += 1
            if requests > 1:
                self.coalesced_batches += 1
            for b in buckets:
                self.bucket_hits[b] = self.bucket_hits.get(b, 0) + 1
            self.busy_seconds += busy

    def items_per_s(self) -> float:
        with self._lock:
            return self.items / self.busy_seconds if self.busy_seconds > 0 else 0.0


def _as_tensor(a: Any) -> Tensor:
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.array(a, copy=True, order="C"))
    return torch.as_tensor(a)


class ShardGraphs:
    """The shards' pieces of a mesh forward across cards, each a captured
    graph on its device. A collective sits between two pieces of a shard's
    work (a gather after each stem layer, a hand-off after each pipeline
    step) and a CUDA graph spans one device, so ``self(tag, fn, *xs)``
    captures ``fn`` over fixed input buffers on ``xs``' device, once a
    (tag, device, input signature), through an :class:`AotCache` of its own
    (``self.aot``: misses are captures, hits replays), and replays it on the
    device's current stream; the collectives run between the replays. A
    tag names one piece of the forward, and ``fn`` stays what it was at the
    capture (the host's resident parameters). On a mesh of one device, or
    off the card, a piece runs as it is: there the host captures the whole
    forward."""

    def __init__(self, mesh: Optional[Mesh]) -> None:
        self.enabled = mesh is not None and mesh.transport == "nccl"
        self.aot = AotCache()

    def __call__(self, tag: str, fn: Callable[..., Any], *xs: Tensor) -> Any:
        dev = xs[0].device
        if not self.enabled or dev.type != "cuda":
            return fn(*xs)

        def build() -> CapturedStep:
            leaves, treedef = pytree.tree_flatten((xs, {}))
            inputs = _ForwardBuffers(leaves, tuple(range(len(leaves))), treedef, dev)
            prog = CapturedStep((), (), inputs, keepalive=(fn,), extra_out=True)
            inputs.fill(leaves)
            self.aot.capture(prog, lambda _s, _a, a, _kw, _m: ((), fn(*a)), dev)
            return prog

        prog = self.aot.get_or_capture((tag, str(dev), AotCache.signature_of(xs)), build)
        with self.aot.exclusive(torch.cuda.current_stream(dev)):
            prog.inputs.fill(list(xs))
            return prog.replay((), ())[1]


class ModelHost:
    """One resident embedded model served on ``device`` (default ``cuda``).

    ``forward(params, *batch) -> features`` takes batch-carried tensors (a
    leading batch dimension each) and returns per-row outputs (a tensor or a
    pytree of them); pad rows are sliced off before results reach a caller.
    ``forward`` may be a dict ``{precision: callable}``; a missing ``"bf16"``
    or ``"int8"`` entry wraps the ``"f32"`` one.

    ``infer(*batch)`` submits and waits; ``submit(*batch)`` returns a handle
    whose ``.get()`` gives the rows (tensors on ``device``) or the serving
    error, so several streams can overlap their requests.

    With ``config.mesh`` the host serves on the mesh (``device`` is its first
    shard's): the buckets divide by the axis size, and ``param_shardings``,
    a placement of ``params`` (the forward's ``place``), lays the parameters
    out once. ``shard_graphs``: the :class:`ShardGraphs` that the forward's
    pieces run through across cards.
    """

    def __init__(
        self,
        kind: str,
        forward: Any,
        params: Any,
        *,
        config: Optional[ModelHostConfig] = None,
        fingerprint: Optional[str] = None,
        unit: str = "items",
        allowed_collectives: Tuple[str, ...] = (),
        param_shardings: Optional[Any] = None,
        aot: Optional[AotCache] = None,
        shard_graphs: Optional[ShardGraphs] = None,
        device: DeviceLike = None,
    ) -> None:
        self.kind = str(kind)
        self.config = config or ModelHostConfig()
        self.unit = str(unit)
        self.allowed_collectives = tuple(allowed_collectives)
        mesh = self.config.mesh
        self.device = mesh.axis(self.config.mesh_axis).devices[0] if mesh is not None else resolve_device(device)
        self.stats = HostStats()
        # `is not None`: a shared but still empty AotCache is falsy (len 0)
        self.aot = aot if aot is not None else AotCache()
        self.shard_graphs = shard_graphs
        self.shared_by = 1  # bumped by shared_host on every dedup hit

        fwd_map = dict(forward) if isinstance(forward, dict) else {"f32": forward}
        precision = self.config.precision
        if precision == "bf16" and "bf16" not in fwd_map:
            fwd_map["bf16"] = _bf16_wrap(fwd_map["f32"])
        if precision == "int8" and "int8" not in fwd_map:
            fwd_map["int8"] = _q8_wrap(fwd_map["f32"])
        self._fwd = fwd_map[precision]

        if fingerprint is None:
            h = hashlib.sha256()
            _fingerprint_value(pytree.tree_leaves(params), h)
            fingerprint = h.hexdigest()[:16]
        self.fingerprint = str(fingerprint)
        divisor = mesh.axis(self.config.mesh_axis).world if mesh is not None else 1
        self._policy = BucketPolicy(self.config.buckets, divisor=divisor)
        # the parameters are resident: placed once, in the layout of the mode
        self.params = param_shardings(params) if param_shardings is not None else params

        self._queue: "queue.Queue" = queue.Queue(maxsize=self.config.queue_depth)
        self._carry: Optional[Any] = None
        self._closed = False
        self._worker_error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, name=f"model-host-{kind}", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- request path

    def submit(self, *batch: Any) -> "queue.Queue":
        """Enqueue one feature request; the handle's ``.get()`` yields the
        per-row outputs or raises nothing itself (it returns the error)."""
        if self._closed:
            raise RuntimeError(f"ModelHost({self.kind}) is closed")
        args = tuple(_as_tensor(a) for a in batch)
        if not args or any(a.ndim == 0 for a in args):
            raise ValueError("ModelHost.submit needs batch-carried array arguments")
        n = args[0].shape[0]
        if any(a.shape[0] != n for a in args):
            raise ValueError(f"ModelHost.submit: inconsistent leading dims {[tuple(a.shape) for a in args]}")
        # keyed by the caller's dtypes, as JAX's host keys its numpy arguments; float64 then
        # narrows to float32, as the JAX package's inputs do with x64 off
        sig = tuple((tuple(a.shape[1:]), str(a.dtype)) for a in args)
        args = tuple(a.to(torch.float32) if a.dtype == torch.float64 else a for a in args)
        req = _Request(args, sig)
        self._queue.put(req)
        return req.future

    def infer(self, *batch: Any) -> Any:
        """Synchronous feature request: submit, wait, return (or raise)."""
        out = self.submit(*batch).get()
        if isinstance(out, BaseException):
            raise out
        return out

    # ------------------------------------------------------------------ worker

    def _run(self) -> None:
        while True:
            req = self._carry or self._queue.get()
            self._carry = None
            if isinstance(req, _Stop):
                return
            group = [req]
            rows = req.n
            deadline = time.monotonic() + self.config.coalesce_window_ms / 1000.0
            while len(group) < self.config.coalesce and rows < self._policy.buckets[-1]:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if isinstance(nxt, _Stop) or nxt.sig != req.sig:
                    self._carry = nxt  # served next round (or the stop after this group)
                    break
                group.append(nxt)
                rows += nxt.n
            try:
                self._serve(group)
            except BaseException as e:  # noqa: BLE001 - delivered to the waiters
                self._worker_error = e
                for r in group:
                    r.future.put(e)

    def _serve(self, group: List[_Request]) -> None:
        n_args = len(group[0].args)
        mega = tuple(torch.cat([r.args[i].to(self.device) for r in group]) if len(group) > 1
                     else group[0].args[i].to(self.device) for i in range(n_args))
        total = int(mega[0].shape[0])
        t0 = time.perf_counter()
        chunk_outs: List[Any] = []
        buckets_used: List[int] = []
        padded = 0
        for start, stop, bucket in self._policy.chunks(total):
            a, _kw, _mask = self._policy.pad_chunk(mega, {}, start, stop, bucket)
            a = tuple(x.contiguous() for x in a)
            padded += bucket - (stop - start)
            buckets_used.append(bucket)
            out = self._run_program(a)
            chunk_outs.append(pytree.tree_map(lambda o: o[: stop - start], out))
        merged = chunk_outs[0] if len(chunk_outs) == 1 else pytree.tree_map(
            lambda *xs: torch.cat(xs), *chunk_outs)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()  # the rows exist before their waiters read them
        self.stats.record(len(group), total, padded, buckets_used, time.perf_counter() - t0)
        off = 0
        for r in group:
            r.future.put(pytree.tree_map(lambda o, lo=off, n=r.n: o[lo:lo + n], merged))
            off += r.n

    # ---------------------------------------------------------------- programs

    def _step(self, state: Any, aux: Any, a: Tuple[Tensor, ...], kw: Dict[str, Any], mask: Any) -> Any:
        """The captured forward: ``((), outputs)`` (no carried state)."""
        if self.config.precision == "bf16":
            return (), self._fwd(self.params, *a)
        with full_f32():
            return (), self._fwd(self.params, *a)

    def _program_key(self, padded_args: Tuple[Tensor, ...]) -> Tuple:
        mesh = self.config.mesh
        return self.aot.program_key(f"model_host_{self.kind}", self.fingerprint, arg_tree=padded_args,
                                    device=self.device, precision=self.config.precision,
                                    mesh=_mesh_fingerprint(mesh) if mesh is not None else None)

    def _run_program(self, padded_args: Tuple[Tensor, ...]) -> Any:
        """One padded chunk through its bucket's entry: captured on the card
        (on a miss, here on the worker thread), eager on the CPU. Across
        cards the entry only counts the bucket: the forward's pieces replay
        their own graphs (:class:`ShardGraphs`) between the collectives."""
        key = self._program_key(padded_args)
        mesh = self.config.mesh
        if self.device.type != "cuda" or (mesh is not None and mesh.transport == "nccl"):
            self.aot.get_or_capture(key, lambda: EAGER)
            with torch.no_grad():
                return self._step((), (), padded_args, {}, None)[1]

        def build() -> CapturedStep:
            leaves, treedef = pytree.tree_flatten((padded_args, {}))
            inputs = _ForwardBuffers(leaves, tuple(range(len(leaves))), treedef, self.device)
            prog = CapturedStep((), (), inputs, keepalive=(self.params,), extra_out=True)
            inputs.fill(list(padded_args))
            with torch.no_grad():
                self.aot.capture(prog, self._step, self.device)
            return prog

        prog = self.aot.get_or_capture(key, build)
        with self.aot.exclusive(torch.cuda.current_stream(self.device)):
            prog.inputs.fill(list(padded_args))
            return prog.replay((), ())[1]

    # --------------------------------------------------------------- telemetry

    def counters(self) -> Dict[str, int]:
        s = self.stats
        return {
            "requests": s.requests,
            "items": s.items,
            "padded_items": s.padded_items,
            "batches": s.batches,
            "coalesced_batches": s.coalesced_batches,
            "bucket_hits": self.aot.hits,
            "bucket_compiles": self.aot.misses,
            "shared_by": self.shared_by,
        }

    def telemetry(self) -> Dict[str, Any]:
        """One JSON-able snapshot (the ``model_host`` section of an engine telemetry doc)."""
        return {
            "kind": self.kind,
            "unit": self.unit,
            "precision": self.config.precision,
            "buckets": list(self._policy.buckets),
            "sharding": "none" if self.config.mesh is None else "mesh",
            "allowed_collectives": list(self.allowed_collectives),
            "counters": self.counters(),
            "bucket_hit_histogram": {str(k): v for k, v in sorted(self.stats.bucket_hits.items())},
            "items_per_s": self.stats.items_per_s(),
            "busy_seconds": self.stats.busy_seconds,
            "aot": self.aot.stats(),
            "device": str(self.device),
        }

    def metrics_text(self) -> str:
        """OpenMetrics exposition of the ``model_host_*`` families."""
        from metrics_tpu_torch.engine.trace import render_openmetrics

        counters = self.counters()
        requests = counters.pop("requests")
        return render_openmetrics(
            counters,
            labeled_counters={"requests": ("precision", {self.config.precision: requests})},
            gauges={f"{self.unit}_per_s": self.stats.items_per_s()},
            prefix="metrics_tpu_model_host_",
        )

    # --------------------------------------------------------------- lifecycle

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(_STOP)
        self._worker.join(timeout=30)

    def __enter__(self) -> "ModelHost":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _bf16_wrap(base: Callable) -> Callable:
    """The generic bf16 path: float inputs cast to bf16 on the way in, float
    outputs back to f32 on the way out."""

    def fwd(params: Any, *batch: Tensor) -> Any:
        cast = tuple(b.to(torch.bfloat16) if b.is_floating_point() else b for b in batch)
        return pytree.tree_map(lambda o: o.to(torch.float32) if o.is_floating_point() else o, base(params, *cast))

    return fwd


def _q8_wrap(base: Callable) -> Callable:
    """The generic int8 path: the f32 forward, then every float output
    through the q8_block codec on the device."""

    def fwd(params: Any, *batch: Tensor) -> Any:
        return pytree.tree_map(lambda o: q8_roundtrip_traced(o) if o.is_floating_point() else o,
                               base(params, *batch))

    return fwd


# ------------------------------------------------------------- shared registry

_REGISTRY: Dict[Tuple, ModelHost] = {}
_REGISTRY_LOCK = threading.Lock()


def shared_host(key: Tuple, factory: Callable[[], ModelHost]) -> ModelHost:
    """Resolve ``key`` to ONE resident host: the first caller builds it, every
    later caller with the same key gets the same instance, ``shared_by``
    bumped. A closed host is evicted and rebuilt."""
    with _REGISTRY_LOCK:
        host = _REGISTRY.get(key)
        if host is not None and not host._closed:
            host.shared_by += 1
            return host
        host = factory()
        _REGISTRY[key] = host
        return host


def reset_host_registry() -> None:
    """Close and drop every registered host (test isolation)."""
    with _REGISTRY_LOCK:
        hosts = list(_REGISTRY.values())
        _REGISTRY.clear()
    for h in hosts:
        h.close()


# ------------------------------------------------------------- the models' hosts


def inception_host(
    feature: str = "2048",
    params: Optional[Any] = None,
    *,
    config: Optional[ModelHostConfig] = None,
    input_size: int = 299,
    seed: int = 0,
    stem_lanes: Optional[int] = None,
    shared: bool = True,
    device: DeviceLike = None,
) -> ModelHost:
    """Build (or resolve from the registry) the resident InceptionV3 host.

    Single-device: the canonical module forward, captured per bucket:
    ``precision="f32"`` features are bit-equal to
    ``InceptionFeatureExtractor``'s at the same padded shape; ``"bf16"`` is
    the module's compute-dtype path; ``"int8"`` sends the tap through the
    q8_block codec. With ``config.mesh``: the hybrid layout, a
    tensor-parallel stem over the 128-lane padded stem parameters
    (``stem_lanes`` defaults to 128; each shard one output-channel slice of
    each stem layer) then a data-parallel trunk
    (``parallel.embedded.stem_tensor_batch_forward``), whose only collective
    is ``all_gather``. ``params`` is the port's state dict or the JAX
    package's Flax variables; without them the seeded fill.
    ``shared=True`` routes through :func:`shared_host`: FID and KID over the
    same (tap, weights, mesh, precision, buckets, device) get ONE model.
    """
    from metrics_tpu_torch.models.inception import FEATURE_DIMS, _as_state_dict, random_inception_params

    feature = str(feature)
    if feature not in FEATURE_DIMS:
        raise ValueError(f"feature must be one of {tuple(FEATURE_DIMS)}, got {feature!r}")
    config = config or ModelHostConfig()
    dev = config.mesh.axis(config.mesh_axis).devices[0] if config.mesh is not None else resolve_device(device)
    if params is None:
        rank_zero_warn(
            "No pretrained InceptionV3 params provided (no network egress in this build); the model host is using"
            " the seeded random fill. Pass `params=` (converted torch-fidelity weights) for meaningful FID/KID"
            " values.",
            UserWarning,
        )
        params = random_inception_params(input_size=input_size, seed=seed)
    if config.mesh is not None and stem_lanes is None:
        stem_lanes = 128  # the padded stem's widths double as the tensor-shard grain
    state = _as_state_dict(params)
    h = hashlib.sha256()
    _fingerprint_value(state, h)  # names, dtypes, shapes and values (large tensors sampled)
    fp = h.hexdigest()[:16]
    key = ("inception", feature, fp, _mesh_fingerprint(config.mesh),
           "stem_tensor" if config.mesh is not None else "single", config.precision, tuple(config.buckets),
           stem_lanes, str(dev))

    def factory() -> ModelHost:
        return _build_inception_host(feature, state, config, stem_lanes, fp, dev)

    return shared_host(key, factory) if shared else factory()


def _build_inception_host(feature: str, state: Dict[str, Tensor], config: ModelHostConfig,
                          stem_lanes: Optional[int], fp: str, device: torch.device) -> ModelHost:
    from metrics_tpu_torch.models.inception import InceptionV3, _nchw, pad_stem_params, split_stem_variables, stem_apply

    dtype = torch.bfloat16 if config.precision == "bf16" else None
    padded = pad_stem_params(state, stem_lanes) if stem_lanes is not None else state

    def module_on(dev: torch.device) -> InceptionV3:
        module = InceptionV3(compute_dtype=dtype, stem_lanes=stem_lanes)
        module.load_state_dict(padded)
        return module.to(dev).eval().requires_grad_(False)

    if config.mesh is None:
        module = module_on(device)

        def fwd(_params: Any, imgs: Tensor) -> Tensor:
            return module(_nchw(imgs, device))[feature].to(torch.float32)

        # the module's own bf16 path serves "bf16"; "int8" wraps the f32 forward
        return ModelHost("inception", {"f32": fwd, "bf16": fwd}, dict(module.state_dict()), config=config,
                         fingerprint=fp, unit="imgs", device=device)

    from metrics_tpu_torch.parallel.embedded import stem_tensor_batch_forward

    # the hybrid layout: the stem's channel slices and one trunk module a
    # device, laid out once (the modules' own stem weights go unread)
    mesh, axis = config.mesh, config.mesh_axis
    graphs = ShardGraphs(mesh)

    def stem_fn(sv: Any, xs: Any, gather_axis: Any) -> Any:
        return stem_apply(sv, xs, compute_dtype=dtype, stem_lanes=stem_lanes, gather_axis=gather_axis,
                          segment=graphs)

    def trunk_fn(module: Any, x_local: Tensor) -> Dict[str, Tensor]:
        return graphs("trunk", module.trunk, x_local)

    sharded = stem_tensor_batch_forward(stem_fn, trunk_fn, mesh, axis)

    def hybrid(p: Any, imgs: Tensor) -> Tensor:
        return sharded(p["stem"], p["trunk"], _nchw(imgs, device))[feature].to(torch.float32)

    def place(params: Dict[str, Tensor]) -> Dict[str, Any]:
        stem, trunk = sharded.place(split_stem_variables(params)[0], module_on(device))
        return {"stem": stem, "trunk": trunk}

    return ModelHost("inception", {"f32": hybrid, "bf16": hybrid}, padded, config=config, fingerprint=fp,
                     unit="imgs", allowed_collectives=("all_gather",), param_shardings=place, shard_graphs=graphs)


def encoder_host(
    forward_fn: Optional[Callable] = None,
    *,
    stage_fn: Optional[Callable] = None,
    stage_params: Optional[Any] = None,
    embed_fn: Optional[Callable] = None,
    config: Optional[ModelHostConfig] = None,
    fingerprint: Optional[str] = None,
    shared: bool = True,
    device: DeviceLike = None,
) -> ModelHost:
    """Build (or resolve) the resident text-encoder host of BERTScore. Two
    layouts:

    * ``forward_fn(input_ids, attention_mask) -> (B, L, D)``, any encoder
      callable, served single-device through the host's buckets, coalescing
      and captured forwards;
    * ``stage_fn`` + ``stage_params`` (+ ``embed_fn(ids, mask)``): a
      pipeline-decomposed encoder over ``config.mesh``, the stage parameters
      stacked ``(S, ...)`` with row ``s`` on shard ``s``, activations handed
      shard to shard (``parallel.embedded.pipeline_stage_forward``); its only
      collective is ``ppermute``.
    """
    config = config or ModelHostConfig()
    if (forward_fn is None) == (stage_fn is None):
        raise ValueError("encoder_host needs exactly one of forward_fn / stage_fn")
    if stage_fn is not None:
        if config.mesh is None:
            raise ValueError("pipeline-staged encoder_host needs config.mesh")
        if stage_params is None:
            raise ValueError("stage_fn needs stage_params (stacked (S, ...) pytree)")
        from metrics_tpu_torch.parallel.embedded import pipeline_stage_forward

        mesh = config.mesh
        graphs = ShardGraphs(mesh)
        pipe = pipeline_stage_forward(lambda p, x: graphs("stage", functools.partial(stage_fn, p), x), mesh,
                                      config.mesh_axis)

        def staged(p: Any, ids: Tensor, mask: Tensor) -> Tensor:
            x = graphs("embed", embed_fn, ids, mask) if embed_fn is not None else ids
            return pipe(p, x)

        if fingerprint is None:
            h = hashlib.sha256()
            _fingerprint_value(pytree.tree_leaves(stage_params), h)
            if embed_fn is not None:
                h.update(getattr(embed_fn, "__qualname__", repr(embed_fn)).encode())
            fingerprint = h.hexdigest()[:16]
        key = ("encoder", fingerprint, _mesh_fingerprint(mesh), "pipeline", config.precision, tuple(config.buckets))

        def pipeline_factory() -> ModelHost:
            return ModelHost("encoder", staged, stage_params, config=config, fingerprint=fingerprint, unit="pairs",
                             allowed_collectives=("ppermute",), param_shardings=pipe.place, shard_graphs=graphs)

        return shared_host(key, pipeline_factory) if shared else pipeline_factory()
    dev = config.mesh.axis(config.mesh_axis).devices[0] if config.mesh is not None else resolve_device(device)
    if fingerprint is None:
        fingerprint = getattr(forward_fn, "__qualname__", type(forward_fn).__name__) + f"@{id(forward_fn):x}"

    def fwd(_params: Any, ids: Tensor, mask: Tensor) -> Tensor:
        return forward_fn(ids, mask)

    key = ("encoder", fingerprint, _mesh_fingerprint(config.mesh), "single", config.precision,
           tuple(config.buckets), str(dev))

    def factory() -> ModelHost:
        return ModelHost("encoder", fwd, (), config=config, fingerprint=fingerprint, unit="pairs", device=dev)

    return shared_host(key, factory) if shared else factory()
