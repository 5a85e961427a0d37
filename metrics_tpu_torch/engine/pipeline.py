"""The streaming engine's step: bucket, pad and fold ragged batches into a
carried metric state on the card.

Port of the synchronous core of ``metrics_tpu/engine/pipeline.py``. A caller
``submit``s ragged batches; each is split into bucketed chunks
(``engine/bucketing.py``), padded with an inert fill and a validity mask, and
folded into the carried state at once, on the caller's thread. With
``use_arena=True`` (the default) the carried state is the per-dtype arena
(``engine/arena.py``). The step is the metric's masked update, whose per-leaf
folds are the K1 kernel; under ``kernel_backend="megastep"`` it is
:meth:`MegastepPlan.apply_masked`, one K5 launch per eligible arena dtype.

The JAX engine's dispatcher thread, queue and coalescing, its AOT program
cache, snapshots, fault injection and recovery, tracing, admission control,
windows and meshes are not ported yet (ROADMAP §A): their ``EngineConfig``
fields raise :class:`~metrics_tpu_torch.utils.exceptions.NotPortedError`.
"""
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.engine.arena import ArenaLayout
from metrics_tpu_torch.engine.bucketing import BucketPolicy
from metrics_tpu_torch.engine.megastep import MegastepPlan
from metrics_tpu_torch.utils.data import infer_batch_size
from metrics_tpu_torch.utils.exceptions import KernelBackendError, MetricsTPUUserError, NotPortedError
from metrics_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["EngineConfig", "EngineStats", "StreamingEngine"]

#: ``metrics_tpu.engine.EngineConfig`` fields the port does not have yet
_NOT_PORTED_FIELDS = (
    "max_queue", "in_flight", "coalesce", "coalesce_window_ms", "snapshot_every", "snapshot_dir",
    "compilation_cache_dir", "mesh", "axis", "mesh_sync", "donate", "telemetry_capacity", "snapshot_keep",
    "fault_injector", "screen", "quarantine_capacity", "max_retries", "backoff_base_ms", "backoff_max_ms",
    "step_timeout_s", "transactional", "degrade_kernel", "trace", "admission", "ladder", "elastic_min_world",
    "window", "drift",
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
            decodes on touch.

    Any other field of the JAX package's ``EngineConfig`` raises
    :class:`NotPortedError`.
    """

    def __init__(
        self,
        buckets: Tuple[int, ...] = (256, 1024),
        use_arena: bool = True,
        kernel_backend: Optional[str] = None,
        pad_value: Any = 0,
        compress_payloads: bool = False,
        **fields: Any,
    ) -> None:
        unported = sorted(k for k in fields if k in _NOT_PORTED_FIELDS)
        if unported:
            raise NotPortedError(f"EngineConfig fields {unported} are not ported yet (see ROADMAP.md §A)")
        if fields:
            raise TypeError(f"EngineConfig got unexpected fields {sorted(fields)}")
        self.buckets = tuple(int(b) for b in buckets)
        self.use_arena = bool(use_arena)
        self.kernel_backend = kernel_backend
        self.pad_value = pad_value
        self.compress_payloads = bool(compress_payloads)

    def __repr__(self) -> str:
        return (f"EngineConfig(buckets={self.buckets}, use_arena={self.use_arena}, "
                f"kernel_backend={self.kernel_backend!r}, pad_value={self.pad_value!r}, "
                f"compress_payloads={self.compress_payloads})")


class EngineStats:
    """Counters of one engine: steps, valid and padded rows, kernel fallback
    verdicts, and the pager's page traffic (paged multi-stream engine)."""

    def __init__(self) -> None:
        self.steps = 0
        self.batches_submitted = 0
        self.rows_in = 0
        self.rows_padded = 0
        self.routed_steps = 0
        self.page_hits = 0
        self.page_faults = 0
        self.page_ins = 0
        self.page_outs = 0
        self.q8_staged_rows = 0  # page-ins seated as int8 codes for K7 to decode
        self.kernel_fallbacks: Dict[str, int] = {}

    def record_step(self, bucket: int, valid: int) -> None:
        self.steps += 1
        self.rows_in += int(valid)
        self.rows_padded += int(bucket)

    def record_kernel_fallback(self, reason: str) -> None:
        self.kernel_fallbacks[reason] = self.kernel_fallbacks.get(reason, 0) + 1

    def kernel_fallbacks_by_reason(self) -> Dict[str, int]:
        """Per-reason counts: ``engine:<reason>`` when the engine cannot take
        the megastep path at all, ``dtype.<key>:<why>`` per degraded dtype."""
        return dict(self.kernel_fallbacks)


def _metric_device(metric: Any) -> torch.device:
    if hasattr(metric, "_defaults"):
        return metric.device
    devices = {m.device for _, m in metric.items(keep_base=True)}
    if len(devices) != 1:
        raise MetricsTPUUserError(f"an engine serves one device; the collection's members lie on {sorted(map(str, devices))}")
    return devices.pop()


class StreamingEngine:
    """Drive a ``Metric``/``MetricCollection`` as a stream of ragged batches.

    ``submit`` pads and folds each batch at once; ``result`` computes the
    accumulated value; ``state`` returns a copy of the logical state tree.
    The state lives on the metric's device (``cuda`` by default).
    """

    def __init__(self, metric: Any, config: Optional[EngineConfig] = None):
        self._metric = metric
        self._cfg = config if config is not None else EngineConfig()
        reason = self._update_path_unsupported_reason(metric)
        if reason is not None:
            raise MetricsTPUUserError(f"metric cannot be served by the streaming engine: {reason}")
        self._device = _metric_device(metric)
        self._policy = BucketPolicy(self._cfg.buckets, pad_value=self._cfg.pad_value)
        self._stats = EngineStats()
        self._compress = self._cfg.compress_payloads
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

    # -------------------------------------------------------------------- the step

    def _traced_update(self, state_tree: Any, payload: Any, mask: torch.Tensor) -> Any:
        """The step body on the LOGICAL state tree (the multi-stream engine
        reroutes it to the segmented update)."""
        a, kw = payload
        return self._metric.update_state_masked(state_tree, *a, mask=mask, **kw)

    def _step_state(self, state: Any, a: Tuple[Any, ...], kw: Dict[str, Any], mask: torch.Tensor) -> Any:
        """One padded step on the carried state; returns the new carried state."""
        if self._megastep_plan is not None:
            return self._megastep_plan.apply_masked(state, a, kw, mask)
        return self._pack(self._traced_update(self._unpack(state), (a, kw), mask))

    def _run_padded_step(self, a: Tuple[Any, ...], kw: Dict[str, Any], mask: np.ndarray, bucket: int,
                         valid: int) -> None:
        mask_t = torch.from_numpy(mask).to(self._device)
        self._state = self._step_state(self._state, a, kw, mask_t)
        self._step += 1
        self._stats.record_step(bucket, valid)

    def _execute_payload(self, merged: Tuple[Tuple[Any, ...], Dict[str, Any]], n: int) -> None:
        """Run one (args, kwargs) batch of ``n`` rows through its bucketed chunks."""
        args, kwargs = merged
        for start, stop, bucket in self._policy.chunks(n):
            a, kw, mask = self._policy.pad_chunk(args, kwargs, start, stop, bucket)
            self._run_padded_step(a, kw, mask, bucket, stop - start)

    # ------------------------------------------------------------------ public API

    def submit(self, *args: Any, **kwargs: Any) -> None:
        """Fold one (ragged) batch into the state, on the caller's thread.
        Tensors or numpy arrays; a batch of zero rows is a no-op."""
        n = infer_batch_size(tree_leaves((args, kwargs)))
        if n is None:
            raise ValueError("no array argument with a leading batch dimension")
        self._stats.batches_submitted += 1
        if n > 0:
            self._execute_payload((args, kwargs), n)

    def flush(self) -> None:
        """Block until the device has finished every submitted step."""
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def result(self) -> Any:
        """The metric's value over everything submitted since the last reset."""
        return self._metric.compute_from(self._unpack(self._state))

    def state(self) -> Any:
        """A copy of the accumulated LOGICAL state tree (arenas unpacked)."""
        return tree_map(torch.clone, self._unpack(self._state))

    def reset(self) -> None:
        """Fresh accumulation."""
        self._state = self._put_state(self._init_state_tree())
        self._step = 0

    def __enter__(self) -> "StreamingEngine":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        self.flush()
        return False

    @property
    def steps(self) -> int:
        return self._step

    @property
    def stats(self) -> EngineStats:
        return self._stats

    @property
    def arena_layout(self) -> Optional[ArenaLayout]:
        return self._layout

