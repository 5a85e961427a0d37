"""Metric runtime: state registry, update/compute/reset protocol, masked updates.

Port of the single-process part of ``metrics_tpu/metric.py``. A metric is an
``nn.Module`` whose registered states are buffers, with the JAX package's pure
API kept under the same names, working on dicts of tensors:

    state = m.init_state()                        # dict of tensors
    state = m.update_state(state, preds, target)  # pure
    state = m.update_state_masked(state, preds, target, mask=mask)
    value = m.compute_from(state)                 # pure

The stateful facade (``update``, ``compute``, ``reset``, ``forward``,
``state_dict``) sits on top. ``update_state`` loads the state into the
buffers, runs the subclass ``update`` and snapshots the result, so the
stateful-looking subclass code *is* the pure function body.

A metric held as an attribute of another (a wrapper's inner metrics, the
operands of a :class:`CompositionalMetric`) is a child module: its state
travels inside its parent's under the reserved ``"_children"`` key, with the
JAX package's attribute names, and every function of the pure API recurses
into it. Lists of children are ``nn.ModuleList``s, so ``state_dict`` keys
read ``metrics.0.<state>`` as in the JAX package and ``.to()`` recurses; a
plain non-empty list or tuple of metrics assigned as an attribute becomes
one, since the JAX package takes such a list as children too.

The masked update is the streaming engine's padding contract: the subclass
``update`` runs per row under ``torch.func.vmap`` (batch-of-1 rows), and each
leaf's row-stacked deltas fold into the state through the K1 fold kernel, the
reduction's identity standing in for masked rows. The kernels the update
reaches (K2 histogram, K3 binned counts) are custom ops whose vmap rules
launch once for the whole bucket. States with no row-neutral identity (the
static-capacity curve buffers) take the scan strategy instead: the update
runs row by row in submission order, masked rows carrying the state through.
The segmented update (the multi-stream engine's step) scatters the row deltas
into stream rows through K4.

Cross-process sync runs over a ``torch.distributed`` process group where
the JAX package names a mesh axis: ``sync_axis``/``process_group`` take a
``ProcessGroup`` (``None``: the ambient group of
:func:`~metrics_tpu_torch.parallel.metric_axis`, else the default group).
``compute()`` runs under :meth:`Metric.sync_context`, which syncs eagerly
with the JAX package's multi-host semantics when the group has more than
one rank; :meth:`Metric.sync_states` / :meth:`Metric.compute_synced` are the
pure form, one fused bundle of collectives for the metric and its nested
metrics (``parallel/collectives.py``), with the ``sync_precision`` policy's
q8 leaves; :meth:`Metric.merge_stacked_states` folds a leading stack axis
of per-rank states without communicating. The pure API (``update_state``,
``compute_from``) never communicates.

``forward`` takes the compiled forward first, with the JAX package's
per-signature protocol (``_forward_fast``): the first call of an input
signature runs eagerly and validates eagerly, the second builds the step
``update -> merge -> compute(delta)``, later calls reuse it; a step that
cannot be built or run leaves its signature eager for good. On a CUDA device
the step is one CUDA graph (``engine/aot.py``'s :class:`CapturedForward`)
whose value checks emit deferred codes (``utils/checks.py``), raised at the
next ``compute()``/``sync()``; on the CPU the same body runs eagerly under
the same deferred checks. As in the JAX package, the metric rebinds its
state to the step's output (clones of the graph's buffers on the card), so
a state tensor or a ``compute()`` result kept across a forward keeps its
values.

A metric whose state is a per-GROUP bag of rows that sorts only at compute
time (retrieval's per-query ranking) declares a :class:`GroupedUpdateSpec`:
its masked strategy is ``"grouped"``, the streaming and multi-stream engines
refuse it with a pointer to the ragged engine
(``metrics_tpu_torch.engine.ragged.RaggedEngine``), which serves it.
"""
import contextlib
import functools
import inspect
import threading
import weakref
from copy import deepcopy
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from metrics_tpu_torch.ops.kernels import combine, fold_rows_masked, segment_reduce_masked, stack_reduce
from metrics_tpu_torch.parallel.collectives import (
    SYNC_PRECISIONS,
    all_gather_stack,
    fused_axis_sync,
    group_size,
    in_mapped_context,
    q8_sum_error_bound,
)
from metrics_tpu_torch.parallel.mesh import MeshAxis, current_metric_axis
from metrics_tpu_torch.ops.kernels.common import int32_bits
from metrics_tpu_torch.utils.checks import (
    _is_batched,
    _tracing,
    deferred_message,
    deferred_value_checks,
    traced_rows,
)
from metrics_tpu_torch.utils.data import apply_to_collection, dim_zero_cat, is_batch_leaf
from metrics_tpu_torch.utils.device import DeviceLike, as_input, resolve_device
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

_MERGEABLE_FX = ("sum", "min", "max", "cat")
#: dtypes whose "sum" states may ride a quantized (q8_block) payload
_FLOAT_SUM_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


@dataclass(frozen=True)
class GroupedField:
    """One per-row payload field of a group-keyed (ragged) metric: ``shape``
    is the per-row trailing shape (``()`` for scalars), ``dtype`` the buffered
    torch dtype. The ragged engine stores each field as a
    ``(capacity,) + shape`` buffer per group, rows valid up to the group's
    count."""

    name: str
    shape: Tuple[int, ...]
    dtype: Any


@dataclass(frozen=True)
class GroupedUpdateSpec:
    """The declaration a metric makes to serve through the ragged engine.

    ``fields`` lists the per-row payloads in the order
    :meth:`Metric.grouped_encode` emits them; ``capacity`` is the per-group
    row budget (rows past it overflow loudly, never truncate silently). A
    metric returning one from :meth:`Metric.grouped_update_spec` also
    implements ``grouped_encode`` (validate like ``update``, flatten to
    ``(group_ids, field_0, ...)`` rows), ``grouped_group_value`` (the
    per-group read over ``(capacity, ...)`` buffers and a count) and
    ``grouped_finalize`` (rebuild the eager state from per-group rows: the
    aggregate's oracle).
    """

    fields: Tuple[GroupedField, ...]
    capacity: int

    def field_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)


@dataclass(frozen=True)
class GroupedAggregateSpec:
    """The declaration that a grouped metric's AGGREGATE can run on the
    device instead of the host eager replay.

    * ``"fold"``: the aggregate is a masked mean of independent per-group
      scores. The metric implements ``grouped_batch_scores(counts, fields,
      capacity)`` (batched over the ``(G, capacity, ...)`` buffers, returning
      per-group ``{"value", "keep", "flag"}``) and
      ``grouped_aggregate_finish(value, kept, flagged)`` (host side); the
      engine folds the scores with the masked row kernel (K1).
    * ``"corpus"``: a corpus-level pass that is no per-group mean
      (detection's PR curve). The metric implements
      ``grouped_corpus_scan_fields()`` (the buffers its plan reads),
      ``grouped_corpus_plan(counts, scan)`` (host; ``None`` declines and the
      engine takes the oracle), ``grouped_corpus_device(counts, fields,
      classes, cls_valid, capacity)`` (the device bundle over the stacked
      buffers) and ``grouped_corpus_finish(bundle, plan)`` (host).
    """

    kind: str  # "fold" | "corpus"


class StateSpec:
    """Shape and dtype of one state leaf, with no storage: the port's
    counterpart of ``jax.ShapeDtypeStruct`` in :meth:`Metric.abstract_state`."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: Tuple[int, ...], dtype: torch.dtype) -> None:
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, StateSpec) and (self.shape, self.dtype) == (other.shape, other.dtype)

    def __repr__(self) -> str:
        return f"StateSpec({self.shape}, {self.dtype})"


def sync_precision_tag_of(precisions: Dict[str, str]) -> str:
    """The canonical tag of a sync-precision map (``"exact"`` or
    ``"q8:<digest>"`` over the sorted quantized paths), shared by ``Metric``
    and ``MetricCollection``."""
    quantized = sorted(f"{k}={v}" for k, v in precisions.items() if v != "exact")
    if not quantized:
        return "exact"
    import hashlib

    return "q8:" + hashlib.sha256(";".join(quantized).encode()).hexdigest()[:10]


def distributed_available(group: Optional[Any] = None) -> bool:
    """True when metric state can differ across ranks: ``group`` (None = the
    default group) is initialised here and has more than one rank."""
    return in_mapped_context(group)


_PURE = threading.local()


@contextlib.contextmanager
def _pure_call():
    """While the pure API runs (a wrapper's ``compute`` reaching a child's
    wrapped ``compute`` inside ``compute_from``), no sync communicates: the
    state handed in is the one to compute, synced or not."""
    _PURE.depth = getattr(_PURE, "depth", 0) + 1
    try:
        yield
    finally:
        _PURE.depth -= 1


def _check_group(name: str, group: Any) -> None:
    if isinstance(group, str):
        raise TypeError(
            f"`{name}` takes a torch.distributed ProcessGroup (None: the default group), not a mesh axis "
            f"name ({group!r}): create the group with torch.distributed.new_group"
        )


def _check_list_lengths(entries: List[Tuple["Metric", str, Any]], group: Any) -> None:
    """One small gather of every list state's row count and size: ranks
    whose lists differ raise, naming the states, rather than hang or
    gather garbage (the JAX package's all-gather cannot take them either)."""
    lists = [(m, k, v) for m, k, v in entries if isinstance(v, list)]
    if not lists:
        return
    sizes = []
    for _, _, v in lists:
        cat = dim_zero_cat(v) if v else torch.zeros((0,))
        sizes += [int(cat.shape[0]), int(cat.numel())]
    gathered = all_gather_stack(torch.tensor(sizes, dtype=torch.int64, device=lists[0][0].device), group).cpu()
    bad = [f"{type(m).__name__}.{k} (rows per rank: {gathered[:, 2 * i].tolist()})"
           for i, (m, k, _) in enumerate(lists)
           if not bool((gathered[:, 2 * i : 2 * i + 2] == gathered[0, 2 * i : 2 * i + 2]).all())]
    if bad:
        raise MetricsTPUUserError(
            f"list states differ in size across ranks and cannot be gathered: {', '.join(bad)}"
        )


def _sync_entries(entries: List[Tuple["Metric", str, Any]], group: Any, eager: bool) -> List[Any]:
    """Sync ``(metric, state name, value)`` entries over ``group`` in one fused
    bundle. List states are concatenated first (fx=None gathers them flat,
    as ``cat``). ``eager`` is the multi-host semantics of ``sync()``: exact
    precisions, list states returned as a one-element list, ``dist_sync_fn``
    not called; otherwise a metric's ``dist_sync_fn`` takes its leaves as
    ``(fx, value, group)`` and its ``sync_precision`` policy applies. Over a
    :class:`~metrics_tpu_torch.parallel.mesh.MeshAxis` each value is the list
    of the W shards' values, and so is each result: the axis is no process
    group, so ``dist_sync_fn`` is not called, and list states, which have
    no fixed shape to gather, raise."""
    mesh = isinstance(group, MeshAxis)
    if mesh:
        for m, k, v in entries:
            if isinstance(v[0], list):
                raise MetricsTPUUserError(
                    f"{type(m).__name__}.{k} is a list state: a mesh sync gathers fixed-shape states only")
    else:
        _check_list_lengths(entries, group)
    results: List[Any] = [None] * len(entries)
    bundle: List[Tuple[Any, Any]] = []
    precs: List[str] = []
    slots: List[int] = []
    for j, (m, k, v) in enumerate(entries):
        was_list = not mesh and isinstance(v, list)
        fx = m._reductions[k]
        fx = "cat" if fx is None and was_list else fx
        if was_list:
            v = dim_zero_cat(v) if v else torch.zeros((0,), device=m.device)
        if not eager and not mesh and m.dist_sync_fn is not None:
            results[j] = m.dist_sync_fn(fx, v, group)
            continue
        bundle.append((fx, v))
        precs.append("exact" if eager or was_list else m._sync_precision.get(k, "exact"))
        slots.append(j)
    for j, synced in zip(slots, fused_axis_sync(bundle, group, precisions=precs) if bundle else []):
        results[j] = [synced] if eager and isinstance(entries[j][2], list) else synced
    return results


def _sync_trees(pairs: List[Tuple["Metric", Any]], group: Any) -> List[Any]:
    """The pure sync of several ``(metric, state)`` pairs (a collection's
    members) in one fused bundle; the synced states, in order. Unchanged
    without an initialised group, or outside ``group``. Over a
    :class:`~metrics_tpu_torch.parallel.mesh.MeshAxis` each state is the list
    of the W shards' states (shard ``k`` on the axis's device ``k``), and so
    is each result."""
    mesh = isinstance(group, MeshAxis)
    if not mesh and group_size(group) < 1:
        return [state for _, state in pairs]
    n = group.world if mesh else 1
    shards = [states if mesh else [states] for _, states in pairs]
    for states in shards:
        if len(states) != n:
            raise MetricsTPUUserError(f"a mesh sync over {n} shards got {len(states)} shard states")
    per_shard: List[List[Tuple[Metric, str, Any]]] = [[] for _ in range(n)]
    for (metric, _), states in zip(pairs, shards):
        for k in range(n):
            metric._sync_tree_entries(states[k], per_shard[k])
    entries = per_shard[0]
    for m in {id(m): m for m, _, _ in entries}.values():
        m._check_spec_consumed()
    if mesh:
        entries = [(m, key, [shard[j][2] for shard in per_shard]) for j, (m, key, _) in enumerate(entries)]
    synced = _sync_entries(entries, group, eager=False)
    built = []
    for k in range(n):
        it = iter([s[k] for s in synced] if mesh else synced)
        built.append([metric._sync_tree_build(states[k], it) for (metric, _), states in zip(pairs, shards)])
    return [list(col) for col in zip(*built)] if mesh else built[0]


class _InstanceCache:
    """``owner -> {signature: entry}`` for the compiled forward, keyed by
    ``id(owner)``. A ``weakref.WeakKeyDictionary`` would compare its keys
    with ``==``, and a metric's ``==`` builds a :class:`CompositionalMetric`
    (a truthy module): every lookup would build one, and two live metrics
    whose hashes collide would share an entry. Here a lookup calls neither
    ``__eq__`` nor ``__hash__`` and never pins the owner: a
    ``weakref.finalize`` drops its entries when it is collected, before its
    id can be reused. A clone or an unpickled copy is another object, so it
    starts with no entries."""

    def __init__(self) -> None:
        self._entries: Dict[int, Dict[Any, Any]] = {}

    def get(self, owner: Any, default: Any = None) -> Any:
        return self._entries.get(id(owner), default)

    def open(self, owner: Any) -> Dict[Any, Any]:
        """The owner's entries, made empty on first use (``TypeError`` for
        an owner that takes no weak reference)."""
        key = id(owner)
        cache = self._entries.get(key)
        if cache is None:
            weakref.finalize(owner, self._entries.pop, key, None)
            cache = self._entries[key] = {}
        return cache

    def drop(self, owner: Any) -> None:
        """Forget every entry of ``owner``: its signatures start over."""
        cache = self._entries.get(id(owner))
        if cache is not None:
            cache.clear()

    def __len__(self) -> int:
        return len(self._entries)


# forward()'s compiled-step cache: instance -> {signature: entry | _EAGER_ONLY | _PENDING}
_FORWARD_JIT_CACHE = _InstanceCache()
_EAGER_ONLY = object()  # sentinel: this signature cannot be built or run - stay eager for good
_PENDING = object()  # sentinel: first call seen eagerly; build on the next one
_MISS = object()  # sentinel: fast path not taken this call


def _jit_cache_lookup(owner: Any, sig: Any, builder: Callable):
    """The per-signature protocol shared by ``Metric._forward_fast`` and
    ``MetricCollection._forward_fused``: the 1st call registers _PENDING (the
    caller runs eagerly, validating), the 2nd call invokes ``builder``, later
    calls reuse its entry.

    Returns ``(entry, cache)``; entry is None when the caller must stay eager
    this call (pending just registered, eager-only, or cache full).
    """
    try:
        cache = _FORWARD_JIT_CACHE.open(owner)
    except TypeError:  # owner takes no weak reference
        return None, None
    entry = cache.get(sig)
    if entry is _EAGER_ONLY:
        return None, cache
    if entry is None:
        if len(cache) < Metric._FORWARD_JIT_MAX_SIGNATURES:
            cache[sig] = _PENDING
        return None, cache
    if entry is _PENDING:
        entry = builder()
        cache[sig] = entry
    return entry, cache


def _mark_eager_only(cache: Dict[Any, Any], sig: Any) -> None:
    """A step that could not be built or run: its signature stays eager, counted."""
    from metrics_tpu_torch.engine.aot import FORWARD_CACHE

    cache[sig] = _EAGER_ONLY
    FORWARD_CACHE.note_eager_only()


def forward_entry_kinds(owner: Any) -> List[str]:
    """Each input signature's entry in the compiled-forward cache of
    ``owner`` (a metric or a collection), in first-call order:
    ``"compiled"``, ``"eager_only"`` or ``"pending"``."""
    cache = _FORWARD_JIT_CACHE.get(owner) or {}
    return ["eager_only" if v is _EAGER_ONLY else "pending" if v is _PENDING else "compiled"
            for v in cache.values()]


def compiled_forward_steps(owner: Any) -> List[Any]:
    """The built steps in the compiled-forward cache of ``owner`` (on the card
    :class:`~metrics_tpu_torch.engine.aot.CapturedForward`, with its
    ``captures``/``replays`` counts)."""
    cache = _FORWARD_JIT_CACHE.get(owner) or {}
    return [v for v in cache.values() if v is not _EAGER_ONLY and v is not _PENDING]


def keep_forward_eager(owner: Any) -> Any:
    """Take ``owner``'s forward (a metric, or every member of a collection,
    which then also never fuses) off the compiled path for good: the eager
    twin a compiled forward is held against. Returns ``owner``."""
    for m in (owner.values() if hasattr(owner, "items") else [owner]):
        m._fwd_path_ok = False
    return owner


def _merge_errcode(prev: Any, code: Tensor) -> Tensor:
    """The running deferred code: the larger of ``prev`` (None, an int kept by
    a raise, or a tensor) and ``code``, on the device."""
    if prev is None:
        return code
    return code.clamp(min=prev) if isinstance(prev, int) else torch.maximum(prev, code)


def _graph_keepalive(module: nn.Module) -> Tuple[Tensor, ...]:
    """Every tensor a captured forward may read without owning it: each
    metric's buffers, tensor attributes and state defaults."""
    out: List[Tensor] = []
    for mod in module.modules():
        out.extend(t for t in mod._buffers.values() if t is not None)
        out.extend(v for v in vars(mod).values() if isinstance(v, Tensor))
        out.extend(v for v in getattr(mod, "_defaults", {}).values() if isinstance(v, Tensor))
    return tuple(out)


def _squeeze_if_scalar(x: Any) -> Any:
    """0-d-ify single-element tensors, mirroring the JAX package."""

    def _sq(v: Tensor) -> Tensor:
        return v.squeeze() if v.numel() == 1 and v.ndim > 0 else v

    return apply_to_collection(x, Tensor, _sq)


def _keep_where(keep: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """``new`` where the row's mask ``keep`` holds, else ``old``, in ``old``'s
    dtype (uint32 through its int32 bits: torch has no uint32 select)."""
    if old.dtype == torch.uint32:
        return torch.where(keep, int32_bits(new.to(old.dtype)), int32_bits(old)).view(torch.uint32)
    return torch.where(keep, new, old).to(old.dtype)


class Metric(nn.Module):
    """Base class for all metrics.

    Subclasses implement ``update(self, ...)`` (mutating registered state
    attributes) and ``compute(self)`` (reading them), and register states with
    :meth:`add_state`.

    Args:
        compute_on_step: return the metric value for the current batch from ``forward``.
        dist_sync_on_step: ``forward`` syncs the batch's state across the
            group before computing its value.
        sync_axis: the ``torch.distributed`` process group to sync over (the
            JAX package's mesh axis name); None takes the ambient group of
            :func:`~metrics_tpu_torch.parallel.metric_axis`, else the default
            group.
        dist_sync_fn: a leaf-sync override ``(reduce_fx, value, group) ->
            value`` that :meth:`sync_states` calls for each of this metric's
            states instead of the fused bundle. As in the JAX package, the
            eager ``sync()`` does not call it.
        process_group: the reference's name for ``sync_axis`` (used when
            ``sync_axis`` is None). A group travels with ``clone()``; a
            pickled metric forgets it (a group does not cross processes).
        device: where the states live and the update runs; ``None`` means
            ``"cuda"``, which raises when CUDA is not available (pass
            ``device="cpu"`` to run on the CPU).
        sync_precision: which states may be quantized (default exact).
            ``"q8_block"`` marks every ELIGIBLE state (float
            ``dist_reduce_fx="sum"`` accumulators); counts, cat buffers and
            min/max states stay exact. A ``{state_name: precision}`` dict
            targets states explicitly and raises on ineligible ones. The
            engine's at-rest codec (``engine/quantize.py``) compresses what
            the policy marks.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None
    #: compute-relevant attributes derived from data during ``update`` (host
    #: side, outside the state dict), e.g. ``Accuracy.mode``
    _host_derived_compute_attrs: Tuple[str, ...] = ()
    _MASKED_FX = ("sum", "min", "max")
    _BOOKKEEPING_ATTRS = ("_computed", "_update_called", "_forward_cache")
    #: list states whose entries are numpy arrays staged on the host (MAP's):
    #: ``.to()`` leaves them there and the state bridge seats them as numpy
    _host_list_states: Tuple[str, ...] = ()

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        sync_axis: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        device: DeviceLike = None,
        sync_precision: Optional[Union[str, Dict[str, str]]] = None,
        **kwargs: Any,
    ) -> None:
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {sorted(kwargs)}")
        _check_group("sync_axis", sync_axis)
        _check_group("process_group", process_group)
        super().__init__()
        self.device = resolve_device(device)
        self.compute_on_step = compute_on_step
        self.dist_sync_on_step = dist_sync_on_step
        self.sync_axis = sync_axis if sync_axis is not None else process_group
        self.dist_sync_fn = dist_sync_fn
        self._is_synced = False
        self._cache: Optional[Dict[str, Any]] = None
        self._to_sync = True
        self._should_unsync = True
        self._defaults: Dict[str, Any] = {}
        self._reductions: Dict[str, Any] = {}
        # list states are no buffers: ``state_dict`` carries the persistent ones itself
        self._persistent_lists: set = set()
        # per-state precision (absent = "exact"); the constructor spec applies
        # as states register, since subclasses add_state after this __init__
        self._sync_precision: Dict[str, str] = {}
        self._sync_precision_spec = self._check_sync_precision_spec(sync_precision)
        self._update_called = False
        self._computed: Any = None
        self._forward_cache: Any = None
        self._deferred_errcode: Any = None  # value-check code of the compiled forward steps
        self.update: Callable = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute: Callable = self._wrap_compute(self.compute)  # type: ignore[method-assign]

    def __setattr__(self, name: str, value: Any) -> None:
        # a plain non-empty list or tuple of metrics is a list of children, as
        # in the JAX package: held as an ``nn.ModuleList``, it is registered,
        # so ``.to()``, ``astype``, ``state_dict`` and the pure API follow it
        if isinstance(value, (list, tuple)) and value and all(isinstance(v, Metric) for v in value):
            value = nn.ModuleList(value)
        super().__setattr__(name, value)

    # ------------------------------------------------------------------ state registry

    def add_state(
        self,
        name: str,
        default: Any,
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
    ) -> None:
        """Register a named state: a tensor (a buffer on the metric's device)
        or an empty list. ``dist_reduce_fx`` in {"sum","mean","min","max",
        "cat", None, callable} names how states merge."""
        if name == self._CHILD_KEY:
            raise ValueError(f"state name {self._CHILD_KEY!r} is reserved for nested metric states")
        if not isinstance(default, (Tensor, np.ndarray, list)) or (isinstance(default, list) and default):
            raise ValueError("state variable must be a tensor or an empty list (where you can append tensors)")
        if not (dist_reduce_fx in ("sum", "mean", "min", "max", "cat", None) or callable(dist_reduce_fx)):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        self._reductions[name] = dist_reduce_fx
        if isinstance(default, list):
            self._defaults[name] = []
            setattr(self, name, [])
            if persistent:
                self._persistent_lists.add(name)
        else:
            default = torch.as_tensor(default).to(self.device)
            self._defaults[name] = default
            self.register_buffer(name, default.clone(), persistent=persistent)
        spec = self._sync_precision_spec
        if isinstance(spec, str):
            # blanket policy: quantize what is eligible, leave the rest exact
            if spec != "exact" and self._sync_precision_ineligible_reason(name) is None:
                self._sync_precision[name] = spec
        elif isinstance(spec, dict) and name in spec:
            self._set_state_precision(name, spec[name])

    # ------------------------------------------------------- sync precision policy

    @staticmethod
    def _check_sync_precision_spec(spec: Any) -> Any:
        if spec is None or isinstance(spec, dict):
            return spec
        if isinstance(spec, str):
            if spec not in SYNC_PRECISIONS:
                raise ValueError(f"unknown sync_precision {spec!r}; expected one of {SYNC_PRECISIONS}")
            return spec
        raise ValueError(f"sync_precision must be a string or a {{state: precision}} dict, got {type(spec).__name__}")

    def _sync_precision_ineligible_reason(self, name: str) -> Optional[str]:
        """None when state ``name`` may be quantized: a fixed-shape float
        ``dist_reduce_fx="sum"`` accumulator. Counts, cat buffers and min/max
        states must stay exact."""
        if name not in self._defaults:
            return f"no registered state named {name!r}"
        if isinstance(self._defaults[name], list):
            return "list (cat/gather) states must stay exact"
        fx = self._reductions[name]
        if fx != "sum":
            return f"dist_reduce_fx={fx!r} states must stay exact (only float 'sum' accumulators quantize)"
        if self._defaults[name].dtype not in _FLOAT_SUM_DTYPES:
            return "integer/count states must stay exact (they keep the bit-exact digit rider)"
        return None

    def _set_state_precision(self, name: str, prec: str) -> None:
        if prec not in SYNC_PRECISIONS:
            raise ValueError(f"unknown sync_precision {prec!r}; expected one of {SYNC_PRECISIONS}")
        if prec == "exact":
            self._sync_precision.pop(name, None)
            return
        reason = self._sync_precision_ineligible_reason(name)
        if reason is not None:
            raise MetricsTPUUserError(f"state {name!r} of {type(self).__name__} cannot ride a quantized sync: {reason}")
        self._sync_precision[name] = prec

    def set_sync_precision(self, spec: Union[str, Dict[str, str]]) -> "Metric":
        """Declare which states tolerate quantization (chainable): a blanket
        string applies to every eligible state (``"exact"`` clears the
        policy); a ``{state_name: precision}`` dict raises on ineligible
        states."""
        spec = self._check_sync_precision_spec(spec)
        if spec is None:
            return self
        if isinstance(spec, str):
            for name in self._defaults:
                if spec == "exact":
                    self._sync_precision.pop(name, None)
                elif self._sync_precision_ineligible_reason(name) is None:
                    self._sync_precision[name] = spec
            self._for_each_child(lambda c: c.set_sync_precision(spec))
        else:
            for name, prec in spec.items():
                self._set_state_precision(name, prec)
        return self

    def state_sync_precisions(self) -> Dict[str, str]:
        """Flat ``{state_path: precision}`` for every registered state of self
        and nested metrics (``name.state``, ``name[i].state``; default
        ``"exact"``). A constructor dict naming a state never registered
        raises here, where the policy is first read."""
        self._check_spec_consumed()
        out = {k: self._sync_precision.get(k, "exact") for k in self._defaults}
        for path, child in self._child_paths():
            out.update({f"{path}.{k}": v for k, v in child.state_sync_precisions().items()})
        return out

    def sync_precision_tag(self) -> str:
        """``"exact"`` when nothing quantizes, else ``"q8:<digest>"`` over the
        sorted quantized state names."""
        return sync_precision_tag_of(self.state_sync_precisions())

    def persistent(self, mode: bool = False) -> None:
        """Include (``True``) or leave out the tensor states, nested metrics'
        too, in ``state_dict``."""
        for k, v in self._defaults.items():
            if isinstance(v, Tensor):
                if mode:
                    self._non_persistent_buffers_set.discard(k)
                else:
                    self._non_persistent_buffers_set.add(k)
            elif mode:
                self._persistent_lists.add(k)
            else:
                self._persistent_lists.discard(k)
        self._for_each_child(lambda c: c.persistent(mode))

    # --------------------------------------------------------------- nested metrics

    _CHILD_KEY = "_children"

    def _child_metrics(self) -> Dict[str, Any]:
        """Child metrics held as attributes (a wrapper's inner metrics, a
        composition's operands): name -> Metric, or name -> list of Metrics,
        in sorted name order. The pure API recurses through them, so a
        wrapper's state carries its inner metrics' under ``"_children"``."""
        out: Dict[str, Any] = {}
        for name in sorted(self._modules):
            v = self._modules[name]
            if isinstance(v, Metric):
                out[name] = v
            elif isinstance(v, nn.ModuleList) and len(v) and all(isinstance(x, Metric) for x in v):
                out[name] = list(v)
        return out

    def _child_paths(self) -> List[Tuple[str, "Metric"]]:
        """``(path, child)`` per nested metric: ``name`` or ``name[i]``."""
        out: List[Tuple[str, Metric]] = []
        for name, child in self._child_metrics().items():
            if isinstance(child, list):
                out.extend((f"{name}[{i}]", c) for i, c in enumerate(child))
            else:
                out.append((name, child))
        return out

    def _for_each_child(self, fn: Callable[["Metric"], Any]) -> None:
        for _, child in self._child_paths():
            fn(child)

    def _map_children(self, fn: Callable[..., Any], *trees: Any) -> Dict[str, Any]:
        """``{name: fn(child, *subtrees)}`` over the nested metrics (a list
        of results for a list of children); ``trees`` are ``"_children"``
        subtrees aligned with them."""
        out: Dict[str, Any] = {}
        for name, child in self._child_metrics().items():
            subs = [t[name] for t in trees]
            if isinstance(child, list):
                out[name] = [fn(c, *parts) for c, *parts in zip(child, *subs)]
            else:
                out[name] = fn(child, *subs)
        return out

    # ------------------------------------------------------------- functional core API

    def init_state(self) -> Dict[str, Any]:
        """A fresh state dict (name -> tensor or list; nested metrics' states
        under the reserved ``"_children"`` key); leaves are copies."""
        state = {k: (v.clone() if isinstance(v, Tensor) else list(v)) for k, v in self._defaults.items()}
        if self._modules:
            children = self._map_children(lambda c: c.init_state())
            if children:
                state[self._CHILD_KEY] = children
        return state

    def abstract_state(self) -> Dict[str, Any]:
        """:class:`StateSpec` (shape, dtype) per tensor state, ``[]`` per list
        state, mirroring :meth:`init_state` without storage: the template of
        the engine's :class:`~metrics_tpu_torch.engine.arena.ArenaLayout`."""
        state = {k: (StateSpec(v.shape, v.dtype) if isinstance(v, Tensor) else []) for k, v in self._defaults.items()}
        if self._modules:
            children = self._map_children(lambda c: c.abstract_state())
            if children:
                state[self._CHILD_KEY] = children
        return state

    def _pack_state(self) -> Dict[str, Any]:
        state = {k: getattr(self, k) for k in self._defaults}
        if self._modules:
            children = self._map_children(lambda c: c._pack_state())
            if children:
                state[self._CHILD_KEY] = children
        return state

    def _load_state(self, state: Dict[str, Any]) -> None:
        for k, v in state.items():
            if k == self._CHILD_KEY:
                children = self._child_metrics()
                for name, sub in v.items():
                    child = children.get(name)
                    if isinstance(child, list):
                        for c, cs in zip(child, sub):
                            c._load_state(cs)
                    elif child is not None:
                        child._load_state(sub)
                continue
            setattr(self, k, list(v) if isinstance(v, (list, tuple)) else v)

    def _snapshot_bookkeeping(self) -> Dict[int, Dict[str, Any]]:
        """The host-side caches of self and every nested metric: a child's
        wrapped ``compute`` caches ``_computed`` while the pure API runs."""
        snap: Dict[int, Dict[str, Any]] = {}

        def visit(m: "Metric") -> None:
            snap[id(m)] = {a: getattr(m, a) for a in self._BOOKKEEPING_ATTRS}
            m._for_each_child(visit)

        visit(self)
        return snap

    def _restore_bookkeeping(self, snap: Dict[int, Dict[str, Any]]) -> None:
        def visit(m: "Metric") -> None:
            for a, v in snap.get(id(m), {}).items():
                object.__setattr__(m, a, v)
            m._for_each_child(visit)

        visit(self)

    def _mark_updated(self) -> None:
        """Post-update bookkeeping on self and nested metrics: a wrapper's
        forward accumulates its children's state too."""
        self._computed = None
        self._update_called = True
        self._for_each_child(lambda c: c._mark_updated())

    def update_state(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure update: ``new_state = f(state, batch)``.

        Runs the subclass ``update`` with ``state`` loaded into the instance,
        then snapshots the result; the registered state and the bookkeeping
        caches are restored afterwards. Host-derived compute attributes
        (``_host_derived_compute_attrs``) keep what the update latched.
        """
        saved = self._pack_state()
        book = self._snapshot_bookkeeping()
        self._load_state(state)
        try:
            with _pure_call():
                self._inner_update(*args, **kwargs)
            return self._pack_state()
        finally:
            self._load_state(saved)
            self._restore_bookkeeping(book)

    def compute_from(self, state: Dict[str, Any]) -> Any:
        """Pure compute on an explicit state dict."""
        saved = self._pack_state()
        book = self._snapshot_bookkeeping()
        self._load_state(state)
        try:
            with _pure_call():
                return _squeeze_if_scalar(self._inner_compute())
        finally:
            self._load_state(saved)
            self._restore_bookkeeping(book)

    # ---------------------------------------------------------------- functional sync

    def _group(self, group: Optional[Any] = None) -> Optional[Any]:
        """The process group a sync runs over: ``group``, else ``sync_axis``,
        else the ambient one; None is the default group."""
        for g in (group, self.sync_axis, current_metric_axis()):
            if g is not None:
                return g
        return None

    def _sync_tree_entries(self, state: Dict[str, Any], out: List[Tuple["Metric", str, Any]]) -> None:
        """``(metric, state name, value)`` for every leaf of ``state``, nested
        metrics' included (a subtree with no metric of its name is left out
        and passes through)."""
        children = self._child_metrics()
        for k, v in state.items():
            if k != self._CHILD_KEY:
                out.append((self, k, v))
                continue
            for name, sub in v.items():
                child = children.get(name)
                pairs = zip(child, sub) if isinstance(child, list) else [(child, sub)] if child is not None else []
                for c, cs in pairs:
                    c._sync_tree_entries(cs, out)

    def _sync_tree_build(self, state: Dict[str, Any], synced: Any) -> Dict[str, Any]:
        """``state`` rebuilt from the iterator ``synced``, in the order of
        :meth:`_sync_tree_entries`."""
        out: Dict[str, Any] = {}
        children = self._child_metrics()
        for k, v in state.items():
            if k != self._CHILD_KEY:
                out[k] = next(synced)
                continue
            out[k] = {}
            for name, sub in v.items():
                child = children.get(name)
                if isinstance(child, list):
                    out[k][name] = [c._sync_tree_build(cs, synced) for c, cs in zip(child, sub)]
                else:
                    out[k][name] = sub if child is None else child._sync_tree_build(sub, synced)
        return out

    def _check_spec_consumed(self) -> None:
        """A constructor ``sync_precision`` dict naming a state never
        registered raises where the policy is first read."""
        spec = self._sync_precision_spec
        if isinstance(spec, dict):
            unknown = sorted(k for k in spec if k not in self._defaults)
            if unknown:
                raise MetricsTPUUserError(
                    f"sync_precision names states {type(self).__name__} never registered: {unknown} "
                    f"(registered: {sorted(self._defaults)})"
                )

    def sync_states(self, state: Dict[str, Any], group: Optional[Any] = None) -> Dict[str, Any]:
        """Pure sync: every state of ``state`` reduced across ``group`` by its
        ``dist_reduce_fx`` (see :meth:`_group` for the default), nested
        metrics' with their own, in ONE fused bundle of collectives
        (``parallel/collectives.py``). List states are concatenated and
        gathered flat; a tensor state under fx=None arrives stacked
        ``(world, ...)``; ``q8_block`` states ride the quantized carrier. A
        metric's ``dist_sync_fn`` takes its own leaves instead. Without an
        initialised group (or outside it) the state comes back unchanged; at
        world 1 the bundle still runs, as the JAX package's does on a
        one-device mesh.

        ``group`` may be a mesh axis (``Mesh.axis(...)``): ``state`` is then
        the list of the W shards' states and so is the result, every shard
        holding the global state, as each device does after JAX's in-step
        ``psum``."""
        return _sync_trees([(self, state)], self._group(group))[0]

    def _sync_child_states(self, children_state: Dict[str, Any], group: Optional[Any] = None) -> Dict[str, Any]:
        """Sync a ``"_children"`` subtree alone, each nested metric with its
        own reductions (one bundle)."""
        return self.sync_states({self._CHILD_KEY: children_state}, group)[self._CHILD_KEY]

    def compute_synced(self, state: Dict[str, Any], group: Optional[Any] = None) -> Any:
        """Pure sync then compute: the global value of the ranks' states."""
        return self.compute_from(self.sync_states(state, group))

    def stacked_merge_unsupported_reason(self) -> Optional[str]:
        """None when :meth:`merge_stacked_states` applies: every state
        (recursively) is a fixed-shape tensor whose ``dist_reduce_fx`` is one
        of sum/min/max/cat."""
        for k, v in self._defaults.items():
            if isinstance(v, list):
                return f"state {k!r} is a list (cat/gather) state with no static shape"
            if self._reductions[k] not in _MERGEABLE_FX:
                return f"state {k!r} has dist_reduce_fx={self._reductions[k]!r} (no stacked merge)"
        for name, child in self._child_metrics().items():
            for c in child if isinstance(child, list) else [child]:
                r = c.stacked_merge_unsupported_reason()
                if r is not None:
                    return f"nested metric {name!r}: {r}"
        return None

    def merge_stacked_states(self, stacked: Dict[str, Any]) -> Dict[str, Any]:
        """Fold a leading STACK axis of per-rank states into one global state,
        with no communication: sum/min/max through the kernel library's
        pairwise ``combine`` (dtype-preserving), ``cat`` flattening the stack
        axis into dim 0 (the layout of the synced gather). Nested metrics
        fold with their own reductions; a subtree with no metric of its name
        passes through."""
        out: Dict[str, Any] = {}
        if self._CHILD_KEY in stacked:
            children = self._child_metrics()
            out[self._CHILD_KEY] = {}
            for name, sub in stacked[self._CHILD_KEY].items():
                child = children.get(name)
                if child is None:
                    out[self._CHILD_KEY][name] = sub
                elif isinstance(child, list):
                    out[self._CHILD_KEY][name] = [c.merge_stacked_states(cs) for c, cs in zip(child, sub)]
                else:
                    out[self._CHILD_KEY][name] = child.merge_stacked_states(sub)
        # every state checked before any is folded: a refused state after a mergeable one raises the same
        if any(isinstance(self._defaults[k], list) or self._reductions[k] not in _MERGEABLE_FX for k in self._defaults):
            raise MetricsTPUUserError(
                f"{type(self).__name__} has no stacked state merge: {self.stacked_merge_unsupported_reason()}."
            )
        for k in self._defaults:
            fx = self._reductions[k]
            v = as_input(stacked[k], self.device)
            if fx == "cat":
                # a per-rank scalar cat state: the stack is the cat
                out[k] = v if v.ndim == 1 else v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))
            else:
                out[k] = stack_reduce(v, fx)
        return out

    def sync_leaf_info(self) -> List[Any]:
        """``(dist_reduce_fx, StateSpec, precision)`` per fixed-shape state
        leaf, nested metrics' appended, in :meth:`sync_states` order: the
        input of ``fused_sync_plan``/``sync_payload_bytes``. List states are
        left out (their payload depends on the data)."""
        abstract = self.abstract_state()
        out: List[Any] = [(self._reductions[k], abstract[k], self._sync_precision.get(k, "exact"))
                          for k, v in self._defaults.items() if not isinstance(v, list)]
        for _, child in self._child_paths():
            out.extend(child.sync_leaf_info())
        return out

    def sync_error_bounds(self, stacked: Dict[str, Any]) -> Dict[str, Any]:
        """Per-element |error| bounds of a quantized sync of ``stacked`` (a
        rank-stacked state, leading axis = rank) against the exact one, per
        quantized state path (``q8_sum_error_bound``); exact states do not
        appear."""
        out: Dict[str, Any] = {k: q8_sum_error_bound(stacked[k]) for k in self._defaults
                               if self._sync_precision.get(k, "exact") == "q8_block"}
        sub = stacked.get(self._CHILD_KEY, {}) if isinstance(stacked, dict) else {}
        for name, child in self._child_metrics().items():
            if isinstance(child, list):
                for i, c in enumerate(child):
                    parts = sub.get(name, [{}] * len(child))
                    out.update({f"{name}[{i}].{k}": v for k, v in c.sync_error_bounds(parts[i]).items()})
            else:
                out.update({f"{name}.{k}": v for k, v in child.sync_error_bounds(sub.get(name, {})).items()})
        return out

    def merge_states(self, a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
        """Pairwise merge of two state dicts (pure): sum/min/max/cat, nested
        metrics with their own reductions."""
        out: Dict[str, Any] = {}
        if self._CHILD_KEY in a or self._CHILD_KEY in b:
            ca, cb = a.get(self._CHILD_KEY, {}), b.get(self._CHILD_KEY, {})
            children = self._child_metrics()
            merged: Dict[str, Any] = {}
            for name in {**ca, **cb}:
                child, x, y = children.get(name), ca.get(name), cb.get(name)
                if child is None or x is None or y is None:
                    merged[name] = x if x is not None else y
                elif isinstance(child, list):
                    merged[name] = [c.merge_states(xs, ys) for c, xs, ys in zip(child, x, y)]
                else:
                    merged[name] = child.merge_states(x, y)
            out[self._CHILD_KEY] = merged
        for k in self._defaults:
            fx = self._reductions[k]
            va, vb = a[k], b[k]
            if isinstance(self._defaults[k], list):
                out[k] = list(va) + list(vb)
            elif fx in self._MASKED_FX:
                out[k] = combine(va, vb, fx)
            elif fx == "cat":
                out[k] = torch.cat([torch.atleast_1d(va), torch.atleast_1d(vb)], dim=0)
            else:
                raise MetricsTPUUserError(
                    f"State '{k}' of {type(self).__name__} has a custom/None dist_reduce_fx; cannot merge pairwise."
                )
        return out

    @property
    def _states_mergeable(self) -> bool:
        if self.full_state_update is not None:
            return not self.full_state_update
        if not all(isinstance(self._defaults[k], list) or fx in _MERGEABLE_FX for k, fx in self._reductions.items()):
            return False
        # a wrapper is only delta-mergeable if every nested metric is
        return all(c._states_mergeable for _, c in self._child_paths())

    # ------------------------------------------------------------- masked update

    def masked_update_strategy(self) -> Optional[str]:
        """How :meth:`update_state_masked` runs: ``"custom"`` (the subclass
        overrides it), ``"delta"`` (the vmapped row-delta path: every state
        reduces with sum/min/max, whose identities make pad rows inert),
        ``"scan"`` (the sequential fold: array states with no row-neutral
        identity, such as the static-capacity curve buffers, take the subclass
        ``update`` one row at a time, masked rows carrying the state through
        unchanged), or ``None`` (not maskable: list states grow with data,
        ``full_state_update`` reads the accumulated state per batch)."""
        if type(self).update_state_masked is not Metric.update_state_masked:
            return "custom"
        if self._delta_masked_reason() is None:
            return "delta"
        if self._scan_masked_reason() is None:
            return "scan"
        if self.grouped_update_spec() is not None:
            return "grouped"
        return None

    def _delta_masked_reason(self) -> Optional[str]:
        """None when the vmapped row-delta masked path is exact."""
        if self.full_state_update:
            return "full_state_update metrics read the accumulated state in update; row deltas are not exact"
        for k, v in self._defaults.items():
            if isinstance(v, list):
                return f"state {k!r} is a list (cat/gather) state"
            if self._reductions[k] not in self._MASKED_FX:
                return f"state {k!r} has dist_reduce_fx={self._reductions[k]!r}"
        for name, child in self._child_metrics().items():
            for c in child if isinstance(child, list) else [child]:
                r = c._delta_masked_reason() if type(c).update_state_masked is Metric.update_state_masked else None
                if r is not None:
                    return f"nested metric {name!r}: {r}"
        return None

    def _scan_masked_reason(self) -> Optional[str]:
        """None when the sequential scan fold is exact: every state is a
        fixed-shape tensor and ``update`` does not read the accumulated state
        (``full_state_update``)."""
        if self.full_state_update:
            return "full_state_update metrics read the accumulated state in update; a row fold is not exact"
        for k, v in self._defaults.items():
            if isinstance(v, list):
                return f"state {k!r} is a list (cat/gather) state with no static shape"
        for name, child in self._child_metrics().items():
            for c in child if isinstance(child, list) else [child]:
                if c.masked_update_strategy() is None:
                    return f"nested metric {name!r}: {c._scan_masked_reason()}"
        return None

    def masked_update_unsupported_reason(self) -> Optional[str]:
        """None when :meth:`update_state_masked` applies (any strategy), else
        the reason."""
        strategy = self.masked_update_strategy()
        if strategy == "grouped":
            return self.grouped_refusal_reason()
        if strategy is not None:
            return None
        return self._scan_masked_reason() or self._delta_masked_reason()

    # ------------------------------------------------- grouped (ragged) serving hooks

    def grouped_update_spec(self) -> Optional[GroupedUpdateSpec]:
        """The metric's group-keyed state declaration, or None (the default).
        Metrics whose state is a per-GROUP bag of rows that only sorts at
        compute time return a :class:`GroupedUpdateSpec`; the ragged engine
        then serves them with per-group capacity buffers, the group keys
        riding the multi-stream machinery as stream ids."""
        return None

    def grouped_refusal_reason(self) -> str:
        """The typed refusal a NON-ragged engine raises for a group-keyed
        metric: the metric, its offending (list or unmergeable) states, and
        the ragged path."""
        offending = sorted(
            k for k, v in self._defaults.items() if isinstance(v, list) or self._reductions[k] not in _MERGEABLE_FX
        )
        states = ", ".join(repr(k) for k in offending) or "its group-keyed states"
        return (
            f"{type(self).__name__} accumulates group-keyed rows ({states}) that "
            "sort/match only at compute time; serve it through the ragged path — "
            "metrics_tpu_torch.engine.ragged.RaggedEngine(metric, num_groups=...) — "
            "see docs/serving.md § Ragged serving"
        )

    def grouped_encode(self, *args: Any, **kwargs: Any) -> Tuple[Any, ...]:
        """Flatten one eager ``update(...)`` call into ragged-ingest arrays
        ``(group_ids, field_0, ...)``, validated exactly like ``update``."""
        raise MetricsTPUUserError(
            f"{type(self).__name__} declares no grouped_update_spec(); "
            "grouped_encode is only meaningful for group-keyed metrics"
        )

    def grouped_group_value(self, fields: Dict[str, Tensor], count: Tensor, capacity: int) -> Any:
        """The per-group read over ``(capacity, ...)`` buffers (rows valid
        below ``count``): what the ragged engine's ``result(group_id)``
        returns."""
        raise MetricsTPUUserError(
            f"{type(self).__name__} declares no grouped_update_spec(); "
            "grouped_group_value is only meaningful for group-keyed metrics"
        )

    def grouped_finalize(self, counts: np.ndarray, fields: Dict[str, np.ndarray],
                         group_ids: np.ndarray) -> Dict[str, Any]:
        """Rebuild this metric's EAGER state from per-group rows (``counts``
        ``(G,)``, each field ``(G, capacity, ...)``): the ragged aggregate's
        oracle feeds it through :meth:`compute_from`."""
        raise MetricsTPUUserError(
            f"{type(self).__name__} declares no grouped_update_spec(); "
            "grouped_finalize is only meaningful for group-keyed metrics"
        )

    def grouped_aggregate_spec(self) -> Optional[GroupedAggregateSpec]:
        """The metric's device-aggregate declaration, or None (the engine
        stays on the host oracle)."""
        return None

    def update_state_masked(self, state: Dict[str, Any], *args: Any, mask: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure mask-aware update: rows of the leading batch axis where
        ``mask`` is False contribute NOTHING to the new state.

        The subclass ``update`` runs per row (``torch.func.vmap`` over
        batch-of-1 rows — exact for every delta-mergeable metric) and each
        state's row-stacked deltas fold into ``state`` with the state's own
        reduction, its identity standing in for masked rows; a ``"scan"``
        metric folds its rows one at a time instead. Every tensor leaf
        of ``args``/``kwargs`` whose leading dimension equals ``mask.shape[0]``
        is batch-carried; everything else broadcasts.
        """
        strategy = self.masked_update_strategy()
        if strategy == "grouped":
            raise MetricsTPUUserError(
                f"{type(self).__name__} has no mask-aware update: {self.grouped_refusal_reason()}.")
        if strategy is None:
            raise MetricsTPUUserError(
                f"{type(self).__name__} has no mask-aware update: "
                f"{self.masked_update_unsupported_reason()}. "
                "Override `update_state_masked` or stream it eagerly (unbucketed)."
            )
        mask = as_input(mask, self.device).to(torch.bool)
        if strategy == "scan":
            return self._masked_update_scan(state, args, kwargs, mask)
        stacked = self._stacked_row_deltas(args, kwargs, mask.shape[0])
        return self._masked_reduce_into(state, stacked, mask)

    def _split_batch_leaves(self, args: Any, kwargs: Any, n_rows: int):
        """Flatten ``(args, kwargs)`` and classify leaves against ``n_rows``,
        reshaping each batch-carried leaf to ``(n_rows, 1, ...)`` so a per-row
        body sees the batch-of-1 shapes the subclass validates. Returns
        ``(leaves, in_dims, treedef)``."""
        leaves, treedef = pytree.tree_flatten((args, kwargs))
        batched: List[Any] = []
        in_dims: List[Optional[int]] = []
        for leaf in leaves:
            leaf = as_input(leaf, self.device)
            if isinstance(leaf, Tensor) and is_batch_leaf(leaf, n_rows):
                batched.append(leaf.reshape((n_rows, 1) + tuple(leaf.shape[1:])))
                in_dims.append(0)
            else:
                batched.append(leaf)
                in_dims.append(None)
        return batched, in_dims, treedef

    def _stacked_row_deltas(self, args: Any, kwargs: Any, n_rows: int) -> Dict[str, Any]:
        """Row-stacked state deltas (leading axis = rows): the subclass update
        vmapped over batch-of-1 rows, the finest batch partition."""
        batched, in_dims, treedef = self._split_batch_leaves(args, kwargs, n_rows)

        def per_row(*row_leaves: Any) -> Dict[str, Any]:
            a, kw = pytree.tree_unflatten(list(row_leaves), treedef)
            return self.update_state(self.init_state(), *a, **kw)

        return torch.func.vmap(per_row, in_dims=tuple(in_dims))(*batched)

    def _masked_update_scan(self, state: Dict[str, Any], args: Any, kwargs: Any, mask: Tensor) -> Dict[str, Any]:
        """Sequential masked fold for states with no row-neutral reduction
        identity: the subclass ``update`` runs on one batch-of-1 row at a time
        in submission order, and every leaf keeps the old value where the
        row's mask is False. Exact whenever a batch update equals its rows
        applied in order (the static-capacity buffers write rows in order).
        The loop reads nothing on the host (the row's mask stays a device
        tensor; value checks are off inside :func:`traced_rows`), so it runs
        inside graph capture; its cost grows with the bucket's rows."""
        batched, in_dims, treedef = self._split_batch_leaves(args, kwargs, mask.shape[0])
        carry = pytree.tree_map(lambda v: as_input(v, self.device), state)
        with traced_rows():
            for i in range(mask.shape[0]):
                row = [b[i] if d == 0 else b for b, d in zip(batched, in_dims)]
                a, kw = pytree.tree_unflatten(row, treedef)
                new = self.update_state(carry, *a, **kw)
                carry = pytree.tree_map(functools.partial(_keep_where, mask[i]), new, carry)
        return carry

    def _masked_reduce_into(self, state: Dict[str, Any], stacked: Dict[str, Any], mask: Tensor) -> Dict[str, Any]:
        """Fold row-stacked deltas into ``state`` through the kernel library
        (the CUDA fold kernel on the card, its plain version on the CPU),
        skipping masked-out rows via each reduction's identity."""
        out: Dict[str, Any] = {}
        if self._CHILD_KEY in stacked:
            out[self._CHILD_KEY] = self._map_children(
                lambda c, cs, cd: c._masked_reduce_into(cs, cd, mask), state[self._CHILD_KEY],
                stacked[self._CHILD_KEY])
        for k in self._defaults:
            fx = self._reductions[k]
            if fx not in self._MASKED_FX:  # pragma: no cover - guarded by masked_update_strategy
                raise MetricsTPUUserError(f"no masked reduction for dist_reduce_fx={fx!r}")
            out[k] = fold_rows_masked(state[k], stacked[k], mask, fx)
        return out

    # ------------------------------------------------- multi-stream serving hooks

    def segmented_update_unsupported_reason(self) -> Optional[str]:
        """None when :meth:`update_state_segmented` applies: the generic
        row-delta path must hold (a custom fused masked form has no segmented
        counterpart). Group-keyed metrics refuse here too, pointing at the
        ragged engine (their per-row keys are not the engine's stream ids)."""
        if self.grouped_update_spec() is not None:
            return self.grouped_refusal_reason()
        if type(self).update_state_masked is not Metric.update_state_masked:
            return "custom update_state_masked override has no segmented form"
        return self._delta_masked_reason()

    def update_state_segmented(
        self,
        state: Dict[str, Any],
        *args: Any,
        mask: Any,
        segment_ids: Any,
        num_segments: int,
        **kwargs: Any,
    ) -> Dict[str, Any]:
        """Pure multi-stream update: ``state`` leaves carry a leading stream
        axis of length ``num_segments``; each batch row updates the stream row
        addressed by ``segment_ids`` (masked-out rows update nothing).

        The ``MultiStreamEngine`` step: the vmapped row deltas fold into the
        addressed state rows with each state's own reduction, one K4 launch
        per leaf on the card. Exact for the same metrics as the delta masked
        path, stream by stream.
        """
        reason = self.segmented_update_unsupported_reason()
        if reason is not None:
            raise MetricsTPUUserError(f"{type(self).__name__} has no segmented (multi-stream) update: {reason}.")
        mask = as_input(mask, self.device).to(torch.bool)
        segment_ids = as_input(segment_ids, self.device).to(torch.int32)
        stacked = self._stacked_row_deltas(args, kwargs, mask.shape[0])
        return self._segment_reduce_into(state, stacked, mask, segment_ids, num_segments)

    def _segment_reduce_into(
        self, state: Dict[str, Any], stacked: Dict[str, Any], mask: Tensor, segment_ids: Tensor, num_segments: int
    ) -> Dict[str, Any]:
        """Scatter row-stacked deltas into the addressed stream rows of a
        stream-stacked ``state``, masked rows folding into nothing."""
        out: Dict[str, Any] = {}
        if self._CHILD_KEY in stacked:
            out[self._CHILD_KEY] = self._map_children(
                lambda c, cs, cd: c._segment_reduce_into(cs, cd, mask, segment_ids, num_segments),
                state[self._CHILD_KEY], stacked[self._CHILD_KEY])
        for k in self._defaults:
            fx = self._reductions[k]
            if fx not in self._MASKED_FX:  # pragma: no cover - guarded by segmented_update_unsupported_reason
                raise MetricsTPUUserError(f"no segmented reduction for dist_reduce_fx={fx!r}")
            out[k] = segment_reduce_masked(state[k], stacked[k], mask, segment_ids, num_segments, fx)
        return out

    def arena_layout(self) -> Any:
        """Packing plan collapsing this metric's state into one contiguous
        buffer per dtype (``engine/arena.py``)."""
        from metrics_tpu_torch.engine.arena import ArenaLayout

        return ArenaLayout.for_state(self.abstract_state())

    # -------------------------------------------------------- host-derived attributes

    def host_compute_attrs(self) -> Dict[str, Any]:
        """Flat ``{path: value}`` of the declared host-derived compute
        attributes of self and nested metrics (``name.attr``,
        ``name[i].attr``)."""
        out = {a: getattr(self, a, None) for a in self._host_derived_compute_attrs}
        for path, child in self._child_paths():
            out.update({f"{path}.{k}": v for k, v in child.host_compute_attrs().items()})
        return out

    def restore_host_compute_attrs(self, attrs: Dict[str, Any]) -> None:
        """Inverse of :meth:`host_compute_attrs`; unknown paths are ignored."""
        for a in self._host_derived_compute_attrs:
            if a in attrs:
                setattr(self, a, attrs[a])
        for path, child in self._child_paths():
            prefix = f"{path}."
            sub = {k[len(prefix):]: v for k, v in attrs.items() if k.startswith(prefix)}
            if sub:
                child.restore_host_compute_attrs(sub)

    # ------------------------------------------------------------------ stateful facade

    def _inner_update(self, *args: Any, **kwargs: Any) -> None:
        """The unwrapped subclass update, inputs moved to the metric's device."""
        args, kwargs = pytree.tree_map(lambda x: as_input(x, self.device), (args, kwargs))
        type(self).update(self, *args, **kwargs)

    def _inner_compute(self) -> Any:
        return type(self).compute(self)

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            if self._is_synced:
                raise MetricsTPUUserError(
                    "The Metric has already been synced. HINT: call unsync() before modifying state."
                )
            self._computed = None
            self._update_called = True
            self._inner_update(*args, **kwargs)

        return wrapped_func

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if not self._update_called:
                rank_zero_warn(
                    f"The ``compute`` method of metric {type(self).__name__} was called before "
                    "the ``update`` method which may lead to errors, as metric states have not "
                    "yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                return self._computed
            self._raise_if_invalid()
            with self.sync_context(
                dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync, should_unsync=self._should_unsync
            ):
                self._computed = _squeeze_if_scalar(compute(*args, **kwargs))
            return self._computed

        return wrapped_func

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate global state and (optionally) return the batch-local value.

        One ``update`` per call when states merge pairwise: the batch value is
        computed from the state delta and the delta merged into the global
        state. Otherwise the global state is snapshotted and the batch value
        computed with a second update. Under ``dist_sync_on_step`` the batch's
        state is synced across the group before its value is computed (the
        accumulated state stays rank-local).
        """
        if self._is_synced:
            raise MetricsTPUUserError("The Metric shouldn't be synced when performing ``forward``.")
        if self._states_mergeable:
            fast = self._forward_fast(args, kwargs)
            if fast is not _MISS:
                merged, value = fast
                self._load_state(merged)
                self._mark_updated()
                self._forward_cache = value if self.compute_on_step else None
                return self._forward_cache
            delta = self.update_state(self.init_state(), *args, **kwargs)
            self._load_state(self.merge_states(self._pack_state(), delta))
            self._mark_updated()
            if not self.compute_on_step:
                self._forward_cache = None
                return None
            if self.dist_sync_on_step:
                delta = self.sync_states(delta)
            self._forward_cache = self.compute_from(delta)
            return self._forward_cache
        self.update(*args, **kwargs)
        if not self.compute_on_step:
            self._forward_cache = None
            return None
        cache = self._pack_state()
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        try:
            self._load_state(self.init_state())
            self.update(*args, **kwargs)
            self._forward_cache = self.compute()
        finally:
            self._load_state(cache)
            self._should_unsync = True
            self._to_sync = True
            self._is_synced = False
            self._cache = None
        self._mark_updated()
        return self._forward_cache

    # ---------------------------------------------------------- compiled forward

    _FORWARD_JIT_MAX_SIGNATURES = 64

    def _raise_if_invalid(self) -> None:
        """Raise the validation error a compiled forward step recorded.

        The step cannot raise mid-graph: its value checks emit error codes
        on the device. This is the deferred raise point, called from
        ``compute()`` and ``sync()``. It is sticky: the merged state holds
        the invalid batch, so every ``compute()``/``sync()`` until
        ``reset()`` raises. Inside a graph capture it reads nothing."""
        code_arr = self._deferred_errcode
        if code_arr is None:
            return
        if isinstance(code_arr, Tensor) and code_arr.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        code = int(code_arr)
        if code:
            self._deferred_errcode = code
            raise ValueError(deferred_message(code) + " (detected by a compiled forward step; raised deferred)")
        self._deferred_errcode = None

    def _forward_jit_safe(self) -> bool:
        """Override to keep a metric off the compiled forward when its eager
        semantics depend on concrete VALUES beyond input validation (the
        aggregators' ``nan_strategy='error'`` must raise on every batch)."""
        for child in self._child_metrics().values():
            children = child if isinstance(child, list) else [child]
            if not all(c._forward_jit_safe() for c in children):
                return False
        return True

    def _has_list_state(self) -> bool:
        if any(isinstance(v, list) for v in self._defaults.values()):
            return True
        for child in self._child_metrics().values():
            children = child if isinstance(child, list) else [child]
            if any(c._has_list_state() for c in children):
                return True
        return False

    def _forward_eligible(self) -> bool:
        """Whether this metric's forward may take a compiled step: states that
        merge pairwise, no per-step sync, at least one state, and the static
        path check. ``_forward_fast`` and the collection's fused step share it."""
        return (self._states_mergeable and not self.dist_sync_on_step and self.dist_sync_fn is None
                and bool(self._defaults) and self._forward_path_ok())

    def _forward_body(self, state: Dict[str, Any], a: Tuple[Any, ...], kw: Dict[str, Any],
                      compute_on_step: bool) -> Tuple[Dict[str, Any], Any, Tensor]:
        """One forward as a compiled step runs it, under ``traced_rows()``:
        the batch's update with its value checks deferred, the merge into
        ``state`` and the batch value. Returns ``(merged, value, code)``.
        ``_build_forward_step`` and the collection's fused step share it."""
        with deferred_value_checks(self.device) as checks:
            delta = self.update_state(self.init_state(), *a, **kw)
        merged = self.merge_states(state, delta)
        value = self.compute_from(delta) if compute_on_step else None
        return merged, value, checks.combined()

    def _forward_path_ok(self) -> bool:
        """Whether the compiled forward may run this metric: static per
        instance configuration, computed once, not per batch."""
        path_ok = self.__dict__.get("_fwd_path_ok")
        if path_ok is None:
            path_ok = self._fwd_path_ok = self._forward_jit_safe() and not self._has_list_state()
        return path_ok

    @staticmethod
    def _forward_signature(args: Any, kwargs: Any):
        """Hashable call signature, or None if the call cannot take the
        compiled path.

        Tensor and numpy leaves are keyed by (shape, dtype) and copied into
        the step's buffers; a Python float is passed as a 0-d f32 argument,
        so one step covers every value; bool, int and None are keyed by VALUE
        and baked in. A string (text metrics), a ``torch.func`` batched
        tensor, or a call inside a trace (:func:`traced_rows`, a graph being
        captured) opts out, as a JAX tracer does.
        """
        if _tracing():
            return None
        leaves, treedef = pytree.tree_flatten((args, kwargs))
        sig: List[Any] = []
        array_idx: List[int] = []
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, str) or _is_batched(leaf):
                return None
            if isinstance(leaf, (Tensor, np.ndarray)):
                sig.append((tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")))
                array_idx.append(i)
            elif isinstance(leaf, float) and not isinstance(leaf, bool):
                sig.append(float)
                array_idx.append(i)
            elif isinstance(leaf, (bool, int, type(None))):
                sig.append((type(leaf), leaf))
            else:
                return None
        return (treedef, tuple(sig)), tuple(array_idx), leaves

    def _forward_fast(self, args: Any, kwargs: Any):
        """The compiled forward: one step (one CUDA graph on the card)
        instead of an eager update, merge and compute.

        Per input signature: the 1st call runs the eager path (so eager value
        validation fires at least once per shape/dtype pattern), the 2nd
        builds ``update -> merge -> compute(delta)`` and runs it, later calls
        reuse it. A step that cannot be built or run (a host read in the
        update or compute, an illegal op under capture) leaves its signature
        eager for good; the metric's state is untouched by the failed try.
        Returns ``(merged_state, batch_value)`` or ``_MISS``.
        """
        if not self._forward_eligible():
            return _MISS
        parsed = self._forward_signature(args, kwargs)
        if parsed is None:
            return _MISS
        sig, array_idx, leaves = parsed
        sig = (sig, bool(self.compute_on_step))  # compute_on_step is baked into the step
        entry, cache = _jit_cache_lookup(self, sig, lambda: self._build_forward_step(sig, array_idx, leaves))
        if entry is None:
            return _MISS
        try:
            merged, value, errcode = entry(self._pack_state(), [leaves[i] for i in array_idx])
        except Exception:
            # an update that cannot run traced, or a capture that failed: the
            # state was not written; the eager path re-raises a user error
            _mark_eager_only(cache, sig)
            return _MISS
        # kept on the device, read at the next compute()/sync()
        self._deferred_errcode = _merge_errcode(self._deferred_errcode, errcode)
        return merged, value

    def _build_forward_step(self, sig: Any, array_idx: Tuple[int, ...], leaves: List[Any]) -> Any:
        from metrics_tpu_torch.engine.aot import forward_entry

        compute_on_step = self.compute_on_step
        # weak binding: the step must not pin the metric its cache entry hangs on
        wself = weakref.ref(self)

        def step(state: Dict[str, Any], aux: Any, a: Tuple[Any, ...], kw: Dict[str, Any], mask: Any = None):
            m = wself()
            assert m is not None  # the caller holds a strong reference for the call
            with traced_rows():
                merged, value, code = m._forward_body(state, a, kw, compute_on_step)
            return merged, (value, code)

        return forward_entry(step, leaves, array_idx, sig[0][0], self.device, _graph_keepalive(self))

    def reset(self) -> None:
        """Reset state to defaults."""
        self._update_called = False
        self._forward_cache = None
        self._computed = None
        self._is_synced = False
        self._cache = None
        self._deferred_errcode = None
        self._load_state(self.init_state())

    # ---------------------------------------------------------------------- eager sync

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        should_sync: bool = True,
        distributed_available_fn: Optional[Callable] = None,
    ) -> None:
        """Replace the local state with the state merged across the group,
        keeping the local one for :meth:`unsync`.

        The JAX package's multi-host semantics: nested metrics' states pass
        through unsynced (each syncs itself when its own ``compute`` runs),
        a list state comes back as a one-element list of the gathered rows
        (fx=None flattened as ``cat``), a tensor under fx=None stacked
        ``(world, ...)``; every state exact, one fused bundle. Nothing
        happens unless ``should_sync`` and the group has more than one rank
        (``distributed_available_fn``, when given, decides instead), or
        inside the pure API. ``dist_sync_fn`` is accepted and not called, as
        in the JAX package's eager path."""
        if self._is_synced and should_sync:
            raise MetricsTPUUserError("The Metric has already been synced.")
        self._raise_if_invalid()
        group = self._group()
        available = distributed_available_fn() if distributed_available_fn is not None else distributed_available(group)
        if not should_sync or not available or getattr(_PURE, "depth", 0):
            return
        state = self._pack_state()
        entries = [(self, k, v) for k, v in state.items() if k != self._CHILD_KEY]
        synced = dict(zip((k for _, k, _ in entries), _sync_entries(entries, group, eager=True)))
        if self._CHILD_KEY in state:
            synced[self._CHILD_KEY] = state[self._CHILD_KEY]
        self._cache = state
        self._load_state(synced)
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the rank-local state after :meth:`sync`."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise MetricsTPUUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise MetricsTPUUserError("The internal cache should exist to unsync the Metric.")
        self._load_state(self._cache)
        self._is_synced = False
        self._cache = None

    @contextlib.contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available_fn: Optional[Callable] = None,
    ):
        """Context manager: the synced state inside, the local state restored
        on exit."""
        self.sync(dist_sync_fn=dist_sync_fn, should_sync=should_sync,
                  distributed_available_fn=distributed_available_fn)
        try:
            yield self
        finally:
            self.unsync(should_unsync=self._is_synced and should_unsync)

    def clone(self) -> "Metric":
        return deepcopy(self)

    def __deepcopy__(self, memo: Dict[int, Any]) -> "Metric":
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        new.__setstate__(deepcopy(self.__getstate__(), memo))
        new.sync_axis = self.sync_axis  # a process group is shared, never copied
        return new

    def _save_to_state_dict(self, destination: Dict[str, Any], prefix: str, keep_vars: bool) -> None:
        """Buffers as ``nn.Module`` saves them, plus the persistent list
        states as lists of tensors, as the JAX package's ``state_dict``
        holds them."""
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for k in sorted(self._persistent_lists):
            destination[prefix + k] = [x if keep_vars else x.detach() for x in getattr(self, k)]

    def _load_from_state_dict(self, state_dict: Dict[str, Any], prefix: str, local_metadata: Any, strict: bool,
                              missing_keys: List[str], unexpected_keys: List[str], error_msgs: List[str]) -> None:
        lists = {prefix + k: k for k, v in self._defaults.items() if isinstance(v, list)}
        for k, v in self._defaults.items():
            # a scalar state may have grown by broadcasting (ExplainedVariance's sums over 2-D rows)
            grown = state_dict.get(prefix + k) if isinstance(v, Tensor) and v.ndim == 0 else None
            if grown is not None and tuple(grown.shape) != tuple(getattr(self, k).shape):
                setattr(self, k, torch.zeros(tuple(grown.shape), dtype=v.dtype, device=self.device))
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys,
                                      error_msgs)
        for key, name in lists.items():
            if key in state_dict:
                setattr(self, name, [as_input(torch.as_tensor(np.array(x)), self.device) for x in state_dict[key]])
        unexpected_keys[:] = [k for k in unexpected_keys if k not in lists]

    def load_state_dict(self, state_dict: Any, strict: bool = True, assign: bool = False) -> Any:
        """``nn.Module.load_state_dict`` that also takes the JAX package's
        ``state_dict()`` (numpy values under the same dotted keys)."""
        state_dict = {k: torch.from_numpy(np.array(v)) if isinstance(v, (np.ndarray, np.generic)) else v
                      for k, v in state_dict.items()}
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def _apply(self, fn: Callable[[Tensor], Tensor], recurse: bool = True) -> "Metric":
        """``nn.Module._apply`` (``.to()``, ``.cuda()``, ``.half()``...) over
        the states, the defaults ``reset`` restores, list states and
        ``self.device`` alike; nested metrics recurse. The compiled forward's
        entries are dropped: their graphs read the old tensors."""
        _FORWARD_JIT_CACHE.drop(self)
        super()._apply(fn, recurse)
        self._defaults = {k: fn(v) if isinstance(v, Tensor) else v for k, v in self._defaults.items()}
        for k, v in self._defaults.items():
            if isinstance(v, list) and k not in self._host_list_states:
                setattr(self, k, [fn(x) for x in getattr(self, k)])
        self.device = fn(torch.empty(0, device=self.device)).device
        return self

    def to_device(self, device: DeviceLike) -> "Metric":
        """Move all states, defaults and nested metrics to ``device``."""
        return self.to(resolve_device(device))

    def astype(self, dtype: torch.dtype) -> "Metric":
        """Cast the floating-point states (and their defaults), nested
        metrics' too."""
        return self._apply(lambda t: t.to(dtype) if t.is_floating_point() else t)

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only kwargs the (unwrapped) update accepts."""
        params = inspect.signature(type(self).update).parameters
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return kwargs
        return {
            k: v
            for k, v in kwargs.items()
            if k in params and params[k].kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY)
        }

    def __getstate__(self) -> Dict[str, Any]:
        # the wrapped methods close over this instance: drop them, re-wrap on load
        state = self.__dict__.copy()
        state.pop("update", None)
        state.pop("compute", None)
        state["sync_axis"] = None  # a process group does not cross processes
        state["_deferred_errcode"] = None  # a device tensor; the validation status is session-local
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self.update = self._wrap_update(type(self).update.__get__(self))
        self.compute = self._wrap_compute(type(self).compute.__get__(self))

    def __hash__(self) -> int:
        return hash((type(self).__name__, id(self)))

    def extra_repr(self) -> str:
        return f"device={self.device}"

    # subclass contract ---------------------------------------------------------------

    def update(self, *args: Any, **kwargs: Any) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def compute(self) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    # operator overloads -> CompositionalMetric ------------------------------------------
    # ``==`` builds a metric too (always truthy): compare metrics with ``is``.

    def __add__(self, other): return CompositionalMetric(torch.add, self, other)
    def __radd__(self, other): return CompositionalMetric(torch.add, other, self)
    def __sub__(self, other): return CompositionalMetric(torch.subtract, self, other)
    def __rsub__(self, other): return CompositionalMetric(torch.subtract, other, self)
    def __mul__(self, other): return CompositionalMetric(torch.multiply, self, other)
    def __rmul__(self, other): return CompositionalMetric(torch.multiply, other, self)
    def __truediv__(self, other): return CompositionalMetric(torch.true_divide, self, other)
    def __rtruediv__(self, other): return CompositionalMetric(torch.true_divide, other, self)
    def __floordiv__(self, other): return CompositionalMetric(torch.floor_divide, self, other)
    def __rfloordiv__(self, other): return CompositionalMetric(torch.floor_divide, other, self)
    def __mod__(self, other): return CompositionalMetric(torch.remainder, self, other)
    def __rmod__(self, other): return CompositionalMetric(torch.remainder, other, self)
    def __pow__(self, other): return CompositionalMetric(torch.pow, self, other)
    def __rpow__(self, other): return CompositionalMetric(torch.pow, other, self)
    def __matmul__(self, other): return CompositionalMetric(torch.matmul, self, other)
    def __rmatmul__(self, other): return CompositionalMetric(torch.matmul, other, self)
    def __and__(self, other): return CompositionalMetric(torch.bitwise_and, self, other)
    def __rand__(self, other): return CompositionalMetric(torch.bitwise_and, other, self)
    def __or__(self, other): return CompositionalMetric(torch.bitwise_or, self, other)
    def __ror__(self, other): return CompositionalMetric(torch.bitwise_or, other, self)
    def __xor__(self, other): return CompositionalMetric(torch.bitwise_xor, self, other)
    def __rxor__(self, other): return CompositionalMetric(torch.bitwise_xor, other, self)
    def __eq__(self, other): return CompositionalMetric(torch.eq, self, other)  # type: ignore[override]
    def __ne__(self, other): return CompositionalMetric(torch.ne, self, other)  # type: ignore[override]
    def __lt__(self, other): return CompositionalMetric(torch.lt, self, other)
    def __le__(self, other): return CompositionalMetric(torch.le, self, other)
    def __gt__(self, other): return CompositionalMetric(torch.gt, self, other)
    def __ge__(self, other): return CompositionalMetric(torch.ge, self, other)
    def __abs__(self): return CompositionalMetric(torch.abs, self, None)
    def __neg__(self): return CompositionalMetric(_neg, self, None)
    def __pos__(self): return CompositionalMetric(torch.abs, self, None)
    def __invert__(self): return CompositionalMetric(torch.logical_not, self, None)
    def __getitem__(self, idx): return CompositionalMetric(lambda x: x[idx], self, None)


def _neg(x: Tensor) -> Tensor:
    """The reference's ``-metric``: ``-abs(value)``, not a plain negation."""
    return -torch.abs(x)


def _operand(x: Any, device: torch.device) -> Tensor:
    """A constant operand as a tensor on ``device``, in the JAX package's
    32-bit types (x64 off): Python and numpy ints become int32, floats
    float32."""
    t = as_input(torch.as_tensor(np.asarray(x)) if not isinstance(x, Tensor) else x, device)
    return t.to(torch.int32) if t.dtype == torch.int64 else t


class CompositionalMetric(Metric):
    """Lazy arithmetic composition of metrics (``2 * p * r / (p + r)``).

    Port of the JAX package's ``CompositionalMetric``. ``update`` and
    ``reset`` go to the operand metrics, ``compute`` applies ``operator`` to
    their values; it has no state of its own. A metric operand is a child
    module (``metric_a``, ``metric_b``), a constant operand a buffer on the
    composition's device (which ``.to()`` moves). An operand metric that
    appears twice in a tree is updated once per occurrence, and each
    occurrence has its own ``"_children"`` subtree, as in the JAX package.
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, int, float, Tensor],
        metric_b: Union[Metric, int, float, Tensor, None],
    ) -> None:
        device = next(m.device for m in (metric_a, metric_b) if isinstance(m, Metric))
        super().__init__(device=device)
        self.op = operator
        for name, operand in (("metric_a", metric_a), ("metric_b", metric_b)):
            if isinstance(operand, Metric) or operand is None:
                setattr(self, name, operand)
            else:
                self.register_buffer(name, _operand(operand, device), persistent=False)

    def sync(self, *args: Any, **kwargs: Any) -> None:
        """No state of its own: each operand syncs in its own ``compute``."""

    def unsync(self, *args: Any, **kwargs: Any) -> None:
        pass

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            self._forward_cache = None
        elif val_b is None:
            if isinstance(self.metric_b, Metric):
                self._forward_cache = None
            else:
                self._forward_cache = self.op(val_a)
        else:
            self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()
        self._update_called = False
        self._forward_cache = None
        self._computed = None

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def __repr__(self) -> str:
        op_name = getattr(self.op, "__name__", "fn")
        return f"{type(self).__name__}(\n  {op_name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"
