"""MetricCollection: an ordered dict of metrics sharing one call signature.

Port of ``metrics_tpu/collections.py``. The collection is an
``nn.ModuleDict``; the pure API carries every member's state as one dict
``{member: state}``:

    state = coll.init_state()
    state = coll.update_state(state, preds, target)
    state = coll.update_state_masked(state, preds, target, mask=mask)
    values = coll.compute_from(state)
    values = coll.compute_synced(state)           # across a process group

The serving hooks (``update_state_segmented``, ``arena_layout``, the
``sync_precision`` policy) fan out to the members as the JAX package's do;
``sync_states`` syncs every member, nested metrics included, in one fused
bundle of collectives.

``forward`` fuses every member into one compiled step per input signature
(``_forward_fused``, the JAX package's protocol: the first call runs the
members' loop, the second builds the step): one CUDA graph on the card for
every member's ``update -> merge -> compute(delta)``. A membership change
drops the fused entries; a collection whose step cannot be built stays on the
loop, where each member takes its own compiled forward.
"""
import weakref
from copy import deepcopy
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from torch import nn

from metrics_tpu_torch.metric import (
    _FORWARD_JIT_CACHE,
    _MISS,
    Metric,
    _graph_keepalive,
    _jit_cache_lookup,
    _mark_eager_only,
    _merge_errcode,
    _sync_trees,
    sync_precision_tag_of,
)
from metrics_tpu_torch.parallel.mesh import MeshAxis, current_metric_axis
from metrics_tpu_torch.utils.checks import traced_rows


class MetricCollection(nn.ModuleDict):
    """An ordered dict of metrics sharing one call signature.

    Args:
        metrics: a Metric, a sequence of Metrics, or a dict name->Metric. Each
            member keeps its own device.
        prefix/postfix: added to every key in the output dict.
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self.add_metrics(metrics, *additional_metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                raise ValueError(
                    f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible with first passed dictionary."
            )
        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, Metric):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of `metrics_tpu_torch.Metric`"
                    )
                self[name] = metric
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, Metric):
                    raise ValueError(f"Input {metric} to `MetricCollection` is not a instance of `metrics_tpu_torch.Metric`")
                name = type(metric).__name__
                if name in self:
                    raise ValueError(f"Encountered two metrics both named {name}")
                self[name] = metric
        else:
            raise ValueError("Unknown input to MetricCollection.")

    # ------------------------------------------------------------------- eager facade

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Call every member; returns a dict of per-batch values.

        When every member can take the compiled path, the whole collection
        runs as ONE step (one CUDA graph on the card); otherwise the members
        run one by one, each through its own compiled forward where it can.
        """
        fast = self._forward_fused(args, kwargs)
        if fast is not _MISS:
            return fast
        return {self._set_name(k): m(*args, **m._filter_kwargs(**kwargs)) for k, m in self.items(keep_base=True)}

    def _forward_fused(self, args: Any, kwargs: Any) -> Any:
        """The fused compiled forward (``Metric._forward_fast``'s protocol
        over every member at once). Returns the renamed value dict or
        ``_MISS``."""
        members = self.items(keep_base=True)
        if not members:
            return _MISS
        # a full_state_update member needs the snapshot path (Metric.forward gates on it first)
        if any(m._is_synced or not m._forward_eligible() for _, m in members):
            return _MISS
        devices = {m.device for _, m in members}
        if len(devices) != 1:
            return _MISS  # one step runs on one device
        parsed = Metric._forward_signature(args, kwargs)
        if parsed is None:
            return _MISS
        inner_sig, array_idx, leaves = parsed
        # membership identity, each member's compute_on_step and the device
        # (a member moved on its own) key the step
        sig = (inner_sig, tuple((k, id(m), bool(m.compute_on_step)) for k, m in members), str(devices.pop()))
        entry, cache = _jit_cache_lookup(self, sig, lambda: self._build_fused_step(inner_sig, array_idx, leaves))
        if entry is None:
            return _MISS
        try:
            merged, values, codes = entry({k: m._pack_state() for k, m in members},
                                          [leaves[i] for i in array_idx])
        except Exception:
            _mark_eager_only(cache, sig)
            return _MISS
        out: Dict[str, Any] = {}
        for k, m in members:
            m._load_state(merged[k])
            m._mark_updated()
            val = values[k] if m.compute_on_step else None
            m._forward_cache = val
            m._deferred_errcode = _merge_errcode(m._deferred_errcode, codes[k])
            out[self._set_name(k)] = val
        return out

    def _build_fused_step(self, inner_sig: Any, array_idx: Tuple[int, ...], leaves: List[Any]) -> Any:
        from metrics_tpu_torch.engine.aot import forward_entry

        members = self.items(keep_base=True)
        compute_on_step = {k: bool(m.compute_on_step) for k, m in members}
        device = members[0][1].device
        # weak binding: the step must not pin the collection (nor, through it, its members)
        wself = weakref.ref(self)

        def step(states: Dict[str, Any], aux: Any, a: Tuple[Any, ...], kw: Dict[str, Any], mask: Any = None):
            coll = wself()
            assert coll is not None  # the caller holds a strong reference for the call
            merged: Dict[str, Any] = {}
            values: Dict[str, Any] = {}
            codes: Dict[str, Any] = {}
            with traced_rows():
                for k, m in coll.items(keep_base=True):
                    merged[k], values[k], codes[k] = m._forward_body(states[k], a, m._filter_kwargs(**kw),
                                                                     compute_on_step[k])
            return merged, (values, codes)

        return forward_entry(step, leaves, array_idx, inner_sig[0], device, _graph_keepalive(self))

    # ------------------------------------------------------------ membership

    def _invalidate_fused(self) -> None:
        """Membership changed: drop every fused step (and its signature slots)."""
        _FORWARD_JIT_CACHE.drop(self)

    def add_module(self, name: str, module: Optional[nn.Module]) -> None:
        # ``coll[k] = m``, ``add_metrics`` and ``register_module`` all land here
        self._invalidate_fused()
        super().add_module(name, module)

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, nn.Module) or name in self.__dict__.get("_modules", {}):
            self._invalidate_fused()
        super().__setattr__(name, value)

    def __delattr__(self, name: str) -> None:
        if name in self._modules:
            self._invalidate_fused()
        super().__delattr__(name)

    def __delitem__(self, key: str) -> None:
        self._invalidate_fused()
        super().__delitem__(key)

    def popitem(self) -> Tuple[str, Metric]:
        """Remove and return the last ``(name, metric)`` pair."""
        if not len(self):
            raise KeyError("popitem(): the collection is empty")
        key = list(self._modules)[-1]
        return key, self.pop(key)

    def clear(self) -> None:
        self._invalidate_fused()
        super().clear()

    def _apply(self, fn: Callable, recurse: bool = True) -> "MetricCollection":
        """``.to()``, ``.half()``... move the members: the fused steps read their old tensors."""
        self._invalidate_fused()
        return super()._apply(fn, recurse)

    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        for _, m in self.items(keep_base=True):
            m.update(*args, **m._filter_kwargs(**kwargs))

    def compute(self) -> Dict[str, Any]:
        return {self._set_name(k): m.compute() for k, m in self.items(keep_base=True)}

    def reset(self) -> None:
        for _, m in self.items(keep_base=True):
            m.reset()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for _, m in self.items(keep_base=True):
            m.persistent(mode)

    # -------------------------------------------------------------- functional path

    def init_state(self) -> Dict[str, Dict[str, Any]]:
        """One dict holding all member states: {metric_name: state_dict}."""
        return {k: m.init_state() for k, m in self.items(keep_base=True)}

    def update_state(self, state: Dict[str, Dict[str, Any]], *args: Any, **kwargs: Any) -> Dict[str, Dict[str, Any]]:
        """Pure fan-out update of all members."""
        return {
            k: m.update_state(state[k], *args, **m._filter_kwargs(**kwargs))
            for k, m in self.items(keep_base=True)
        }

    def merge_states(self, a: Dict[str, Dict[str, Any]], b: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
        """Pairwise merge of two collection states (member-wise, pure)."""
        return {k: m.merge_states(a[k], b[k]) for k, m in self.items(keep_base=True)}

    def masked_update_unsupported_reason(self) -> Optional[str]:
        """None when every member supports the mask-aware update path."""
        for k, m in self.items(keep_base=True):
            r = m.masked_update_unsupported_reason()
            if r is not None:
                return f"member {k!r}: {r}"
        return None

    def masked_update_strategies(self) -> Dict[str, Optional[str]]:
        """Each member's :meth:`Metric.masked_update_strategy`: which members
        ride the vmapped delta path and which take the sequential scan."""
        return {k: m.masked_update_strategy() for k, m in self.items(keep_base=True)}

    def update_state_masked(
        self, state: Dict[str, Dict[str, Any]], *args: Any, mask: Any, **kwargs: Any
    ) -> Dict[str, Dict[str, Any]]:
        """Mask-aware fan-out update of all members (the bucketed engine step:
        pad rows where ``mask`` is False contribute nothing; a scan member
        folds its rows in order inside the same step)."""
        return {
            k: m.update_state_masked(state[k], *args, mask=mask, **m._filter_kwargs(**kwargs))
            for k, m in self.items(keep_base=True)
        }

    def abstract_state(self) -> Dict[str, Dict[str, Any]]:
        """Every member's :meth:`Metric.abstract_state` (the arena template)."""
        return {k: m.abstract_state() for k, m in self.items(keep_base=True)}

    def segmented_update_unsupported_reason(self) -> Optional[str]:
        """None when every member supports the multi-stream segmented update."""
        for k, m in self.items(keep_base=True):
            r = m.segmented_update_unsupported_reason()
            if r is not None:
                return f"member {k!r}: {r}"
        return None

    def update_state_segmented(
        self,
        state: Dict[str, Dict[str, Any]],
        *args: Any,
        mask: Any,
        segment_ids: Any,
        num_segments: int,
        **kwargs: Any,
    ) -> Dict[str, Dict[str, Any]]:
        """Multi-stream fan-out update: every member's stream-stacked state
        rows addressed by ``segment_ids`` take the row deltas."""
        return {
            k: m.update_state_segmented(
                state[k], *args, mask=mask, segment_ids=segment_ids,
                num_segments=num_segments, **m._filter_kwargs(**kwargs),
            )
            for k, m in self.items(keep_base=True)
        }

    def arena_layout(self) -> Any:
        """Per-dtype packing plan over ALL member states (``engine/arena.py``)."""
        from metrics_tpu_torch.engine.arena import ArenaLayout

        return ArenaLayout.for_state(self.abstract_state())

    def set_sync_precision(self, spec: Union[str, Dict[str, Union[str, Dict[str, str]]]]) -> "MetricCollection":
        """The collection's quantization policy (chainable): a blanket string
        fans out to every member, a dict keyed by member name routes
        per-member specs."""
        if isinstance(spec, str):
            for _, m in self.items(keep_base=True):
                m.set_sync_precision(spec)
        elif isinstance(spec, dict):
            for name, sub in spec.items():
                if name not in self:
                    raise ValueError(f"no member named {name!r} in this collection")
                self[name].set_sync_precision(sub)
        else:
            raise ValueError(f"sync_precision spec must be a string or a per-member dict, got {type(spec).__name__}")
        return self

    def state_sync_precisions(self) -> Dict[str, str]:
        """Flat ``{member.state: precision}`` over every member."""
        return {f"{k}.{path}": prec for k, m in self.items(keep_base=True)
                for path, prec in m.state_sync_precisions().items()}

    def sync_precision_tag(self) -> str:
        """Policy tag (see ``Metric.sync_precision_tag``)."""
        return sync_precision_tag_of(self.state_sync_precisions())

    def compute_from(self, state: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        return {self._set_name(k): m.compute_from(state[k]) for k, m in self.items(keep_base=True)}

    # ------------------------------------------------------------------ sync

    def sync_states(self, state: Dict[str, Dict[str, Any]], group: Optional[Any] = None) -> Dict[str, Dict[str, Any]]:
        """Every member's :meth:`Metric.sync_states` in ONE fused bundle of
        collectives, however many members and nested metrics: ``group``, else
        the ambient group, else the default one. Unchanged without an
        initialised group."""
        members = self.items(keep_base=True)
        group = group if group is not None else current_metric_axis()
        if isinstance(group, MeshAxis):
            # the W shards' collection states in, the W synced states out
            synced = _sync_trees([(m, [s[k] for s in state]) for k, m in members], group)
            return [{k: per[j] for (k, _), per in zip(members, synced)} for j in range(group.world)]
        synced = _sync_trees([(m, state[k]) for k, m in members], group)
        return {k: s for (k, _), s in zip(members, synced)}

    def compute_synced(self, state: Dict[str, Dict[str, Any]], group: Optional[Any] = None) -> Dict[str, Any]:
        return self.compute_from(self.sync_states(state, group))

    def merge_stacked_states(self, stacked: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
        """Member-wise :meth:`Metric.merge_stacked_states`."""
        return {k: m.merge_stacked_states(stacked[k]) for k, m in self.items(keep_base=True)}

    def stacked_merge_unsupported_reason(self) -> Optional[str]:
        """None when every member's states fold across a stack axis."""
        for k, m in self.items(keep_base=True):
            r = m.stacked_merge_unsupported_reason()
            if r is not None:
                return f"member {k!r}: {r}"
        return None

    def sync_leaf_info(self) -> List[Any]:
        """Every member's :meth:`Metric.sync_leaf_info`, in member order."""
        return [leaf for _, m in self.items(keep_base=True) for leaf in m.sync_leaf_info()]

    def sync_error_bounds(self, state: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Every member's :meth:`Metric.sync_error_bounds` over a rank-stacked
        collection state, keys prefixed by member name."""
        return {f"{k}.{path}": bound for k, m in self.items(keep_base=True)
                for path, bound in m.sync_error_bounds(state[k]).items()}

    def host_compute_attrs(self) -> Dict[str, Any]:
        """Flat ``{member.attr: value}`` of every member's host-derived compute attributes."""
        return {f"{k}.{a}": v for k, m in self.items(keep_base=True) for a, v in m.host_compute_attrs().items()}

    def restore_host_compute_attrs(self, attrs: Dict[str, Any]) -> None:
        for k, m in self.items(keep_base=True):
            prefix = f"{k}."
            m.restore_host_compute_attrs({p[len(prefix):]: v for p, v in attrs.items() if p.startswith(prefix)})

    # ------------------------------------------------------------------------- naming

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def items(self, keep_base: bool = False) -> Iterable[Tuple[str, Metric]]:  # type: ignore[override]
        if keep_base:
            return list(super().items())
        return [(self._set_name(k), v) for k, v in super().items()]

    def keys(self, keep_base: bool = False) -> Iterable[str]:  # type: ignore[override]
        if keep_base:
            return list(super().keys())
        return [self._set_name(k) for k in super().keys()]
