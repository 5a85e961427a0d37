"""State arenas: pack a metric-state tree into one buffer per dtype.

Port of ``metrics_tpu/engine/arena.py``. All state leaves of one dtype
concatenate (raveled) into one contiguous 1-D tensor, so an engine step
carries one buffer per dtype class however many metrics a collection serves,
and the megastep kernels (K5–K7) fold a whole dtype in one launch. The
packing plan (:class:`ArenaLayout`) is static metadata derived from
``abstract_state()``: per leaf, its dtype segment, offset, flat size and shape.

The leaves are taken in the JAX package's order (dicts by sorted key,
``utils/tree.py``), so a layout's column offsets, its megastep op rows and its
q8 column masks are the JAX package's, element for element: spilled rows and
bridged arenas carry across the two packages unchanged.

Invariants: one buffer per distinct state dtype; ``unpack(pack(tree)) ==
tree`` bit-exactly; buffer keys are dtype names (``"float32"``, ``"int32"``,
as ``jnp.dtype(...).name`` spells them).
"""
import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.ops.kernels.common import int32_bits
from metrics_tpu_torch.utils.tree import spell_treedef, tree_flatten, tree_unflatten

__all__ = ["ArenaLayout", "dtype_key", "gather_rows", "scatter_rows"]


def dtype_key(dtype: torch.dtype) -> str:
    """The buffer key of a torch dtype: its name as numpy and JAX spell it."""
    return str(dtype).replace("torch.", "")


def gather_rows(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``buf[idx]``; a uint32 buffer through its int32 bits (torch has no
    uint32 index kernels)."""
    if buf.dtype == torch.uint32:
        return int32_bits(buf)[idx].view(torch.uint32)
    return buf[idx]


def scatter_rows(buf: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """``buf[idx] = rows`` in place; a uint32 buffer through its int32 bits."""
    rows = rows.to(buf.dtype)
    if buf.dtype == torch.uint32:
        int32_bits(buf)[idx] = int32_bits(rows)
    else:
        buf[idx] = rows


class _LeafSpec:
    __slots__ = ("key", "offset", "size", "shape", "dtype")

    def __init__(self, key: str, offset: int, size: int, shape: Tuple[int, ...], dtype: torch.dtype):
        self.key = key
        self.offset = offset
        self.size = size
        self.shape = shape
        self.dtype = dtype


class ArenaLayout:
    """Static plan for packing a state tree into per-dtype 1-D buffers.

    Build one from a metric via :meth:`Metric.arena_layout` (or directly with
    :meth:`for_state` on any tree of tensors or ``metric.StateSpec``s). Pure
    metadata, safe to share across engines over equivalently-shaped states.
    """

    def __init__(self, treedef: Any, specs: List[_LeafSpec], totals: Dict[str, int],
                 spelled: Optional[str] = None, unspellable: Optional[TypeError] = None):
        self._treedef = treedef
        self._specs = specs
        self._totals = totals  # dtype key -> flat element count
        # repr of the JAX package's treedef of the state (the JAX-form
        # fingerprint hashes it), or why the state has none
        self._spelled = spelled
        self._unspellable = unspellable

    @classmethod
    def for_state(cls, abstract_state: Any) -> "ArenaLayout":
        """The packing plan of a tree whose leaves have ``shape`` and
        ``dtype`` (``StateSpec``s or tensors). List (cat) states have no
        static arena slot: the engine refuses those metrics earlier."""
        leaves, treedef = tree_flatten(abstract_state)
        totals: Dict[str, int] = {}
        specs: List[_LeafSpec] = []
        for leaf in leaves:
            shape = getattr(leaf, "shape", None)
            dtype = getattr(leaf, "dtype", None)
            if shape is None or dtype is None:
                raise ValueError(f"arena layouts need array-shaped state leaves, got {type(leaf).__name__}")
            key = dtype_key(dtype)
            shape = tuple(int(d) for d in shape)
            size = int(np.prod(shape, dtype=np.int64))
            specs.append(_LeafSpec(key, totals.get(key, 0), size, shape, dtype))
            totals[key] = totals.get(key, 0) + size
        try:
            return cls(treedef, specs, totals, spelled=spell_treedef(abstract_state)[1])
        except TypeError as e:
            return cls(treedef, specs, totals, unspellable=e)

    # ------------------------------------------------------------------ queries

    @property
    def num_buffers(self) -> int:
        return len(self._totals)

    @property
    def dtype_keys(self) -> Tuple[str, ...]:
        return tuple(sorted(self._totals))

    @property
    def num_leaves(self) -> int:
        return len(self._specs)

    def buffer_sizes(self) -> Dict[str, int]:
        """Flat element count per dtype buffer."""
        return dict(self._totals)

    def leaf_slices(self) -> Tuple[Tuple[str, int, int, Tuple[int, ...], torch.dtype], ...]:
        """One ``(dtype_key, offset, size, shape, dtype)`` per leaf, in
        flatten order: column ``offset + i`` of dtype ``key``'s buffer is
        element ``i`` of that leaf's ravel."""
        return tuple((s.key, s.offset, s.size, s.shape, s.dtype) for s in self._specs)

    def column_ops(self, leaf_ops: List[int]) -> Dict[str, np.ndarray]:
        """Expand a per-leaf integer opcode list (flatten order) into per-dtype
        opcode column rows aligned with the packed buffers (host numpy)."""
        if len(leaf_ops) != len(self._specs):
            raise ValueError(f"got {len(leaf_ops)} leaf opcodes, layout has {len(self._specs)} leaves")
        rows = {k: np.zeros((n,), np.int32) for k, n in self._totals.items()}
        for spec, op in zip(self._specs, leaf_ops):
            rows[spec.key][spec.offset : spec.offset + spec.size] = int(op)
        return rows

    def abstract_paned(self, panes: int) -> Dict[str, Any]:
        """``StateSpec`` dict of the PANE-RING arena: one ``(panes, n)`` buffer
        per dtype, row ``p`` pane ``p``'s packed state for this layout (a
        tumbling or sliding engine's carried form). Each row is a contiguous
        view, the form a captured step reads and writes."""
        from metrics_tpu_torch.metric import StateSpec

        return {k: StateSpec((int(panes), n), self._specs_dtype(k)) for k, n in self._totals.items()}

    def _specs_dtype(self, key: str) -> torch.dtype:
        return next(s.dtype for s in self._specs if s.key == key)

    def matches(self, arena: Dict[str, Any], world: Optional[int] = None, panes: Optional[int] = None) -> bool:
        """Shape compatibility of the BUFFERS (restoring a snapshot): one
        buffer per dtype key, each ``lead + (n,)``, where ``lead`` is
        ``(world,)`` for a shard-stacked arena, ``(panes,)`` for a pane ring,
        both for the deferred windowed form. Necessary but not sufficient:
        permuted same-dtype leaves give identical buffers, which
        :meth:`fingerprint` tells apart."""
        if set(arena) != set(self._totals):
            return False
        lead: Tuple[int, ...] = ()
        if world is not None:
            lead += (int(world),)
        if panes is not None:
            lead += (int(panes),)
        return all(tuple(getattr(arena[k], "shape", ())) == lead + (n,) for k, n in self._totals.items())

    def fingerprint(self) -> str:
        """Digest of the full packing plan in the JAX package's form: the
        ``repr`` of JAX's treedef of the state (spelled by
        :func:`~metrics_tpu_torch.utils.tree.spell_treedef`) plus every
        leaf's ``key:offset:size:shape:dtype``. Two layouts unpack a buffer
        identically iff their fingerprints match, and a layout's fingerprint
        equals the JAX package's for the same state, so a snapshot's
        ``arena_fp`` is checked across the packages. Raises, naming it, for
        a state node the JAX form cannot spell."""
        if self._spelled is None:
            raise TypeError(f"this layout has no fingerprint in the JAX package's form: {self._unspellable}")
        h = hashlib.sha256(self._spelled.encode())
        for s in self._specs:
            h.update(f"{s.key}:{s.offset}:{s.size}:{s.shape}:{dtype_key(s.dtype)}".encode())
        return h.hexdigest()[:16]

    @staticmethod
    def clone_buffers(arena: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A copy of a packed arena, one clone per dtype buffer."""
        return {k: v.clone() for k, v in arena.items()}

    # ------------------------------------------------------------- pack / unpack

    def _leaves(self, state: Any) -> List[Any]:
        leaves = tree_flatten(state)[0]
        if len(leaves) != len(self._specs):
            raise ValueError(f"state has {len(leaves)} leaves, layout expects {len(self._specs)}")
        return leaves

    def pack(self, state: Any) -> Dict[str, torch.Tensor]:
        """State tree -> per-dtype 1-D buffers."""
        return self.pack_stacked(state, lead=0)

    def unpack(self, arena: Dict[str, torch.Tensor]) -> Any:
        """Per-dtype buffers -> state tree (leaves are views of the buffers)."""
        return self.unpack_stacked(arena, lead=0)

    def pack_stacked(self, state: Any, lead: int = 1) -> Dict[str, torch.Tensor]:
        """Stacked state tree (``lead`` leading stack axes on every leaf) ->
        per-dtype ``leading + (n,)`` buffers: the per-row packing applied
        row-wise (the paged engine's slot-stacked form, a pane ring's
        ``(panes, n)`` form; ``lead=2`` a snapshot's ``(world, panes, n)``)."""
        parts: Dict[str, List[torch.Tensor]] = {k: [] for k in self._totals}
        for leaf, spec in zip(self._leaves(state), self._specs):
            arr = torch.as_tensor(leaf).to(spec.dtype)
            parts[spec.key].append(arr.reshape(tuple(arr.shape[:lead]) + (spec.size,)))
        return {k: (torch.cat(chunks, dim=lead) if len(chunks) > 1 else chunks[0].contiguous())
                for k, chunks in parts.items()}

    def unpack_stacked(self, arena: Dict[str, torch.Tensor], lead: int = 1) -> Any:
        """Inverse of :meth:`pack_stacked`: every leaf gains the ``lead``
        leading axes of the buffers."""
        leading = tuple(next(iter(arena.values())).shape[:lead])
        leaves = [arena[s.key][..., s.offset : s.offset + s.size].reshape(leading + s.shape) for s in self._specs]
        return tree_unflatten(self._treedef, leaves)

    def __repr__(self) -> str:
        segs = ", ".join(f"{k}:{n}" for k, n in sorted(self._totals.items()))
        return f"ArenaLayout({len(self._specs)} leaves -> {self.num_buffers} buffers [{segs}])"
