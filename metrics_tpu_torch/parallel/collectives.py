"""State synchronisation over a ``torch.distributed`` process group.

Port of ``metrics_tpu/parallel/collectives.py``. Where the JAX package reduces
over a named mesh axis inside ``shard_map``, the port reduces over a
``torch.distributed.ProcessGroup`` (``None`` is the default group): NCCL for
CUDA tensors, gloo for CPU ones. The names are JAX's:

* :func:`in_mapped_context` / :func:`axis_size_or_one` answer "is a group
  initialised here with more than one rank" and "its world size";
* :func:`all_gather_cat`, :func:`all_gather_stack` and
  :func:`sync_axis_state` lower one state's ``dist_reduce_fx``;
* :func:`fused_axis_sync` syncs many ``(dist_reduce_fx, tensor)`` leaves in a
  bounded bundle, however many metrics and states: ONE f32 ``all_reduce`` for
  every ``sum`` leaf of a float or <=32-bit integer dtype (integers ride as
  base-2**bits digits each f32-exactly summable, so the result is JAX's u32
  wraparound sum bit for bit, negatives and overflow included), one
  ``all_reduce`` per (reduction, dtype) for ``mean``/``min``/``max`` and the
  ``sum`` leaves no rider takes (f64, int64, bool), and ONE ``all_gather`` for
  every ``cat``/None/callable leaf and every ``q8_block`` leaf.

Where the port's bundle differs from JAX's, and why:

* the gather carries BYTES (each leaf's ``uint8`` view), not JAX's u32 words:
  the u32 layout exists for XLA's bitcasts, and NCCL and gloo gather bytes.
  Sub-word leaves are not padded, so :func:`fused_sync_plan` counts
  ``gather_bytes`` where JAX counts ``gather_words``;
* ``mean``/``min``/``max`` leaves of a dtype the collectives lack travel
  widened and come back in JAX's result dtype: int16/uint16 as int32, uint32
  as int64, bool as uint8 for min/max; integer means sum in int64 and wrap
  to the leaf's dtype before the division, as JAX's ``pmean`` (a ``psum`` in
  the leaf's dtype, then a true division) does. gloo has no AVG, so every
  ``mean`` is a sum divided by the world size. :func:`sync_payload_bytes`
  counts the widened wire bytes;
* a 0-d ``cat`` leaf gathers to ``(world,)`` (JAX's bundle cannot take one;
  its stacked merge gives the same layout).

Quantized sync: a float ``sum`` leaf whose precision is ``"q8_block"``
leaves the f32 all-reduce and rides the gather as block-scaled int8 codes
plus their f32 scales (:data:`Q8_BLOCK` elements per scale, half-to-even
rounding, near-subnormal blocks flushed below :data:`Q8_FLUSH`); each rank's
contribution is decoded against its own scales and the sum folds in f32, so
the error is bounded by :func:`q8_sum_error_bound`.

The in-process mesh form: with a :class:`~metrics_tpu_torch.parallel.mesh.MeshAxis`
in place of a process group, every value is a LIST of the W shards' tensors
(shard ``k`` on the axis's device ``k``), and every result one too (JAX's
``shard_map`` view: each shard sees the replicated result). The bundle is the
same one (the same buckets, the same rider and codec); only the transport
differs, picked by the mesh's layout alone: ``"nccl"`` issues each collective
as ONE ``torch.cuda.nccl`` group call over the W per-device tensors,
``"one_device"`` stacks the shards on a leading axis and reduces over it.
A failure raises; the transport never changes.

Every collective this module issues adds one to :func:`collective_counts`,
in either form. :func:`hierarchical_fold_bytes` counts the fleet's fold
by leg. ``HLO_COLLECTIVE_RE`` has no counterpart (it reads XLA's HLO text).
"""
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from metrics_tpu_torch.parallel.mesh import MeshAxis
from metrics_tpu_torch.utils.data import METRIC_EPS

Tensor = torch.Tensor

#: elements per absmax-scale block of the block-scaled int8 codec
Q8_BLOCK = 32

#: the declared sync precisions; "exact" is the default everywhere
SYNC_PRECISIONS = ("exact", "q8_block")

#: blocks whose absmax sits below this flush to zero codes: the scale
#: absmax/127 would be subnormal there, and 1/scale overflows f32
Q8_FLUSH = 1.5e-36

_REDUCE_OPS = {"sum": "SUM", "mean": "SUM", "min": "MIN", "max": "MAX"}

_COUNTS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "ppermute": 0}

#: ``ncclRedOp_t`` values (``torch.cuda.nccl`` names only SUM)
_NCCL_OPS = {"SUM": 0, "MAX": 2, "MIN": 3}


def collective_counts() -> Dict[str, int]:
    """Collectives issued by this module since :func:`reset_collective_counts`,
    by kind (``all_reduce``, ``all_gather``, ``ppermute``)."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


# ------------------------------------------------------------------ group helpers


def group_size(group: Optional[Any] = None) -> int:
    """The world size of ``group`` (None = the default group; a
    :class:`MeshAxis` counts its shards), or 0 when no process group is
    initialised or this rank is not a member of it."""
    if isinstance(group, MeshAxis):
        return group.world
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    if group is not None and dist.get_rank(group) < 0:
        return 0
    return int(dist.get_world_size(group))


def in_mapped_context(group: Optional[Any] = None) -> bool:
    """True when ``group`` is initialised here and has more than one rank:
    its states can differ across ranks."""
    return group_size(group) > 1


def axis_size_or_one(group: Optional[Any] = None) -> int:
    """The world size of ``group``, or 1 outside it."""
    return max(1, group_size(group))


def _all_reduce(flat: Tensor, op: str, group: Optional[Any]) -> Tensor:
    _COUNTS["all_reduce"] += 1
    dist.all_reduce(flat, op=getattr(dist.ReduceOp, op), group=group)
    return flat


def _all_gather(x: Tensor, group: Optional[Any]) -> Tensor:
    """``(world,) + x.shape``: every rank's ``x``, stacked in rank order."""
    world = axis_size_or_one(group)
    x = x.contiguous()
    out = x.new_empty((world * x.numel(),))
    _COUNTS["all_gather"] += 1
    dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
    return out.reshape((world,) + tuple(x.shape))


def _mesh_all_reduce(parts: List[Tensor], op: str, axis: MeshAxis) -> List[Tensor]:
    """One all-reduce over the W shards' flat tensors: the result on every
    shard's device (one tensor, shared, on a one-device mesh)."""
    _COUNTS["all_reduce"] += 1
    if axis.transport == "nccl":
        import torch.cuda.nccl as nccl

        parts = [p.contiguous() for p in parts]
        nccl.all_reduce(parts, op=_NCCL_OPS[op])
        return parts
    stacked = torch.stack(parts)
    if op == "SUM":
        red = stacked.sum(0, dtype=stacked.dtype)
    else:
        red = stacked.amin(0) if op == "MIN" else stacked.amax(0)
    return [red] * len(parts)


def _mesh_all_gather(parts: List[Tensor], axis: MeshAxis) -> List[Tensor]:
    """``(world,) + x.shape`` on every shard's device: each shard's ``x``
    stacked in shard order."""
    _COUNTS["all_gather"] += 1
    flat = [p.contiguous().reshape(-1) for p in parts]
    shape = (len(parts),) + tuple(parts[0].shape)
    if axis.transport == "nccl":
        import torch.cuda.nccl as nccl

        outs = [f.new_empty((len(flat) * f.numel(),)) for f in flat]
        nccl.all_gather(flat, outs)
        return [o.reshape(shape) for o in outs]
    return [torch.stack(flat).reshape(shape)] * len(parts)


def mesh_all_gather_tiled(parts: List[Tensor], axis: MeshAxis, dim: int = 0) -> List[Tensor]:
    """JAX's tiled ``all_gather`` over a mesh axis: the W shards' tensors
    concatenated along ``dim`` in shard order, on every shard's device (one
    tensor, shared, on a one-device mesh). One ``all_gather``."""
    gathered = _mesh_all_gather(parts, axis)
    out: Dict[int, Tensor] = {}
    for g in gathered:
        if id(g) not in out:  # (W, ...) -> the W slices laid end to end along dim
            out[id(g)] = torch.cat(list(g.unbind(0)), dim=dim)
    return [out[id(g)] for g in gathered]


def mesh_ppermute(parts: List[Optional[Tensor]], axis: MeshAxis, perm: Sequence[Tuple[int, int]]) -> List[Optional[Tensor]]:
    """JAX's ``ppermute`` over a mesh axis: for each ``(src, dst)`` of
    ``perm``, shard ``dst`` receives shard ``src``'s tensor on its own
    device; a shard no pair names receives None. Across devices each is one
    peer copy, which PyTorch orders against both devices' current streams
    with events (no device-wide synchronize). One ``ppermute``."""
    _COUNTS["ppermute"] += 1
    out: List[Optional[Tensor]] = [None] * axis.world
    for src, dst in perm:
        if parts[src] is not None:
            out[dst] = parts[src].to(axis.devices[dst], non_blocking=True)
    return out


def all_gather_cat(x: Any, group: Optional[Any] = None) -> Any:
    """Gather shards along dim 0 (the "cat" reduction): ``(n, ...)`` ->
    ``(world*n, ...)`` (per shard, from the W shards' tensors, over a
    :class:`MeshAxis`)."""
    if isinstance(group, MeshAxis):
        return [g.reshape((-1,) + tuple(x[0].shape[1:])) for g in _mesh_all_gather(x, group)]
    g = _all_gather(x, group)
    return g.reshape((-1,) + tuple(x.shape[1:]))


def all_gather_stack(x: Any, group: Optional[Any] = None) -> Any:
    """Gather shards stacked on a new leading dim: ``(...)`` -> ``(world, ...)``,
    the post-sync layout of ``dist_reduce_fx=None`` tensor states."""
    if isinstance(group, MeshAxis):
        return _mesh_all_gather(x, group)
    return _all_gather(x, group)


def sync_axis_state(reduce_fx: Any, value: Any, group: Optional[Any] = None) -> Any:
    """One state's ``dist_reduce_fx`` as the matching collective over ``group``
    (per shard, from the W shards' tensors, over a :class:`MeshAxis`)."""
    return fused_axis_sync([(reduce_fx, value)], group)[0]


# -------------------------------------------------------------------- the bundle


_INT_RIDERS = (torch.int8, torch.uint8, torch.int16, torch.uint16, torch.int32, torch.uint32)
_FLOAT_RIDERS = (torch.float32, torch.float16, torch.bfloat16)


def _sum_rider(dtype: torch.dtype) -> Optional[str]:
    """How a 'sum' leaf of ``dtype`` rides the shared f32 all-reduce (None = it
    cannot: f64, int64 and bool take a reduce bucket of their own)."""
    if dtype in _FLOAT_RIDERS:
        return "float"
    if dtype in _INT_RIDERS:
        return "int"
    return None


def _bucket(fx: Any, dtype: torch.dtype, prec: Optional[str]) -> str:
    """Which collective of the bundle a leaf rides: ``"q8"``, ``"sum"``,
    ``"reduce"`` or ``"gather"``. The one rule :func:`fused_axis_sync` and
    :func:`fused_sync_plan` share."""
    prec = prec or "exact"
    if prec not in SYNC_PRECISIONS:
        raise ValueError(f"unknown sync precision {prec!r}; expected one of {SYNC_PRECISIONS}")
    if prec == "q8_block":
        if fx != "sum" or _sum_rider(dtype) != "float":
            raise ValueError(
                f"sync_precision='q8_block' needs a float 'sum' leaf, got dist_reduce_fx={fx!r} dtype={dtype} — "
                "counts, cat buffers and min/max states must stay exact"
            )
        return "q8"
    if fx == "sum" and _sum_rider(dtype) is not None:
        return "sum"
    if isinstance(fx, str) and fx in _REDUCE_OPS:
        return "reduce"
    if fx == "cat" or fx is None or callable(fx):
        return "gather"
    raise ValueError(f"unknown dist_reduce_fx: {fx!r}")


def _int_split_bits(world: int) -> int:
    """Bits per integer digit so the f32 all-reduce over ``world`` ranks stays
    exact: each digit < 2**bits, so digit sums < world * 2**bits <= 2**24."""
    headroom = max(1, int(math.ceil(math.log2(max(world, 1)))))
    return max(1, min(16, 24 - headroom))


def _wrap_int(total: Tensor, dtype: torch.dtype) -> Tensor:
    """int64 ``total`` reduced modulo 2**bits of ``dtype`` (two's complement
    for the signed ones) and cast: the wraparound of a sum in ``dtype``."""
    bits = dtype.itemsize * 8
    if bits >= 64:  # an int64 sum wraps by itself
        return total.to(dtype)
    low = total & ((1 << bits) - 1)
    if dtype.is_signed:
        low = torch.where(low >= (1 << (bits - 1)), low - (1 << bits), low)
    return low.to(dtype)


def _to_sum_rider(v: Tensor, bits: int) -> Tensor:
    """One 'sum' leaf as a flat f32 payload of the shared all-reduce: floats
    widen (exactly), integers split their u32 bit pattern into digits."""
    flat = v.reshape(-1)
    if _sum_rider(v.dtype) == "float":
        return flat.to(torch.float32)
    u = flat.to(torch.int64) & 0xFFFFFFFF
    mask = (1 << bits) - 1
    return torch.cat([((u >> (bits * p)) & mask).to(torch.float32) for p in range(-(-32 // bits))])


def _from_sum_rider(piece: Tensor, ref: Tensor, bits: int) -> Tensor:
    """Decode a summed payload to the leaf's dtype: the digits reassemble
    modulo 2**32, the native integer sum's wraparound included."""
    if _sum_rider(ref.dtype) == "float":
        return piece.reshape(ref.shape).to(ref.dtype)
    parts = piece.reshape(-(-32 // bits), -1).to(torch.int64)
    total = torch.zeros_like(parts[0])
    for p in range(parts.shape[0]):
        total = total + (parts[p] << (bits * p))
    return _wrap_int(total & 0xFFFFFFFF, ref.dtype).reshape(ref.shape)


def _wire_dtype(fx: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype a reduce-bucket leaf travels in: the collectives have no
    int16, uint16 or uint32; bool sums count in int32 (JAX's ``psum`` of a
    bool); integer means sum in int64 and wrap afterwards."""
    if fx == "sum":
        return torch.int32 if dtype == torch.bool else dtype
    if fx == "mean" and not dtype.is_floating_point:
        return torch.int64
    if dtype in (torch.int16, torch.uint16):
        return torch.int32
    if dtype == torch.uint32:
        return torch.int64
    if dtype == torch.bool:
        return torch.uint8
    return dtype


def _from_reduced(piece: Tensor, fx: str, dtype: torch.dtype, world: int) -> Tensor:
    """A reduce bucket's result in the dtype JAX's collective gives."""
    if fx == "sum":
        return piece
    if fx == "mean":  # a tensor divisor: see _q8_encode
        if dtype.is_floating_point:
            return piece / piece.new_full((), world)
        summed = piece.to(torch.int32) if dtype == torch.bool else _wrap_int(piece, dtype)
        return summed.to(torch.float32) / torch.full((), world, dtype=torch.float32, device=piece.device)
    return piece.to(dtype)


def _to_bytes(v: Tensor) -> Tensor:
    return v.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(raw: Tensor, dtype: torch.dtype, shape: Tuple[int, ...]) -> Tensor:
    """Inverse of :func:`_to_bytes` for a gathered ``(world, nbytes)`` slab:
    ``(world,) + shape`` in ``dtype``. The bytes are copied first: a slice of
    the gathered buffer may start at an offset ``dtype`` cannot view."""
    own = torch.empty(raw.shape, dtype=torch.uint8, device=raw.device).copy_(raw)
    return own.view(dtype).reshape((raw.shape[0],) + tuple(shape))


class _GroupTransport:
    """The bundle's transport over a process group: one participant, this
    rank's tensors."""

    def __init__(self, group: Optional[Any], device: torch.device):
        self.group = group
        self.world = axis_size_or_one(group)
        self.devices = [device]
        self.decoded = range(1)

    def all_reduce(self, parts: List[Tensor], op: str) -> List[Tensor]:
        return [_all_reduce(parts[0], op, self.group)]

    def all_gather(self, parts: List[Tensor]) -> List[Tensor]:
        return [_all_gather(parts[0], self.group)]

    def spread(self, per: List[Tensor]) -> List[Tensor]:
        return per


class _MeshTransport:
    """The bundle's transport over a :class:`MeshAxis`: the W shards are the
    participants, each collective one call over their payloads. On a
    one-device mesh the shards' results are one tensor, decoded once and
    shared."""

    def __init__(self, axis: MeshAxis):
        self.axis = axis
        self.world = axis.world
        self.devices = axis.devices
        self.decoded = range(axis.world if axis.transport == "nccl" else 1)

    def all_reduce(self, parts: List[Tensor], op: str) -> List[Tensor]:
        return _mesh_all_reduce(parts, op, self.axis)

    def all_gather(self, parts: List[Tensor]) -> List[Tensor]:
        return _mesh_all_gather(parts, self.axis)

    def spread(self, per: List[Tensor]) -> List[Tensor]:
        return per if len(per) == self.world else per * self.world


def _from_gathered(fx: Any, raw: Tensor, ref: Tensor, world: int) -> Tensor:
    """A gather-bucket leaf from its ``(world, nbytes)`` slab: ``cat`` as
    ``(world*n, ...)``, None as ``(world, ...)``, a callable folding the
    ranks' values pairwise in rank order."""
    piece = _from_bytes(raw, ref.dtype, tuple(ref.shape))
    if fx == "cat":
        return piece.reshape((-1,) + tuple(ref.shape[1:]))
    if fx is None:
        return piece
    acc = piece[0]
    for w in range(1, world):
        acc = fx(acc, piece[w])
    return acc


def _fused_sync(leaves: List[Tuple[Any, List[Tensor]]], t: Any,
                precisions: Optional[Sequence[Optional[str]]]) -> List[List[Tensor]]:
    """The bundle over transport ``t``: each leaf's value is the list of the
    participants' tensors (this rank's alone over a process group, the W
    shards' over a mesh axis), and so is each result."""
    n_parts = len(t.devices)
    out: List[Optional[List[Tensor]]] = [None] * len(leaves)
    buckets: Dict[str, List[int]] = {"sum": [], "gather": [], "q8": []}
    reduce_buckets: Dict[Tuple[str, torch.dtype], List[int]] = {}
    for i, (fx, parts) in enumerate(leaves):
        if len(parts) != n_parts:
            raise ValueError(f"a sync over {n_parts} participants got {len(parts)} values for a leaf")
        kind = _bucket(fx, parts[0].dtype, precisions[i] if precisions is not None else None)
        if kind == "reduce":
            reduce_buckets.setdefault((fx, parts[0].dtype), []).append(i)
        else:
            buckets[kind].append(i)
    world = t.world

    def collect(idxs: List[int], encode: Callable[[int, Tensor], Tensor]) -> Tuple[List[Tensor], List[int]]:
        """Each participant's flat payload of ``idxs``, on its device; each
        leaf's size in it."""
        pieces = [[encode(i, leaves[i][1][k]) for i in idxs] for k in range(n_parts)]
        return [torch.cat(p).to(t.devices[k]) for k, p in enumerate(pieces)], [p.numel() for p in pieces[0]]

    def unpack(idxs: List[int], sizes: List[int], synced: List[Tensor],
               decode: Callable[[int, int, Tensor], Tensor]) -> None:
        off = 0
        for i, n in zip(idxs, sizes):
            out[i] = t.spread([decode(i, k, synced[k][..., off : off + n]) for k in t.decoded])
            off += n

    if buckets["sum"]:
        bits = _int_split_bits(world)
        payloads, sizes = collect(buckets["sum"], lambda i, v: _to_sum_rider(v, bits))
        unpack(buckets["sum"], sizes, t.all_reduce(payloads, "SUM"),
               lambda i, k, piece: _from_sum_rider(piece, leaves[i][1][k], bits))

    for (fx, dtype), idxs in reduce_buckets.items():
        wire = _wire_dtype(fx, dtype)
        payloads, sizes = collect(idxs, lambda i, v: v.reshape(-1).to(wire))
        unpack(idxs, sizes, t.all_reduce(payloads, _REDUCE_OPS[fx]),
               lambda i, k, piece: _from_reduced(piece, fx, dtype, world).reshape(leaves[i][1][k].shape))

    gather, q8 = buckets["gather"] + buckets["q8"], set(buckets["q8"])
    if gather:
        payloads, sizes = collect(gather, lambda i, v: _q8_carrier(v) if i in q8 else _to_bytes(v))
        unpack(gather, sizes, t.all_gather(payloads),  # (world, bytes) a participant
               lambda i, k, raw: (_q8_sum_from_gathered(raw, leaves[i][1][k]) if i in q8
                                  else _from_gathered(leaves[i][0], raw, leaves[i][1][k], world)))
    return out  # type: ignore[return-value]


def fused_axis_sync(
    leaves: List[Tuple[Any, Tensor]],
    group: Optional[Any] = None,
    precisions: Optional[Sequence[Optional[str]]] = None,
) -> List[Tensor]:
    """Sync many ``(reduce_fx, value)`` state leaves over ``group`` with a
    bounded collective bundle (see the module docstring): at most one f32
    all-reduce, one all-reduce per (reduction, dtype) of the rest, and one
    byte all-gather, however many leaves.

    ``precisions`` aligns with ``leaves``; None (or ``"exact"`` entries)
    keeps every leaf exact. Returns the synced values in input order: sums,
    means, mins and maxes in the leaf's shape; ``cat`` as ``(world*n, ...)``;
    None as ``(world, ...)``; a callable folds the ranks' values pairwise in
    rank order. Over a :class:`MeshAxis` every value and result is the list
    of the W shards' tensors: the same bundle, over the mesh's transport.
    """
    if not leaves:
        return []
    if isinstance(group, MeshAxis):
        return _fused_sync(leaves, _MeshTransport(group), precisions)
    synced = _fused_sync([(fx, [v]) for fx, v in leaves], _GroupTransport(group, leaves[0][1].device), precisions)
    return [s[0] for s in synced]


# ------------------------------------------------------------ the q8_block rider


def _q8_block_count(n: int, block: int = Q8_BLOCK) -> int:
    return -(-int(n) // int(block))


def q8_carrier_words(n: int, block: int = Q8_BLOCK) -> int:
    """32-bit words one quantized leaf of ``n`` elements contributes (the
    port gathers them as ``4 *`` this many bytes): block-padded int8 codes
    plus one f32 scale per block."""
    nb = _q8_block_count(n, block)
    return nb * (block // 4) + nb


def _q8_encode(v: Tensor, block: int = Q8_BLOCK) -> Tuple[Tensor, Tensor]:
    """One rank's block-scaled int8 encoding of a float leaf: ``(codes int8
    (nb*block,), scales f32 (nb,))``. ``|x - code*scale| <= scale/2`` per
    element; blocks under :data:`Q8_FLUSH` flush to zero codes."""
    flat = v.reshape(-1).to(torch.float32)
    nb = _q8_block_count(flat.numel(), block)
    pad = nb * block - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    blocks = flat.reshape(nb, block)
    absmax = blocks.abs().amax(dim=1) if nb else flat.new_zeros((0,))
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which can differ in the last bit from the division
    scales = torch.where(absmax >= Q8_FLUSH, absmax / absmax.new_full((), 127.0), torch.zeros_like(absmax))
    inv = torch.where(scales > 0, 1.0 / scales, torch.zeros_like(scales))
    codes = torch.clamp(torch.round(blocks * inv[:, None]), -127.0, 127.0).to(torch.int8)
    return codes.reshape(-1), scales


def _q8_carrier(v: Tensor, block: int = Q8_BLOCK) -> Tensor:
    """One quantized sum leaf as gather bytes: ``[int8 codes | f32 scales]``,
    the scales travelling in the same collective."""
    codes, scales = _q8_encode(v, block)
    return torch.cat([_to_bytes(codes), _to_bytes(scales)])


def _q8_sum_from_gathered(raw: Tensor, ref: Tensor, block: int = Q8_BLOCK) -> Tensor:
    """Decode a gathered ``(world, bytes)`` q8 slab to the summed leaf: each
    rank's codes dequantize against its own scales and the contributions
    fold in f32, in rank order."""
    n = ref.numel()
    nb = _q8_block_count(n, block)
    ncodes = nb * block
    codes = _from_bytes(raw[:, :ncodes], torch.int8, (nb, block))
    scales = _from_bytes(raw[:, ncodes:], torch.float32, (nb,))
    contrib = codes.to(torch.float32) * scales[:, :, None]
    total = contrib[0]
    for w in range(1, contrib.shape[0]):
        total = total + contrib[w]
    return total.reshape(-1)[:n].reshape(ref.shape).to(ref.dtype)


def _as_numpy_f32(v: Any) -> np.ndarray:
    if isinstance(v, Tensor):
        return v.detach().cpu().to(torch.float32).numpy()
    return np.asarray(v, np.float32)


def q8_roundtrip(v: Any, block: int = Q8_BLOCK) -> np.ndarray:
    """One rank's encode→decode round trip (no collective): what a single
    quantized contribution loses, identical to the world-1 quantized sum."""
    t = torch.from_numpy(_as_numpy_f32(v))
    codes, scales = _q8_encode(t, block)
    vals = codes.to(torch.float32).reshape(-1, block) * scales[:, None]
    return vals.reshape(-1)[: t.numel()].reshape(t.shape).numpy()


def q8_sum_error_bound(stacked: Any, block: int = Q8_BLOCK) -> np.ndarray:
    """Per-element |error| bound of the q8_block quantized sum of ``stacked``
    (leading axis = rank) against the exact f32 sum: per rank and element
    ``scale/2`` where the block quantizes, ``absmax`` (< :data:`Q8_FLUSH`)
    where it flushes, summed over ranks. Numpy; shaped like one rank's leaf."""
    arr = _as_numpy_f32(stacked)
    world = arr.shape[0]
    flat = arr.reshape(world, -1)
    n = flat.shape[1]
    nb = _q8_block_count(n, block)
    padded = np.zeros((world, nb * block), np.float32)
    padded[:, :n] = flat
    absmax = np.abs(padded.reshape(world, nb, block)).max(axis=2) if nb else np.zeros((world, 0), np.float32)
    per_block = np.where(absmax < Q8_FLUSH, absmax, absmax / 254.0)  # absmax/127/2
    per_elem = np.repeat(per_block, block, axis=1)[:, :n].sum(axis=0)
    return per_elem.reshape(arr.shape[1:])


# ------------------------------------------------------------ payload accounting


def _leaf_dtype_shape(leaf: Any) -> Tuple[torch.dtype, Tuple[int, ...]]:
    """dtype and shape of a tensor or of a :class:`~metrics_tpu_torch.metric.StateSpec`."""
    return leaf.dtype, tuple(int(d) for d in leaf.shape)


def fused_sync_plan(
    leaves: Sequence[Tuple[Any, Any, Optional[str]]], world: int, block: int = Q8_BLOCK
) -> Dict[str, Any]:
    """How :func:`fused_axis_sync` buckets ``leaves`` — ``(dist_reduce_fx,
    tensor or StateSpec, precision)`` triples — on a ``world``-rank group, and
    what each collective moves per rank: ``sum_elems`` f32 elements (integer
    leaves count their digits), ``reduce_elems`` per (reduction, dtype name),
    ``gather_bytes`` of exact gather leaves, ``q8_words`` of quantized
    carriers (4 bytes each), the ``quantized`` leaf indices and the number of
    ``collectives`` one call issues. JAX's plan counts the gather in u32
    ``gather_words`` (sub-word leaves padded); the port gathers bytes."""
    sum_elems = gather_bytes = q8_words = 0
    n_sum = n_gather = 0
    reduce_elems: Dict[Tuple[str, str], int] = {}
    quantized: List[int] = []
    nparts = -(-32 // _int_split_bits(max(1, int(world))))
    for i, (fx, leaf, prec) in enumerate(leaves):
        dtype, shape = _leaf_dtype_shape(leaf)
        size = math.prod(shape)
        kind = _bucket(fx, dtype, prec)
        if kind == "q8":
            q8_words += q8_carrier_words(size, block)
            quantized.append(i)
            n_gather += 1
        elif kind == "sum":
            sum_elems += size if _sum_rider(dtype) == "float" else size * nparts
            n_sum += 1
        elif kind == "reduce":
            key = (str(fx), str(dtype).replace("torch.", ""))
            reduce_elems[key] = reduce_elems.get(key, 0) + size
        else:
            gather_bytes += size * dtype.itemsize
            n_gather += 1
    return {
        "sum_elems": sum_elems,
        "reduce_elems": reduce_elems,
        "gather_bytes": gather_bytes,
        "q8_words": q8_words,
        "quantized": quantized,
        "collectives": int(n_sum > 0) + len(reduce_elems) + int(n_gather > 0),
    }


def sync_payload_bytes(
    leaves: Sequence[Tuple[Any, Any, Optional[str]]], world: int, block: int = Q8_BLOCK
) -> int:
    """Bytes one rank contributes to the fused sync's collectives under the
    given precisions: the f32 all-reduce, the reduce buckets in their wire
    dtypes, the byte gather and the q8 carriers. Compare with the same call
    at all-"exact" precisions for the quantization ratio."""
    plan = fused_sync_plan(leaves, world, block)
    nbytes = 4 * plan["sum_elems"] + plan["gather_bytes"] + 4 * plan["q8_words"]
    for (fx, dtype_name), elems in plan["reduce_elems"].items():
        nbytes += _wire_dtype(fx, getattr(torch, dtype_name)).itemsize * elems
    return int(nbytes)


def sync_payload_split(
    leaves: Sequence[Tuple[Any, Any, Optional[str]]], world: int, block: int = Q8_BLOCK
) -> Tuple[int, int]:
    """(exact, quantized) bytes one rank contributes to the fused sync: the
    q8 carriers apart from the rest of :func:`sync_payload_bytes`."""
    quant = 4 * fused_sync_plan(leaves, world, block)["q8_words"]
    return int(sync_payload_bytes(leaves, world, block) - quant), int(quant)


def hierarchical_fold_bytes(
    leaves: Sequence[Tuple[Any, Any, Optional[str]]], hosts: int, block: int = Q8_BLOCK
) -> Dict[str, int]:
    """Bytes of the fleet's fold by leg: ``intra_bytes``, the host's LOGICAL
    leaves (``(dist_reduce_fx, tensor or StateSpec, precision)`` triples,
    the engine's ``_fleet_leaf_info``) that each host folds before anything
    leaves it; ``cross_exact_bytes`` and ``cross_quant_bytes``, what one
    host contributes to the fused sync over ``hosts`` ranks, from
    :func:`sync_payload_bytes` and :func:`fused_sync_plan` (bytes where
    JAX's plan counts u32 words). The cross legs scale with the hosts, not
    the streams: the stream axis lives inside each leaf."""
    intra = 0
    for _fx, leaf, _prec in leaves:
        dtype, shape = _leaf_dtype_shape(leaf)
        intra += math.prod(shape) * dtype.itemsize
    exact, quant = sync_payload_split(leaves, hosts, block)
    return {"intra_bytes": int(intra), "cross_exact_bytes": exact, "cross_quant_bytes": quant}


# ------------------------------------------------------------------ reductions


def reduce(x: Tensor, reduction: str) -> Tensor:
    """Elementwise->scalar reduction: ``elementwise_mean``, ``sum`` or
    ``none``."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction == "none" or reduction is None:
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Class-averaged fraction num/denom with micro/macro/weighted/none
    reduction."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    if class_reduction == "micro":
        fraction = torch.sum(num) / (torch.sum(denom) + METRIC_EPS)
    else:
        fraction = num / (denom + METRIC_EPS)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights / torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between {valid_reduction}")
