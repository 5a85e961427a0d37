"""The mesh streaming engine's step builders (port of the engine half of
``metrics_tpu/parallel/embedded.py``).

The JAX package builds each mesh step as one ``shard_map``-ped program; the
port's mesh is one process driving W devices (``parallel/mesh.py``), so each
builder returns a plain function over the W shards' carried states (shard
``k`` on the mesh's device ``k``; on a one-device mesh every shard on that
device): a list in, a list out. A step takes the W shards' BLOCKS, ``(x_k,
valid_k)`` pairs: ``x_k`` what shard ``k``'s fold reads, ``valid_k`` its
valid-row count (an int, or a mask to count). A padded bucket splits over
the shards exactly as ``P(axis)`` splits it (:func:`split_bucket`, cut where
``engine.bucketing.shard_blocks`` cuts: W contiguous blocks of ``bucket /
W`` rows, pad rows in the last shards, broadcast arguments whole on every
shard).

* :func:`sharded_masked_step`: STEP sync. Each shard folds its rows into a
  fresh state (its masked delta), the deltas merge in one fused collective
  bundle (``Metric.sync_states`` over the mesh axis), and every replica of
  the global state takes the global delta (:func:`merge_step_deltas`). The
  token is the global valid-row count.
* :func:`sharded_local_step` (and :func:`stream_sharded_step`, the same
  builder over slot-stacked paged arenas): DEFERRED sync. Each shard folds
  its own rows into its own state; no collective. The token is the
  ``(W,)`` per-shard valid-row count.
* :func:`sharded_state_merge`: the deferred boundary merge, the whole
  shard-local states through one fused bundle into the global state.
* :func:`boundary_merge_error`: the typed error of a failed merge.

These are the streaming engine's own steps (``engine/pipeline.py``): its
blocks are the shards' row ranges of the host batch, and its fold replays
the shard's captured graph on its device's stream (K5 under
``kernel_backend="megastep"``, K1/K4 otherwise; the collectives sit between
the graphs) or runs the eager step.

The sharded embedded-model forwards run a model inside a metric over the
mesh, each shard's work on its device (its current stream; across devices
the shards' launches overlap), the collectives between them:

* :func:`shard_batch_forward`: parameters replicated (one copy a device),
  the batch split over the axis with zero pad rows cut off the result; the
  output stays sharded (a list of the shards' row blocks), is gathered
  (``out_axis=None``), or is sharded over an in-order prefix of the axes;
* :func:`stem_tensor_batch_forward`: the model host's Inception layout, a
  tensor-parallel stem (each shard computes an output-channel slice of each
  stem layer, gathered back in order) then a data-parallel trunk whose rows
  are gathered;
* :func:`pipeline_stage_forward`: GPipe stages, stage ``s``'s parameters on
  shard ``s`` only, microbatches handed shard to shard by
  :func:`~metrics_tpu_torch.parallel.collectives.mesh_ppermute`, the only
  operation between devices.

Each returned forward has a ``place(params)`` method that lays parameters
out once, in the layout it needs (:class:`PlacedParams`); a forward given
raw parameters places them on every call.
"""
import copy
import itertools
import math
from contextlib import nullcontext
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.parallel.collectives import mesh_all_gather_tiled, mesh_ppermute
from metrics_tpu_torch.parallel.mesh import AxisName, Mesh, MeshAxis, MeshConfig
from metrics_tpu_torch.utils.data import is_batch_leaf
from metrics_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

__all__ = [
    "PlacedParams",
    "boundary_merge_error",
    "data_parallel_mesh",
    "merge_step_deltas",
    "pipeline_stage_forward",
    "shard_batch_forward",
    "sharded_local_step",
    "sharded_masked_step",
    "sharded_state_merge",
    "split_bucket",
    "stem_tensor_batch_forward",
    "stream_sharded_step",
]

Block = Tuple[Any, Any]  # (what a shard's fold reads, its valid rows: an int or a mask)


def data_parallel_mesh(axis: str = "dp") -> Mesh:
    """A 1-D mesh over every local CUDA device: the default layout."""
    return MeshConfig.data_parallel(axis=axis).make_mesh()


def split_bucket(payload: Any, mask: torch.Tensor, mesh: Mesh, axis: AxisName) -> List[Block]:
    """One padded bucket's ``(payload, mask)`` as the W shards' blocks
    ``((payload_k, mask_k), mask_k)``, in ``P(axis)``'s split: every
    batch-carried leaf (leading dimension the mask's) cut where
    :func:`~metrics_tpu_torch.engine.bucketing.shard_blocks` cuts, every
    other leaf whole; each block on its shard's device."""
    from metrics_tpu_torch.engine.bucketing import shard_blocks

    ax = mesh.axis(axis)
    n = int(mask.shape[0])
    if n % ax.world:
        raise ValueError(f"bucket {n} is not divisible by the mesh axis size {ax.world}")
    leaves, treedef = tree_flatten(payload)
    out = []
    for (lo, hi), dev in zip(shard_blocks(0, n, n, ax.world), ax.devices):
        cut = [leaf[lo:hi] if is_batch_leaf(leaf, n) else leaf for leaf in leaves]
        cut = [x.to(dev) if isinstance(x, torch.Tensor) else x for x in cut]
        m = mask[lo:hi].to(dev)
        out.append(((tree_unflatten(treedef, cut), m), m))
    return out


def _tokens(blocks: List[Block]) -> torch.Tensor:
    """The ``(W,)`` valid-row counts of the shards' blocks."""
    if all(isinstance(v, int) for _, v in blocks):  # the engine's host row counts: no device work
        return torch.tensor([v for _, v in blocks], dtype=torch.int32)
    counts = [torch.as_tensor(v).to(torch.int32).sum() for _, v in blocks]
    return torch.stack([c.to(counts[0].device) for c in counts])


def merge_step_deltas(metric: Any, mesh: Mesh, axis: AxisName, states: List[Any], deltas: List[Any],
                      layout: Any = None) -> List[Any]:
    """The step-sync merge: the W shards' delta states (carried form) merge
    in one fused bundle into the global delta, which is merged into each
    replica of the global state given, replica ``k`` on shard ``k``'s device
    (the streaming engine keeps one, on the first device). On a one-device
    mesh the shards share one replica, merged once."""
    ax = mesh.axis(axis)
    unpack = layout.unpack if layout is not None else (lambda x: x)
    pack = layout.pack if layout is not None else (lambda x: x)
    synced = metric.sync_states([unpack(d) for d in deltas], ax)
    if ax.transport != "nccl":
        return [pack(metric.merge_states(unpack(states[0]), synced[0]))] * len(states)
    return [pack(metric.merge_states(unpack(s), d)) for s, d in zip(states, synced)]


def sharded_masked_step(metric: Any, mesh: Mesh, axis: AxisName, layout: Any = None,
                        delta_fn: Optional[Callable[[int, Any], Any]] = None) -> Callable[..., Any]:
    """The STEP-SYNC mesh step: ``(states, blocks) -> (new_states, token)``
    over the replicas of the global carried state (the packed arena with
    ``layout``, else the logical tree; W of them, or fewer, the streaming
    engine's one on the first device). Shard ``k``'s delta is
    ``delta_fn(k, x_k)``, in the carried form (default: the metric's masked
    update of a fresh state, ``x_k`` a :func:`split_bucket` block's
    ``(payload_k, mask_k)``; the engine's replays the shard's graph into its
    reset delta buffer); the deltas merge as :func:`merge_step_deltas` does;
    ``token`` is the global valid-row count."""
    ax = mesh.axis(axis)
    pack = layout.pack if layout is not None else (lambda x: x)

    def default_delta(k: int, x: Any) -> Any:
        (a, kw), mask = x
        init = tree_map(lambda v: torch.as_tensor(v).to(ax.devices[k]), metric.init_state())
        return pack(metric.update_state_masked(init, *a, mask=mask, **kw))

    fn = delta_fn or default_delta

    def step(states: List[Any], blocks: List[Block]) -> Tuple[List[Any], torch.Tensor]:
        if len(blocks) != ax.world:
            raise ValueError(f"a step over {ax.world} shards got {len(blocks)} blocks")
        deltas = [fn(k, x) for k, (x, _) in enumerate(blocks)]
        return merge_step_deltas(metric, mesh, axis, states, deltas, layout), _tokens(blocks).sum()

    return step


def sharded_local_step(update_fn: Callable[[Any, Any, int], Any], mesh: Mesh, axis: AxisName) -> Callable[..., Any]:
    """The DEFERRED-SYNC mesh step: ``(states, blocks) -> (new_states,
    token)`` over the W shards' LOCAL carried states. Shard ``k``'s new
    state is ``update_fn(state_k, x_k, k)``, its own state with its own rows
    (the engine's fold returns None where its graph wrote the state in
    place): no collective. ``token`` is the ``(W,)`` per-shard valid-row
    count."""
    ax = mesh.axis(axis)

    def step(states: List[Any], blocks: List[Block]) -> Tuple[List[Any], torch.Tensor]:
        if len(states) != ax.world or len(blocks) != ax.world:
            raise ValueError(f"a step over {ax.world} shards got {len(states)} states and {len(blocks)} blocks")
        return [update_fn(state, x, k) for k, (state, (x, _)) in enumerate(zip(states, blocks))], _tokens(blocks)

    return step


def stream_sharded_step(update_fn: Callable[[Any, Any, int], Any], mesh: Mesh, axis: AxisName) -> Callable[..., Any]:
    """The STREAM-SHARDED routed step: shard ``k`` carries only its own
    streams, ``(resident, n)`` slot-stacked arena buffers, and the host routes
    each shard's rows into its block with pager slot ids as segment ids
    (``engine/multistream.py``). Mechanically :func:`sharded_local_step` over
    that carried form."""
    return sharded_local_step(update_fn, mesh, axis)


def sharded_state_merge(metric: Any, mesh: Mesh, axis: AxisName,
                        unpack: Optional[Callable[..., Any]] = None) -> Callable[..., Any]:
    """The deferred BOUNDARY merge: ``states -> global logical state`` (on
    shard 0's device). Each shard's carried state unpacks to the logical
    tree and the whole tree rides ``Metric.sync_states`` over the mesh axis:
    one fused bundle however many metrics (sum riders in one f32
    all-reduce, min/max one per (reduction, dtype), ``cat`` buffers and
    ``q8_block`` states in one byte gather: the quantized states ride as
    whole accumulated states, so their error bound does not grow with the
    step count). ``cat`` buffers arrive concatenated across shards."""
    ax = mesh.axis(axis)

    def merge(states: List[Any]) -> Any:
        trees = [unpack(s) if unpack is not None else s for s in states]
        return metric.sync_states(trees, ax)[0]

    return merge


# ------------------------------------------------------- the embedded-model forwards


class PlacedParams:
    """Parameters laid out for a mesh forward: ``shards[k]`` is what shard
    ``k`` reads (the whole tree, a channel slice or a stage row), on shard
    ``k``'s device; shards on one device share one copy of a replicated
    tree."""

    def __init__(self, shards: Sequence[Any]):
        self.shards = list(shards)

    def __iter__(self) -> Iterator[Any]:
        return iter(self.shards)


def _axis_size(mesh: Mesh, axis: AxisName) -> int:
    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    return int(math.prod(mesh.shape[a] for a in names))


def _on(dev: torch.device) -> Any:
    """Make ``dev`` current for a shard's launches (a no-op off the card)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _to_dev(tree: Any, dev: torch.device) -> Any:
    """``tree`` on ``dev``: each tensor moved, each ``torch.nn.Module``
    copied there (the module itself where it already lives)."""
    def move(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, torch.nn.Module):
            home = next(itertools.chain(x.parameters(), x.buffers()), None)
            return x if home is None or home.device == dev else copy.deepcopy(x).to(dev)
        return x

    return tree_map(move, tree)


def _replicate(tree: Any, ax: MeshAxis) -> PlacedParams:
    """One copy of ``tree`` (tensors and modules) a device, shared by the
    shards on it."""
    copies = {}
    for dev in ax.devices:
        if dev not in copies:
            copies[dev] = _to_dev(tree, dev)
    return PlacedParams([copies[dev] for dev in ax.devices])


def _as_batch(a: Any) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def shard_batch_forward(fn: Callable, mesh: Mesh, axis: AxisName = "dp", out_axis: Optional[AxisName] = "__same__",
                        replicated_argnums: Sequence[int] = ()) -> Callable:
    """``fn`` batch-parallel over ``mesh``'s ``axis`` (JAX's signature).

    Every positional argument but ``replicated_argnums`` has a leading batch
    dimension: the batch is zero-padded to a multiple of the axis size and
    split into W contiguous blocks, block ``k`` on shard ``k``'s device,
    where ``fn`` runs on it; the replicated arguments (parameters) reach
    every shard whole, one copy a device (pass :class:`PlacedParams` from
    the forward's ``place`` to place them once). Pad rows never reach the
    caller.

    ``out_axis``: the default keeps the output sharded, the list of the W
    shards' row blocks (each a tensor or a pytree of them, on its shard's
    device); ``None`` gathers it (one ``all_gather`` a leaf) into one result
    on the first shard's device; an in-order PREFIX of the batch axes (``"dp"``
    of ``("dp", "grp")``) gathers the trailing axes and leaves one block per
    prefix index. Any other subset would permute rows: ``ValueError``. The
    axis must cover the mesh's axes in order, as the port's mesh axes do."""
    ax = mesh.axis(axis)
    n = ax.world
    rep = frozenset(int(i) for i in replicated_argnums)
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    if out_axis is None:
        blocks = 1
    elif out_axis == "__same__":
        blocks = n
    else:
        out_axes = tuple(out_axis) if isinstance(out_axis, (tuple, list)) else (out_axis,)
        if out_axes != axes[: len(out_axes)]:
            raise ValueError(
                f"out_axis {out_axes} must be an in-order prefix of the batch axes {axes} (anything else would "
                "permute output rows); gather fully with out_axis=None instead."
            )
        blocks = _axis_size(mesh, out_axes)

    def place(params: Any) -> PlacedParams:
        return _replicate(params, ax)

    def forward(*args: Any) -> Any:
        batch_ix = [i for i in range(len(args)) if i not in rep]
        if not batch_ix:
            raise ValueError("shard_batch_forward needs at least one batch argument")
        args = tuple(a if i in rep else _as_batch(a) for i, a in enumerate(args))
        b = int(args[batch_ix[0]].shape[0])
        per = -(-b // n)
        reps = {i: (args[i] if isinstance(args[i], PlacedParams) else place(args[i])) for i in rep}
        outs = []
        for k, dev in enumerate(ax.devices):
            shard_args = []
            for i, a in enumerate(args):
                if i in rep:
                    shard_args.append(reps[i].shards[k])
                    continue
                blk = a[min(k * per, b):min((k + 1) * per, b)]
                if blk.shape[0] < per:  # the zero pad rows of the last shards
                    blk = torch.cat([blk, blk.new_zeros((per - blk.shape[0],) + tuple(blk.shape[1:]))])
                shard_args.append(blk.to(dev))
            with _on(dev):
                outs.append(fn(*shard_args))
        treedef = tree_flatten(outs[0])[1]
        cols = list(zip(*(tree_flatten(o)[0] for o in outs)))
        if blocks == n:
            return [tree_unflatten(treedef, [c[k][: max(0, min(per, b - k * per))] for c in cols]) for k in range(n)]
        full = [mesh_all_gather_tiled(list(c), ax, 0) for c in cols]
        g = n // blocks  # shards a block gathers
        out = []
        for j in range(blocks):
            lo, hi = j * g * per, min((j + 1) * g * per, b)
            out.append(tree_unflatten(treedef, [f[j * g][lo:hi] for f in full]))
        return out[0] if blocks == 1 else out

    forward.place = place
    return forward


def _stem_slice(tree: Any, k: int, world: int, dev: torch.device) -> Any:
    """Shard ``k``'s output-channel slice of a stem tree on ``dev``: every
    tensor leaf split on dim 0 (a PyTorch conv weight's ``cout``, a BN
    vector's channel), where JAX's HWIO kernels split on their last dim."""
    def cut(x: Any) -> Any:
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x.to(dev) if isinstance(x, torch.Tensor) else x
        c = x.shape[0] // world
        return x[k * c:(k + 1) * c].to(dev)

    return tree_map(cut, tree)


def stem_tensor_batch_forward(stem_fn: Callable, trunk_fn: Callable, mesh: Mesh, axis: AxisName = "dp") -> Callable:
    """The hybrid tensor-then-data sharded forward: the model host's
    Inception layout (JAX's signature). ``fwd(stem_vars, trunk_vars, x)``:

    1. the image batch ``x`` is replicated (one copy a device) and the stem's
       parameters are split on the output channel (:func:`_stem_slice`), so
       shard ``k`` computes channel slice ``k`` of every stem layer;
       ``stem_fn(stem_slices, xs, gather_axis) -> (x_stems, auxes)`` takes the
       W shards' slices and copies and the mesh axis, gathers each layer's
       slices back in channel order (``models.inception.stem_apply``), and
       returns every shard's post-stem activation and its taps (the
       ``'64'``/``'192'`` taps, from the full batch);
    2. shard ``k`` runs ``trunk_fn(trunk_vars, x_k) -> dict`` on its own
       ``B / W``-row block of the post-stem activation, and the per-row
       outputs are gathered in shard order.

    The result (on the first shard's device) is the trunk's outputs and the
    stem's taps. A batch that does not divide by the axis size raises
    JAX's ``ValueError``. ``fwd.place(stem_vars, trunk_vars)`` lays both
    out once; the only collective is ``all_gather``."""
    ax = mesh.axis(axis)
    world = ax.world

    def place(stem_vars: Any, trunk_vars: Any) -> Tuple[PlacedParams, PlacedParams]:
        stem = PlacedParams([_stem_slice(stem_vars, k, world, dev) for k, dev in enumerate(ax.devices)])
        return stem, _replicate(trunk_vars, ax)

    def fwd(stem_vars: Any, trunk_vars: Any, x: Any) -> Any:
        x = _as_batch(x)
        if x.shape[0] % world:
            raise ValueError(
                f"stem_tensor_batch_forward: batch {x.shape[0]} not divisible by axis {axis!r} size {world} — serve "
                f"it through a bucket set with divisor={world}"
            )
        stem = stem_vars if isinstance(stem_vars, PlacedParams) else place(stem_vars, None)[0]
        trunk = trunk_vars if isinstance(trunk_vars, PlacedParams) else _replicate(trunk_vars, ax)
        xs = _replicate(x, ax).shards
        x_stems, auxes = stem_fn(stem.shards, xs, ax)
        b = x.shape[0] // world
        outs = []
        for k, dev in enumerate(ax.devices):
            with _on(dev):
                outs.append(trunk_fn(trunk.shards[k], x_stems[k][k * b:(k + 1) * b]))
        out = {key: mesh_all_gather_tiled([o[key] for o in outs], ax, 0)[0] for key in outs[0]}
        out.update(auxes[0])
        return out

    fwd.place = place
    return fwd


def pipeline_stage_forward(stage_fn: Callable, mesh: Mesh, axis: AxisName = "dp",
                           microbatches: Optional[int] = None) -> Callable:
    """GPipe pipeline-parallel forward over ``mesh``'s ``axis`` (JAX's
    signature): ``fwd(params, x)``, ``params`` a pytree stacked ``(S, ...)``
    whose row ``s`` lives only on shard ``s`` (``fwd.place(params)`` lays
    the rows out once).

    The batch splits into ``M`` microbatches (default ``M = S``); the
    schedule runs ``S + M - 1`` steps, shard ``s`` taking microbatch ``t -
    s`` at step ``t`` through ``stage_fn(stage_params, x_mb) -> x_mb`` (shape
    preserving), and each step ends in one hand-off
    (:func:`~metrics_tpu_torch.parallel.collectives.mesh_ppermute`, JAX's
    ``ppermute``): across devices a peer copy, ordered against the sender's
    and the receiver's streams by events. The last stage's output buffer
    then goes round the ring in ``S - 1`` more hand-offs, so every shard
    holds it; the result is shard 0's copy. Hand-offs per forward: ``S + M -
    1 + S - 1``, and no other operation between devices. A batch that does
    not divide by ``M`` raises JAX's ``ValueError``."""
    ax = mesh.axis(axis)
    world = ax.world
    hand = [(i, i + 1) for i in range(world - 1)]
    ring = [(i, (i + 1) % world) for i in range(world)]

    def place(params: Any) -> PlacedParams:
        return PlacedParams([tree_map(lambda a, s=s, dev=dev: a[s].to(dev), params)
                             for s, dev in enumerate(ax.devices)])

    def fwd(params: Any, x: Any) -> Any:
        m = microbatches or world
        x = _as_batch(x)
        if x.shape[0] % m:
            raise ValueError(
                f"pipeline_stage_forward: batch {x.shape[0]} not divisible by microbatch count {m} — serve it "
                f"through a bucket set with divisor={m}"
            )
        stages = params if isinstance(params, PlacedParams) else place(params)
        mb = x.shape[0] // m
        x0 = x.to(ax.devices[0])
        state: List[Optional[torch.Tensor]] = [None] * world
        out: List[torch.Tensor] = []
        for t in range(m + world - 1):
            new: List[Optional[torch.Tensor]] = [None] * world
            for s, dev in enumerate(ax.devices):
                j = t - s
                if 0 <= j < m:
                    with _on(dev):
                        new[s] = stage_fn(stages.shards[s], x0[j * mb:(j + 1) * mb] if s == 0 else state[s])
            if new[world - 1] is not None:
                out.append(new[world - 1])
            state = mesh_ppermute(new, ax, hand)
        last = ax.devices[world - 1]
        with _on(last):
            buf = torch.cat(out) if len(out) > 1 else out[0]
        held: List[Optional[torch.Tensor]] = [None] * world
        held[world - 1] = buf
        cur = list(held)
        for _ in range(world - 1):
            cur = mesh_ppermute(cur, ax, ring)
            for d, y in enumerate(cur):
                if y is not None:
                    held[d] = y
        return held[0]

    fwd.place = place
    return fwd


def boundary_merge_error(axis: AxisName, world: int, cause: BaseException) -> BaseException:
    """The typed error of a failed deferred boundary merge, naming the mesh
    axis and world (the engine chains ``cause`` onto it). The merge is a
    read of the shard-local states, so they are intact after any failure.
    A merge error or a user error passes through as it is."""
    from metrics_tpu_torch.engine.faults import BoundaryMergeError
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    if isinstance(cause, (BoundaryMergeError, MetricsTPUUserError)):
        return cause
    return BoundaryMergeError(
        f"deferred boundary merge failed over mesh axis {axis!r} (world={world}): "
        f"{type(cause).__name__}: {cause}; the shard-local carried state is intact — "
        "result()/state() keep serving the last consistent value"
    )

