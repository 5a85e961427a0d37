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
the graphs) or runs the eager step. The sharded embedded-model forwards
(``shard_batch_forward``, ``stem_tensor_batch_forward``,
``pipeline_stage_forward``) are not ported yet (ROADMAP.md §A).
"""
from typing import Any, Callable, List, Optional, Tuple

import torch

from metrics_tpu_torch.parallel.mesh import AxisName, Mesh, MeshConfig
from metrics_tpu_torch.utils.data import is_batch_leaf
from metrics_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

__all__ = [
    "boundary_merge_error",
    "data_parallel_mesh",
    "merge_step_deltas",
    "sharded_local_step",
    "sharded_masked_step",
    "sharded_state_merge",
    "split_bucket",
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

