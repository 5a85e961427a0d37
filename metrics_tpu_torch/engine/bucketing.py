"""Shape bucketing + padding policy: a closed set of step batch sizes.

Port of ``metrics_tpu/engine/bucketing.py``, whole. Every incoming batch is
rounded up to the smallest of a small set of bucket sizes, padded with an
inert fill and a validity mask; batches larger than the biggest bucket split
into max-bucket chunks plus a bucketed remainder. On the card this keeps the
kernels' launch shapes, and the engine's CUDA-graph step cache
(``engine/aot.py``), to ``len(buckets)`` per input signature.

The captured step reads its chunk from fixed device buffers
(:class:`StepBuffers`, one set per bucket and payload signature): each step
copies the chunk's rows, its pad fill and its mask straight into them,
device-to-device for CUDA inputs and non-blocking from pinned host memory
(:class:`PinnedRing`) for numpy and CPU inputs. :meth:`BucketPolicy.pad_chunk`
builds the same padded chunk as fresh arrays for the uncaptured step.

Pad rows contribute nothing: the engine feeds the mask to
``Metric.update_state_masked``/``update_state_segmented``, which substitute
each reduction's identity for masked-out rows, so correctness does not depend
on the fill. The fill only has to be VALID input (pass the metric's checks).
"""
import bisect
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.data import infer_batch_size, is_batch_leaf
from metrics_tpu_torch.utils.tree import tree_flatten, tree_unflatten

__all__ = ["BucketPolicy", "PinnedRing", "StepBuffers", "classify_leaves", "shard_blocks"]

#: a leaf's role in a padded step: batch-carried rows (sliced and padded), an
#: array copied as it is (a broadcast argument, the paged engine's slot ids),
#: or None for a Python value (part of the step's cache key)
ROWS, WHOLE = "rows", "whole"


def pad_rows(rows: Any, bucket: int, pad_value: Any) -> Any:
    """``rows`` (a tensor or numpy array) padded with ``pad_value`` to ``bucket`` rows."""
    valid = rows.shape[0]
    if valid == bucket:
        return rows
    shape = (bucket - valid,) + tuple(rows.shape[1:])
    if isinstance(rows, torch.Tensor):
        return torch.cat([rows, torch.full(shape, pad_value, dtype=rows.dtype, device=rows.device)])
    return np.concatenate([rows, np.full(shape, pad_value, rows.dtype)], axis=0)


def classify_leaves(leaves: List[Any], n: int, bucket: int, divisor: int = 1) -> List[Optional[str]]:
    """Each leaf's role in a step of ``bucket`` rows cut from a batch of
    ``n``: :data:`ROWS` when its leading dimension is ``n``, :data:`WHOLE` for
    any other array, None for a value. A non-batch array whose leading
    dimension equals the bucket would read as batch-carried downstream
    (``is_batch_leaf`` against the mask), so it raises."""
    ambiguous = {bucket, bucket // divisor} - {n}
    kinds: List[Optional[str]] = []
    for leaf in leaves:
        if is_batch_leaf(leaf, n):
            kinds.append(ROWS)
            continue
        if any(is_batch_leaf(leaf, a) for a in ambiguous):
            raise ValueError(
                f"non-batch array argument with leading dimension {leaf.shape[0]} is "
                f"ambiguous against bucket {bucket} (batch size here is {n}); reshape it "
                "(e.g. add a leading axis of 1) or choose buckets that cannot collide"
            )
        kinds.append(WHOLE if hasattr(leaf, "shape") else None)
    return kinds


def shard_blocks(start: int, stop: int, bucket: int, world: int) -> List[Tuple[int, int]]:
    """The row split of one padded bucket over ``world`` shards, as JAX's
    ``P(axis)`` splits it: the bucket's ``bucket / world``-row blocks, block
    ``k`` holding padded positions ``[k * per, (k + 1) * per)``. Rows
    ``[start, stop)`` fill the bucket's first positions, so shard ``k``'s rows
    are ``[start + min(k * per, valid), start + min((k + 1) * per, valid))``:
    pad rows fall in the last shards, and a shard past the valid rows gets
    none (its block is all pad, its mask all False)."""
    per, valid = bucket // world, stop - start
    return [(start + min(k * per, valid), start + min((k + 1) * per, valid)) for k in range(world)]


def pad_leaves(leaves: List[Any], kinds: List[Optional[str]], start: int, stop: int, bucket: int,
               pad_value: Any) -> List[Any]:
    """Rows ``[start, stop)`` of every :data:`ROWS` leaf padded to ``bucket``
    rows as fresh arrays; every other leaf as it is."""
    return [pad_rows(leaf[start:stop], bucket, pad_value) if kind == ROWS else leaf
            for leaf, kind in zip(leaves, kinds)]


def torch_dtype(dtype: Any) -> torch.dtype:
    """A numpy or torch dtype as the torch dtype of the same name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty((0,), dtype)).dtype


def padded_shape(leaf: Any, kind: str, bucket: int) -> Tuple[int, ...]:
    """The shape a leaf of ``kind`` has in a step of ``bucket`` rows."""
    return (bucket,) + tuple(leaf.shape[1:]) if kind == ROWS else tuple(leaf.shape)


def on_card(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_cuda


class PinnedRing:
    """``depth`` sets of pinned host buffers for the host leaves of one step
    signature, used in turn. The event recorded after a set's host-to-device
    copies is waited on before the set is written again, so a copy still
    pending (with ``in_flight`` steps un-synced) never reads a half-rewritten
    buffer. ``specs`` maps a leaf index to its padded ``(shape, dtype)``."""

    def __init__(self, specs: Dict[int, Tuple[Tuple[int, ...], torch.dtype]], depth: int):
        self._slots = [{i: torch.empty(shape, dtype=dtype, pin_memory=True) for i, (shape, dtype) in specs.items()}
                       for _ in range(max(1, depth))]
        self._events: List[Optional[torch.cuda.Event]] = [None] * len(self._slots)
        self._next = 0

    def acquire(self) -> int:
        """The next set, once every copy out of it has finished."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        if self._events[i] is not None:
            self._events[i].synchronize()
        return i

    def buffer(self, slot: int, leaf: int) -> torch.Tensor:
        return self._slots[slot][leaf]

    def release(self, slot: int, stream: torch.cuda.Stream) -> None:
        """Mark the copies just enqueued on ``stream`` out of ``slot``."""
        ev = self._events[slot] or torch.cuda.Event()
        ev.record(stream)
        self._events[slot] = ev


class StepBuffers:
    """The fixed device buffers one captured step reads: every array leaf of
    the payload at its padded shape (Python values stay as they are: they are
    part of the step's cache key), and the mask.

    Args:
        leaves: the flattened payload of a chunk (tensors, numpy arrays, values).
        kinds: each leaf's role (:func:`classify_leaves`).
        treedef: the payload's structure (``utils/tree.py``).
        bucket: the step's padded row count.
        device: the CUDA device of the step.
    """

    def __init__(self, leaves: List[Any], kinds: List[Optional[str]], treedef: Any, bucket: int,
                 device: torch.device):
        self.kinds = list(kinds)
        self.bucket = int(bucket)
        self.leaves = [leaf if kind is None else
                       torch.empty(padded_shape(leaf, kind, bucket), dtype=torch_dtype(leaf.dtype), device=device)
                       for leaf, kind in zip(leaves, kinds)]
        #: ``(args, kwargs)`` over the buffers: what the captured step is called with
        self.payload = tree_unflatten(treedef, self.leaves)
        self.mask = torch.zeros((bucket,), dtype=torch.bool, device=device)
        self._rows = torch.arange(bucket, dtype=torch.int32, device=device)

    def fill(self, leaves: List[Any], start: int, stop: int, pad_value: Any, ring: Optional[PinnedRing],
             stream: torch.cuda.Stream) -> None:
        """Copy one chunk into the buffers, on ``stream`` (the current one):
        rows ``[start, stop)`` of each batch-carried leaf and its pad fill,
        every other array whole, and the mask. CUDA leaves copy device to
        device; host leaves go through ``ring``'s pinned buffers."""
        valid = stop - start
        slot = ring.acquire() if ring is not None else None
        for i, (leaf, kind, buf) in enumerate(zip(leaves, self.kinds, self.leaves)):
            if kind is None:
                continue
            src = leaf[start:stop] if kind == ROWS else leaf
            if on_card(leaf):
                dst = buf
            else:
                dst = ring.buffer(slot, i)
            if kind == ROWS:
                if isinstance(src, np.ndarray):
                    view = dst.numpy()
                    view[:valid] = src
                    view[valid:] = pad_value
                else:
                    dst[:valid].copy_(src)
                    if valid < self.bucket:
                        dst[valid:].fill_(pad_value)
            elif isinstance(src, np.ndarray):
                dst.numpy()[...] = src
            else:
                dst.copy_(src)
            if dst is not buf:
                buf.copy_(dst, non_blocking=True)
        torch.lt(self._rows, valid, out=self.mask)
        if slot is not None:
            ring.release(slot, stream)


class BucketPolicy:
    """Round ragged batch sizes to a fixed ascending set of padded sizes.

    Args:
        buckets: allowed padded batch sizes (deduplicated, sorted ascending).
        pad_value: scalar fill for pad rows (cast to each leaf's dtype).
        divisor: every bucket must be divisible by this (1 on one device).
    """

    def __init__(self, buckets: Sequence[int], pad_value: Any = 0, divisor: int = 1):
        sizes = sorted({int(b) for b in buckets})
        if not sizes or sizes[0] <= 0:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        bad = [b for b in sizes if b % divisor]
        if bad:
            raise ValueError(f"bucket sizes {bad} are not divisible by the mesh batch-axis size {divisor}")
        self.buckets: Tuple[int, ...] = tuple(sizes)
        self.pad_value = pad_value
        self.divisor = int(divisor)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the biggest bucket for oversized chunks)."""
        if n <= 0:
            raise ValueError(f"batch size must be positive, got {n}")
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[i] if i < len(self.buckets) else self.buckets[-1]

    def chunks(self, n: int) -> List[Tuple[int, int, int]]:
        """Split a batch of ``n`` rows into ``(start, stop, bucket)`` chunks:
        whole max-bucket chunks first, then one bucketed remainder."""
        top = self.buckets[-1]
        out: List[Tuple[int, int, int]] = []
        start = 0
        while n - start > top:
            out.append((start, start + top, top))
            start += top
        out.append((start, n, self.bucket_for(n - start)))
        return out

    def pad_chunk(
        self, args: Tuple[Any, ...], kwargs: Dict[str, Any], start: int, stop: int, bucket: int
    ) -> Tuple[Tuple[Any, ...], Dict[str, Any], np.ndarray]:
        """Slice rows ``[start, stop)`` out of every batch-carried leaf (a
        tensor or numpy array whose leading dimension is the batch size of the
        first such leaf) and pad to ``bucket`` rows; returns ``(args, kwargs,
        mask)`` with a numpy bool mask. Other leaves pass through untouched."""
        leaves, treedef = tree_flatten((args, kwargs))
        n = infer_batch_size(leaves)
        if n is None:
            raise ValueError("no array argument with a leading batch dimension")
        valid = stop - start
        if not (0 < valid <= bucket):
            raise ValueError(f"chunk [{start}:{stop}) does not fit bucket {bucket}")
        out_leaves = pad_leaves(leaves, classify_leaves(leaves, n, bucket, self.divisor), start, stop, bucket,
                                self.pad_value)
        mask = np.zeros((bucket,), bool)
        mask[:valid] = True
        a, kw = tree_unflatten(treedef, out_leaves)
        return a, kw, mask

    @staticmethod
    def waste_fraction(valid_total: int, padded_total: int) -> float:
        """Fraction of device rows spent on padding (0 = perfect packing)."""
        return 0.0 if padded_total == 0 else 1.0 - valid_total / padded_total

    def __repr__(self) -> str:
        return f"BucketPolicy(buckets={self.buckets}, divisor={self.divisor})"
