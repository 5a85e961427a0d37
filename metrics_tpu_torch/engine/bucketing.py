"""Shape bucketing + padding policy: a closed set of step batch sizes.

Port of ``metrics_tpu/engine/bucketing.py``, whole. Every incoming batch is
rounded up to the smallest of a small set of bucket sizes, padded with an
inert fill and a validity mask; batches larger than the biggest bucket split
into max-bucket chunks plus a bucketed remainder. On the card this keeps the
kernels' launch shapes (and a later CUDA-graph cache) to ``len(buckets)`` per
input signature.

Pad rows contribute nothing: the engine feeds the mask to
``Metric.update_state_masked``/``update_state_segmented``, which substitute
each reduction's identity for masked-out rows, so correctness does not depend
on the fill. The fill only has to be VALID input (pass the metric's checks).
"""
import bisect
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.data import infer_batch_size, is_batch_leaf
from metrics_tpu_torch.utils.tree import tree_flatten, tree_unflatten

__all__ = ["BucketPolicy"]


def pad_rows(rows: Any, bucket: int, pad_value: Any) -> Any:
    """``rows`` (a tensor or numpy array) padded with ``pad_value`` to ``bucket`` rows."""
    valid = rows.shape[0]
    if valid == bucket:
        return rows
    shape = (bucket - valid,) + tuple(rows.shape[1:])
    if isinstance(rows, torch.Tensor):
        return torch.cat([rows, torch.full(shape, pad_value, dtype=rows.dtype, device=rows.device)])
    return np.concatenate([rows, np.full(shape, pad_value, rows.dtype)], axis=0)


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
        # a broadcast leaf whose leading dimension equals the bucket would be
        # classified batch-carried downstream (is_batch_leaf against the mask)
        ambiguous = {bucket, bucket // self.divisor} - {n}
        out_leaves = []
        for leaf in leaves:
            if is_batch_leaf(leaf, n):
                out_leaves.append(pad_rows(leaf[start:stop], bucket, self.pad_value))
            else:
                if any(is_batch_leaf(leaf, a) for a in ambiguous):
                    raise ValueError(
                        f"non-batch array argument with leading dimension {leaf.shape[0]} is "
                        f"ambiguous against bucket {bucket} (batch size here is {n}); reshape it "
                        "(e.g. add a leading axis of 1) or choose buckets that cannot collide"
                    )
                out_leaves.append(leaf)
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
