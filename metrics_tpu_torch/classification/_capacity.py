"""Static-capacity buffer states shared by the exact curve metrics.

Port of ``metrics_tpu/classification/_capacity.py``. ``AUROC(capacity=N)``,
``AveragePrecision(capacity=N)``, ``ROC(capacity=N)`` and
``PrecisionRecallCurve(capacity=N)`` keep the same
``(preds_buf, target_buf, valid_buf, count, overflow)`` states; this mixin
owns their registration, the buffer write at the device cursor and the
overflow → NaN contract. Nothing here reads a state on the host while an
update runs, so the write serves inside the engines' captured steps.
"""
from typing import Optional

import torch

from metrics_tpu_torch.ops.masked_curves import _per_column
from metrics_tpu_torch.utils.checks import _is_traced
from metrics_tpu_torch.utils.data import to_onehot
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class CapacityCurveStateMixin:
    """Mixin for metrics with a static ``(capacity, ...)`` score buffer."""

    capacity: Optional[int]
    num_classes: Optional[int]

    def _capacity_num_columns(self) -> Optional[int]:
        return self.num_classes if (self.num_classes or 0) > 1 else None

    def _validate_capacity_kwargs(self, pos_label, average) -> None:
        """Shared up-front rejections for eager-only options."""
        if average == "micro":
            raise ValueError("`average='micro'` is not supported in static-capacity mode")
        if pos_label not in (None, 1):
            raise ValueError(
                "`pos_label` is not supported in static-capacity mode (positives are `target > 0`);"
                " use the default eager mode"
            )

    def _compute_capacity_with(self, binary_kernel, multilabel_kernel):
        """Per-column kernel for declared multiclass/multilabel, the binary
        kernel otherwise; NaN on overflow."""
        if self._capacity_num_columns():
            value = multilabel_kernel(
                self.preds_buf, self.target_buf, self.valid_buf,
                average=self.average if self.average in ("macro", "weighted") else "none",
            )
        else:
            value = binary_kernel(self.preds_buf, self.target_buf, self.valid_buf)
        return self._capacity_guard_nan(value)

    def _init_capacity_states(self) -> None:
        c = self._capacity_num_columns()
        capacity = self.capacity
        if not isinstance(capacity, int) or capacity <= 0:
            raise ValueError(f"`capacity` must be a positive int, got {capacity}")
        score_shape = (capacity, c) if c else (capacity,)
        # multiclass labels are stored one-hot: the per-column kernels then read
        # the layout multilabel targets arrive in
        self.add_state("preds_buf", default=torch.zeros(score_shape, dtype=torch.float32), dist_reduce_fx="cat")
        self.add_state("target_buf", default=torch.zeros(score_shape, dtype=torch.int32), dist_reduce_fx="cat")
        self.add_state("valid_buf", default=torch.zeros((capacity,), dtype=torch.bool), dist_reduce_fx="cat")
        self.add_state("count", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("overflow", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def _capacity_write(self, preds: Tensor, target: Tensor) -> None:
        """Write one canonicalized batch (binary ``(N,)`` or per-column
        ``(N, C)`` with one-hot/multilabel targets) at the device cursor
        ``count``.

        A single batch larger than the whole buffer is a shape error, raised
        here. Overflow across batches cannot raise without reading ``count``
        on the host: it sets the flag, the write is a no-op (the buffers stay
        intact for anyone reading partial results), and compute returns NaN.
        The rows go to ``count + arange(N)``, clamped: an overflowing write
        puts back the values it read there.
        """
        n = preds.shape[0]
        if n > self.capacity:
            raise ValueError(
                f"A single batch of {n} samples cannot fit the capacity-{self.capacity} buffer of"
                f" {type(self).__name__}; raise `capacity` to at least the largest batch size."
            )
        start = self.count
        fits = start + n <= self.capacity
        idx = torch.clamp(start + torch.arange(n, device=start.device), max=self.capacity - 1)

        def write(buf: Tensor, rows: Tensor) -> Tensor:
            return buf.index_copy(0, idx, torch.where(fits, rows.to(buf.dtype), buf.index_select(0, idx)))

        self.preds_buf = write(self.preds_buf, preds)
        self.target_buf = write(self.target_buf, target)
        self.valid_buf = write(self.valid_buf, torch.ones(n, dtype=torch.bool, device=start.device))
        self.overflow = self.overflow + (~fits).to(torch.int32)
        self.count = torch.where(fits, start + n, start)

    def _capacity_curve_precheck(self, preds: Tensor) -> None:
        """Layout check on the RAW inputs, before canonicalization (whose
        multilabel branch would otherwise fail with a bare IndexError on
        mismatched shapes)."""
        c = self._capacity_num_columns()
        nd = preds.ndim
        if c is not None and nd < 2:
            raise ValueError(
                f"Static-capacity {type(self).__name__} needs `num_classes` matching the data:"
                f" num_classes={self.num_classes} expects (N, {self.num_classes}) scores, got"
                f" shape {tuple(preds.shape)} — leave num_classes unset/1 for binary inputs"
            )
        if c is None and nd > 1:
            raise ValueError(
                f"Static-capacity {type(self).__name__} needs `num_classes` matching the data:"
                f" multi-column scores of shape {tuple(preds.shape)} need num_classes=C"
            )

    def _capacity_curve_write(self, preds: Tensor, target: Tensor) -> None:
        """Shared update of the curve metrics: check the declared layout
        against the canonicalized batch, one-hot multiclass labels, write."""
        c = self._capacity_num_columns()
        if (preds.ndim == 1) != (c is None):
            raise ValueError(
                f"Static-capacity {type(self).__name__} needs `num_classes` matching the data:"
                f" leave it unset/1 for binary inputs, set it to C for multiclass — got"
                f" num_classes={self.num_classes} with preds of shape {tuple(preds.shape)}"
            )
        if c and target.ndim == 1:
            target = to_onehot(target, c)
        self._capacity_write(preds, target)

    def _compute_capacity_curve_with(self, kernel):
        """A 3-output curve kernel over the buffers: one vmap over the
        columns for declared multiclass, a plain call otherwise."""
        if self._capacity_num_columns():
            a, b, c = _per_column(kernel, self.preds_buf, self.target_buf, self.valid_buf)
        else:
            a, b, c = kernel(self.preds_buf, self.target_buf, self.valid_buf)
        return self._capacity_guard_nan(a), self._capacity_guard_nan(b), self._capacity_guard_nan(c)

    def _capacity_guard_nan(self, value: Tensor) -> Tensor:
        """Warn on overflow where the flag can be read on the host (not under
        vmap or graph capture); mask the result to NaN either way."""
        if not _is_traced(self.overflow) and int(self.overflow) > 0:
            rank_zero_warn(
                f"{type(self).__name__}(capacity={self.capacity}) overflowed — more samples were"
                " updated than the buffer holds; returning NaN. Raise `capacity`.", UserWarning,
            )
        return torch.where(self.overflow > 0, float("nan"), value)
