"""Input-format & validation layer for classification and retrieval inputs.

Port of the classification and retrieval parts of
``metrics_tpu/utils/checks.py``: the same 6-way case taxonomy and the same
canonical output contract, binary ``(N, C)``/``(N, C, X)`` int32 tensors plus
the inferred DataType; retrieval's flattened ``(indexes, preds, target)``
rows with ``ignore_index`` filtered eagerly.

Shape- and dtype-driven checks always run. Value-dependent checks
(``target.max() > 1`` and the like) need the values on the host; they run
eagerly exactly as the JAX package runs them eagerly, and are skipped when an
input is a ``torch.func.vmap`` batched tensor, or inside :func:`traced_rows`
(the scan masked update's row loop, the engines' result computes, the
compiled forward) — the port's counterpart of the JAX package skipping them
on tracers, and necessary, since a data-dependent ``if`` on a batched tensor
raises and a host read inside CUDA-graph capture fails. Inside
:class:`deferred_value_checks` (the compiled forward's update, captured into a
CUDA graph on the card) the skipped checks EMIT int32 error codes instead:
device reductions with no host read, which the metric raises, deferred, at
its next ``compute()``/``sync()`` (``Metric._raise_if_invalid``).
"""
import contextlib
import threading
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.data import select_topk, to_onehot
from metrics_tpu_torch.utils.enums import DataType

Tensor = torch.Tensor


def _is_batched(x) -> bool:
    """True for a tensor that carries a ``torch.func.vmap`` batch dimension."""
    return isinstance(x, torch.Tensor) and torch._C._functorch.is_batchedtensor(x)


_rows = threading.local()


@contextlib.contextmanager
def traced_rows() -> Iterator[None]:
    """Run the body as the JAX package runs a traced body: every input
    counts as traced, so no value check reads it on the host. The scan
    masked update loops over device rows in it (possibly inside graph
    capture), as JAX runs a ``lax.scan`` body; the engines' ``result`` and
    ``results`` compute in it, as JAX runs their compiled compute program."""
    depth = getattr(_rows, "depth", 0)
    _rows.depth = depth + 1
    try:
        yield
    finally:
        _rows.depth = depth


def _is_traced(x: Any) -> bool:
    """The port's ``_is_tracer``: a ``torch.func.vmap`` batched tensor, any
    input inside :func:`traced_rows`, or a CUDA tensor while this thread's
    current stream is capturing a graph. Data-dependent host reads and checks
    are skipped for such inputs."""
    if _is_batched(x) or getattr(_rows, "depth", 0):
        return True
    return isinstance(x, torch.Tensor) and x.is_cuda and torch.cuda.is_current_stream_capturing()


def _tracing() -> bool:
    """True inside :func:`traced_rows`, or while this thread's current CUDA
    stream captures a graph: the port's "inside a trace"."""
    if getattr(_rows, "depth", 0):
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class _ValueStats(NamedTuple):
    """Min/max of preds+target, fetched from the device in ONE transfer."""

    target_min: float
    target_max: float
    preds_min: float
    preds_max: float


def _compute_value_stats(preds: Tensor, target: Tensor) -> Optional[_ValueStats]:
    """None for traced inputs (value checks are skipped there); else one fetch."""
    if _is_traced(preds) or _is_traced(target):
        return None
    pf = preds.reshape(-1).to(torch.float32)
    tf = target.reshape(-1).to(torch.float32)
    vals = torch.stack([tf.min(), tf.max(), pf.min(), pf.max()]).cpu().tolist()
    return _ValueStats(*vals)


# --------------------------------------------------------- deferred (in-graph) checks
#
# The port of the JAX package's deferred checks. A compiled forward step
# (``Metric._build_forward_step``) opens a ``deferred_value_checks`` context
# around its update: the check sites below then EMIT int32 error codes as
# device tensors instead of being skipped. The step returns max(codes); the
# facade keeps it on the device and raises the code's message at the next
# compute()/sync(). Codes are allocated in the JAX package's order, so the
# larger of two codes names the same message in both packages.

_DEFERRED_MESSAGES: Dict[int, str] = {}
_deferred = threading.local()  # .stack: this thread's open code collectors


def register_deferred_message(message: str) -> int:
    """Allocate a stable error code for a deferred-check message."""
    code = len(_DEFERRED_MESSAGES) + 1
    _DEFERRED_MESSAGES[code] = message
    return code


def deferred_message(code: int) -> str:
    return _DEFERRED_MESSAGES.get(code, f"invalid input detected (code {code})")


class deferred_value_checks:
    """Context manager: collect error codes from the value-check sites that
    run inside it, on this thread."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.codes: List[Tensor] = []
        self.device = device

    def __enter__(self) -> "deferred_value_checks":
        stack = getattr(_deferred, "stack", None)
        if stack is None:
            stack = _deferred.stack = []
        stack.append(self.codes)
        return self

    def __exit__(self, *exc: Any) -> None:
        _deferred.stack.pop()

    def combined(self) -> Tensor:
        """The collected codes folded into one 0-d int32 tensor (0 = every
        input valid), on the inputs' device."""
        if not self.codes:
            return torch.zeros((), dtype=torch.int32, device=self.device)
        out = self.codes[0]
        for c in self.codes[1:]:
            out = torch.maximum(out, c)
        return out


def defer_value_check(bad: Callable[[], Tensor], code: int) -> None:
    """Emit ``code`` where the 0-d bool tensor ``bad()`` holds (no host
    read); a no-op outside :class:`deferred_value_checks`. ``bad`` runs only
    inside the context, so the engines' traced updates launch no reduction
    for it."""
    stack = getattr(_deferred, "stack", None)
    if stack:
        stack[-1].append(bad().to(torch.int32) * code)


_CODE_TARGET_NEG = register_deferred_message("The `target` has to be a non-negative tensor.")
_CODE_PREDS_NEG = register_deferred_message("If `preds` are integers, they have to be non-negative.")
_CODE_TARGET_GT1_MC_FALSE = register_deferred_message(
    "If you set `multiclass=False`, then `target` should not exceed 1."
)
_CODE_PREDS_GT1_MC_FALSE = register_deferred_message(
    "If you set `multiclass=False` and `preds` are integers, then `preds` should not exceed 1."
)
_CODE_TARGET_NOT_BINARY = register_deferred_message(
    "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary."
)
_CODE_TARGET_GE_IMPLIED = register_deferred_message(
    "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."
)
_CODE_TARGET_GE_NUM_CLASSES = register_deferred_message(
    "The highest label in `target` should be smaller than `num_classes`."
)
# the retrieval checks' codes
_CODE_TARGET_NOT_BINARY_RETRIEVAL = register_deferred_message("`target` must contain `binary` values")
_CODE_EMPTY_QUERY_RETRIEVAL = register_deferred_message(
    "`compute` method was provided with a query with no positive target."
)


def _is_floating(x: Tensor) -> bool:
    return x.is_floating_point()


def _basic_input_validation(
    preds: Tensor, target: Tensor, threshold: float, multiclass: Optional[bool], stats: Optional[_ValueStats] = None
) -> None:
    """Value-dependent sanity checks: eager, or deferred codes on traced inputs."""
    if _is_floating(target):
        raise ValueError("The `target` has to be an integer tensor.")
    if stats is None:
        stats = _compute_value_stats(preds, target)
    preds_float = _is_floating(preds)
    if stats is None:
        # traced: emit deferred codes instead (no-op outside the context)
        defer_value_check(lambda: target.min() < 0, _CODE_TARGET_NEG)
        if not preds_float:
            defer_value_check(lambda: preds.min() < 0, _CODE_PREDS_NEG)
        if multiclass is False:
            defer_value_check(lambda: target.max() > 1, _CODE_TARGET_GT1_MC_FALSE)
            if not preds_float:
                defer_value_check(lambda: preds.max() > 1, _CODE_PREDS_GT1_MC_FALSE)
        return
    if stats.target_min < 0:
        raise ValueError("The `target` has to be a non-negative tensor.")
    if not preds_float and stats.preds_min < 0:
        raise ValueError("If `preds` are integers, they have to be non-negative.")
    if preds.shape[0] != target.shape[0]:
        raise ValueError("The `preds` and `target` should have the same first dimension.")
    if multiclass is False and stats.target_max > 1:
        raise ValueError("If you set `multiclass=False`, then `target` should not exceed 1.")
    if multiclass is False and not preds_float and stats.preds_max > 1:
        raise ValueError("If you set `multiclass=False` and `preds` are integers, then `preds` should not exceed 1.")


def _check_shape_and_type_consistency(
    preds: Tensor, target: Tensor, stats: Optional[_ValueStats] = None
) -> Tuple[DataType, int]:
    """Infer the input case from shapes/dtypes (plus one eager value check)."""
    preds_float = _is_floating(preds)
    p_shape, t_shape = tuple(preds.shape), tuple(target.shape)

    if preds.ndim == target.ndim:
        if p_shape != t_shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={p_shape} and `target` with shape={t_shape}."
            )
        if preds_float and stats is None:
            stats = _compute_value_stats(preds, target)
        if preds_float and stats is not None and stats.target_max > 1:
            raise ValueError(
                "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary."
            )
        if preds_float and stats is None:
            defer_value_check(lambda: target.max() > 1, _CODE_TARGET_NOT_BINARY)
        if preds.ndim == 1 and preds_float:
            case = DataType.BINARY
        elif preds.ndim == 1 and not preds_float:
            case = DataType.MULTICLASS
        elif preds.ndim > 1 and preds_float:
            case = DataType.MULTILABEL
        else:
            case = DataType.MULTIDIM_MULTICLASS
        implied_classes = int(np.prod(p_shape[1:])) if len(p_shape) > 1 else 1
    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if p_shape[2:] != t_shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        implied_classes = p_shape[1]
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    return case, implied_classes


def _check_num_classes_binary(num_classes: int, multiclass: Optional[bool]) -> None:
    if num_classes > 2:
        raise ValueError("Your data is binary, but `num_classes` is larger than 2.")
    if num_classes == 2 and not multiclass:
        raise ValueError(
            "Your data is binary and `num_classes=2`, but `multiclass` is not True."
            " Set it to True if you want to transform binary data to multi-class format."
        )
    if num_classes == 1 and multiclass:
        raise ValueError(
            "You have binary data and have set `multiclass=True`, but `num_classes` is 1."
            " Either set `multiclass=None`(default) or set `num_classes=2`"
            " to transform binary data to multi-class format."
        )


def _check_num_classes_mc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multiclass: Optional[bool],
    implied_classes: int,
    stats: Optional[_ValueStats] = None,
) -> None:
    if num_classes == 1 and multiclass is not False:
        raise ValueError(
            "You have set `num_classes=1`, but predictions are integers."
            " If you want to convert (multi-dimensional) multi-class data with 2 classes"
            " to binary/multi-label, set `multiclass=False`."
        )
    if num_classes > 1:
        if multiclass is False and implied_classes != num_classes:
            raise ValueError(
                "You have set `multiclass=False`, but the implied number of classes "
                " (from shape of inputs) does not match `num_classes`."
            )
        if stats is None:
            stats = _compute_value_stats(preds, target)
        if stats is not None and num_classes <= int(stats.target_max):
            raise ValueError("The highest label in `target` should be smaller than `num_classes`.")
        if stats is None:
            defer_value_check(lambda: target.max() >= num_classes, _CODE_TARGET_GE_NUM_CLASSES)
        if preds.shape != target.shape and num_classes != implied_classes:
            raise ValueError("The size of C dimension of `preds` does not match `num_classes`.")


def _check_num_classes_ml(num_classes: int, multiclass: Optional[bool], implied_classes: int) -> None:
    if multiclass and num_classes != 2:
        raise ValueError(
            "Your have set `multiclass=True`, but `num_classes` is not equal to 2."
            " If you are trying to transform multi-label data to 2 class multi-dimensional"
            " multi-class, you should set `num_classes` to either 2 or None."
        )
    if not multiclass and num_classes != implied_classes:
        raise ValueError("The implied number of classes (from shape of inputs) does not match num_classes.")


def _check_top_k(top_k: int, case: DataType, implied_classes: int, multiclass: Optional[bool], preds_float: bool) -> None:
    if case == DataType.BINARY:
        raise ValueError("You can not use `top_k` parameter with binary data.")
    if not isinstance(top_k, int) or top_k <= 0:
        raise ValueError("The `top_k` has to be an integer larger than 0.")
    if not preds_float:
        raise ValueError("You have set `top_k`, but you do not have probability predictions.")
    if multiclass is False:
        raise ValueError("If you set `multiclass=False`, you can not set `top_k`.")
    if case == DataType.MULTILABEL and multiclass:
        raise ValueError(
            "If you want to transform multi-label data to 2 class multi-dimensional"
            "multi-class data using `multiclass=True`, you can not use `top_k`."
        )
    if top_k >= implied_classes:
        raise ValueError("The `top_k` has to be strictly smaller than the `C` dimension of `preds`.")


def _check_classification_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    stats: Optional[_ValueStats] = None,
) -> DataType:
    """Full input validation; returns the inferred case."""
    if stats is None:
        stats = _compute_value_stats(preds, target)
    _basic_input_validation(preds, target, threshold, multiclass, stats=stats)
    case, implied_classes = _check_shape_and_type_consistency(preds, target, stats=stats)

    if preds.shape != target.shape:
        if multiclass is False and implied_classes != 2:
            raise ValueError(
                "You have set `multiclass=False`, but have more than 2 classes in your data,"
                " based on the C dimension of `preds`."
            )
        if stats is not None and int(stats.target_max) >= implied_classes:
            raise ValueError(
                "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."
            )
        if stats is None:
            defer_value_check(lambda: target.max() >= implied_classes, _CODE_TARGET_GE_IMPLIED)

    if num_classes:
        if case == DataType.BINARY:
            _check_num_classes_binary(num_classes, multiclass)
        elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            _check_num_classes_mc(preds, target, num_classes, multiclass, implied_classes, stats=stats)
        elif case == DataType.MULTILABEL:
            _check_num_classes_ml(num_classes, multiclass, implied_classes)

    if top_k is not None:
        _check_top_k(top_k, case, implied_classes, multiclass, _is_floating(preds))

    return case


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    if tuple(preds.shape) != tuple(target.shape):
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape, "
            f"got {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _input_squeeze(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Remove excess size-1 dims (all but the leading N)."""
    if preds.shape[0] == 1:
        preds = torch.squeeze(preds).unsqueeze(0)
        target = torch.squeeze(target).unsqueeze(0)
    else:
        preds, target = torch.squeeze(preds), torch.squeeze(target)
    return preds, target


def _input_format_classification(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[Tensor, Tensor, DataType]:
    """Canonicalize classification inputs to binary int32 ``(N, C)``/``(N, C, X)``.

    Under vmap ``num_classes`` cannot be inferred from the labels' values and
    must be given, as under the JAX package's ``jit``.
    """
    preds, target = _input_squeeze(preds, target)
    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)

    stats = _compute_value_stats(preds, target)
    case = _check_classification_inputs(
        preds, target, threshold=threshold, num_classes=num_classes, multiclass=multiclass, top_k=top_k,
        stats=stats,
    )

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = (preds >= threshold).to(torch.int32) if _is_floating(preds) else preds
        num_classes = num_classes if not multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or multiclass:
        if _is_floating(preds):
            num_classes = preds.shape[1]
            preds = select_topk(preds, top_k or 1)
        else:
            if not num_classes:
                if stats is None:
                    raise ValueError(
                        "Cannot infer `num_classes` from data inside vmap; pass `num_classes` explicitly."
                    )
                num_classes = int(max(stats.preds_max, stats.target_max)) + 1
            preds = to_onehot(preds, max(2, num_classes))
        target = to_onehot(target, max(2, int(num_classes) if num_classes else 2))

        if multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and multiclass is not False) or multiclass:
        target = target.reshape(target.shape[0], target.shape[1], -1)
        preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
    else:
        target = target.reshape(target.shape[0], -1)
        preds = preds.reshape(preds.shape[0], -1)

    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = preds.squeeze(-1), target.squeeze(-1)

    return preds.to(torch.int32), target.to(torch.int32), case


def _check_retrieval_functional_inputs(
    preds: Tensor, target: Tensor, allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    """Flatten and validate retrieval ``(preds, target)``: preds float,
    target bool/int (or float when ``allow_non_binary_target``), binary
    unless allowed. Returns f32 preds and int32 targets (f32 when non-binary
    targets are allowed)."""
    if tuple(preds.shape) != tuple(target.shape):
        raise ValueError("`preds` and `target` must be of the same shape")
    if preds.ndim == 0 or preds.numel() == 0:
        raise ValueError("`preds` and `target` must be non-empty and non-scalar tensors")
    integral = not (target.is_floating_point() or target.is_complex())  # bool counts as integral
    if not (integral or (allow_non_binary_target and target.is_floating_point())):
        raise ValueError("`target` must be a tensor of booleans or integers")
    if not _is_floating(preds):
        raise ValueError("`preds` must be a tensor of floats")
    if not allow_non_binary_target and target.numel():
        if _is_traced(target):
            defer_value_check(lambda: target.max() > 1, _CODE_TARGET_NOT_BINARY_RETRIEVAL)
        elif int(target.max()) > 1:
            raise ValueError("`target` must contain `binary` values")
    preds = preds.reshape(-1).to(torch.float32)
    target = target.reshape(-1).to(torch.float32 if allow_non_binary_target else torch.int32)
    return preds, target


def _check_retrieval_inputs(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Validate ``(indexes, preds, target)`` triplets: one shape, integer
    indexes (int32 out, as the JAX package ravels them), then
    :func:`_check_retrieval_functional_inputs`. ``ignore_index`` drops the
    rows whose target equals it (an eager boolean mask)."""
    if tuple(indexes.shape) != tuple(preds.shape) or tuple(preds.shape) != tuple(target.shape):
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if indexes.dtype == torch.bool or indexes.is_floating_point() or indexes.is_complex():
        raise ValueError("`indexes` must be a tensor of long integers")
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target)
    indexes = indexes.reshape(-1).to(torch.int32)
    if ignore_index is not None:
        keep = target != ignore_index
        indexes, preds, target = indexes[keep], preds[keep], target[keep]
    return indexes, preds, target
