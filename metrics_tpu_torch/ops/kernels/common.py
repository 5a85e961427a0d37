"""Shared pieces of the streaming-update kernel library.

Port of ``metrics_tpu/ops/kernels/common.py``. The reduction identities live
here so the plain versions and the CUDA kernels fold masked-out rows with the
SAME element. The TPU's VMEM block sizing (``block_rows``) has no counterpart:
the CUDA kernels pick their own launch shapes.
"""
from typing import Optional, Tuple, Union

import torch

#: the reductions the kernel library implements — exactly the set
#: ``Metric._MASKED_FX`` serves through the delta masked path
REDUCE_OPS = ("sum", "min", "max")


def reduce_identity(dtype: torch.dtype, fx: str) -> torch.Tensor:
    """The identity element of sum/min/max over ``dtype`` (masked rows reduce
    to it), as a 0-d CPU tensor."""
    if fx == "sum":
        return torch.zeros((), dtype=dtype)
    if dtype.is_floating_point:
        return torch.tensor(float("inf") if fx == "min" else float("-inf"), dtype=dtype)
    if dtype == torch.bool:
        # min over bool is AND (identity True), max is OR (identity False)
        return torch.tensor(fx == "min", dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.tensor(info.max if fx == "min" else info.min, dtype=dtype)


#: int32's sign bit: XOR with it maps the order of uint32 values onto int32's
SIGN_BIT = -(2**31)


def int32_bits(x: torch.Tensor, flip: Optional[Union[int, torch.Tensor]] = None) -> torch.Tensor:
    """A uint32 tensor as int32 of the same bits. Torch has no uint32 add,
    select or index kernels, and a two's-complement int32 sum gives a uint32
    sum's bits; ``flip`` (:data:`SIGN_BIT`, or a per-column row of it and
    zeros) is XORed in where min/max must order the values as uint32."""
    x = x.view(torch.int32)
    return x if flip is None else torch.bitwise_xor(x, flip)


def uint32_from_bits(x: torch.Tensor, flip: Optional[Union[int, torch.Tensor]] = None) -> torch.Tensor:
    """Inverse of :func:`int32_bits`."""
    return (x if flip is None else torch.bitwise_xor(x, flip)).view(torch.uint32)


def combine(a: torch.Tensor, b: torch.Tensor, fx: str) -> torch.Tensor:
    """Fold two partial reductions (the between-blocks combine)."""
    if a.dtype == torch.uint32:
        flip = None if fx == "sum" else SIGN_BIT
        return uint32_from_bits(combine(int32_bits(a, flip), int32_bits(b.to(torch.uint32), flip), fx), flip)
    if fx == "sum":
        return a + b
    if fx == "min":
        return torch.minimum(a, b)
    return torch.maximum(a, b)


def stack_reduce(stacked: torch.Tensor, fx: str) -> torch.Tensor:
    """Fold a leading stack axis with ``fx``, dtype-preserving: a sequential
    pairwise :func:`combine` rather than ``torch.sum``, so small ints and
    bool never promote (a merge returns the state's own dtype)."""
    out = stacked[0]
    for i in range(1, stacked.shape[0]):
        out = combine(out, stacked[i], fx)
    return out


def supported_dtype(dtype: torch.dtype) -> bool:
    """Dtypes the CUDA fold kernels take: f32/bf16 floats and the 32-bit
    ints (uint32 as its int32 bits, :func:`int32_bits`).

    Sub-32-bit ints and bool are excluded as on the TPU: a sum over them
    promotes, and a fixed-dtype kernel cannot reproduce that promotion."""
    return dtype in (torch.float32, torch.bfloat16, torch.int32, torch.uint32)


def as_2d_rows(rows: torch.Tensor, n_rows: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Collapse ``(N, *leaf)`` to the kernels' canonical ``(N, F)`` layout.

    Returns the reshaped tensor and the trailing leaf shape. F is at least 1
    (scalar leaves become one column)."""
    trailing = tuple(int(d) for d in rows.shape[1:])
    f = 1
    for d in trailing:
        f *= d
    return rows.reshape(n_rows, f), trailing
