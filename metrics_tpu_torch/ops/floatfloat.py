"""Float-float (double-float) arithmetic: ~48-bit values from f32 pairs (port of ``metrics_tpu/ops/floatfloat.py``).

Error-free transformations (Knuth's 2Sum, Veltkamp's split and Dekker's
2Prod) represent a value as an unevaluated f32 pair ``(hi, lo)`` whose sum
carries ~48 significant bits. They are exact only if every operation rounds
on its own: each step here is a separate PyTorch elementwise op, never
fused, contracted to an FMA (no ``addcmul``/``addcdiv``) or compiled, so
the CPU and the card run the same roundings as numpy's float64 checks
expect (``tests/test_torch_image_models.py``, and on the card
``tests/test_torch_cuda.py``).

FID's streaming statistics keep their running mean and scatter in these
pairs (``image/fid.py``), so that a capture of the forward, which cannot
leave the card's f32 path, still accumulates at ~48 bits. Eager compute
recovers them in float64 on the device (:func:`ff_to_f64`).
"""
from typing import Tuple

import torch

Tensor = torch.Tensor
Pair = Tuple[Tensor, Tensor]

_SPLIT_FACTOR = 4097.0  # 2**12 + 1: Veltkamp split constant for f32 (24-bit mantissa)


def two_sum(a, b) -> Pair:
    """Knuth's branch-free 2Sum: ``s + e == a + b`` exactly (any magnitude order)."""
    s = a + b
    bp = s - a
    ap = s - bp
    return s, (a - ap) + (b - bp)


def _veltkamp_split(a) -> Pair:
    c = a * _SPLIT_FACTOR
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b) -> Pair:
    """Dekker's 2Prod: ``p + e == a * b`` exactly (no FMA)."""
    p = a * b
    ah, al = _veltkamp_split(a)
    bh, bl = _veltkamp_split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ff_add(x: Pair, y: Pair) -> Pair:
    """Pair + pair (Dekker's add2)."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return two_sum(s, e)


def ff_add_f32(x: Pair, v) -> Pair:
    """Pair + plain f32 (a compensated accumulate step)."""
    s, e = two_sum(x[0], v)
    e = e + x[1]
    return two_sum(s, e)


def ff_neg(x: Pair) -> Pair:
    return -x[0], -x[1]


def ff_sub(x: Pair, y: Pair) -> Pair:
    return ff_add(x, ff_neg(y))


def ff_mul(x: Pair, y: Pair) -> Pair:
    """Pair * pair."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return two_sum(p, e)


def ff_scale(x: Pair, c) -> Pair:
    """Pair * plain f32 scalar or tensor (a Python number is taken as f32)."""
    if not isinstance(c, Tensor):
        c = torch.tensor(c, dtype=x[0].dtype, device=x[0].device)
    p, e = two_prod(x[0], c)
    e = e + x[1] * c
    return two_sum(p, e)


def ff_to_f32(x: Pair) -> Tensor:
    return x[0] + x[1]


def ff_from_f32(v: Tensor) -> Pair:
    return v, torch.zeros_like(v)


def ff_to_f64(x: Pair) -> Tensor:
    """The pair's ~48-bit value in float64 (on the pair's device)."""
    return x[0].to(torch.float64) + x[1].to(torch.float64)
