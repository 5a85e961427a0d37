"""JAX's threefry2x32 PRNG in torch, bit for bit: ``PRNGKey``, ``fold_in`` and ``randint``.

Streaming Inception Score assigns each sample to a split with
``randint(fold_in(PRNGKey(seed), n_seen), (n,), 0, splits)``
(``metrics_tpu/image/inception.py``), and the port must draw the same
splits. This module repeats JAX 0.9.0's default implementation
(``jax_default_prng_impl="threefry2x32"``, ``jax_threefry_partitionable=True``;
``jax/_src/prng.py`` and ``jax/_src/random.py``): the Threefry-2x32 hash of
20 rounds, the seed's split into two 32-bit words, ``fold_in`` as a hash of
``(0, data)``, the fold-like split of a key and the partitionable random bits
(the hash of a 64-bit iota, its two words XORed), and ``randint``'s
modulus with its ``2 ** 16`` multiplier.

uint32 values are held in int64 tensors and masked after every add, shift
and multiply, since torch has no uint32 arithmetic. Keys and counters are
tensors on the caller's device, so a draw reads nothing on the host and can
be captured into a CUDA graph.
"""
from typing import Sequence, Tuple

import torch

Tensor = torch.Tensor
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x: Tensor) -> Tensor:
    return torch.bitwise_and(x, _MASK)


def _rotl(x: Tensor, r: int) -> Tensor:
    return _u32(torch.bitwise_or(torch.bitwise_left_shift(x, r), torch.bitwise_right_shift(x, 32 - r)))


def threefry2x32(key: Tensor, x0: Tensor, x1: Tensor) -> Tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash of the counter words ``(x0, x1)`` (uint32 values
    in int64 tensors, broadcast together) under ``key`` (a ``(2,)`` key)."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, _u32(torch.bitwise_xor(torch.bitwise_xor(k0, k1), 0x1BD11BDA)))
    x = [_u32(x0 + ks[0]), _u32(x1 + ks[1])]
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x[0] = _u32(x[0] + x[1])
            x[1] = torch.bitwise_xor(x[0], _rotl(x[1], r))
        x[0] = _u32(x[0] + ks[(group + 1) % 3])
        x[1] = _u32(x[1] + ks[(group + 2) % 3] + (group + 1))
    return x[0], x[1]


def prng_key(seed: int, device: torch.device = None) -> Tensor:
    """``jax.random.PRNGKey(seed)`` as a ``(2,)`` int64 tensor of uint32
    words: the seed's high 32 bits, then its low 32 bits (an int32 seed's
    high word is 0)."""
    seed = int(seed)
    hi = (seed >> 32) & _MASK if not -(2**31) <= seed < 2**31 else 0
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key: Tensor, data: Tensor) -> Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter ``(0, data)``
    for a scalar ``data`` (a tensor, taken as uint32; no host read)."""
    data = _u32(torch.as_tensor(data, device=key.device).to(torch.int64)).reshape(1)
    y0, y1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.cat([y0, y1])


def _split2(key: Tensor) -> Tuple[Tensor, Tensor]:
    """``jax.random.split(key)`` (fold-like, partitionable): the hash of the
    64-bit iota ``(0, 0), (0, 1)``; key ``i`` is the two words of count ``i``."""
    lo = torch.arange(2, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key, torch.zeros_like(lo), lo)
    return torch.stack([b0[0], b1[0]]), torch.stack([b0[1], b1[1]])


def random_bits32(key: Tensor, shape: Sequence[int]) -> Tensor:
    """``jax.random.bits(key, shape, uint32)`` (partitionable): the hash of
    the 64-bit iota over ``shape``, its two words XORed."""
    n = 1
    for d in shape:
        n *= int(d)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key, torch.zeros_like(lo), lo)
    return torch.bitwise_xor(b0, b1).reshape(tuple(shape))


def randint(key: Tensor, shape: Sequence[int], minval: int, maxval: int) -> Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with int32 output
    (JAX's default with x64 off), for ``minval < maxval`` within int32."""
    span = int(maxval) - int(minval)
    if span <= 0:
        span = 1
    k1, k2 = _split2(key)
    higher, lower = random_bits32(k1, shape), random_bits32(k2, shape)
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span  # uint32 products wrap
    offset = _u32(_u32(torch.remainder(higher, span) * multiplier) + torch.remainder(lower, span))
    return (int(minval) + torch.remainder(offset, span)).to(torch.int32)
