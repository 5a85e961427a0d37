"""K2: the CUDA histogram (masked/weighted bincount), its plain version, and
the custom ops that carry both through ``torch.func.vmap``.

Replaces ``metrics_tpu/ops/kernels/pallas_hist.py::histogram_pallas``. The
kernel (``csrc/hist.cu``) scatters with shared-memory atomics when the
``(L, K)`` histogram fits in 48 KB and with global atomics otherwise, so every
length is covered; counts are int32 and exact, weight sums f32. It is bound by
bytes (each index and weight read once) and, at the slice's sizes, by launch
latency.

The masked engine step runs each metric's update under ``torch.func.vmap``
over batch-of-1 rows, as the JAX package ``jax.vmap``s it. The two primitives
are therefore ``torch.library.custom_op``s whose vmap rule launches the kernel
ONCE for the whole batch: row ``b``'s bin ``i`` becomes bin ``b * L + i`` of
one histogram of length ``B * L``, which is then reshaped to ``(B, L[, K])``.
On a CUDA tensor an op launches the kernel; on a CPU tensor it runs the plain
version. Nothing else chooses between them.
"""
from typing import Optional

import torch

from metrics_tpu_torch.ops.kernels import build
from metrics_tpu_torch.ops.kernels.xla_ref import histogram_ref

__all__ = ["histogram_cuda", "histogram_plain", "histogram_counts_op", "histogram_weights_op"]

_WDTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BINS = 2**31 - 1


def histogram_plain(idx: torch.Tensor, length: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: int32 ``(L,)`` counts, or f32
    ``(L, K)`` sums of ``(N, K)`` weights (bf16 widened to f32 first)."""
    if weights is None:
        return histogram_ref(idx, length)
    return histogram_ref(idx, length, weights=weights.to(torch.float32))


def histogram_cuda(idx: torch.Tensor, length: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K2 on the card.

    ``idx`` is ``(N,)`` int32 (negatives count in bin 0, ``>= length`` drop);
    ``weights`` None gives int32 ``(length,)`` counts, an ``(N, K)`` f32 or
    bf16 tensor gives f32 ``(length, K)`` sums. All inputs contiguous on one
    CUDA device; anything else raises.
    """
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError("histogram_cuda: indices must lie on a CUDA device")
    if idx.dtype != torch.int32 or idx.ndim != 1 or not idx.is_contiguous():
        raise TypeError(f"histogram_cuda: indices must be contiguous 1-D int32, got {idx.dtype} {tuple(idx.shape)}")
    length = int(length)
    if not 0 < length <= _MAX_BINS:
        raise ValueError(f"histogram_cuda: length must be in [1, 2**31), got {length}")
    n = idx.shape[0]
    lib = build.library("hist")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if weights is None:
            out = torch.empty(length, dtype=torch.int32, device=dev)
            err = lib.histogram_counts(idx.data_ptr(), n, length, out.data_ptr(), stream)
        else:
            if weights.device != dev or weights.dtype not in _WDTYPE_CODE:
                raise TypeError(f"histogram_cuda: weights must be f32 or bf16 on {dev}, "
                                f"got {weights.dtype} on {weights.device}")
            if weights.ndim != 2 or weights.shape[0] != n or not weights.is_contiguous():
                raise ValueError(f"histogram_cuda: weights must be contiguous (N={n}, K), got {tuple(weights.shape)}")
            k = weights.shape[1]
            if k == 0 or length * k > _MAX_BINS:
                raise ValueError(f"histogram_cuda: cannot take {length} x {k} bins")
            out = torch.empty((length, k), dtype=torch.float32, device=dev)
            err = lib.histogram_weights(idx.data_ptr(), weights.data_ptr(), n, length, k,
                                        _WDTYPE_CODE[weights.dtype], out.data_ptr(), stream)
    build.check(err, "histogram launch")
    histogram_cuda.launches += 1
    return out


#: launches of the K2 kernel since the count was last set to 0
histogram_cuda.launches = 0


@torch.library.custom_op("metrics_tpu_torch::histogram_counts", mutates_args=())
def histogram_counts_op(idx: torch.Tensor, length: int) -> torch.Tensor:
    """int32 ``(length,)`` counts of int32 ``(N,)`` indices."""
    if idx.device.type == "cuda":
        return histogram_cuda(idx, length)
    return histogram_plain(idx, length)


@histogram_counts_op.register_fake
def _(idx, length):
    return idx.new_empty((length,), dtype=torch.int32)


@torch.library.custom_op("metrics_tpu_torch::histogram_weights", mutates_args=())
def histogram_weights_op(idx: torch.Tensor, weights: torch.Tensor, length: int) -> torch.Tensor:
    """f32 ``(length, K)`` sums of ``(N, K)`` weights by int32 ``(N,)`` indices."""
    if idx.device.type == "cuda":
        return histogram_cuda(idx, length, weights)
    return histogram_plain(idx, length, weights)


@histogram_weights_op.register_fake
def _(idx, weights, length):
    return weights.new_empty((length, weights.shape[1]), dtype=torch.float32)


def _batched(x: torch.Tensor, dim: Optional[int], b: int) -> torch.Tensor:
    return x.movedim(dim, 0) if dim is not None else x.expand((b,) + tuple(x.shape))


def fold_batch_into_bins(idx: torch.Tensor, length: int) -> torch.Tensor:
    """``(B, N)`` indices → ``(B*N,)`` int32 indices into one histogram of
    length ``B * length``: row ``b``'s bin ``i`` becomes ``b * length + i``;
    clipping (negatives to 0) happens first, and an out-of-range index maps
    to ``B * length``, so it still drops."""
    b = idx.shape[0]
    if b * length > _MAX_BINS:
        raise ValueError(f"vmapped histogram: {b} x {length} bins exceed int32 indices")
    idx = idx.reshape(b, -1).to(torch.int64).clamp(min=0)
    base = torch.arange(b, device=idx.device, dtype=torch.int64).unsqueeze(1) * length
    flat = torch.where(idx < length, idx + base, torch.full_like(idx, b * length))
    return flat.reshape(-1).to(torch.int32)


def _counts_vmap(info, in_dims, idx, length):
    if in_dims[0] is None:
        return histogram_counts_op(idx, length), None
    b = info.batch_size
    out = histogram_counts_op(fold_batch_into_bins(_batched(idx, in_dims[0], b), length), b * length)
    return out.reshape(b, length), 0


def _weights_vmap(info, in_dims, idx, weights, length):
    if in_dims[0] is None and in_dims[1] is None:
        return histogram_weights_op(idx, weights, length), None
    b = info.batch_size
    idx_b = _batched(idx, in_dims[0], b)
    w_b = _batched(weights, in_dims[1], b)
    k = w_b.shape[-1]
    flat_w = w_b.reshape(-1, k).contiguous()
    out = histogram_weights_op(fold_batch_into_bins(idx_b, length), flat_w, b * length)
    return out.reshape(b, length, k), 0


histogram_counts_op.register_vmap(_counts_vmap)
histogram_weights_op.register_vmap(_weights_vmap)
