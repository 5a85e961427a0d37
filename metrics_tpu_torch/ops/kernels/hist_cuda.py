"""K2: the batched CUDA histogram (masked/weighted bincount), its plain
version, and the custom op that carries both through ``torch.func.vmap``.

Replaces ``metrics_tpu/ops/kernels/pallas_hist.py::histogram_pallas``, whose
``pallas_call`` gains a batch axis in its grid under ``jax.vmap``: one
``(L, K)`` histogram per row. The op here is that batched function: ``(B, N)``
indices, an optional ``(B, N)`` mask and optional ``(B, N, K)`` weights give
``(B, L)`` int32 counts or ``(B, L, K)`` sums in the weights' dtype. The
kernel (``csrc/hist.cu``) reads every input in place through its strides
(int32 or int64 indices, a bool, uint8 or int32 mask, a batch stride of 0 for
an argument the vmap rule expands) and writes every output element once, so a
call is one launch with nothing before it. It is bound by bytes (each input
read once, each output written once) and, at the main path's shapes, by launch
latency.

The masked engine step runs each metric's update under ``torch.func.vmap``
over batch-of-1 rows, as the JAX package ``jax.vmap``s it. The vmap rule hands
the batch to the op as its ``B`` axis (an unbatched argument expanded with
stride 0), so the whole bucket is one launch. On a CUDA tensor the op launches
the kernel; on a CPU tensor it runs the plain version. Nothing else chooses
between them.
"""
from typing import Optional

import torch

from metrics_tpu_torch.ops.kernels import build

__all__ = ["INDEX_DTYPES", "MASK_DTYPES", "WEIGHT_DTYPES", "histogram_cuda", "histogram_plain", "histogram_op"]

# the weights the kernel sums (csrc/hist.cu's Wdtype codes) and the dtype each
# accumulates in; the sums are cast back to the weights' dtype
_WDTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.float64: 3, torch.int8: 4,
                torch.int16: 5, torch.int32: 6, torch.int64: 7, torch.uint8: 8}
_ACC = {torch.float32: torch.float32, torch.bfloat16: torch.float32, torch.float16: torch.float32,
        torch.float64: torch.float64, torch.int8: torch.int32, torch.int16: torch.int32,
        torch.int32: torch.int32, torch.int64: torch.int64, torch.uint8: torch.int32}
WEIGHT_DTYPES = tuple(_WDTYPE_CODE)
_INDEX_WIDE = {torch.int32: 0, torch.int64: 1}
INDEX_DTYPES = tuple(_INDEX_WIDE)
_MASK_KIND = {torch.bool: 1, torch.uint8: 1, torch.int32: 2}  # bool is one byte, read as uint8
MASK_DTYPES = tuple(_MASK_KIND)
_MAX_LENGTH = 2**31 - 1


def histogram_plain(idx: torch.Tensor, length: int, mask: Optional[torch.Tensor] = None,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: row ``b``'s bin ``i`` becomes
    bin ``b * length + i`` of one flat histogram. Negative indices count in
    bin 0; indices ``>= length`` and masked ones drop."""
    b = idx.shape[0]
    v = idx.to(torch.int64).clamp(min=0)
    keep = v < length
    if mask is not None:
        keep = keep & (mask != 0)
    flat = (v + torch.arange(b, device=v.device).unsqueeze(1) * length)[keep]
    if weights is None:
        out = torch.zeros(b * length, dtype=torch.int32, device=v.device)
        return out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32)).reshape(b, length)
    acc = _ACC[weights.dtype]
    k = weights.shape[2]
    sums = torch.zeros((b * length, k), dtype=acc, device=v.device).index_add_(0, flat, weights[keep].to(acc))
    return sums.to(weights.dtype).reshape(b, length, k)


def histogram_cuda(idx: torch.Tensor, length: int, mask: Optional[torch.Tensor] = None,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K2 on the card.

    ``idx`` is ``(B, N)`` int32 or int64 (negatives count in bin 0, indices
    ``>= length`` drop); ``mask`` None or ``(B, N)`` bool, uint8 or int32
    (zero drops the index); ``weights`` None gives int32 ``(B, length)``
    counts, a ``(B, N, K)`` tensor of a :data:`WEIGHT_DTYPES` dtype gives
    ``(B, length, K)`` sums in that dtype. Any strides, 0 included; all on one
    CUDA device. Anything else raises.
    """
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError("histogram_cuda: indices must lie on a CUDA device")
    if idx.dtype not in _INDEX_WIDE or idx.ndim != 2:
        raise TypeError(f"histogram_cuda: indices must be (B, N) int32 or int64, got {idx.dtype} {tuple(idx.shape)}")
    length = int(length)
    if not 0 <= length <= _MAX_LENGTH:
        raise ValueError(f"histogram_cuda: length must be in [0, 2**31), got {length}")
    b, n = idx.shape
    mask_args = (None, 0, 0, 0)
    if mask is not None:
        if mask.device != dev or mask.dtype not in _MASK_KIND or tuple(mask.shape) != (b, n):
            raise TypeError(f"histogram_cuda: mask must be ({b}, {n}) bool, uint8 or int32 on {dev}, "
                            f"got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
        mask_args = (mask.data_ptr(), _MASK_KIND[mask.dtype], *mask.stride())
    if weights is None:
        out = torch.empty((b, length), dtype=torch.int32, device=dev)
        k, w_args = 1, (None, -1, 0, 0, 0)
    else:
        if weights.device != dev or weights.dtype not in _WDTYPE_CODE:
            raise TypeError(f"histogram_cuda: weights must be one of {WEIGHT_DTYPES} on {dev}, "
                            f"got {weights.dtype} on {weights.device}")
        if weights.ndim != 3 or tuple(weights.shape[:2]) != (b, n) or weights.shape[2] == 0:
            raise ValueError(f"histogram_cuda: weights must be ({b}, {n}, K > 0), got {tuple(weights.shape)}")
        k = weights.shape[2]
        out = torch.empty((b, length, k), dtype=weights.dtype, device=dev)
        w_args = (weights.data_ptr(), _WDTYPE_CODE[weights.dtype], *weights.stride())
    if out.numel() == 0:
        return out
    lib = build.library("hist")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.histogram(idx.data_ptr(), _INDEX_WIDE[idx.dtype], *idx.stride(), *mask_args, *w_args,
                            b, n, length, k, out.data_ptr(), stream)
    build.check(err, "histogram launch")
    histogram_cuda.launches += 1
    return out


#: launches of the K2 kernel since the count was last set to 0
histogram_cuda.launches = 0


@torch.library.custom_op("metrics_tpu_torch::histogram", mutates_args=())
def histogram_op(idx: torch.Tensor, mask: Optional[torch.Tensor], weights: Optional[torch.Tensor],
                 length: int) -> torch.Tensor:
    """``(B, length)`` int32 counts of ``(B, N)`` indices, or ``(B, length,
    K)`` sums of ``(B, N, K)`` weights, rows dropped where ``mask`` is 0."""
    if idx.device.type == "cuda":
        return histogram_cuda(idx, length, mask, weights)
    return histogram_plain(idx, length, mask, weights)


@histogram_op.register_fake
def _(idx, mask, weights, length):
    if weights is None:
        return idx.new_empty((idx.shape[0], length), dtype=torch.int32)
    return weights.new_empty((idx.shape[0], length, weights.shape[2]))


def _histogram_vmap(info, in_dims, idx, mask, weights, length):
    b = info.batch_size

    def merged(x, dim):  # (b, B, ...) -> (b*B, ...): a view for B = 1, stride 0 where x is unbatched
        if x is None:
            return None
        x = x.movedim(dim, 0) if dim is not None else x.expand((b,) + tuple(x.shape))
        return x.reshape((b * x.shape[1],) + tuple(x.shape[2:]))

    idx = merged(idx, in_dims[0])
    out = histogram_op(idx, merged(mask, in_dims[1]), merged(weights, in_dims[2]), length)
    return out.reshape((b, idx.shape[0] // b) + tuple(out.shape[1:])), 0


histogram_op.register_vmap(_histogram_vmap)
