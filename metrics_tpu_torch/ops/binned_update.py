"""K3: the binned precision-recall update — the CUDA kernel, its plain version, and the
custom op that carries both through ``torch.func.vmap``.

Port of ``metrics_tpu/ops/binned_update.py``; the kernel
(``csrc/binned.cu``) replaces ``binned_counts_pallas``. The binned curve
metrics accumulate TP/FP/FN counts of shape ``(C, T)`` from ``(N, C)``
probabilities against ``T`` thresholds. The plain version broadcasts an
``(N, C, T)`` intermediate; the kernel is one launch in which a thread counts
a class against four thresholds in registers and writes its f32 counts
itself when one row chunk holds every row (the vmapped step). With many rows,
row chunks add their counts to an int32 buffer with atomics (exact,
deterministic) and the last chunk of each pair tile writes them out and leaves
the buffer zero. Device memory sees the ``(N, C)`` inputs and the outputs
once.

The masked engine step vmaps each update over batch-of-1 rows. The vmap rule
launches the kernel once: ``(B, N, C)`` preds become ``(N, B*C)`` (the batch
widens the class axis) and the ``(B*C, T)`` result is reshaped to
``(B, C, T)``. On a CUDA tensor the op launches the kernel; on a CPU tensor it
runs the plain version.
"""
from typing import Dict, List, Tuple

import torch

from metrics_tpu_torch.ops.kernels import build
from metrics_tpu_torch.ops.kernels.dispatch import _maybe_kernel_fault

__all__ = ["binned_counts", "binned_counts_cuda", "binned_counts_torch", "binned_counts_op"]

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def binned_counts_torch(preds: torch.Tensor, target_bool: torch.Tensor, thresholds: torch.Tensor) -> Counts:
    """Plain version (port of ``binned_counts_jnp``): ``(TPs, FPs, FNs)``, each
    ``(C, T)`` f32."""
    t3 = target_bool[:, :, None]
    p3 = preds[:, :, None] >= thresholds[None, None, :]
    tps = torch.sum(t3 & p3, dim=0, dtype=torch.int32).to(torch.float32)
    fps = torch.sum(~t3 & p3, dim=0, dtype=torch.int32).to(torch.float32)
    fns = torch.sum(t3 & ~p3, dim=0, dtype=torch.int32).to(torch.float32)
    return tps, fps, fns


_zeroed: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# buffers a larger one replaced: a CUDA graph captured with one still reads it
_outgrown: List[torch.Tensor] = []


def _zeroed_scratch(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    """An int32 buffer of at least ``numel`` zeros for the kernel's many-row
    form on ``stream`` (a ``cuda_stream`` handle). The kernel leaves its sums
    and finish counters zero when it ends, so the buffer is made once per
    (device, stream), never shared by two streams, and grown, zeroed anew,
    only when a call needs more; an outgrown buffer is kept, never freed.
    The engine's warm-up step makes it for its capture stream before a
    capture, so no graph holds a memset."""
    buf = _zeroed.get((device, stream))
    if buf is None or buf.numel() < numel:
        if buf is not None:
            _outgrown.append(buf)
        buf = _zeroed[(device, stream)] = torch.zeros(numel, dtype=torch.int32, device=device)
    return buf


def binned_counts_cuda(preds: torch.Tensor, target_bool: torch.Tensor, thresholds: torch.Tensor) -> Counts:
    """Launch K3 on the card: contiguous ``(N, C)`` f32 preds, ``(N, C)`` bool
    target and ``(T,)`` f32 thresholds on one CUDA device; anything else
    raises."""
    dev = preds.device
    if dev.type != "cuda" or target_bool.device != dev or thresholds.device != dev:
        raise ValueError("binned_counts_cuda: preds, target and thresholds must lie on one CUDA device")
    if preds.dtype != torch.float32 or target_bool.dtype != torch.bool or thresholds.dtype != torch.float32:
        raise TypeError(f"binned_counts_cuda takes f32 preds, bool target and f32 thresholds, got "
                        f"{preds.dtype}, {target_bool.dtype}, {thresholds.dtype}")
    if preds.ndim != 2 or target_bool.shape != preds.shape or thresholds.ndim != 1:
        raise ValueError(f"binned_counts_cuda: expected (N, C) preds and target and (T,) thresholds, got "
                         f"{tuple(preds.shape)}, {tuple(target_bool.shape)}, {tuple(thresholds.shape)}")
    if not (preds.is_contiguous() and target_bool.is_contiguous() and thresholds.is_contiguous()):
        raise ValueError("binned_counts_cuda: inputs must be contiguous")
    n, c = preds.shape
    t = thresholds.shape[0]
    if c == 0 or t == 0 or 3 * c * t >= 2**31:
        raise ValueError(f"binned_counts_cuda: cannot take {c} classes x {t} thresholds")
    lib = build.library("binned")
    tp, fp, fn = (torch.empty((c, t), dtype=torch.float32, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        need = lib.binned_scratch_ints(n, c, t)
        scratch = _zeroed_scratch(dev, stream, need).data_ptr() if need else None
        err = lib.binned_counts(preds.data_ptr(), target_bool.data_ptr(), thresholds.data_ptr(), n, c, t,
                                scratch, tp.data_ptr(), fp.data_ptr(), fn.data_ptr(), stream)
    build.check(err, "binned_counts launch")
    binned_counts_cuda.launches += 1
    return tp, fp, fn


#: launches of the K3 kernel since the count was last set to 0
binned_counts_cuda.launches = 0


@torch.library.custom_op("metrics_tpu_torch::binned_counts", mutates_args=())
def binned_counts_op(preds: torch.Tensor, target_bool: torch.Tensor, thresholds: torch.Tensor) -> Counts:
    """``(TPs, FPs, FNs)`` of ``(N, C)`` preds against ``(T,)`` thresholds."""
    if preds.device.type == "cuda":
        return binned_counts_cuda(preds, target_bool, thresholds)
    return binned_counts_torch(preds, target_bool, thresholds)


@binned_counts_op.register_fake
def _(preds, target_bool, thresholds):
    shape = (preds.shape[1], thresholds.shape[0])
    return tuple(preds.new_empty(shape, dtype=torch.float32) for _ in range(3))


def _binned_vmap(info, in_dims, preds, target_bool, thresholds):
    p_dim, t_dim, thr_dim = in_dims
    if thr_dim is not None:
        raise NotImplementedError("binned_counts: thresholds cannot carry a vmapped batch dimension")
    if p_dim is None and t_dim is None:
        return binned_counts_op(preds, target_bool, thresholds), (None, None, None)
    b = info.batch_size

    def widen(x, dim):  # (B, N, C) -> (N, B*C): the batch widens the class axis
        x = x.movedim(dim, 0) if dim is not None else x.expand((b,) + tuple(x.shape))
        return x.permute(1, 0, 2).reshape(x.shape[1], b * x.shape[2]).contiguous()

    c = preds.shape[-1] if p_dim is None else preds.movedim(p_dim, 0).shape[2]
    tp, fp, fn = binned_counts_op(widen(preds, p_dim), widen(target_bool, t_dim), thresholds)
    t = thresholds.shape[0]
    return (tp.reshape(b, c, t), fp.reshape(b, c, t), fn.reshape(b, c, t)), (0, 0, 0)


binned_counts_op.register_vmap(_binned_vmap)


def binned_counts(preds: torch.Tensor, target_bool: torch.Tensor, thresholds: torch.Tensor) -> Counts:
    """TP/FP/FN ``(C, T)`` counts of ``(N, C)`` preds; the kernel on a CUDA
    tensor, the plain version on a CPU tensor (under vmap too)."""
    if preds.ndim != 2:
        raise ValueError(f"binned_counts expects (N, C) preds, got shape {tuple(preds.shape)}")
    _maybe_kernel_fault("binned_counts")
    thresholds = thresholds.to(device=preds.device, dtype=torch.float32).contiguous()
    return binned_counts_op(
        preds.to(torch.float32).contiguous(), target_bool.to(torch.bool).contiguous(), thresholds
    )
