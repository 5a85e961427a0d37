"""K9: COCO's greedy detection matcher on the card, and its plain version beside it.

The JAX package matches detections to ground truths with ``_greedy_match_single``
(``metrics_tpu/detection/map.py:200-239``), a ``lax.scan`` over the score-sorted
detections carrying the matched-gt mask, vmapped over IoU thresholds, area
ranges and problems; no Pallas kernel lies there. :func:`greedy_match_cuda`
runs that scan for every ``(problem, area, threshold)`` cell at once, one
thread a cell for ``G <= 32``, one warp a cell up to ``G = 1024`` and one
block a cell above (``csrc/match.cu``), in one launch unless the cells
outnumber a grid's 65 535 rows; :func:`greedy_match_plain` is the same scan as a
Python loop over the detections with tensor ops over ``(P, A, T, G)``, and
:func:`greedy_match` picks by the tensor's device.

Inputs: ``iou`` ``(B, D, G)`` float32 blocks, ``iou_index`` ``(P,)`` int32
naming each problem's block (the identity for the eager metric; the corpus
aggregate's problem ``(class, image)`` reads its image's block),
``det_valid`` ``(P, D)``, ``gt_valid`` ``(P, G)`` and ``gt_ignore``
``(P, A, G)`` as bool or uint8, ``thresholds`` ``(T,)`` float32. Outputs:
``dm`` ``(P, A, T, D)`` uint8 and ``mi`` ``(P, A, T, D)`` int32, -1 where a
detection is unmatched: ``vmap(vmap(_greedy_match_single))`` over problems
and areas, bit for bit. A problem whose index lies outside ``[0, B)`` reads
no block and matches nothing.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.ops.kernels import build

__all__ = ["greedy_match", "greedy_match_cuda", "greedy_match_plain"]

#: ``1 - 1e-10`` as float32 (1.0): the clamp of ``map.py:222`` in JAX's dtype
_THR_CAP = 1.0 - 1e-10


def _check_shapes(iou: torch.Tensor, iou_index: torch.Tensor, det_valid: torch.Tensor, gt_valid: torch.Tensor,
                  gt_ignore: torch.Tensor, thresholds: torch.Tensor, what: str) -> Tuple[int, int, int, int, int]:
    if iou.ndim != 3 or iou_index.ndim != 1 or thresholds.ndim != 1:
        raise ValueError(f"{what}: expected iou (B, D, G), iou_index (P,) and thresholds (T,), got "
                         f"{tuple(iou.shape)}, {tuple(iou_index.shape)} and {tuple(thresholds.shape)}")
    _, d, g = iou.shape
    p = iou_index.shape[0]
    if tuple(det_valid.shape) != (p, d) or tuple(gt_valid.shape) != (p, g) or gt_ignore.ndim != 3 \
            or tuple(gt_ignore.shape[::2]) != (p, g):
        raise ValueError(f"{what}: expected det_valid ({p}, {d}), gt_valid ({p}, {g}) and gt_ignore ({p}, A, {g}), "
                         f"got {tuple(det_valid.shape)}, {tuple(gt_valid.shape)} and {tuple(gt_ignore.shape)}")
    return p, gt_ignore.shape[1], thresholds.shape[0], d, g


def greedy_match_plain(iou: torch.Tensor, iou_index: torch.Tensor, det_valid: torch.Tensor, gt_valid: torch.Tensor,
                       gt_ignore: torch.Tensor, thresholds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dm, mi)`` of every problem, area and threshold: the scan of
    ``_greedy_match_single`` as a loop over the ``D`` detections."""
    p, a, t, d, g = _check_shapes(iou, iou_index, det_valid, gt_valid, gt_ignore, thresholds, "greedy_match_plain")
    dev = iou.device
    dm = torch.zeros((p, a, t, d), dtype=torch.uint8, device=dev)
    mi = torch.full((p, a, t, d), -1, dtype=torch.int32, device=dev)
    if min(p, a, t, d, g) == 0:
        return dm, mi
    idx = iou_index.to(torch.int64)
    ok = (idx >= 0) & (idx < iou.shape[0])
    rows = iou[torch.where(ok, idx, 0)]  # (P, D, G)
    thr = torch.minimum(thresholds.to(torch.float32), torch.tensor(_THR_CAP, dtype=torch.float32, device=dev))
    thr = thr[None, None, :, None]
    gvalid = (gt_valid.to(torch.bool) & ok[:, None])[:, None, None, :]  # (P, 1, 1, G)
    ignored = gt_ignore.to(torch.bool)[:, :, None, :]  # (P, A, 1, G)
    dvalid = det_valid.to(torch.bool)
    gidx = torch.arange(g, device=dev)
    matched = torch.zeros((p, a, t, g), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    for i in range(d):
        row = rows[:, i][:, None, None, :]  # (P, 1, 1, G)
        cand = gvalid & ~matched & (row >= thr)
        regular = cand & ~ignored
        pool = torch.where(regular.any(dim=-1, keepdim=True), regular, cand)
        masked = torch.where(pool, row, neg_inf)
        best = masked.amax(dim=-1, keepdim=True)
        match = torch.where(pool & (masked == best), gidx, -1).amax(dim=-1)  # (P, A, T)
        hit = (match >= 0) & dvalid[:, i, None, None]
        matched |= hit[..., None] & (gidx == match[..., None])
        dm[..., i] = hit.to(torch.uint8)
        mi[..., i] = torch.where(hit, match, -1).to(torch.int32)
    return dm, mi


def _flags(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dtype == torch.bool:
        return x.contiguous().view(torch.uint8)
    if x.dtype != torch.uint8:
        raise TypeError(f"greedy_match_cuda takes {name} as bool or uint8, got {x.dtype}")
    return x.contiguous()


def greedy_match_cuda(iou: torch.Tensor, iou_index: torch.Tensor, det_valid: torch.Tensor, gt_valid: torch.Tensor,
                      gt_ignore: torch.Tensor, thresholds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`greedy_match_plain` on the card: float32 ``iou`` and
    ``thresholds``, int32 ``iou_index``, bool or uint8 flags, all on one CUDA
    device, any ``G`` and ``A * T``; raises on anything else. Past ``2**18``
    ground truths the open sets live in an int32 scratch allocated here on
    the call's stream."""
    p, a, t, d, g = _check_shapes(iou, iou_index, det_valid, gt_valid, gt_ignore, thresholds, "greedy_match_cuda")
    tensors = (iou, iou_index, det_valid, gt_valid, gt_ignore, thresholds)
    if iou.device.type != "cuda" or any(x.device != iou.device for x in tensors):
        raise ValueError("greedy_match_cuda: every input must lie on one CUDA device")
    if iou.dtype != torch.float32 or thresholds.dtype != torch.float32:
        raise TypeError(f"greedy_match_cuda takes float32 iou and thresholds, got {iou.dtype} and {thresholds.dtype}")
    if iou_index.dtype != torch.int32:
        raise TypeError(f"greedy_match_cuda takes an int32 iou_index, got {iou_index.dtype}")
    flags = [_flags(x, n) for x, n in ((det_valid, "det_valid"), (gt_valid, "gt_valid"), (gt_ignore, "gt_ignore"))]
    lib = build.library("match")
    if min(p, a, t, d, g) == 0 or iou.shape[0] == 0:  # nothing to match: no launch
        return (torch.zeros((p, a, t, d), dtype=torch.uint8, device=iou.device),
                torch.full((p, a, t, d), -1, dtype=torch.int32, device=iou.device))
    dm = torch.empty((p, a, t, d), dtype=torch.uint8, device=iou.device)  # the kernel writes every cell
    mi = torch.empty((p, a, t, d), dtype=torch.int32, device=iou.device)
    iou, iou_index, thresholds = iou.contiguous(), iou_index.contiguous(), thresholds.contiguous()
    with torch.cuda.device(iou.device):
        words = lib.match_scratch_words(p, a, t, g)
        scratch = torch.empty((words,), dtype=torch.int32, device=iou.device) if words else None
        stream = torch.cuda.current_stream(iou.device).cuda_stream
        err = lib.greedy_match(iou.data_ptr(), iou_index.data_ptr(), flags[0].data_ptr(), flags[1].data_ptr(),
                               flags[2].data_ptr(), thresholds.data_ptr(), dm.data_ptr(), mi.data_ptr(),
                               scratch.data_ptr() if scratch is not None else None, iou.shape[0], p, d, g, a, t,
                               stream)
    build.check(err, "greedy_match launch")
    greedy_match_cuda.launches += 1
    return dm, mi


#: launches of the K9 kernel since the count was last set to 0
greedy_match_cuda.launches = 0


def greedy_match(iou: torch.Tensor, iou_index: torch.Tensor, det_valid: torch.Tensor, gt_valid: torch.Tensor,
                 gt_ignore: torch.Tensor, thresholds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy matcher: the kernel for CUDA tensors, the plain version for
    CPU ones."""
    fn = greedy_match_cuda if iou.is_cuda else greedy_match_plain
    return fn(iou, iou_index, det_valid, gt_valid, gt_ignore, thresholds)
