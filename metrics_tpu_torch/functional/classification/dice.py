"""Dice score (port of ``metrics_tpu/functional/classification/dice.py``).

One vectorised one-hot comparison over the class axis gives every class's
tp/fp/fn at once; no branch reads the data.
"""
import torch

from metrics_tpu_torch.parallel.collectives import reduce
from metrics_tpu_torch.utils.data import to_categorical
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor


def dice_score(
    preds: Tensor,
    target: Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: str = "elementwise_mean",
    device: DeviceLike = None,
) -> Tensor:
    """Dice score from prediction scores.

    Args:
        preds: estimated probabilities with a class axis: ``(N, C)`` or ``(N, C, ...)``
        target: ground-truth labels ``(N, ...)``
        bg: whether to also compute dice for the background class (index 0)
        nan_score: score to return when the denominator (2*tp+fp+fn) is zero
        no_fg_score: score to return for a class absent from ``target``
        reduction: ``'elementwise_mean'`` | ``'sum'`` | ``'none'``
        device: where to compute (default: the inputs' device, else ``cuda``)
    """
    dev = tensor_device(preds, target, device=device)
    preds, target = as_input(preds, dev), as_input(target, dev)
    if preds.ndim < 2:
        raise ValueError(
            "`dice_score` expects `preds` with a class dimension at axis 1 "
            f"(probabilities of shape (N, C, ...)), got shape {tuple(preds.shape)}."
        )
    num_classes = preds.shape[1]
    if preds.ndim == target.ndim + 1:
        preds = to_categorical(preds, argmax_dim=1)

    start = 0 if bg else 1
    classes = torch.arange(start, num_classes, device=dev)
    shape = (-1,) + (1,) * preds.ndim
    p = preds.unsqueeze(0) == classes.reshape(shape)
    t = target.unsqueeze(0) == classes.reshape(shape)
    axes = tuple(range(1, p.ndim))
    tp = torch.sum(p & t, dim=axes, dtype=torch.int32)
    fp = torch.sum(p & ~t, dim=axes, dtype=torch.int32)
    fn = torch.sum(~p & t, dim=axes, dtype=torch.int32)
    support = torch.sum(t, dim=axes, dtype=torch.int32)

    denom = (2 * tp + fp + fn).to(torch.float32)
    scores = torch.where(denom > 0, 2.0 * tp / torch.clamp(denom, min=1.0), torch.full_like(denom, nan_score))
    scores = torch.where(support > 0, scores, torch.full_like(scores, no_fg_score))
    return reduce(scores, reduction=reduction)
