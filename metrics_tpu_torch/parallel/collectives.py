"""Constants of the q8_block quantized codec, and the reductions the
classification metrics share (port of those parts of
``metrics_tpu/parallel/collectives.py``). The collectives themselves are not
ported yet; the engine's at-rest codec (``engine/quantize.py``) and the
metric's ``sync_precision`` policy read the constants, Jaccard and dice the
reductions."""
import torch

from metrics_tpu_torch.utils.data import METRIC_EPS

Tensor = torch.Tensor

#: elements per absmax-scale block of the block-scaled int8 codec
Q8_BLOCK = 32

#: the declared sync precisions; "exact" is the default everywhere
SYNC_PRECISIONS = ("exact", "q8_block")

#: blocks whose absmax sits below this flush to zero codes: the scale
#: absmax/127 would be subnormal there, and 1/scale overflows f32
Q8_FLUSH = 1.5e-36


def reduce(x: Tensor, reduction: str) -> Tensor:
    """Elementwise->scalar reduction: ``elementwise_mean``, ``sum`` or
    ``none``."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction == "none" or reduction is None:
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Class-averaged fraction num/denom with micro/macro/weighted/none
    reduction."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    if class_reduction == "micro":
        fraction = torch.sum(num) / (torch.sum(denom) + METRIC_EPS)
    else:
        fraction = num / (denom + METRIC_EPS)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights / torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between {valid_reduction}")
