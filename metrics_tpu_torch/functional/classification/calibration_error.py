"""Top-label calibration error with the l1 (ECE), l2 and max norms (port of
``metrics_tpu/functional/classification/calibration_error.py``).

The binning is the JAX package's: ``searchsorted(side="left") - 1``, so bin
``i`` covers ``(b_i, b_{i+1}]`` and a confidence of 0 lands in no bin. The
three per-bin sums (count, confidence sum, accuracy sum) are ONE call of
:func:`~metrics_tpu_torch.ops.kernels.histogram_accumulate` with ``(N, 3)``
weights: one K2 launch on the card, its plain version on the CPU.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.kernels import histogram_accumulate
from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.enums import DataType

Tensor = torch.Tensor


def _bin_boundaries(n_bins: int, device: Optional[torch.device] = None) -> Tensor:
    """``n_bins + 1`` f32 boundaries ``i * f32(1 / n_bins)``, the last one 1,
    bit for bit as ``jnp.linspace(0, 1, n_bins + 1)`` gives them
    (``torch.linspace`` steps from both ends and differs in the last bit)."""
    step = torch.tensor(1.0 / n_bins, dtype=torch.float32)
    out = torch.arange(n_bins + 1, dtype=torch.float32) * step
    out[-1] = 1.0
    return out.to(device)


def _ce_compute(
    confidences: Tensor,
    accuracies: Tensor,
    bin_boundaries: Tensor,
    norm: str = "l1",
    debias: bool = False,
) -> Tensor:
    if norm not in {"l1", "l2", "max"}:
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")

    n_bins = bin_boundaries.shape[0] - 1
    idx = torch.searchsorted(bin_boundaries, confidences, side="left") - 1
    valid = idx >= 0
    idx = torch.clamp(idx, 0, n_bins - 1)
    w = valid.to(confidences.dtype)

    cols = torch.stack([w, confidences * w, accuracies * w], dim=-1)
    sums = histogram_accumulate(idx, n_bins, weights=cols)
    count_bin, conf_sum, acc_sum = sums[:, 0], sums[:, 1], sums[:, 2]

    n = confidences.shape[0]
    prop_bin = count_bin / n
    safe = torch.clamp(count_bin, min=1.0)
    zero = torch.zeros_like(count_bin)
    conf_bin = torch.where(count_bin > 0, conf_sum / safe, zero)
    acc_bin = torch.where(count_bin > 0, acc_sum / safe, zero)
    # padded to the boundaries' length, as the reference's zeros_like(boundaries)
    pad = bin_boundaries.shape[0] - n_bins
    conf_bin = torch.cat([conf_bin, conf_bin.new_zeros(pad)])
    acc_bin = torch.cat([acc_bin, acc_bin.new_zeros(pad)])
    prop_bin = torch.cat([prop_bin, prop_bin.new_zeros(pad)])

    if norm == "l1":
        ce = torch.sum(torch.abs(acc_bin - conf_bin) * prop_bin)
    elif norm == "max":
        ce = torch.max(torch.abs(acc_bin - conf_bin))
    else:  # l2
        ce = torch.sum((acc_bin - conf_bin) ** 2 * prop_bin)
        if debias:
            debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * n - 1)
            ce = ce + torch.sum(torch.nan_to_num(debias_bins))
        ce = torch.where(ce > 0, torch.sqrt(torch.clamp(ce, min=0.0)), torch.zeros_like(ce))
    return ce


def _ce_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _, _, mode = _input_format_classification(preds, target)

    if mode == DataType.BINARY:
        confidences, accuracies = preds, target
    elif mode == DataType.MULTICLASS:
        confidences, predictions = torch.max(preds, dim=1)
        accuracies = predictions == target
    elif mode == DataType.MULTIDIM_MULTICLASS:
        flat = torch.movedim(preds, 1, -1).reshape(-1, preds.shape[1])
        confidences, predictions = torch.max(flat, dim=1)
        accuracies = predictions == target.reshape(-1)
    else:
        raise ValueError(
            f"Calibration error is not well-defined for data with size {tuple(preds.shape)} and targets "
            f"{tuple(target.shape)}."
        )
    return confidences.to(torch.float32), accuracies.to(torch.float32)


def calibration_error(preds: Tensor, target: Tensor, n_bins: int = 15, norm: str = "l1",
                      device: DeviceLike = None) -> Tensor:
    """Top-label calibration error of ``preds`` against ``target``."""
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
    if not isinstance(n_bins, int) or n_bins <= 0:
        raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")
    dev = tensor_device(preds, target, device=device)
    confidences, accuracies = _ce_update(as_input(preds, dev), as_input(target, dev))
    return _ce_compute(confidences, accuracies, _bin_boundaries(n_bins, dev), norm=norm)
