"""Hinge loss: binary, Crammer-Singer and one-vs-all (port of
``metrics_tpu/functional/classification/hinge.py``).

The true class's score and the best wrong class's are masked maxima over
the one-hot target, with no boolean indexing or gather, so the update runs
under ``torch.func.vmap`` (the engines' per-row step) and a padded row's
out-of-range label reads nothing.
"""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _input_squeeze
from metrics_tpu_torch.utils.data import to_onehot
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device
from metrics_tpu_torch.utils.enums import DataType, EnumStr
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class MulticlassMode(EnumStr):
    """Possible multiclass modes of hinge."""

    CRAMMER_SINGER = "crammer-singer"
    ONE_VS_ALL = "one-vs-all"


def _check_shape_and_type_consistency_hinge(preds: Tensor, target: Tensor) -> DataType:
    if target.ndim > 1:
        raise ValueError(f"The `target` should be one dimensional, got `target` with shape={tuple(target.shape)}.")
    if preds.ndim == 1:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        mode = DataType.BINARY
    elif preds.ndim == 2:
        if preds.shape[0] != target.shape[0]:
            raise ValueError(
                "The `preds` and `target` should have the same shape in the first dimension,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        mode = DataType.MULTICLASS
    else:
        raise ValueError(f"The `preds` should be one or two dimensional, got `preds` with shape={tuple(preds.shape)}.")
    return mode


def _hinge_update(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tuple[Tensor, Tensor]:
    preds, target = _input_squeeze(preds, target)
    mode = _check_shape_and_type_consistency_hinge(preds, target)

    if mode == DataType.MULTICLASS:
        target_oh = to_onehot(target, max(2, preds.shape[1])).to(torch.bool)

    if mode == DataType.MULTICLASS and (multiclass_mode is None or multiclass_mode == MulticlassMode.CRAMMER_SINGER):
        # margin = the true class's score minus the best wrong class's; both are
        # masked maxima, so an out-of-range label (a padded engine row) reads nothing
        neg_inf = torch.full_like(preds, -float("inf"))
        true_scores = torch.amax(torch.where(target_oh, preds, neg_inf), dim=1)
        wrong_best = torch.amax(torch.where(target_oh, neg_inf, preds), dim=1)
        margin = true_scores - wrong_best
    elif mode == DataType.BINARY or multiclass_mode == MulticlassMode.ONE_VS_ALL:
        t = target.to(torch.bool) if mode == DataType.BINARY else target_oh
        margin = torch.where(t, preds, -preds)
    else:
        raise ValueError(
            "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
            "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
            f" got {multiclass_mode}."
        )

    measures = torch.clamp(1 - margin, min=0)
    if squared:
        measures = measures**2

    # int32, as jnp.asarray(n) is; torch.full, not torch.tensor, so a captured step may hold it
    total = torch.full((), target.shape[0], dtype=torch.int32, device=target.device)
    return torch.sum(measures, dim=0), total


def _hinge_compute(measure: Tensor, total: Tensor) -> Tensor:
    return measure / total


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
    device: DeviceLike = None,
) -> Tensor:
    """The mean hinge loss."""
    dev = tensor_device(preds, target, device=device)
    measure, total = _hinge_update(as_input(preds, dev), as_input(target, dev), squared=squared,
                                   multiclass_mode=multiclass_mode)
    return _hinge_compute(measure, total)


def hinge(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
    device: DeviceLike = None,
) -> Tensor:
    """Deprecated alias of :func:`hinge_loss`."""
    rank_zero_warn("`hinge` was renamed to `hinge_loss` and it will be removed.", DeprecationWarning)
    return hinge_loss(preds, target, squared=squared, multiclass_mode=multiclass_mode, device=device)
