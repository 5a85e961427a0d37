"""Word information preserved (port of ``metrics_tpu/functional/text/wip.py``)."""
from typing import List, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _edit_distance_batch, _f32
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor


def _wip_update(
    predictions: Union[str, List[str]], references: Union[str, List[str]], device: torch.device
) -> Tuple[Tensor, Tensor, Tensor]:
    if isinstance(predictions, str):
        predictions = [predictions]
    if isinstance(references, str):
        references = [references]
    pred_tokens = [p.split() for p in predictions]
    ref_tokens = [r.split() for r in references]
    errors = float(_edit_distance_batch(pred_tokens, ref_tokens).sum())
    reference_total = float(sum(len(r) for r in ref_tokens))
    prediction_total = float(sum(len(p) for p in pred_tokens))
    total = float(sum(max(len(r), len(p)) for p, r in zip(pred_tokens, ref_tokens)))
    return _f32(errors - total, device), _f32(reference_total, device), _f32(prediction_total, device)


def _wip_compute(errors: Tensor, reference_total: Tensor, prediction_total: Tensor) -> Tensor:
    return (errors / reference_total) * (errors / prediction_total)


def word_information_preserved(
    predictions: Union[str, List[str]], references: Union[str, List[str]], device: DeviceLike = None
) -> Tensor:
    """WIP = (H/N_ref)(H/N_pred)."""
    errors, reference_total, prediction_total = _wip_update(predictions, references, resolve_device(device))
    return _wip_compute(errors, reference_total, prediction_total)
