"""Match error rate (port of ``metrics_tpu/functional/text/mer.py``)."""
from typing import List, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _edit_distance_batch, _f32
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor


def _mer_update(
    predictions: Union[str, List[str]], references: Union[str, List[str]], device: torch.device
) -> Tuple[Tensor, Tensor]:
    if isinstance(predictions, str):
        predictions = [predictions]
    if isinstance(references, str):
        references = [references]
    pred_tokens = [p.split() for p in predictions]
    ref_tokens = [r.split() for r in references]
    errors = _edit_distance_batch(pred_tokens, ref_tokens).sum()
    total = sum(max(len(r), len(p)) for p, r in zip(pred_tokens, ref_tokens))
    return _f32(float(errors), device), _f32(float(total), device)


def _mer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def match_error_rate(
    predictions: Union[str, List[str]], references: Union[str, List[str]], device: DeviceLike = None
) -> Tensor:
    """MER = edit operations / max(reference, prediction) length."""
    errors, total = _mer_update(predictions, references, resolve_device(device))
    return _mer_compute(errors, total)
