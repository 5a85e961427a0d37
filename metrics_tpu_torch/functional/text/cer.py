"""Character error rate (port of ``metrics_tpu/functional/text/cer.py``)."""
from typing import List, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _edit_distance_batch, _f32
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor


def _cer_update(
    predictions: Union[str, List[str]], references: Union[str, List[str]], device: torch.device
) -> Tuple[Tensor, Tensor]:
    if isinstance(predictions, str):
        predictions = [predictions]
    if isinstance(references, str):
        references = [references]
    errors = _edit_distance_batch([list(p) for p in predictions], [list(r) for r in references]).sum()
    total = sum(len(r) for r in references)
    return _f32(float(errors), device), _f32(float(total), device)


def _cer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def char_error_rate(
    predictions: Union[str, List[str]], references: Union[str, List[str]], device: DeviceLike = None
) -> Tensor:
    """CER = character edit operations / reference characters."""
    errors, total = _cer_update(predictions, references, resolve_device(device))
    return _cer_compute(errors, total)
