"""Word error rate (port of ``metrics_tpu/functional/text/wer.py``).

Words are split on the host and scored by the native batch edit distance;
the counts become float32 tensors on the caller's device.
"""
from typing import List, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _edit_distance_batch, _f32
from metrics_tpu_torch.utils.device import DeviceLike, resolve_device
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _wer_update(
    predictions: Union[str, List[str]], references: Union[str, List[str]], device: torch.device
) -> Tuple[Tensor, Tensor]:
    if isinstance(predictions, str):
        predictions = [predictions]
    if isinstance(references, str):
        references = [references]
    pred_tokens = [p.split() for p in predictions]
    ref_tokens = [r.split() for r in references]
    errors = _edit_distance_batch(pred_tokens, ref_tokens).sum()
    total = sum(len(r) for r in ref_tokens)
    return _f32(float(errors), device), _f32(float(total), device)


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def word_error_rate(
    predictions: Union[str, List[str]], references: Union[str, List[str]], device: DeviceLike = None
) -> Tensor:
    """WER = edit operations / reference words, on ``device`` (default ``cuda``).

    Example:
        >>> from metrics_tpu_torch.functional import word_error_rate
        >>> score = word_error_rate(['hello there world'], ['hello there word'], device="cpu")
        >>> print(f"{float(score):.4f}")
        0.3333
    """
    errors, total = _wer_update(predictions, references, resolve_device(device))
    return _wer_compute(errors, total)


def wer(
    predictions: Union[str, List[str]], references: Union[str, List[str]], device: DeviceLike = None
) -> Tensor:
    """Deprecated alias of word_error_rate."""
    rank_zero_warn("`wer` was renamed to `word_error_rate` and it will be removed.", DeprecationWarning)
    return word_error_rate(predictions, references, device=device)
