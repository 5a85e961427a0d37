"""Matthews correlation coefficient (port of
``metrics_tpu/functional/classification/matthews_corrcoef.py``)."""
import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: Tensor) -> Tensor:
    tk = torch.sum(confmat, dim=1).to(torch.float32)
    pk = torch.sum(confmat, dim=0).to(torch.float32)
    c = torch.sum(torch.diagonal(confmat, dim1=-2, dim2=-1)).to(torch.float32)  # the trace, batched under vmap
    s = torch.sum(confmat).to(torch.float32)
    return (c * s - torch.sum(tk * pk)) / (torch.sqrt(s**2 - torch.sum(pk * pk)) * torch.sqrt(s**2 - torch.sum(tk * tk)))


def matthews_corrcoef(preds: Tensor, target: Tensor, num_classes: int, threshold: float = 0.5,
                      device: DeviceLike = None) -> Tensor:
    """The Matthews correlation coefficient."""
    dev = tensor_device(preds, target, device=device)
    confmat = _matthews_corrcoef_update(as_input(preds, dev), as_input(target, dev), num_classes, threshold)
    return _matthews_corrcoef_compute(confmat)
