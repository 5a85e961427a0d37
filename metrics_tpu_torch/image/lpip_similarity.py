"""LPIPS, learned perceptual image patch similarity (port of ``metrics_tpu/image/lpip_similarity.py``).

The built-in backbones are VGG16 and AlexNet (``models/perceptual.py``) with
the converted linear-head weights; the math on top (per-layer unit
normalisation over channels, the squared difference, the channel weights,
the spatial mean, the sum over layers) runs on the metric's device. The
port's feature maps are NCHW, so the channel axis is 1 where JAX's is -1.
A custom ``net`` returns NCHW maps.
"""
from typing import Any, Callable, List, Optional, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _is_traced

Tensor = torch.Tensor


def _normalize_tensor(feat: Tensor, eps: float = 1e-10) -> Tensor:
    norm = torch.sqrt(torch.sum(feat**2, dim=1, keepdim=True))
    return feat / (norm + eps)


def _lpips_from_features(feats_a: List[Tensor], feats_b: List[Tensor],
                         weights: Optional[List[Tensor]] = None) -> Tensor:
    """Per-sample LPIPS distance from per-layer NCHW feature maps."""
    total = None
    for i, (fa, fb) in enumerate(zip(feats_a, feats_b)):
        diff = (_normalize_tensor(fa) - _normalize_tensor(fb)) ** 2
        if weights is not None:
            diff = diff * torch.as_tensor(weights[i], device=diff.device).reshape(1, -1, 1, 1)
        layer = torch.mean(torch.sum(diff, dim=1), dim=(1, 2))  # channel-weighted, spatial mean
        total = layer if total is None else total + layer
    return total


class LPIPS(Metric):
    """Learned perceptual image patch similarity on the built-in VGG16 or AlexNet.

    Args:
        net: a custom callable ``imgs -> list of (N, C_i, H_i, W_i) maps``;
            overrides the built-in backbones.
        net_type: ``'vgg'`` or ``'alex'`` (``'squeeze'`` needs ``net``).
        reduction: ``'mean'`` or ``'sum'`` over the batch.
        weights: per-layer channel weights; default the converted checkpoint's.
        params: the converted checkpoint (a path or the loaded payload).
        check_value_range: ``'first'`` (default: the first update), ``True``
            (every update) or ``False``: the [-1, 1] check, one host read.
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(
        self,
        net: Optional[Callable[[Tensor], List[Tensor]]] = None,
        net_type: str = "alex",
        reduction: str = "mean",
        weights: Optional[List[Tensor]] = None,
        params: Optional[Any] = None,
        check_value_range: Union[bool, str] = "first",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_net_type = ("vgg", "alex", "squeeze")
        if net is None and net_type not in valid_net_type:
            raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
        self._builtin_net = net is None
        if net is None:
            if net_type == "squeeze":
                raise ModuleNotFoundError(
                    "The built-in LPIPS backbones are 'vgg' and 'alex'; for 'squeeze' pass"
                    " `net=` a callable mapping images (N,H,W,C) to a list of feature maps."
                )
            from metrics_tpu_torch.models.perceptual import LPIPSFeatureNet

            feature_net = LPIPSFeatureNet(net_type=net_type, params=params, device=self.device)
            net = feature_net
            if weights is None:
                weights = feature_net.weights
        self.net = net
        self.weights = weights
        if check_value_range != "first":
            if check_value_range in (True, False):
                check_value_range = bool(check_value_range)
            else:
                raise ValueError(
                    f"Argument `check_value_range` must be True, False or 'first', got {check_value_range}"
                )
        self.check_value_range = check_value_range
        self._range_checked = False
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction

        self.add_state("sum_scores", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _validate_imgs(self, img1: Tensor, img2: Tensor) -> None:
        """4-d batches with a 3-wide channel axis (always), values in [-1, 1]
        (eager only, one host read: on the first update by default, every
        update with ``True``, never with ``False``)."""
        for name, img in (("img1", img1), ("img2", img2)):
            shape = tuple(img.shape)
            if len(shape) != 4 or (shape[1] != 3 and shape[-1] != 3):
                raise ValueError(f"Expected `{name}` to be a 4-d batch with a 3-channel axis, got shape {shape}")
        check = self.check_value_range is True or (self.check_value_range == "first" and not self._range_checked)
        if check and not (_is_traced(img1) or _is_traced(img2)):
            bounds = torch.stack([torch.min(img1), torch.max(img1), torch.min(img2), torch.max(img2)]).tolist()
            lo1, hi1, lo2, hi2 = (float(v) for v in bounds)
            if lo1 < -1.0 or hi1 > 1.0 or lo2 < -1.0 or hi2 > 1.0:
                raise ValueError(
                    "Expected both input arguments to be normalized tensors (all values in"
                    f" range [-1,1]), but `img1` spans [{lo1}, {hi1}] and `img2` spans"
                    f" [{lo2}, {hi2}]"
                )
            # only a passed check retires the first-update probe
            self._range_checked = True

    def reset(self) -> None:
        super().reset()
        self._range_checked = False

    def update(self, img1: Tensor, img2: Tensor) -> None:
        if self._builtin_net:
            self._validate_imgs(img1, img2)
        loss = _lpips_from_features(self.net(img1), self.net(img2), self.weights)
        self.sum_scores = self.sum_scores + torch.sum(loss)
        self.total = self.total + loss.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores
