"""LPIPS's perceptual backbones, VGG16 and AlexNet (port of ``metrics_tpu/models/perceptual.py``).

The ``lpips`` package's feature stacks, as the JAX package builds them: the
scaling layer (``(x - shift) / scale`` per RGB channel on images in
[-1, 1]), then torchvision's VGG16 or AlexNet convolutions cut at their five
ReLU taps. The port runs them in NCHW on cuDNN, under :func:`full_f32`
(cuDNN otherwise takes TF32 on an H100). AlexNet's first convolution is
11 x 11 at stride 4 with padding 2, its pools 3 x 3 at stride 2; VGG's pools
2 x 2 between blocks.

Weights: the JAX package's converted payload (``tools/convert_weights.py
lpips``: ``{"net_type", "variables", "weights"}``) carries across through
:func:`lpips_state_dict_from_flax` (Flax ``Conv_i`` HWIO kernels to OIHW,
biases as they are) and the five ``(C,)`` linear-head weights ride along.
Without weights the backbone is initialised by PyTorch's defaults from
``seed`` (JAX's draws Flax's initialisers; the two differ).
"""
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.utils.device import DeviceLike, resolve_device
from metrics_tpu_torch.utils.precision import full_f32
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

# the lpips ScalingLayer constants: images in [-1, 1] are shifted and scaled per channel (RGB)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def _scale_input(x: Tensor) -> Tensor:
    shift = torch.tensor(_LPIPS_SHIFT, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_LPIPS_SCALE, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    return (x - shift) / scale


class VGG16Features(nn.Module):
    """VGG16's feature stack: taps relu1_2 (64 channels), relu2_2 (128),
    relu3_3 (256), relu4_3 (512) and relu5_3 (512)."""

    BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
    CHANNELS = (64, 128, 256, 512, 512)

    def __init__(self) -> None:
        super().__init__()
        convs, cin = [], 3
        for n_convs, ch in self.BLOCKS:
            for _ in range(n_convs):
                convs.append(nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
        self.convs = nn.ModuleList(convs)

    def forward(self, x: Tensor) -> List[Tensor]:
        x = _scale_input(x)
        taps: List[Tensor] = []
        i = 0
        for n_convs, _ in self.BLOCKS:
            if taps:  # a pool between blocks, none before the first
                x = F.max_pool2d(x, 2, stride=2)
            for _ in range(n_convs):
                x = F.relu(self.convs[i](x))
                i += 1
            taps.append(x)
        return taps


class AlexNetFeatures(nn.Module):
    """AlexNet's feature stack: taps relu1 to relu5."""

    CHANNELS = (64, 192, 384, 256, 256)

    def __init__(self) -> None:
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.Conv2d(64, 192, 5, padding=2),
            nn.Conv2d(192, 384, 3, padding=1), nn.Conv2d(384, 256, 3, padding=1), nn.Conv2d(256, 256, 3, padding=1)])

    def forward(self, x: Tensor) -> List[Tensor]:
        c = self.convs
        t1 = F.relu(c[0](_scale_input(x)))
        t2 = F.relu(c[1](F.max_pool2d(t1, 3, stride=2)))
        t3 = F.relu(c[2](F.max_pool2d(t2, 3, stride=2)))
        t4 = F.relu(c[3](t3))
        t5 = F.relu(c[4](t4))
        return [t1, t2, t3, t4, t5]


_BACKBONES: Dict[str, Any] = {"vgg": VGG16Features, "alex": AlexNetFeatures}


def lpips_state_dict_from_flax(payload: Any) -> Dict[str, Tensor]:
    """The backbone's state dict from the JAX package's converted LPIPS
    payload (or its bare ``variables``): Flax's ``Conv_i`` kernels, HWIO,
    become ``convs.i.weight``, OIHW, and ``Conv_i`` biases ``convs.i.bias``."""
    variables = payload["variables"] if "variables" in payload else payload
    params = variables["params"]
    out: Dict[str, Tensor] = {}
    for i in range(len(params)):
        conv = params[f"Conv_{i}"]
        out[f"convs.{i}.weight"] = torch.from_numpy(np.array(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1),
                                                             dtype=np.float32, order="C"))
        out[f"convs.{i}.bias"] = torch.from_numpy(np.array(conv["bias"], dtype=np.float32))
    return out


class LPIPSFeatureNet:
    """The LPIPS backbone on ``device`` (default ``cuda``): ``imgs`` NCHW (or
    NHWC, transposed) to the list of five NCHW taps. Carries the converted
    linear-head weights as ``.weights`` (five ``(C,)`` tensors, or None).

    ``params``: a path to, or the loaded, converted payload; Flax variables;
    or the port's state dict.
    """

    def __init__(self, net_type: str = "alex", params: Optional[Any] = None, seed: int = 0,
                 device: DeviceLike = None) -> None:
        if net_type not in _BACKBONES:
            raise ValueError(f"Argument `net_type` must be one of {tuple(_BACKBONES)}, but got {net_type}.")
        self.net_type = net_type
        self.device = resolve_device(device)
        self.weights: Optional[List[Tensor]] = None
        if isinstance(params, (str, bytes)):
            params = self.load_params(params)
        state = None
        if isinstance(params, dict) and "variables" in params:
            if params.get("net_type") not in (None, net_type):
                raise ValueError(
                    f"Converted LPIPS checkpoint is for net_type={params.get('net_type')!r},"
                    f" but this net is {net_type!r}."
                )
            self.weights = [torch.as_tensor(np.asarray(w), dtype=torch.float32).to(self.device)
                            for w in params.get("weights", [])] or None
            state = lpips_state_dict_from_flax(params)
        elif isinstance(params, dict) and "params" in params:
            state = lpips_state_dict_from_flax(params)
        elif params is not None:
            state = {k: torch.as_tensor(v) for k, v in params.items()}
        if state is None:
            rank_zero_warn(
                "No pretrained LPIPS params provided (no network egress in this build); using a seeded random"
                " initialisation. Convert the `lpips` package weights with `python tools/convert_weights.py lpips"
                " ...` for meaningful values.",
                UserWarning,
            )
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                self.module = _BACKBONES[net_type]()
        else:
            self.module = _BACKBONES[net_type]()
            self.module.load_state_dict(state)
        # inference weights: a gradient reaches the images (LPIPS as a loss), never the backbone
        self.module = self.module.to(self.device).eval().requires_grad_(False)

    @staticmethod
    def load_params(path: Any) -> Any:
        with open(path, "rb") as f:
            return pickle.load(f)

    def __call__(self, imgs: Any) -> List[Tensor]:
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(np.ascontiguousarray(imgs))
        imgs = imgs.to(self.device)
        if imgs.ndim == 4 and imgs.shape[-1] == 3 and imgs.shape[1] != 3:
            imgs = imgs.permute(0, 3, 1, 2).contiguous()
        with full_f32():
            return self.module(imgs.to(torch.float32))
