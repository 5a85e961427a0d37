"""InceptionV3 (FID variant), the feature extractor of FID, KID and IS (port of ``metrics_tpu/models/inception.py``).

The graph is torch-fidelity's FID InceptionV3, as in the JAX package: a
stem of five conv-BN-ReLU layers and two max pools, then InceptionA x3, B,
C x4, D and E x2, with the branch average pools taking
``count_include_pad=False``, the second InceptionE max-pooling, and a
1008-way logits head without bias. The port runs it in PyTorch's NCHW, so
Flax's ``"SAME"`` padding is written out (symmetric ``k // 2`` for the
stride-1 odd kernels, ``"VALID"`` none) and the convolutions go to cuDNN.
It returns the taps ``'64'``, ``'192'``, ``'768'``, ``'2048'`` and
``'logits_unbiased'``, each a spatial mean taken in f32.

Weights: no network, so no pretrained download. :func:`random_inception_params`
fills the JAX package's ``random_inception_params(fast=True)`` tree with the
same numpy draws in the same order, and :func:`inception_state_dict_from_flax`
carries any Flax variables tree across (HWIO kernels to OIHW, BN
``scale``/``bias``/``mean``/``var`` to ``weight``/``bias``/``running_mean``/
``running_var``, the Dense kernel transposed). The module's parameters are
defined in Flax's creation order, which is also the order of
``tools/torch_mirrors.py``'s torch-fidelity mirror.

Precision: the f32 forward runs under :func:`full_f32`, as the JAX package
runs its convolutions in full f32; cuDNN otherwise takes TF32 on an H100.
``compute_dtype=torch.bfloat16`` is the JAX package's bf16 path: the input
and the conv weights are cast to bf16 (the f32 master weights stay), the
taps' means accumulate in f32.

Meshes (``parallel/embedded.py``): ``mesh=`` on the extractor runs the
forward batch-parallel (``shard_batch_forward``: one module a device, the
batch split over the shards, the features gathered). :func:`stem_apply` and
:func:`split_stem_variables` serve the model host's hybrid layout: the five
stem layers as a function of their parameters, whose output channels the
shards split (each shard one slice of each layer, gathered back in channel
order before the next), then :meth:`InceptionV3.trunk` per shard on its
batch block.
"""
import functools
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.utils.device import DeviceLike, resolve_device
from metrics_tpu_torch.utils.exceptions import NotPortedError
from metrics_tpu_torch.utils.precision import full_f32
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor
StateDict = Dict[str, Tensor]

# output width of each feature tap (FID/IS/KID size their streaming buffers by it)
FEATURE_DIMS = {"64": 64, "192": 192, "768": 768, "2048": 2048, "logits_unbiased": 1008}

_BN_EPS = 0.001

# the five stem layers in application order (everything before the '192'
# tap; the rest is the trunk): (in channels, out channels, kernel, stride,
# padding), the padding in NCHW. The module's stem and stem_apply read it.
_STEM = ((3, 32, 3, 2, 0), (32, 32, 3, 1, 0), (32, 64, 3, 1, 1), (64, 80, 1, 1, 0), (80, 192, 3, 1, 0))
STEM_LAYERS = tuple(f"stem.{i}" for i in range(len(_STEM)))


class _BatchNorm(nn.Module):
    """Inference BatchNorm: ``weight``/``bias`` parameters, ``running_mean``/
    ``running_var`` buffers, eps 0.001, no running-count buffer."""

    def __init__(self, features: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: Tensor) -> Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, _BN_EPS)


class BasicConv2d(nn.Module):
    """Conv (no bias) + inference BatchNorm (eps 0.001) + ReLU. ``padding``
    is ``"VALID"``, ``"SAME"`` (stride 1: ``k // 2`` on each side) or ints."""

    def __init__(self, cin: int, cout: int, kernel: Union[int, Tuple[int, int]], stride: int = 1,
                 padding: Union[str, int, Tuple[int, int]] = "VALID", dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        kernel = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        if padding == "VALID":
            padding = (0, 0)
        elif padding == "SAME":
            padding = (kernel[0] // 2, kernel[1] // 2)
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = _BatchNorm(cout)

    def forward(self, x: Tensor) -> Tensor:
        w = self.conv.weight if self.dtype is None else self.conv.weight.to(self.dtype)
        return F.relu(self.bn(F.conv2d(x, w, None, self.stride, self.padding)), inplace=True)


def _avg_pool_same(x: Tensor) -> Tensor:
    # torch-fidelity's branch pools: border windows divide by the count of real pixels
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)  # noqa: E731
        self.convs = nn.ModuleList([
            c(cin, 64, 1), c(cin, 48, 1), c(48, 64, 5, padding="SAME"), c(cin, 64, 1),
            c(64, 96, 3, padding="SAME"), c(96, 96, 3, padding="SAME"), c(cin, pool_features, 1)])

    def forward(self, x: Tensor) -> Tensor:
        k = self.convs
        return torch.cat([k[0](x), k[2](k[1](x)), k[5](k[4](k[3](x))), k[6](_avg_pool_same(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)  # noqa: E731
        self.convs = nn.ModuleList([c(cin, 384, 3, stride=2), c(cin, 64, 1), c(64, 96, 3, padding="SAME"),
                                    c(96, 96, 3, stride=2)])

    def forward(self, x: Tensor) -> Tensor:
        k = self.convs
        return torch.cat([k[0](x), k[3](k[2](k[1](x))), F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)  # noqa: E731
        self.convs = nn.ModuleList([
            c(cin, 192, 1),
            c(cin, c7, 1), c(c7, c7, (1, 7), padding="SAME"), c(c7, 192, (7, 1), padding="SAME"),
            c(cin, c7, 1), c(c7, c7, (7, 1), padding="SAME"), c(c7, c7, (1, 7), padding="SAME"),
            c(c7, c7, (7, 1), padding="SAME"), c(c7, 192, (1, 7), padding="SAME"),
            c(cin, 192, 1)])

    def forward(self, x: Tensor) -> Tensor:
        k = self.convs
        b2 = k[3](k[2](k[1](x)))
        b3 = k[8](k[7](k[6](k[5](k[4](x)))))
        return torch.cat([k[0](x), b2, b3, k[9](_avg_pool_same(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)  # noqa: E731
        self.convs = nn.ModuleList([
            c(cin, 192, 1), c(192, 320, 3, stride=2),
            c(cin, 192, 1), c(192, 192, (1, 7), padding="SAME"), c(192, 192, (7, 1), padding="SAME"),
            c(192, 192, 3, stride=2)])

    def forward(self, x: Tensor) -> Tensor:
        k = self.convs
        return torch.cat([k[1](k[0](x)), k[5](k[4](k[3](k[2](x)))), F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_mode: str = "avg", dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)  # noqa: E731
        self.pool_mode = pool_mode
        self.convs = nn.ModuleList([
            c(cin, 320, 1),
            c(cin, 384, 1), c(384, 384, (1, 3), padding="SAME"), c(384, 384, (3, 1), padding="SAME"),
            c(cin, 448, 1), c(448, 384, 3, padding="SAME"), c(384, 384, (1, 3), padding="SAME"),
            c(384, 384, (3, 1), padding="SAME"),
            c(cin, 192, 1)])

    def forward(self, x: Tensor) -> Tensor:
        k = self.convs
        b2 = k[1](x)
        b2 = torch.cat([k[2](b2), k[3](b2)], 1)
        b3 = k[5](k[4](x))
        b3 = torch.cat([k[6](b3), k[7](b3)], 1)
        # the max pool's SAME padding is -inf: F.max_pool2d pads so
        pooled = F.max_pool2d(x, 3, stride=1, padding=1) if self.pool_mode == "max" else _avg_pool_same(x)
        return torch.cat([k[0](x), b2, b3, k[8](pooled)], 1)


def _preprocess(x: Tensor, preprocess_folded: bool, dt: Optional[torch.dtype]) -> Tensor:
    """uint8 images, or floats in [0, 1] quantised by ``floor(x * 255)``,
    then ``(x - 128) / 128`` unless folded into the first conv."""
    if x.dtype == torch.uint8:
        x = x.to(torch.float32)
    else:
        x = torch.floor(x.to(torch.float32) * 255.0)
    if not preprocess_folded:
        x = (x - 128.0) / 128.0
    return x if dt is None else x.to(dt)


def _tap_mean(v: Tensor) -> Tensor:
    # the taps feed f32 and float-float statistics: the spatial mean is taken in f32
    return torch.mean(v.to(torch.float32), dim=(2, 3))


class InceptionV3(nn.Module):
    """FID-variant InceptionV3 on ``(N, 3, H, W)`` images: uint8, or floats in
    [0, 1] quantised by ``floor(x * 255)``, then ``(x - 128) / 128`` unless
    ``preprocess_folded``. Returns the dict of taps.

    ``compute_dtype=torch.bfloat16`` runs every layer in bf16 (the weights
    cast per call, the f32 master kept). ``preprocess_folded`` consumes
    params from :func:`fold_preprocess_into_params`; ``stem_lanes`` those
    from :func:`pad_stem_params` (the stem widened with zero channels; the
    ``'64'`` tap slices back to 64).
    """

    def __init__(self, num_classes: int = 1008, compute_dtype: Optional[torch.dtype] = None,
                 preprocess_folded: bool = False, stem_lanes: Optional[int] = None) -> None:
        super().__init__()
        dt = compute_dtype
        self.compute_dtype, self.preprocess_folded, self.stem_lanes = dt, bool(preprocess_folded), stem_lanes

        def st(features: int) -> int:
            return features if stem_lanes is None or features >= stem_lanes else stem_lanes

        self.stem = nn.ModuleList([BasicConv2d(cin if i == 0 else st(cin), st(cout), k, stride=stride, padding=pad,
                                               dtype=dt) for i, (cin, cout, k, stride, pad) in enumerate(_STEM)])
        self.mixed = nn.ModuleList([
            InceptionA(192, 32, dt), InceptionA(256, 64, dt), InceptionA(288, 64, dt), InceptionB(288, dt),
            InceptionC(768, 128, dt), InceptionC(768, 160, dt), InceptionC(768, 160, dt), InceptionC(768, 192, dt),
            InceptionD(768, dt), InceptionE(1280, "avg", dt), InceptionE(2048, "max", dt)])
        self.fc = nn.Linear(2048, num_classes, bias=False)

    def forward(self, x: Tensor) -> Dict[str, Tensor]:
        stem_vars = {f"stem.{k}": v for k, v in itertools.chain(self.stem.named_parameters(),
                                                                 self.stem.named_buffers())}
        x, out = stem_apply(stem_vars, x, compute_dtype=self.compute_dtype, preprocess_folded=self.preprocess_folded,
                            stem_lanes=self.stem_lanes)
        out.update(self.trunk(x))
        return out

    def trunk(self, x: Tensor) -> Dict[str, Tensor]:
        """Everything after the ``'192'`` tap, on the post-stem activation
        (JAX's ``InceptionV3(stem_input=True)``): the ``'768'``, ``'2048'``
        and ``'logits_unbiased'`` taps."""
        dt = self.compute_dtype
        out: Dict[str, Tensor] = {}
        for block in self.mixed[:4]:
            x = block(x)
        out["768"] = _tap_mean(x)
        for block in self.mixed[4:]:
            x = block(x)
        pooled = _tap_mean(x)
        out["2048"] = pooled
        w = self.fc.weight if dt is None else self.fc.weight.to(dt)
        out["logits_unbiased"] = F.linear(pooled if dt is None else pooled.to(dt), w).to(pooled.dtype)
        return out


# ------------------------------------------------------------------------- weights

# the Flax modules each port layer stands for, in Flax's creation order
_BLOCK_NAMES = ("InceptionA_0", "InceptionA_1", "InceptionA_2", "InceptionB_0", "InceptionC_0", "InceptionC_1",
                "InceptionC_2", "InceptionC_3", "InceptionD_0", "InceptionE_0", "InceptionE_1")
_BN_LEAVES = (("weight", "params", "scale"), ("bias", "params", "bias"),
              ("running_mean", "batch_stats", "mean"), ("running_var", "batch_stats", "var"))


def _flax_map() -> List[Tuple[str, Tuple[str, ...], str]]:
    """``(port key, Flax path, kind)`` of every leaf, ``kind`` being
    ``"conv"`` (HWIO <-> OIHW), ``"dense"`` (transposed) or ``"vec"``."""
    out = []

    def conv(prefix: str, path: Tuple[str, ...]) -> None:
        out.append((f"{prefix}.conv.weight", ("params",) + path + ("Conv_0", "kernel"), "conv"))
        for leaf, coll, name in _BN_LEAVES:
            out.append((f"{prefix}.bn.{leaf}", (coll,) + path + ("BatchNorm_0", name), "vec"))

    for i in range(5):
        conv(f"stem.{i}", (f"BasicConv2d_{i}",))
    for b, (name, n) in enumerate(zip(_BLOCK_NAMES, (7, 7, 7, 4, 10, 10, 10, 10, 6, 9, 9))):
        for i in range(n):
            conv(f"mixed.{b}.convs.{i}", (name, f"BasicConv2d_{i}"))
    out.append(("fc.weight", ("params", "Dense_0", "kernel"), "dense"))
    return out


def _to_port(value: Any, kind: str) -> Tensor:
    a = np.asarray(value, dtype=np.float32)
    if kind == "conv":
        a = a.transpose(3, 2, 0, 1)
    elif kind == "dense":
        a = a.T
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def inception_state_dict_from_flax(variables: Any) -> StateDict:
    """The port's state dict from the JAX package's Flax variables
    (``{"params": ..., "batch_stats": ...}``, numpy or JAX leaves; a padded
    stem carries across padded)."""
    out: StateDict = {}
    for key, path, kind in _flax_map():
        node = variables
        for p in path:
            node = node[p]
        out[key] = _to_port(node, kind)
    return out


def random_inception_params(input_size: int = 299, seed: int = 0, fast: bool = True) -> StateDict:
    """The JAX package's ``random_inception_params(fast=True)``, as the port's
    state dict: its leaves drawn from ``np.random.RandomState(seed)`` in the
    order JAX flattens the Flax tree (sorted keys), BN ``var`` uniform in
    [0.5, 1.5], ``scale`` 1 + 0.1 N(0, 1), kernels fan-in scaled
    ``sqrt(2 / fan_in)`` N(0, 1), the rest 0.1 N(0, 1). The weights do not
    depend on ``input_size`` (kept for the JAX signature). ``fast=False``,
    Flax's own initialisers, has no counterpart here."""
    if not fast:
        raise NotPortedError("random_inception_params(fast=False) draws Flax's initialisers; the port has the "
                             "seeded fill (fast=True) only")
    shapes = {key: tuple(v.shape) for key, v in InceptionV3().state_dict().items()}
    leaves = []
    for key, path, kind in _flax_map():
        shape = shapes[key]
        flax_shape = (shape[2], shape[3], shape[1], shape[0]) if kind == "conv" else shape[::-1]
        leaves.append((path, key, kind, flax_shape))
    rng = np.random.RandomState(seed)
    drawn: Dict[str, Any] = {}
    for path, key, kind, shape in sorted(leaves, key=lambda e: e[0]):
        name = "".join(f"['{p}']" for p in path)
        if "var" in name:
            a = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif "scale" in name:
            a = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif len(shape) >= 2:
            std = (2.0 / float(np.prod(shape[:-1]))) ** 0.5
            a = (std * rng.standard_normal(shape)).astype(np.float32)
        else:
            a = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        drawn[key] = _to_port(a, kind)
    return {key: drawn[key] for key in shapes}


def fold_preprocess_into_params(state: StateDict) -> StateDict:
    """Absorb the ``(x - 128) / 128`` input affine into the first conv: its
    kernel over 128 and ``mean + sum(W)`` per output channel into the BN
    mean (exact: the first conv is VALID). Consume with
    ``InceptionV3(preprocess_folded=True)``. Pure."""
    out = dict(state)
    k = state["stem.0.conv.weight"]
    out["stem.0.conv.weight"] = k / 128.0
    out["stem.0.bn.running_mean"] = state["stem.0.bn.running_mean"] + torch.sum(k, dim=(1, 2, 3))
    return out


# (layer, pad its input channels, pad its output channels) of the stem
_STEM_PAD = ((0, False, True), (1, True, True), (2, True, True), (3, True, True), (4, True, False))


def pad_stem_params(state: StateDict, lanes: int = 128) -> StateDict:
    """Zero-pad the stem's convs to ``lanes`` output (and next-layer input)
    channels: the padded channels stay exactly 0 (BN ``weight`` 0, ``bias``
    0, ``mean`` 0, ``var`` 1, then ReLU). Consume with
    ``InceptionV3(stem_lanes=lanes)``. Pure."""
    out = dict(state)
    for layer, pad_in, pad_out in _STEM_PAD:
        p = f"stem.{layer}"
        kernel = out[f"{p}.conv.weight"]
        cout, cin = kernel.shape[:2]
        pin = (lanes - cin) if (pad_in and cin < lanes) else 0
        pout = (lanes - cout) if (pad_out and cout < lanes) else 0
        if pin or pout:
            out[f"{p}.conv.weight"] = F.pad(kernel, (0, 0, 0, 0, 0, pin, 0, pout))
        if pout:
            for leaf, value in (("weight", 0.0), ("bias", 0.0), ("running_mean", 0.0), ("running_var", 1.0)):
                out[f"{p}.bn.{leaf}"] = F.pad(out[f"{p}.bn.{leaf}"], (0, pout), value=value)
    return out


def split_stem_variables(variables: Any) -> Tuple[StateDict, StateDict]:
    """Split a state dict (or the JAX package's Flax variables) into
    ``(stem_vars, trunk_vars)``: the five stem layers' entries, consumed by
    :func:`stem_apply`, and everything else, consumed by
    :meth:`InceptionV3.trunk`. Pure; tensors are shared, not copied."""
    state = _as_state_dict(variables)
    stem = {k: v for k, v in state.items() if k.split(".conv.")[0].split(".bn.")[0] in STEM_LAYERS}
    return stem, {k: v for k, v in state.items() if k not in stem}


def _conv_bn_relu(x: Tensor, sv: StateDict, i: int, dt: Optional[torch.dtype]) -> Tensor:
    """Stem layer ``i`` as :class:`BasicConv2d` computes it, from ``sv``:
    conv, inference BatchNorm, ReLU."""
    p = STEM_LAYERS[i]
    w = sv[f"{p}.conv.weight"]
    y = F.conv2d(x, w if dt is None else w.to(dt), None, _STEM[i][3], _STEM[i][4])
    y = F.batch_norm(y, sv[f"{p}.bn.running_mean"], sv[f"{p}.bn.running_var"], sv[f"{p}.bn.weight"],
                     sv[f"{p}.bn.bias"], False, 0.0, _BN_EPS)
    return F.relu(y, inplace=True)


def _run_piece(tag: str, fn: Callable[..., Any], *xs: Tensor) -> Any:
    return fn(*xs)


def stem_apply(stem_variables: Any, x: Any, *, compute_dtype: Optional[torch.dtype] = None,
               preprocess_folded: bool = False, stem_lanes: Optional[int] = None,
               gather_axis: Optional[Any] = None, segment: Callable[..., Any] = _run_piece) -> Tuple[Any, Any]:
    """The stem as a function: preprocessing, the five stem layers, the two
    max pools and the ``'64'``/``'192'`` taps. Returns ``(post_stem, taps)``;
    ``post_stem`` feeds :meth:`InceptionV3.trunk`. :meth:`InceptionV3.forward`
    runs its stem through it.

    ``gather_axis`` (a mesh axis, ``Mesh.axis(...)``): the tensor-parallel
    stem of the model host. ``stem_variables`` is then the list of the W
    shards' output-channel slices (conv weights split on dim 0, BN vectors
    on their channel) and ``x`` the list of the W shards' copies of the
    images; each shard computes its slice of each layer and one tiled
    ``all_gather`` restores the full channels, in order, before the next.
    Both come back as lists, one entry a shard. Each shard's slice of a layer
    runs as ``segment(tag, fn, x)`` (default ``fn(x)``): the model host
    across cards captures it there, one graph a layer and shard."""
    if gather_axis is None:
        sv = _as_state_dict(stem_variables)
        x = _preprocess(x, preprocess_folded, compute_dtype)
        taps: Dict[str, Tensor] = {}
        for i in range(len(STEM_LAYERS)):
            x = _conv_bn_relu(x, sv, i, compute_dtype)
            if i == 2:
                x = F.max_pool2d(x, 3, stride=2)
                taps["64"] = _tap_mean(x[:, :64] if stem_lanes is not None else x)
            elif i == 4:
                x = F.max_pool2d(x, 3, stride=2)
                taps["192"] = _tap_mean(x)
        return x, taps
    from metrics_tpu_torch.parallel.collectives import mesh_all_gather_tiled
    from metrics_tpu_torch.parallel.embedded import _on

    devices = gather_axis.devices
    memo: Dict[int, Any] = {}

    def per_copy(xs: List[Tensor], fn: Callable[[Tensor], Any]) -> List[Any]:
        """``fn`` once a distinct tensor (the shards of one device share it)."""
        memo.clear()
        for t in xs:
            if id(t) not in memo:
                with _on(t.device):
                    memo[id(t)] = fn(t)
        return [memo[id(t)] for t in xs]

    xs = per_copy(list(x), lambda t: _preprocess(t, preprocess_folded, compute_dtype))
    taps_of: List[Dict[str, Tensor]] = [{} for _ in xs]
    for i in range(len(STEM_LAYERS)):
        parts = []
        for k, dev in enumerate(devices):
            with _on(dev):
                parts.append(segment(STEM_LAYERS[i], functools.partial(_conv_bn_relu, sv=stem_variables[k], i=i,
                                                                       dt=compute_dtype), xs[k]))
        xs = mesh_all_gather_tiled(parts, gather_axis, dim=1)
        if i in (2, 4):
            xs = per_copy(xs, lambda t: F.max_pool2d(t, 3, stride=2))
            name = "64" if i == 2 else "192"
            means = per_copy(xs, lambda t: _tap_mean(t[:, :64] if name == "64" and stem_lanes is not None else t))
            for k, m in enumerate(means):
                taps_of[k][name] = m
    return xs, taps_of


def _as_state_dict(params: Any) -> StateDict:
    """A port state dict from ``params``: a state dict, or Flax variables."""
    if isinstance(params, dict) and "params" in params:
        return inception_state_dict_from_flax(params)
    return {k: torch.as_tensor(v) for k, v in params.items()}


# ------------------------------------------------------------------------ extractor

def resolve_feature_extractor(
    metric_name: str,
    feature: Any,
    params: Optional[Any],
    mesh: Optional[Any],
    mesh_axis: Any,
    valid: Tuple[str, ...],
    model_host: Optional[Any] = None,
    device: DeviceLike = None,
) -> Tuple[Callable, Optional[int]]:
    """FID's, IS's and KID's shared constructor logic: a callable passes
    through; a tap name builds the built-in extractor on ``device``, or,
    with ``model_host``, resolves the resident host that serves it
    (``True``: the registry's host for this identity; a
    ``ModelHostConfig``: one built to it; a ``ModelHost``: that one).
    Returns ``(extractor, feature_dim)``, ``feature_dim`` None for a
    callable. ``mesh=`` builds the batch-sharded extractor, or with
    ``model_host`` the host's hybrid stem-tensor layout; a callable with
    ``mesh=`` raises JAX's ``ValueError`` (shard it yourself with
    ``parallel.shard_batch_forward``)."""
    if model_host is not None and model_host is not False:
        if callable(feature) and not isinstance(feature, (str, int)):
            raise ValueError(
                f"{metric_name}(model_host=...) only applies to the built-in "
                f"InceptionV3 (feature in {valid}); wrap your callable with "
                "engine.model_host.ModelHost yourself."
            )
        from metrics_tpu_torch.engine.model_host import ModelHost, ModelHostConfig, inception_host

        if isinstance(model_host, ModelHost):
            host = model_host
        else:
            config = model_host if isinstance(model_host, ModelHostConfig) else ModelHostConfig(
                mesh=mesh, mesh_axis=mesh_axis)
            host = inception_host(str(feature), params, config=config, device=device)

        def extractor(imgs: Any) -> Tensor:
            return host.infer(imgs)

        extractor.model_host = host
        return extractor, FEATURE_DIMS[str(feature)]
    if callable(feature):
        if mesh is not None:
            raise ValueError(
                f"{metric_name}(mesh=...) only applies to the built-in InceptionV3 (feature in {valid}). For a "
                "callable `feature`, shard it yourself with metrics_tpu_torch.parallel.shard_batch_forward(fn, mesh) "
                "and pass the wrapped callable."
            )
        return feature, None
    if str(feature) not in valid:
        raise ValueError(f"Input to argument `feature` must be one of {valid}, but got {feature}.")
    extractor = InceptionFeatureExtractor(feature=str(feature), params=params, mesh=mesh, mesh_axis=mesh_axis,
                                          device=device)
    return extractor, FEATURE_DIMS[str(feature)]


def _nchw(imgs: Any, device: torch.device) -> Tensor:
    """Images as an NCHW tensor on ``device``: NHWC input (a last axis of 3
    and a second that is not) is transposed, as JAX's extractor transposes
    NCHW to its NHWC."""
    if isinstance(imgs, np.ndarray):
        imgs = torch.from_numpy(np.ascontiguousarray(imgs))
    imgs = imgs.to(device)
    if imgs.ndim == 4 and imgs.shape[-1] == 3 and imgs.shape[1] != 3:
        imgs = imgs.permute(0, 3, 1, 2)
    return imgs.contiguous()


class InceptionFeatureExtractor:
    """The InceptionV3 forward returning one tap, on ``device`` (default ``cuda``).

    ``params``: the port's state dict or the JAX package's Flax variables
    (carried across by :func:`inception_state_dict_from_flax`); without
    them the seeded fill of :func:`random_inception_params` (warned once:
    meaningless for real FID values). ``compute_dtype=torch.bfloat16`` is
    the bf16 path; ``fold_preprocess`` and ``stem_lanes`` transform the
    params as the JAX extractor does (features equal to f32 rounding).
    Rebinding ``params`` reloads the model. The f32 forward runs under
    :func:`full_f32`.

    ``mesh=`` runs the forward batch-parallel over the mesh's ``mesh_axis``
    (``parallel.embedded.shard_batch_forward``): one module a device of the
    mesh, the batch split over the shards, the features gathered onto the
    first shard's device (JAX's ``out_axis=None``), which is then the
    extractor's device.
    """

    def __init__(
        self,
        feature: str = "2048",
        params: Optional[Any] = None,
        input_size: int = 299,
        seed: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
        mesh: Optional[Any] = None,
        mesh_axis: Any = "dp",
        fold_preprocess: bool = False,
        stem_lanes: Optional[int] = None,
        device: DeviceLike = None,
    ) -> None:
        self.feature = str(feature)
        self.compute_dtype = compute_dtype
        self.fold_preprocess = bool(fold_preprocess)
        self.stem_lanes = stem_lanes
        self._sharded: Optional[Callable] = None
        self.device = mesh.axis(mesh_axis).devices[0] if mesh is not None else resolve_device(device)
        if params is None:
            rank_zero_warn(
                "No pretrained InceptionV3 params provided (no network egress in this build); using the seeded"
                " random fill. Pass `params=` (converted torch-fidelity weights) for meaningful FID/IS/KID values.",
                UserWarning,
            )
            params = random_inception_params(input_size=input_size, seed=seed)
        module = InceptionV3(compute_dtype=compute_dtype, preprocess_folded=self.fold_preprocess,
                             stem_lanes=stem_lanes).eval().requires_grad_(False)
        if mesh is not None:
            from metrics_tpu_torch.parallel.embedded import shard_batch_forward

            self._sharded = shard_batch_forward(self._tap, mesh, mesh_axis, out_axis=None, replicated_argnums=(0,))
            self._placed = self._sharded.place(module)  # one module a device: shards on one device share it
            self._replicas = list({id(m): m for m in self._placed}.values())
        else:
            self._replicas = [module.to(self.device)]
        self.module = self._replicas[0]
        self.params = params

    @property
    def params(self) -> StateDict:
        return self._params

    @params.setter
    def params(self, params: Any) -> None:
        self._params = _as_state_dict(params)
        state = self._params
        if self.fold_preprocess:
            state = fold_preprocess_into_params(state)
        if self.stem_lanes is not None:
            state = pad_stem_params(state, self.stem_lanes)
        for module in self._replicas:
            module.load_state_dict(state)

    @staticmethod
    def load_params(path: str) -> Any:
        import pickle

        with open(path, "rb") as f:
            return pickle.load(f)

    def _tap(self, module: nn.Module, imgs: Tensor) -> Tensor:
        return module(imgs)[self.feature].to(torch.float32)

    def forward_nchw(self, imgs: Tensor) -> Tensor:
        """The tap of NCHW ``imgs`` already on the device, as f32 (on a mesh,
        each shard's block on its device, gathered)."""
        run = (lambda x: self._sharded(self._placed, x)) if self._sharded is not None \
            else (lambda x: self._tap(self.module, x))
        with torch.no_grad():
            if self.compute_dtype is None:
                with full_f32():
                    return run(imgs)
            return run(imgs)

    def __call__(self, imgs: Any) -> Tensor:
        return self.forward_nchw(_nchw(imgs, self.device))
