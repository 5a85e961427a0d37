"""The port's embedded-model image metrics against the JAX package, on the CPU.

Covered: float-float arithmetic against numpy float64; the PSD square roots
against JAX's; InceptionV3 at 75 x 75 fed one seeded torch state dict three
ways (the port, ``tools/torch_mirrors.py``'s torch-fidelity mirror, and JAX's
module through ``tools/convert_weights.py``), every tap compared; the Flax
-> port bridges both ways and the seeded fill equal to JAX's;
``fold_preprocess`` and ``stem_lanes``; the bf16 path within JAX's bound;
LPIPS's VGG16 and AlexNet the same three ways at 64 x 64; FID (streaming and
list), KID, IS (both modes, the split draws bit-equal) and LPIPS against
JAX over uneven updates; the threefry draws against ``jax.random``; FID's
and KID's states over the three gloo ranks of
``tests/helpers/torch_sync_worker.py`` against JAX over the union; FID's
state through the state bridge both ways; the refusals and the exports.

Tolerances: taps of the f32 Inception within 1e-4 of the largest tap value
(94 f32 convolutions, summed in another order; as JAX's own graph-parity
test holds them); FID, KID and IS values within 1e-5 relative (1e-4 where
the input is the Inception's features); LPIPS within 1e-5.
"""
import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.ops import floatfloat as jff
from metrics_tpu_torch.ops import floatfloat as ff
from metrics_tpu_torch.utils.exceptions import NotPortedError
from metrics_tpu_torch.utils.state_bridge import state_from_numpy, state_to_numpy
from tests.helpers import torch_sync_worker as w

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from convert_weights import convert_conv_bn_model, convert_lpips  # noqa: E402
from torch_mirrors import (  # noqa: E402
    TorchAlexLpips,
    TorchFidInception,
    TorchVggLpips,
    load_state_positional,
    save_lpips_style_state,
)

j_inc = importlib.import_module("metrics_tpu.models.inception")
p_inc = importlib.import_module("metrics_tpu_torch.models.inception")
j_per = importlib.import_module("metrics_tpu.models.perceptual")
p_per = importlib.import_module("metrics_tpu_torch.models.perceptual")

CPU = torch.device("cpu")
SIZE = 75  # the Inception's smallest input
TAPS = ("64", "192", "768", "2048", "logits_unbiased")
RTOL = 1e-5


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(to_np(v) for v in x)
    return np.asarray(x)


def close(got, want, what="", rtol=RTOL, atol=0.0):
    g, w_ = np.asarray(to_np(got), np.float64), np.asarray(to_np(want), np.float64)
    assert g.shape == w_.shape, f"{what}: shape {g.shape} != {w_.shape}"
    np.testing.assert_allclose(g, w_, rtol=rtol, atol=atol, err_msg=what)


def pair_f64(p):
    return np.asarray(to_np(p[0]), np.float64) + np.asarray(to_np(p[1]), np.float64)


def uint8_images(seed, n, size=SIZE):
    return np.random.RandomState(seed).randint(0, 256, (n, 3, size, size)).astype(np.uint8)


# ------------------------------------------------------------------ float-float


def test_two_sum_and_two_prod_are_exact():
    a, b = torch.tensor(1e8, dtype=torch.float32), torch.tensor(1.2345, dtype=torch.float32)
    s, e = ff.two_sum(a, b)
    assert np.float64(s) + np.float64(e) == np.float64(np.float32(1e8)) + np.float64(np.float32(1.2345))
    assert float(e) != 0.0  # the error term survived
    rng = np.random.RandomState(0)
    x, y = rng.randn(1000).astype(np.float32), rng.randn(1000).astype(np.float32)
    p, e = ff.two_prod(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(pair_f64((p, e)), x.astype(np.float64) * y.astype(np.float64))


def test_compensated_accumulation_matches_float64():
    """100 000 values over 12 decades, pre-summed into 200 f32 batch sums:
    the pair accumulator stays at float64 rounding, and equals JAX's pair."""
    rng = np.random.RandomState(1)
    xs = (rng.randn(200, 500) * np.logspace(-6, 6, 500)).astype(np.float32)
    sums = xs.sum(axis=1, dtype=np.float32)
    pair = (torch.zeros(()), torch.zeros(()))
    jpair = (jnp.float32(0), jnp.float32(0))
    for v in sums:
        pair = ff.ff_add_f32(pair, torch.tensor(v))
        jpair = jff.ff_add_f32(jpair, jnp.float32(v))
    exact = np.sum(sums.astype(np.float64))
    assert abs(pair_f64(pair) - exact) / abs(np.sum(xs.astype(np.float64))) < 1e-12
    assert pair_f64(pair) == pair_f64(jpair)


@pytest.mark.parametrize("op,np_op", [("ff_add", np.add), ("ff_sub", np.subtract), ("ff_mul", np.multiply)])
def test_pair_ops_match_float64(op, np_op):
    rng = np.random.RandomState(2)
    x64, y64 = rng.randn(1000) * 1e4, rng.randn(1000)
    x = (torch.from_numpy(x64.astype(np.float32)), torch.from_numpy((x64 - np.float32(x64)).astype(np.float32)))
    y = (torch.from_numpy(y64.astype(np.float32)), torch.from_numpy((y64 - np.float32(y64)).astype(np.float32)))
    got = getattr(ff, op)(x, y)
    np.testing.assert_allclose(pair_f64(got), np_op(pair_f64(x), pair_f64(y)), rtol=1e-13, atol=1e-10)
    jx, jy = tuple(jnp.asarray(to_np(v)) for v in x), tuple(jnp.asarray(to_np(v)) for v in y)
    np.testing.assert_array_equal(pair_f64(got), pair_f64(getattr(jff, op)(jx, jy)))


def test_scale_neg_and_conversions():
    rng = np.random.RandomState(3)
    x64 = rng.randn(500) * 1e3
    x = (torch.from_numpy(x64.astype(np.float32)), torch.from_numpy((x64 - np.float32(x64)).astype(np.float32)))
    c = np.float32(0.37)
    np.testing.assert_allclose(pair_f64(ff.ff_scale(x, torch.tensor(c))), pair_f64(x) * np.float64(c),
                               rtol=1e-13)
    np.testing.assert_allclose(pair_f64(ff.ff_scale(x, 0.37)), pair_f64(x) * np.float64(c), rtol=1e-13)
    np.testing.assert_array_equal(pair_f64(ff.ff_neg(x)), -pair_f64(x))
    assert ff.ff_to_f64(x).dtype == torch.float64
    np.testing.assert_array_equal(to_np(ff.ff_to_f64(x)), pair_f64(x))
    np.testing.assert_array_equal(to_np(ff.ff_to_f32(x)), to_np(x[0] + x[1]))
    hi, lo = ff.ff_from_f32(x[0])
    assert torch.equal(hi, x[0]) and not lo.any()


# ------------------------------------------------------------------ square roots


def test_psd_square_roots_match_jax():
    from metrics_tpu.ops import sqrtm as jsq
    from metrics_tpu_torch.ops import sqrtm as psq

    rng = np.random.RandomState(4)
    a, b = rng.randn(40, 12), rng.randn(50, 12) + 0.5
    s1, s2 = (a.T @ a / 40).astype(np.float32), (b.T @ b / 50).astype(np.float32)
    close(psq.trace_sqrtm_product(torch.from_numpy(s1), torch.from_numpy(s2)),
          jsq.trace_sqrtm_product(jnp.asarray(s1), jnp.asarray(s2)), "trace sqrtm f32", rtol=1e-5)
    ref = np.sum(np.sqrt(np.clip(np.linalg.eigvals(s1.astype(np.float64) @ s2).real, 0, None)))
    close(psq.trace_sqrtm_product(torch.from_numpy(s1).double(), torch.from_numpy(s2).double()), ref,
          "trace sqrtm f64", rtol=1e-9)
    close(psq.psd_sqrt(torch.from_numpy(s1)), jsq.psd_sqrt(jnp.asarray(s1)), "psd_sqrt", rtol=1e-4, atol=1e-6)
    got, err = psq.sqrtm_newton_schulz(torch.from_numpy(s1), num_iters=30)
    want, jerr = jsq.sqrtm_newton_schulz(jnp.asarray(s1), num_iters=30)
    close(got, want, "newton-schulz", rtol=1e-4, atol=1e-5)
    assert float(err) < 1e-4 and float(jerr) < 1e-4


# --------------------------------------------------------------------- Inception


@pytest.fixture(scope="module")
def inception_case():
    """A seeded torch-fidelity mirror (BN statistics from two train-mode
    passes), its state dict carried into JAX by ``convert_conv_bn_model`` and
    into the port positionally; JAX's taps of 2 images at 75 x 75."""
    torch.manual_seed(7)
    mirror = TorchFidInception()
    mirror.train()
    with torch.no_grad():
        for _ in range(2):
            mirror(torch.randint(0, 256, (2, 3, SIZE, SIZE), dtype=torch.uint8))
    mirror.eval()
    state = {k: v for k, v in mirror.state_dict().items() if k != "fc.bias"}
    template = jax.tree.map(np.asarray, j_inc.random_inception_params(input_size=SIZE, seed=0, fast=True))
    variables = convert_conv_bn_model({k: v.numpy() for k, v in state.items()}, template)
    imgs = uint8_images(3, 2)
    jax_taps = {k: np.asarray(v) for k, v in
                jax.jit(j_inc.InceptionV3().apply)(variables, jnp.asarray(imgs.transpose(0, 2, 3, 1))).items()}
    with torch.no_grad():
        mirror_taps = {k: v.numpy() for k, v in mirror(torch.from_numpy(imgs)).items()}
    return {"mirror": mirror, "state": state, "variables": variables, "imgs": imgs, "jax": jax_taps,
            "mirror_taps": mirror_taps}


def test_inception_taps_equal_the_mirror_and_jax(inception_case):
    """One seeded torch state dict in three models: every tap of the port
    within 1e-4 of the largest value of the mirror's and of JAX's."""
    port = p_inc.InceptionV3().eval()
    load_state_positional(port, inception_case["state"])
    with torch.no_grad():
        got = port(torch.from_numpy(inception_case["imgs"]))
    for k in TAPS:
        for ref, what in ((inception_case["mirror_taps"][k], "mirror"), (inception_case["jax"][k], "JAX")):
            tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(to_np(got[k]), ref, atol=tol, rtol=0, err_msg=f"{k} vs {what}")
    assert got["2048"].shape == (2, 2048) and got["logits_unbiased"].shape == (2, 1008)


def test_inception_flax_bridge_both_ways(inception_case):
    """The Flax variables carried across by ``inception_state_dict_from_flax``
    equal the positionally loaded mirror weights: HWIO kernels to OIHW, BN
    leaves renamed, the Dense kernel transposed, every tensor bit-equal."""
    port = p_inc.InceptionV3().eval()
    load_state_positional(port, inception_case["state"])
    bridged = p_inc.inception_state_dict_from_flax(inception_case["variables"])
    own = port.state_dict()
    assert list(bridged) == list(own)
    for k, v in own.items():
        assert torch.equal(bridged[k], v), k
    kernel = np.asarray(inception_case["variables"]["params"]["InceptionE_1"]["BasicConv2d_2"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(bridged["mixed.10.convs.2.conv.weight"].numpy(), kernel.transpose(3, 2, 0, 1))


def test_random_inception_params_equal_jax_seeded_fill():
    """``random_inception_params(fast=True)``: the same draws in the same
    order as the JAX package's, for two seeds; ``fast=False`` is refused."""
    for seed in (0, 5):
        want = p_inc.inception_state_dict_from_flax(
            jax.tree.map(np.asarray, j_inc.random_inception_params(input_size=SIZE, seed=seed, fast=True)))
        got = p_inc.random_inception_params(input_size=SIZE, seed=seed)
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in got)
    with pytest.raises(NotPortedError):
        p_inc.random_inception_params(fast=False)


@pytest.fixture(scope="module")
def seeded_extractors():
    params = p_inc.random_inception_params(input_size=SIZE, seed=2)
    return params, {tap: p_inc.InceptionFeatureExtractor(tap, params=params, device="cpu") for tap in TAPS}


def test_fold_preprocess_and_stem_lanes_keep_the_features(seeded_extractors):
    """The folded input affine and the 128-lane padded stem give the plain
    forward's taps within f32 rounding (2e-5 of the largest value); the
    padded stem's params are zero past the logical widths."""
    params, plain = seeded_extractors
    imgs = uint8_images(9, 2)
    padded = p_inc.pad_stem_params(params, 128)
    assert padded["stem.0.conv.weight"].shape == (128, 3, 3, 3)
    assert not padded["stem.1.conv.weight"][32:].any() and not padded["stem.1.conv.weight"][:, 32:].any()
    for kw in ({"fold_preprocess": True}, {"stem_lanes": 128}, {"fold_preprocess": True, "stem_lanes": 128}):
        for tap in ("64", "2048"):
            ext = p_inc.InceptionFeatureExtractor(tap, params=params, device="cpu", **kw)
            want = to_np(plain[tap](imgs))
            np.testing.assert_allclose(to_np(ext(imgs)), want, atol=2e-5 * np.abs(want).max(), rtol=0,
                                       err_msg=f"{kw} {tap}")


def test_extractor_inputs_layouts_and_bf16(seeded_extractors):
    """NHWC input is transposed as JAX's NCHW is; [0, 1] floats quantise as
    uint8 does; the bf16 path holds JAX's bound for it (5e-2 relative and
    absolute, ``tests/engine/test_model_host.py``) and differs from f32."""
    params, plain = seeded_extractors
    imgs = uint8_images(10, 2)
    want = to_np(plain["2048"](imgs))
    np.testing.assert_array_equal(to_np(plain["2048"](imgs.transpose(0, 2, 3, 1))), want)
    close(plain["2048"](imgs.astype(np.float32) / 255.0), want, "float input", rtol=2e-5, atol=1e-5)
    bf16 = p_inc.InceptionFeatureExtractor("2048", params=params, compute_dtype=torch.bfloat16, device="cpu")
    got = to_np(bf16(imgs))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    assert not np.array_equal(got, want)


def test_extractor_matches_jax_extractor_with_flax_params():
    """The port's extractor given JAX's Flax variables (the bridge on the
    way in) against JAX's ``InceptionFeatureExtractor`` on NCHW uint8."""
    jv = j_inc.random_inception_params(input_size=SIZE, seed=4, fast=True)
    imgs = uint8_images(11, 3)
    want = np.asarray(j_inc.InceptionFeatureExtractor("768", params=jv)(jnp.asarray(imgs)))
    got = p_inc.InceptionFeatureExtractor("768", params=jax.tree.map(np.asarray, jv), device="cpu")(imgs)
    np.testing.assert_allclose(to_np(got), want, atol=1e-4 * np.abs(want).max(), rtol=0)


# ------------------------------------------------------------------------- LPIPS


@pytest.fixture(scope="module", params=["vgg", "alex"])
def lpips_case(request, tmp_path_factory):
    """A seeded lpips mirror saved under the lpips package's names, converted
    by ``tools/convert_weights.py lpips`` into JAX's payload."""
    import pickle

    torch.manual_seed(11)
    mirror = TorchVggLpips() if request.param == "vgg" else TorchAlexLpips()
    with torch.no_grad():
        for lin in mirror.lins:
            lin.weight.uniform_(0.0, 1.0)
    d = tmp_path_factory.mktemp(f"lpips_{request.param}")
    save_lpips_style_state(mirror, str(d / "l.pth"))
    convert_lpips(str(d / "l.pth"), str(d / "l.pkl"), net_type=request.param)
    with open(d / "l.pkl", "rb") as f:
        payload = pickle.load(f)
    return request.param, mirror, payload


def lpips_pairs(seed, n, size=64):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, (n, 3, size, size)).astype(np.float32)
    return a, np.clip(a + 0.2 * rng.randn(*a.shape), -1, 1).astype(np.float32)


def test_lpips_backbones_equal_the_mirror_and_jax(lpips_case):
    """The converted payload in the port (``lpips_state_dict_from_flax``) and
    in JAX, and the mirror itself: taps and distances within 1e-4 of the
    largest value."""
    net_type, mirror, payload = lpips_case
    a, b = lpips_pairs(12, 2)
    port = p_per.LPIPSFeatureNet(net_type, params=payload, device="cpu")
    jnet = j_per.LPIPSFeatureNet(net_type, params=payload)
    got, want = port(a), jnet(jnp.asarray(a))
    with torch.no_grad():
        mirror_taps = mirror.taps(torch.from_numpy(a))
    for i, (g, wj, wm) in enumerate(zip(got, want, mirror_taps)):
        ref = np.asarray(wj).transpose(0, 3, 1, 2)
        tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(to_np(g), ref, atol=tol, rtol=0, err_msg=f"{net_type} tap {i} vs JAX")
        np.testing.assert_allclose(to_np(g), to_np(wm), atol=tol, rtol=0, err_msg=f"{net_type} tap {i} vs mirror")
    assert len(port.weights) == 5 and all(torch.equal(p_, torch.from_numpy(np.asarray(j_)))
                                          for p_, j_ in zip(port.weights, jnet.weights))
    from metrics_tpu.image.lpip_similarity import _lpips_from_features as j_dist
    from metrics_tpu_torch.image.lpip_similarity import _lpips_from_features as p_dist

    dist = p_dist(port(a), port(b), port.weights)
    close(dist, j_dist(jnet(jnp.asarray(a)), jnet(jnp.asarray(b)), jnet.weights), f"{net_type} distance", rtol=1e-5)
    with torch.no_grad():
        close(dist, mirror(torch.from_numpy(a), torch.from_numpy(b)), f"{net_type} distance vs mirror", rtol=1e-5)


def test_lpips_metric_matches_jax_over_uneven_updates(lpips_case):
    net_type, _, payload = lpips_case
    a, b = lpips_pairs(13, 5)
    for reduction in ("mean", "sum"):
        pm = mp.LPIPS(net_type=net_type, params=payload, reduction=reduction, device="cpu")
        jm = mt.LPIPS(net_type=net_type, params=payload, reduction=reduction)
        for lo, hi in ((0, 2), (2, 3), (3, 5)):
            pm.update(a[lo:hi], b[lo:hi])
            jm.update(jnp.asarray(a[lo:hi]), jnp.asarray(b[lo:hi]))
        close(pm.compute(), jm.compute(), f"LPIPS {net_type} {reduction}", rtol=1e-5)
        assert float(pm.total) == float(jm.total) == 5.0


def test_lpips_value_range_checks_and_messages_match_jax(lpips_case):
    """The [-1, 1] check's modes, and JAX's messages word for word; a passed
    first check retires the probe, a failed one does not; ``reset`` re-arms."""
    net_type, _, payload = lpips_case
    a = np.zeros((1, 3, 64, 64), np.float32)
    bad = a + 2.0
    jm = mt.LPIPS(net_type=net_type, params=payload)
    with pytest.raises(ValueError) as je:
        jm.update(jnp.asarray(bad), jnp.asarray(a))
    for mode in ("first", True, False):
        pm = mp.LPIPS(net_type=net_type, params=payload, check_value_range=mode, device="cpu")
        if mode is False:
            pm.update(bad, a)
            continue
        with pytest.raises(ValueError) as pe:
            pm.update(bad, a)
        assert str(pe.value) == str(je.value)
        pm.update(a, a)
        if mode == "first":
            pm.update(bad, a)  # the passed first check retired the probe
        else:
            with pytest.raises(ValueError):
                pm.update(bad, a)
        pm.reset()
        with pytest.raises(ValueError):
            pm.update(bad, a)
    for args in ({"check_value_range": "always"}, {"net_type": "resnet"}, {"reduction": "max"}):
        with pytest.raises(ValueError) as pe:
            mp.LPIPS(net=lambda x: [x], device="cpu", **args) if "net_type" not in args else \
                mp.LPIPS(device="cpu", **args)
        with pytest.raises(ValueError) as je2:
            mt.LPIPS(net=lambda x: [x], **args) if "net_type" not in args else mt.LPIPS(**args)
        assert str(pe.value) == str(je2.value)
    with pytest.raises(ModuleNotFoundError):
        mp.LPIPS(net_type="squeeze", device="cpu")
    with pytest.raises(ValueError, match="4-d batch"):
        mp.LPIPS(net_type=net_type, params=payload, device="cpu").update(np.zeros((3, 64, 64), np.float32),
                                                                           np.zeros((3, 64, 64), np.float32))


# ----------------------------------------------------------- FID, KID, IS on features

D = 12
PROJ = np.random.RandomState(20).randn(8, D).astype(np.float32)


def p_feat(x):
    return torch.as_tensor(x, dtype=torch.float32) @ torch.from_numpy(PROJ)


def j_feat(x):
    return jnp.asarray(x, jnp.float32) @ jnp.asarray(PROJ)


def feature_rows(seed, n, offset=0.0):
    """``(n, 8)`` rows with a common offset, the case where the raw-moment
    form cancels."""
    return (np.random.RandomState(seed).randn(n, 8) * 2.0 + offset).astype(np.float32)


SPLITS = ((0, 7), (7, 8), (8, 20), (20, 33))


def fid_pair(streaming=True, **kw):
    pm = mp.FID(feature=p_feat, feature_dim=D if streaming else None, streaming=streaming, device="cpu", **kw)
    jm = mt.FID(feature=j_feat, feature_dim=D if streaming else None, streaming=streaming, **kw)
    return pm, jm


@pytest.mark.parametrize("streaming", [True, False])
def test_fid_matches_jax_over_uneven_updates(streaming):
    """Real and fake rows in four uneven updates each, a large common offset:
    the value within 1e-5 relative (JAX's eager float64 path and the port's);
    the streaming states: ``n`` exact, the pairs' float64 values within 1e-5
    of the largest (each batch's scatter is one f32 matmul in each package,
    summed in another order); M2 within that of float64 numpy."""
    real, fake = feature_rows(21, 33, 100.0), feature_rows(22, 33, 100.3)
    pm, jm = fid_pair(streaming)
    for lo, hi in SPLITS:
        for x, is_real in ((real, True), (fake, False)):
            pm.update(x[lo:hi], real=is_real)
            jm.update(jnp.asarray(x[lo:hi]), real=is_real)
    close(pm.compute(), jm.compute(), f"FID streaming={streaming}", rtol=1e-5)
    if streaming:
        ps, js = pm._pack_state(), jax.tree.map(np.asarray, jm._pack_state())
        assert sorted(ps) == sorted(js) and len(ps) == 10
        for dist in ("real", "fake"):
            assert float(ps[f"{dist}_n"]) == float(js[f"{dist}_n"]) == 33.0
            for part in ("mean", "m2"):
                got = pair_f64((ps[f"{dist}_{part}_hi"], ps[f"{dist}_{part}_lo"]))
                want = pair_f64((js[f"{dist}_{part}_hi"], js[f"{dist}_{part}_lo"]))
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
        exact = np.cov(real.astype(np.float64) @ PROJ.astype(np.float64), rowvar=False, ddof=0) * 33
        m2 = pair_f64((ps["real_m2_hi"], ps["real_m2_lo"]))
        np.testing.assert_allclose(m2, exact, rtol=1e-5, atol=1e-5 * np.abs(exact).max())


def test_fid_in_trace_pair_path_and_underfilled_nan():
    """Under ``traced_rows`` compute takes JAX's in-trace pair path (f32
    covariances and eighs): within 2e-3 relative of the eager float64 value
    and within 1e-3 of JAX's jitted compute (the f32 traces cancel to a
    distance ~1e-3 of their size here, and each package's f32 eighs round
    their own way: the two lie 1.5e-4 apart). The eager value within 1e-5
    of JAX's eager one. One sample a side reads NaN in both packages."""
    from metrics_tpu_torch.utils.checks import traced_rows

    real, fake = feature_rows(23, 40, 5.0), feature_rows(24, 40, 5.5)
    pm, jm = fid_pair()
    pm.update(real, real=True)
    pm.update(fake, real=False)
    eager = float(pm.compute())
    with traced_rows():
        traced = float(pm._compute_streaming())
    assert abs(traced - eager) <= 2e-3 * abs(eager)
    jm.update(jnp.asarray(real), real=True)
    jm.update(jnp.asarray(fake), real=False)
    close(traced, jax.jit(jm.compute_from)(jm._pack_state()), "in-trace vs JAX's jitted compute", rtol=1e-3)
    close(eager, jm.compute(), "eager vs JAX's eager compute", rtol=1e-5)
    pm, jm = fid_pair()
    pm.update(real[:1], real=True)
    pm.update(fake[:5], real=False)
    jm.update(jnp.asarray(real[:1]), real=True)
    jm.update(jnp.asarray(fake[:5]), real=False)
    assert np.isnan(float(pm.compute())) and np.isnan(float(jm.compute()))


def test_fid_forward_matches_jax_jitted_forward():
    """FID's forward (a full-state update: the eager snapshot path, no
    compiled entry) against JAX's forward: a batch holds one distribution,
    so both batch values are NaN, and the accumulated values agree within
    1e-5 relative."""
    from metrics_tpu_torch.metric import forward_entry_kinds

    real, fake = feature_rows(25, 30, 3.0), feature_rows(26, 30, 3.2)
    pm, jm = fid_pair()
    pm.update(real[:20], real=True)
    jm.update(jnp.asarray(real[:20]), real=True)
    pm.update(fake[:20], real=False)
    jm.update(jnp.asarray(fake[:20]), real=False)
    for x, is_real in ((real[20:], True), (fake[20:], False)):
        got, want = pm(x, real=is_real), jm(jnp.asarray(x), real=is_real)
        # a batch holds one distribution, the other is empty: NaN in both
        assert np.isnan(float(got)) and np.isnan(float(want))
    # the accumulated state holds all 30 rows a side
    close(pm.compute(), jm.compute(), "after forward", rtol=1e-5)
    assert forward_entry_kinds(pm) == []


def test_kid_matches_jax_on_the_same_subsets():
    """KID's subset draws follow JAX's RandomState order: mean and std
    (ddof 0) within 1e-5 relative (absolute 1e-7); a full-size subset gives
    std 0 in both; the argument checks raise JAX's messages."""
    real, fake = feature_rows(27, 25, 1.0), feature_rows(28, 22, 1.4)
    for kw in ({"subsets": 6, "subset_size": 9, "seed": 3}, {"subsets": 3, "subset_size": 22, "seed": 1},
               {"subsets": 4, "subset_size": 10, "seed": 5, "degree": 2, "gamma": 0.5, "coef": 2.0}):
        pm = mp.KID(feature=p_feat, device="cpu", **kw)
        jm = mt.KID(feature=j_feat, **kw)
        for lo, hi in ((0, 10), (10, 25)):
            pm.update(real[lo:hi], real=True)
            jm.update(jnp.asarray(real[lo:hi]), real=True)
        for lo, hi in ((0, 4), (4, 22)):
            pm.update(fake[lo:hi], real=False)
            jm.update(jnp.asarray(fake[lo:hi]), real=False)
        for g, wv in zip(pm.compute(), jm.compute()):
            close(g, wv, f"KID {kw}", rtol=1e-5, atol=1e-7)
    for bad in ({"subsets": 0}, {"subset_size": -1}, {"degree": 0}, {"gamma": 1}, {"coef": 0.0}):
        with pytest.raises(ValueError) as pe:
            mp.KID(feature=p_feat, device="cpu", **bad)
        with pytest.raises(ValueError) as je:
            mt.KID(feature=j_feat, **bad)
        assert str(pe.value) == str(je.value)
    pm = mp.KID(feature=p_feat, subset_size=50, device="cpu")
    pm.update(real, real=True)
    pm.update(fake, real=False)
    with pytest.raises(ValueError, match="subset_size"):
        pm.compute()


def logit_rows(seed, n, c=10):
    return (np.random.RandomState(seed).randn(n, 8) * 1.5).astype(np.float32) @ \
        np.random.RandomState(99).randn(8, c).astype(np.float32)


@pytest.mark.parametrize("streaming", [False, True])
def test_inception_score_matches_jax(streaming):
    """IS over four uneven updates: list mode's permutation and splits
    (ddof 1) as JAX's; streaming's split counts bit-equal (the same threefry
    draws) and the pair sums within 1e-6; mean and std within 1e-5."""
    x = np.random.RandomState(29).randn(45, 8).astype(np.float32)
    proj = np.random.RandomState(99).randn(8, 10).astype(np.float32)
    pm = mp.IS(feature=lambda v: torch.as_tensor(v) @ torch.from_numpy(proj), feature_dim=10, splits=4, seed=17,
               streaming=streaming, device="cpu")
    jm = mt.IS(feature=lambda v: jnp.asarray(v) @ jnp.asarray(proj), feature_dim=10, splits=4, seed=17,
               streaming=streaming)
    for lo, hi in ((0, 9), (9, 10), (10, 31), (31, 45)):
        pm.update(x[lo:hi])
        jm.update(jnp.asarray(x[lo:hi]))
    if streaming:
        np.testing.assert_array_equal(to_np(pm.split_n), np.asarray(jm.split_n))
        assert float(pm.split_n.sum()) == 45.0
        for part in ("prob_sum", "plogp_sum"):
            np.testing.assert_allclose(pair_f64((getattr(pm, f"{part}_hi"), getattr(pm, f"{part}_lo"))),
                                       pair_f64((getattr(jm, f"{part}_hi"), getattr(jm, f"{part}_lo"))),
                                       rtol=1e-6, atol=1e-6)
    for g, wv in zip(pm.compute(), jm.compute()):
        close(g, wv, f"IS streaming={streaming}", rtol=1e-5)


def test_threefry_draws_equal_jax_random():
    """``PRNGKey``, ``fold_in`` and ``randint`` bit-equal to ``jax.random``
    over seeds, counters (int32 extremes included), sizes and spans (one
    whose ``2 ** 16`` multiplier wraps uint32)."""
    from metrics_tpu_torch.utils import prng

    for seed in (0, 1, 17, 2**31 - 1):
        key = prng.prng_key(seed)
        np.testing.assert_array_equal(to_np(key), np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))
        for n_seen in (0, 1, 45, 2**24 + 1, 2**31 - 1):
            jk = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(n_seen))
            pk = prng.fold_in(key, torch.tensor(n_seen, dtype=torch.int32))
            np.testing.assert_array_equal(to_np(pk), np.asarray(jk).astype(np.int64))
            for n, lo, hi in ((1, 0, 10), (9, 0, 4), (64, 0, 3), (5, 0, 1), (33, 0, 1000003), (7, -5, 5)):
                np.testing.assert_array_equal(to_np(prng.randint(pk, (n,), lo, hi)),
                                              np.asarray(jax.random.randint(jk, (n,), lo, hi)),
                                              err_msg=f"{seed} {n_seen} {n} [{lo}, {hi})")


# -------------------------------------------------------- the built-in extractor


def test_fid_kid_is_on_the_builtin_inception_match_jax():
    """FID (2048 tap), KID and IS (logits) on the seeded Inception at
    75 x 75, uint8 NCHW in both packages, over two updates a side: values
    within 1e-4 relative (features within 1e-4 of their scale, f32 convs)."""
    jv = j_inc.random_inception_params(input_size=SIZE, seed=6, fast=True)
    pv = jax.tree.map(np.asarray, jv)
    real, fake = uint8_images(30, 6), uint8_images(31, 6)
    pm, jm = mp.FID(feature=2048, params=pv, device="cpu"), mt.FID(feature=2048, params=jv)
    pk = mp.KID(feature=2048, params=pv, subsets=3, subset_size=4, seed=2, device="cpu")
    jk = mt.KID(feature=2048, params=jv, subsets=3, subset_size=4, seed=2)
    pi = mp.IS(params=pv, splits=2, seed=1, device="cpu")
    ji = mt.IS(params=jv, splits=2, seed=1)
    for lo, hi in ((0, 3), (3, 6)):
        for x, is_real in ((real, True), (fake, False)):
            for m in (pm, pk):
                m.update(x[lo:hi], real=is_real)
            for m in (jm, jk):
                m.update(jnp.asarray(x[lo:hi]), real=is_real)
        pi.update(real[lo:hi])
        ji.update(jnp.asarray(real[lo:hi]))
    close(pm.compute(), jm.compute(), "FID", rtol=1e-4)
    for g, wv in zip(pk.compute(), jk.compute()):
        close(g, wv, "KID", rtol=1e-4, atol=1e-6)
    for g, wv in zip(pi.compute(), ji.compute()):
        close(g, wv, "IS", rtol=1e-4, atol=1e-6)  # two near-equal splits: std ~2e-5


def test_refusals_and_argument_errors():
    """``mesh=`` with a callable feature raises JAX's message (the built-in
    extractor takes a mesh since the model meshes were ported:
    ``tests/test_torch_model_mesh.py``); the feature checks raise JAX's
    messages."""
    from jax.sharding import Mesh as JaxMesh

    from metrics_tpu_torch.parallel.mesh import MeshConfig

    pmesh = MeshConfig(shape=(4,), devices=["cpu"] * 4).make_mesh()
    jmesh = JaxMesh(np.asarray(jax.devices()[:4]), ("dp",))
    for pcls, jcls, kw in ((mp.FID, mt.FID, {"feature_dim": 8}), (mp.KID, mt.KID, {}),
                           (mp.IS, mt.IS, {"feature_dim": 8})):
        with pytest.raises(ValueError, match="mesh") as pe:
            pcls(feature=p_feat, mesh=pmesh, device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            jcls(feature=p_feat, mesh=jmesh, **kw)
        assert str(pe.value) == str(je.value).replace("metrics_tpu.", "metrics_tpu_torch.")
    assert p_inc.InceptionFeatureExtractor(input_size=SIZE, mesh=pmesh).device == CPU
    for pcls, jcls, kw in ((mp.FID, mt.FID, {"feature": 100}), (mp.FID, mt.FID, {"feature": p_feat,
                                                                                   "streaming": True}),
                           (mp.IS, mt.IS, {"feature": p_feat, "streaming": True})):
        with pytest.raises(ValueError) as pe:
            pcls(device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            jcls(**kw)
        assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="model_host"):
        mp.FID(feature=p_feat, model_host=True, device="cpu")


# ------------------------------------------------------------ sync and bridge


@pytest.fixture(scope="module")
def pool():
    p = w.RankPool()
    yield p
    p.close()


def test_fid_and_kid_synced_over_three_ranks_equal_jax_on_the_union(pool):
    """Each rank updates a streaming FID, a list FID and a KID on its shard;
    FID's ten states gather ``(world, ...)`` and compute folds them in rank
    order; every rank's value equals JAX's one process over the union within
    1e-5 relative (KID: the same subsets of the rank-ordered union)."""
    got = pool.run("image_models", group="world")
    proj = jnp.asarray(w.IMAGE_MODEL_PROJ)
    ref = {"fid": mt.FID(feature=lambda x: jnp.asarray(x) @ proj, feature_dim=w.IMAGE_MODEL_DIM),
           "fid_list": mt.FID(feature=lambda x: jnp.asarray(x) @ proj, streaming=False),
           "kid": mt.KID(feature=lambda x: jnp.asarray(x) @ proj, **w.IMAGE_MODEL_KID)}
    for rank in range(w.WORLD):
        real, fake = w.image_model_rows(rank)
        for m in ref.values():
            m.update(jnp.asarray(real), real=True)
            m.update(jnp.asarray(fake), real=False)
    for rank in range(w.WORLD):
        res = got[rank]
        assert res["fid_state_shape"] == [w.WORLD, w.IMAGE_MODEL_DIM, w.IMAGE_MODEL_DIM]
        close(res["fid"][2], ref["fid"].compute(), f"FID rank {rank}", rtol=1e-5)
        close(res["fid_list"][2], ref["fid_list"].compute(), f"list FID rank {rank}", rtol=1e-5)
        for g, wv in zip((r[2] for r in res["kid"]), ref["kid"].compute()):
            close(g, wv, f"KID rank {rank}", rtol=1e-5, atol=1e-7)


def test_fid_state_bridge_both_ways_mid_stream():
    """FID's ten states cross between the packages mid-stream, both ways:
    the continued runs end with the straight run's value (1e-5 relative)
    and states (pairs within 1e-5 of the largest)."""
    real, fake = feature_rows(40, 30, 7.0), feature_rows(41, 30, 7.2)
    straight, _ = fid_pair()
    for x, r in ((real, True), (fake, False)):
        straight.update(x, real=r)
    pm, jm = fid_pair()
    jm.update(jnp.asarray(real[:12]), real=True)
    jm.update(jnp.asarray(fake[:12]), real=False)
    pm._load_state(state_from_numpy(pm, jax.tree.map(np.asarray, jm._pack_state()), device="cpu"))
    pm.update(real[12:], real=True)
    pm.update(fake[12:], real=False)
    close(pm.compute(), straight.compute(), "JAX -> port", rtol=1e-5)
    pm2, jm2 = fid_pair()
    pm2.update(real[:12], real=True)
    pm2.update(fake[:12], real=False)
    jm2._load_state(jax.tree.map(jnp.asarray, state_to_numpy(pm2._pack_state())))
    jm2.update(jnp.asarray(real[12:]), real=True)
    jm2.update(jnp.asarray(fake[12:]), real=False)
    close(jm2.compute(), straight.compute(), "port -> JAX", rtol=1e-5)
    js, ps = jax.tree.map(np.asarray, jm2._pack_state()), straight._pack_state()
    for dist in ("real", "fake"):
        assert float(js[f"{dist}_n"]) == float(ps[f"{dist}_n"]) == 30.0
        for part in ("mean", "m2"):
            want = pair_f64((ps[f"{dist}_{part}_hi"], ps[f"{dist}_{part}_lo"]))
            np.testing.assert_allclose(pair_f64((js[f"{dist}_{part}_hi"], js[f"{dist}_{part}_lo"])), want,
                                       rtol=1e-5, atol=1e-5 * np.abs(want).max(), err_msg=f"{dist}_{part}")


def test_exports():
    for name in ("FID", "FrechetInceptionDistance", "IS", "InceptionScore", "KID", "KernelInceptionDistance",
                 "LPIPS"):
        assert name in mp.__all__ and getattr(mp, name) is getattr(importlib.import_module(
            "metrics_tpu_torch.image"), name)
    assert mp.FrechetInceptionDistance is mp.FID and mp.InceptionScore is mp.IS and \
        mp.KernelInceptionDistance is mp.KID
    from metrics_tpu_torch.models import InceptionFeatureExtractor, InceptionV3

    assert InceptionV3 is p_inc.InceptionV3 and InceptionFeatureExtractor is p_inc.InceptionFeatureExtractor
    assert p_inc.FEATURE_DIMS == j_inc.FEATURE_DIMS
