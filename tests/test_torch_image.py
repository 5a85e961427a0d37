"""The port's signal-level image metrics against the JAX package, on the CPU.

The same seeded numpy images (smooth plus texture, and a copy blurred with
noise added) go to both packages: PSNR in every state form (with and
without ``data_range`` and ``dim``, each ``reduction``, three bases), SSIM
(square and non-square kernels, one with no crop, the contrast
sensitivity, each reduction), MS-SSIM with ``normalize`` None, ``relu``
and ``simple`` and its size and argument errors, and ``image_gradients``,
all within 1e-5 of JAX but ``image_gradients``, which is bit-equal. Every
module class takes three uneven updates, its states dtype-equal to JAX's
(``total`` int32); the state bridge both ways mid-stream; the compiled
forward (PSNR) and the eager one (SSIM's ``cat`` states). SNR and three
image metrics are synced over the three-rank gloo pool of
``tests/helpers/torch_sync_worker.py`` and held against JAX's one process
over the whole input.
"""
import doctest
import importlib
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metrics_tpu as mt
import metrics_tpu.functional as jf
import metrics_tpu_torch as mp
import metrics_tpu_torch.functional as pf
from metrics_tpu_torch.metric import forward_entry_kinds
from metrics_tpu_torch.utils.state_bridge import state_from_numpy, state_to_numpy
from tests.helpers import torch_sync_worker as w

CPU = torch.device("cpu")
RTOL = 1e-5
SSIM_TOL = 1e-5
# an SSIM MAP (reduction "none") per pixel: sigma^2 = E[x^2] - mu^2 cancels, and the two packages' f32
# convolutions (121 terms in another order) leave each package ~5e-5 from a float64 map, so their maps
# are held within this absolute bound; every reduced value within SSIM_TOL
SSIM_MAP_ATOL = 2e-4


def images(seed, n, c=3, h=40, width=48):
    """``(target, preds)``: smooth fields plus a texture in [0, 1], and each
    blurred (a 3x3 box) with Gaussian noise of sigma 0.02-0.10 added."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, width), indexing="ij")
    t = np.empty((n, c, h, width), np.float32)
    for i in range(n):
        for j in range(c):
            a, b, f = rng.rand(3)
            t[i, j] = 0.5 + 0.3 * np.sin(2 * np.pi * (a * 2 * xx + b * 3 * yy)) + 0.1 * np.cos(40 * f * xx * yy)
    t = np.clip(t + 0.03 * rng.randn(*t.shape), 0.0, 1.0).astype(np.float32)
    pad = np.pad(t, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="edge")
    blur = sum(pad[..., dy:dy + h, dx:dx + width] for dy in range(3) for dx in range(3)) / 9.0
    sigma = rng.uniform(0.02, 0.10, size=(n, 1, 1, 1))
    return t, (blur + sigma * rng.randn(*t.shape)).astype(np.float32)


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


def same_state(pstate, jstate, what=""):
    """Every leaf (list states element by element) of JAX's dtype and shape;
    integer leaves bit-equal, float ones within 1e-5 relative."""
    assert sorted(pstate) == sorted(jstate), what
    for k, jv in jstate.items():
        pv = pstate[k]
        pairs = list(zip(pv, jv)) if isinstance(jv, list) else [(pv, jv)]
        if isinstance(jv, list):
            assert isinstance(pv, list) and len(pv) == len(jv), f"{what}.{k}"
        for p_, j_ in pairs:
            p_, j_ = to_np(p_), np.asarray(j_)
            assert p_.dtype == j_.dtype, f"{what}.{k}: dtype {p_.dtype} != {j_.dtype}"
            assert p_.shape == j_.shape, f"{what}.{k}: shape {p_.shape} != {j_.shape}"
            if np.issubdtype(j_.dtype, np.integer):
                np.testing.assert_array_equal(p_, j_, err_msg=f"{what}.{k}")
            else:
                np.testing.assert_allclose(p_, j_, rtol=RTOL, err_msg=f"{what}.{k}")


T, P = images(0, 5)


# --------------------------------------------------------------------- PSNR

PSNR_FORMS = [
    {}, {"data_range": 1.0}, {"data_range": 2.0, "base": 2.0}, {"base": float(np.e)},
    {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"},
    {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "sum"},
    {"data_range": 1.0, "dim": (2, 3), "reduction": "elementwise_mean"},
    {"data_range": 1.0, "dim": 1, "reduction": "none", "base": 2.0},
]


@pytest.mark.parametrize("form", range(len(PSNR_FORMS)))
def test_psnr_functional_matches_jax(form):
    kw = PSNR_FORMS[form]
    got = pf.psnr(P, T, device="cpu", **kw)
    assert got.dtype == torch.float32
    close(got, jf.psnr(P, T, **kw), str(kw))
    close(pf.psnr(torch.from_numpy(P), torch.from_numpy(T), **kw), jf.psnr(P, T, **kw), f"{kw} tensors")


def test_psnr_warnings_and_errors_match_jax():
    with pytest.warns(UserWarning, match="will not have any effect"):
        got = pf.psnr(P, T, reduction="sum", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        close(got, jf.psnr(P, T, reduction="sum"), "reduction with dim=None")
    for pkg, kw in ((jf, {}), (pf, {"device": "cpu"})):
        with pytest.raises(ValueError, match="must be given when `dim` is not None"):
            pkg.psnr(P, T, dim=1, **kw)
    with pytest.raises(ValueError, match="must be given when `dim` is not None"):
        mp.PSNR(dim=1, device="cpu")
    with pytest.raises(ValueError, match="Reduction parameter unknown"):
        pf.psnr(P, T, data_range=1.0, dim=1, reduction="mean", device="cpu")


PSNR_MODULES = {
    "inferred_range": {},
    "data_range": {"data_range": 1.0},
    "data_range_base2": {"data_range": 1.0, "base": 2.0},
    "dim_none": {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"},
    "dim_sum": {"data_range": 2.0, "dim": (2, 3), "reduction": "sum"},
    "dim_mean": {"data_range": 1.0, "dim": 1},
}
SPLITS = ((0, 2), (2, 3), (3, 5))


@pytest.mark.parametrize("name", sorted(PSNR_MODULES))
def test_psnr_module_states_match_jax_over_uneven_updates(name):
    kw = PSNR_MODULES[name]
    pm, jm = mp.PSNR(device="cpu", **kw), mt.PSNR(**kw)
    for lo, hi in SPLITS:
        pm.update(P[lo:hi], T[lo:hi] * (1 + lo))  # a range that grows: min/max move
        jm.update(P[lo:hi], T[lo:hi] * (1 + lo))
    same_state(pm._pack_state(), jm._pack_state(), name)
    if "dim" not in kw:
        assert pm.total.dtype == torch.int32
    close(pm.compute(), jm.compute(), name)
    pm.reset()
    jm.reset()
    same_state(pm._pack_state(), jm._pack_state(), f"{name} reset")


def test_psnr_forward_compiles_as_jax_when_its_states_merge():
    """``dim=None`` with the range inferred (sum/min/max states) takes the
    compiled forward; a ``data_range`` state (``mean``) and ``cat`` lists do not."""
    for kw, kinds in (({}, ["compiled"]), ({"data_range": 1.0}, []), ({"data_range": 1.0, "dim": 1}, [])):
        pm, jm = mp.PSNR(device="cpu", **kw), mt.PSNR(**kw)
        for lo in (0, 1, 2):
            close(pm(P[lo:lo + 2], T[lo:lo + 2]), jm(P[lo:lo + 2], T[lo:lo + 2]), f"{kw} forward")
        assert forward_entry_kinds(pm) == kinds, kw
        close(pm.compute(), jm.compute(), f"{kw} compute")


# --------------------------------------------------------------------- SSIM and MS-SSIM

SSIM_FORMS = [
    {}, {"data_range": 1.0}, {"kernel_size": (7, 3), "sigma": (1.5, 0.8)}, {"kernel_size": (1, 5)},
    {"kernel_size": (5, 5), "reduction": "none"}, {"kernel_size": (3, 7), "reduction": "sum", "k1": 0.02, "k2": 0.05},
]


@pytest.mark.parametrize("form", range(len(SSIM_FORMS)))
def test_ssim_functional_matches_jax(form):
    """A non-square kernel shows JAX's padding (height by ``pad_h``); a
    ``(1, k)`` kernel its crop only when both pads are non-zero."""
    kw = SSIM_FORMS[form]
    got = pf.ssim(P, T, device="cpu", **kw)
    tol = {"rtol": 0.0, "atol": SSIM_MAP_ATOL} if kw.get("reduction") == "none" else {"rtol": SSIM_TOL}
    close(got, jf.ssim(P, T, **kw), str(kw), **tol)


@pytest.mark.parametrize("kernel_size", [(11, 11), (5, 3)])
def test_ssim_contrast_sensitivity_matches_jax(kernel_size):
    from metrics_tpu.functional.image.ssim import _ssim_compute as j_compute
    from metrics_tpu_torch.functional.image.ssim import _ssim_compute as p_compute

    for reduction in ("elementwise_mean", "none"):
        got = p_compute(torch.from_numpy(P), torch.from_numpy(T), kernel_size, (1.5, 1.5), reduction, None,
                        return_contrast_sensitivity=True)
        want = j_compute(jnp.asarray(P), jnp.asarray(T), kernel_size, (1.5, 1.5), reduction, None,
                         return_contrast_sensitivity=True)
        tol = {"rtol": 0.0, "atol": SSIM_MAP_ATOL} if reduction == "none" else {"rtol": SSIM_TOL}
        for g, w_ in zip(got, want):
            close(g, w_, f"{kernel_size} {reduction}", **tol)


def test_ssim_argument_errors_match_jax():
    for pkg, kw in ((jf, {}), (pf, {"device": "cpu"})):
        with pytest.raises(TypeError, match="same data type"):
            pkg.ssim(P, T.astype(np.float16), **kw)
        with pytest.raises(ValueError, match="BxCxHxW"):
            pkg.ssim(P[0], T[0], **kw)
        with pytest.raises(RuntimeError, match="same shape"):
            pkg.ssim(P, T[:2], **kw)
        with pytest.raises(ValueError, match="length of two"):
            pkg.ssim(P, T, kernel_size=(3, 3, 3), **kw)
        with pytest.raises(ValueError, match="odd positive"):
            pkg.ssim(P, T, kernel_size=(4, 3), **kw)
        with pytest.raises(ValueError, match="positive number"):
            pkg.ssim(P, T, sigma=(1.0, 0.0), **kw)


MS_T, MS_P = images(1, 3, c=2, h=56, width=64)


@pytest.mark.parametrize("normalize", [None, "relu", "simple"])
def test_ms_ssim_matches_jax(normalize):
    kw = {"kernel_size": (3, 3), "normalize": normalize}
    got = pf.multiscale_structural_similarity_index_measure(MS_P, MS_T, device="cpu", **kw)
    close(got, jf.multiscale_structural_similarity_index_measure(MS_P, MS_T, **kw), str(kw), rtol=SSIM_TOL)
    betas = (0.3, 0.3, 0.4)
    close(pf.multiscale_structural_similarity_index_measure(MS_P, MS_T, kernel_size=(5, 5), betas=betas,
                                                            data_range=1.0, normalize=normalize, device="cpu"),
          jf.multiscale_structural_similarity_index_measure(MS_P, MS_T, kernel_size=(5, 5), betas=betas,
                                                            data_range=1.0, normalize=normalize),
          f"{normalize} three betas", rtol=SSIM_TOL)


def test_ms_ssim_alias_and_errors_match_jax():
    from metrics_tpu_torch.functional.image.ms_ssim import ms_ssim

    assert ms_ssim is pf.multiscale_structural_similarity_index_measure
    for pkg, kw in ((jf, {}), (pf, {"device": "cpu"})):
        fn = pkg.multiscale_structural_similarity_index_measure
        with pytest.raises(ValueError, match="tuple of floats"):
            fn(MS_P, MS_T, betas=[0.5, 0.5], **kw)
        with pytest.raises(ValueError, match="'relu' or 'simple'"):
            fn(MS_P, MS_T, normalize="max", **kw)
        with pytest.raises(ValueError, match="larger than or equal to 32"):
            fn(MS_P[..., :24, :], MS_T[..., :24, :], **kw)
        with pytest.raises(ValueError, match="image height must be larger than 160"):
            fn(MS_P, MS_T, **kw)
        with pytest.raises(ValueError, match="image width must be larger than 64"):
            fn(MS_P, MS_T, kernel_size=(3, 5), **kw)
    for bad in ({"betas": (1, 2)}, {"normalize": "max"}):
        with pytest.raises(ValueError):
            mp.MultiScaleStructuralSimilarityIndexMeasure(device="cpu", **bad)


IMAGE_MODULES = {
    "SSIM": ("SSIM", {"kernel_size": (5, 5)}, T, P),
    "SSIM_data_range": ("SSIM", {"data_range": 1.0, "kernel_size": (7, 3), "reduction": "sum"}, T, P),
    "MS_SSIM": ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": (3, 3)}, MS_T, MS_P),
    "MS_SSIM_simple": ("MultiScaleStructuralSimilarityIndexMeasure",
                       {"kernel_size": (3, 3), "normalize": "simple", "data_range": 1.0}, MS_T, MS_P),
}
IMAGE_SPLITS = {5: SPLITS, 3: ((0, 1), (1, 3), (3, 3))}


def make_image(pkg, name, **extra):
    cls, kw, _, _ = IMAGE_MODULES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return getattr(pkg, cls)(**kw, **extra)


@pytest.mark.parametrize("name", sorted(IMAGE_MODULES))
def test_ssim_modules_match_jax_over_uneven_updates(name):
    _, _, t, p = IMAGE_MODULES[name]
    pm, jm = make_image(mp, name, device="cpu"), make_image(mt, name)
    for lo, hi in IMAGE_SPLITS[len(t)]:
        if hi > lo:
            pm.update(p[lo:hi], t[lo:hi])
            jm.update(p[lo:hi], t[lo:hi])
    same_state(pm._pack_state(), jm._pack_state(), name)
    close(pm.compute(), jm.compute(), name, rtol=SSIM_TOL)
    # the forward is eager: cat states take no compiled step, in JAX neither
    pm.reset()
    close(pm(p[:2], t[:2]), jm(p[:2], t[:2]), f"{name} forward", rtol=SSIM_TOL)
    assert forward_entry_kinds(pm) == []


@pytest.mark.parametrize("cls, warning", [("SSIM", "Metric `SSIM` will save"),
                                          ("MultiScaleStructuralSimilarityIndexMeasure", "Metric `MS_SSIM` will save")])
def test_ssim_modules_warn_once_when_constructed(cls, warning):
    with pytest.warns(UserWarning, match=warning) as record:
        m = getattr(mp, cls)(device="cpu")
    assert len([r for r in record if warning in str(r.message)]) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.update(MS_P, MS_T)


# --------------------------------------------------------------------- image gradients

def test_image_gradients_are_bit_equal_to_jax():
    for img in (T, np.arange(60.0, dtype=np.float32).reshape(1, 3, 4, 5), (T * 255).astype(np.int32)):
        dy, dx = pf.image_gradients(torch.from_numpy(img))
        jdy, jdx = jf.image_gradients(img)
        for g, w_ in ((dy, jdy), (dx, jdx)):
            g, w_ = to_np(g), np.asarray(w_)
            assert g.dtype == w_.dtype
            np.testing.assert_array_equal(g, w_)
    dy, _ = pf.image_gradients(T, device="cpu")
    assert dy.device == CPU
    for pkg in (jf, pf):
        with pytest.raises(RuntimeError, match="4D tensor but got 2D"):
            pkg.image_gradients([[1.0]])
        with pytest.raises(RuntimeError, match="4D tensor but got 3D"):
            pkg.image_gradients(T[0])
    for pkg in (jf, pf):  # what no array conversion takes
        with pytest.raises(TypeError, match="<Array> type"):
            importlib.import_module(f"{pkg.__name__}.image.gradients")._image_gradients_validate([[1.0]])


# --------------------------------------------------------------------- the state bridge

BRIDGED = {**{f"PSNR_{k}": ("PSNR", v, T, P) for k, v in PSNR_MODULES.items()}, **IMAGE_MODULES}


@pytest.mark.parametrize("name", sorted(BRIDGED))
def test_state_crosses_from_jax_mid_stream_and_back(name):
    """JAX takes the first two updates and the port the last from JAX's
    state (int32 total, +-inf extremes, cat lists of images); and the
    other way. Both end on JAX's state and value."""
    cls, kw, t, p = BRIDGED[name]

    def new(pkg, **extra):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return getattr(pkg, cls)(**kw, **extra)

    splits = [s for s in IMAGE_SPLITS[len(t)] if s[1] > s[0]]
    whole = new(mt)
    for lo, hi in splits:
        whole.update(p[lo:hi], t[lo:hi])
    jm, pm = new(mt), new(mp, device="cpu")
    jm.update(p[splits[0][0]:splits[0][1]], t[splits[0][0]:splits[0][1]])
    if len(splits) == 3:
        jm.update(p[splits[1][0]:splits[1][1]], t[splits[1][0]:splits[1][1]])
    fresh = mt.PSNR() if cls == "PSNR" and not kw else None
    if fresh is not None:  # the untouched extremes cross too
        pm2 = new(mp, device="cpu")
        pm2._load_state(state_from_numpy(pm2, jax.tree.map(np.asarray, fresh._pack_state()), device="cpu"))
        assert float(pm2.min_target) == float("inf") and float(pm2.max_target) == float("-inf")
    pm._load_state(state_from_numpy(pm, jax.tree.map(np.asarray, jm._pack_state()), device="cpu"))
    for lo, hi in splits[len(splits) - 1:]:
        pm.update(p[lo:hi], t[lo:hi])
    same_state(pm._pack_state(), whole._pack_state(), f"{name} JAX -> port")
    close(pm.compute(), whole.compute(), name, rtol=SSIM_TOL)

    pm3, jm3 = new(mp, device="cpu"), new(mt)
    for lo, hi in splits[:-1]:
        pm3.update(p[lo:hi], t[lo:hi])
    jm3._load_state(jax.tree.map(jnp.asarray, state_to_numpy(pm3._pack_state())))
    lo, hi = splits[-1]
    jm3.update(p[lo:hi], t[lo:hi])
    same_state(pm._pack_state(), jm3._pack_state(), f"{name} port -> JAX")
    close(jm3.compute(), whole.compute(), name, rtol=SSIM_TOL)


# ----------------------------------------------------- three gloo ranks (no JAX in them)

@pytest.fixture(scope="module")
def pool():
    p = w.RankPool()
    yield p
    p.close()


def test_signal_states_synced_over_three_ranks_equal_jax_on_the_whole_input(pool):
    """Each rank updates SNR, PSNR (range inferred: min/max; given: mean)
    and SSIM (cat images) on its shard; every rank's ``sync_states`` and
    synced ``compute()`` equal JAX's one process over all three shards:
    counts bit-equal and int32, float sums within 1e-5, images in rank order."""
    got = pool.run("signal", group="world")
    for name, (cls, kw, kind) in w.SIGNAL_SUITE.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = getattr(mt, cls)(**kw)
        for rank in range(w.WORLD):
            ref.update(*w.signal_rows(kind, rank))
        want_state = jax.tree.map(np.asarray, ref._pack_state())
        want_value = to_np(ref.compute())
        for rank in range(w.WORLD):
            res = got[rank][name]
            for k, jv in want_state.items():
                tag, dtype, pv = res["synced"][k]
                if isinstance(jv, list):
                    jv = np.concatenate([np.atleast_1d(x) for x in jv])
                jv = np.asarray(jv)
                assert dtype == str(jv.dtype), f"{name}.{k}: {dtype} != {jv.dtype}"
                if np.issubdtype(jv.dtype, np.integer):
                    np.testing.assert_array_equal(pv, jv, err_msg=f"{name}.{k} rank {rank}")
                else:
                    np.testing.assert_allclose(pv, jv, rtol=RTOL, err_msg=f"{name}.{k} rank {rank}")
            close(res["compute"][2], want_value, f"{name} rank {rank}", rtol=SSIM_TOL)


# --------------------------------------------------------------------- exports and docstrings

def test_exports_carry_the_jax_packages_names():
    for name in ("PSNR", "SSIM", "MultiScaleStructuralSimilarityIndexMeasure"):
        assert hasattr(mt, name) and name in mp.__all__ and hasattr(mp, name), name
    for name in ("psnr", "ssim", "multiscale_structural_similarity_index_measure", "image_gradients"):
        assert hasattr(jf, name) and name in pf.__all__ and hasattr(pf, name), name
    for name in ("FID", "KID", "IS", "LPIPS"):  # ported with their models since
        assert hasattr(mt, name) and name in mp.__all__ and hasattr(mp, name), name


@pytest.mark.parametrize("mod", ["metrics_tpu_torch.image.psnr", "metrics_tpu_torch.image.ssim",
                                 "metrics_tpu_torch.functional.image.psnr",
                                 "metrics_tpu_torch.functional.image.gradients"])
def test_module_docstring_examples_run(mod):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = doctest.testmod(importlib.import_module(mod), optionflags=doctest.ELLIPSIS)
    assert result.failed == 0 and result.attempted > 0, mod
