"""The port's counting metrics against the JAX package's, on the CPU.

Precision, Recall, Specificity, HammingDistance, JaccardIndex (and IoU),
CohenKappa, MatthewsCorrCoef (and MatthewsCorrcoef), HingeLoss (and Hinge),
KLDivergence and CalibrationError, their functional forms, dice_score, and
``reduce``/``class_reduce``. Each takes the same numpy inputs, made from a
seed, as its ``metrics_tpu`` twin (kernels under
``use_backend("pallas_interpret")``). Tolerances: integer states bit-exact;
f32 states and values within ``rtol=1e-6`` plus ``atol=1e-6`` (f32 sums such
as the hinge measure or the calibration bins add the same terms in another
order). The masked update (the bucketed engine
step) is compared the same way, with garbage in the masked rows, and every
engine-served compute must run under ``torch.func.vmap`` (the engines'
batched ``results()``) with the values of the stream-by-stream compute.
"""
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.functional as mtf
import metrics_tpu_torch as mp
import metrics_tpu_torch.functional as mpf
from metrics_tpu.functional.classification.calibration_error import _ce_compute as jax_ce_compute
from metrics_tpu.ops.kernels import use_backend
from metrics_tpu.parallel.collectives import class_reduce as jax_class_reduce
from metrics_tpu.parallel.collectives import reduce as jax_reduce
from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine
from metrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries, _ce_compute
from metrics_tpu_torch.parallel.collectives import class_reduce, reduce
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

ATOL = RTOL = 1e-6
C, X = 4, 3


def _inputs(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "multiclass_probs":
        p = rng.rand(n, C).astype(np.float32)
        return p / p.sum(1, keepdims=True), rng.randint(0, C, n)
    if kind == "multiclass_labels":
        return rng.randint(0, C, n), rng.randint(0, C, n)
    if kind == "absent_labels":  # the last class never occurs
        return rng.randint(0, C - 1, n), rng.randint(0, C - 1, n)
    if kind == "binary_probs":
        return rng.rand(n).astype(np.float32), rng.randint(0, 2, n)
    if kind == "binary_labels":
        return rng.randint(0, 2, n), rng.randint(0, 2, n)
    if kind == "multilabel_probs":
        return rng.rand(n, C).astype(np.float32), rng.randint(0, 2, (n, C))
    if kind == "mdmc_probs":
        p = rng.rand(n, C, X).astype(np.float32)
        return p / p.sum(1, keepdims=True), rng.randint(0, C, (n, X))
    if kind == "scores":  # hinge's unnormalised multiclass scores
        return rng.randn(n, C).astype(np.float32), rng.randint(0, C, n)
    if kind == "binary_scores":
        return rng.randn(n).astype(np.float32), rng.randint(0, 2, n)
    if kind == "distributions":  # KL's p and q
        p, q = rng.rand(n, C).astype(np.float32) + 0.05, rng.rand(n, C).astype(np.float32) + 0.05
        return p / p.sum(1, keepdims=True), q / q.sum(1, keepdims=True)
    if kind == "log_distributions":
        p, q = _inputs("distributions", n, seed)
        return np.log(p), np.log(q)
    raise ValueError(kind)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want, atol=ATOL):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w, atol)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, equal_nan=True)


def _states(m):
    return {k: getattr(m, k) for k in m._defaults}


def _mk(cls_name, **kw):
    return lambda m, **dev: getattr(m, cls_name)(**kw, **dev)


#: name -> (constructor over a package, input kind)
CASES = {}
for _avg in ("micro", "macro", "weighted", "none", "samples"):
    for _cls in ("Precision", "Recall", "Specificity"):
        CASES[f"{_cls}-{_avg}"] = (_mk(_cls, num_classes=C, average=_avg), "multiclass_probs")
for _cls in ("Precision", "Recall", "Specificity"):
    CASES[f"{_cls}-mdmc_global"] = (_mk(_cls, num_classes=C, average="macro", mdmc_average="global"), "mdmc_probs")
    CASES[f"{_cls}-mdmc_samplewise"] = (_mk(_cls, num_classes=C, average="micro", mdmc_average="samplewise"),
                                        "mdmc_probs")
    CASES[f"{_cls}-ignore_index_macro"] = (_mk(_cls, num_classes=C, average="macro", ignore_index=1),
                                           "multiclass_labels")
    CASES[f"{_cls}-ignore_index_micro"] = (_mk(_cls, num_classes=C, ignore_index=0), "multiclass_probs")
    CASES[f"{_cls}-multiclass_binary"] = (_mk(_cls, num_classes=2, average="macro", multiclass=True), "binary_probs")
    CASES[f"{_cls}-multiclass_false"] = (_mk(_cls, multiclass=False), "binary_labels")
    CASES[f"{_cls}-absent_class_none"] = (_mk(_cls, num_classes=C, average="none"), "absent_labels")
CASES.update({
    "HammingDistance-probs": (_mk("HammingDistance"), "multiclass_probs"),
    "HammingDistance-labels": (_mk("HammingDistance", num_classes=C), "multiclass_labels"),
    "HammingDistance-multilabel": (_mk("HammingDistance", threshold=0.3), "multilabel_probs"),
    "HammingDistance-binary": (_mk("HammingDistance"), "binary_probs"),
    "HammingDistance-multiclass_binary": (_mk("HammingDistance", num_classes=2, multiclass=True), "binary_probs"),
    "HammingDistance-mdmc": (_mk("HammingDistance"), "mdmc_probs"),
    "JaccardIndex": (_mk("JaccardIndex", num_classes=C), "multiclass_probs"),
    "JaccardIndex-labels": (_mk("JaccardIndex", num_classes=C), "multiclass_labels"),
    "JaccardIndex-ignore_index": (_mk("JaccardIndex", num_classes=C, ignore_index=0), "multiclass_probs"),
    "JaccardIndex-absent_score": (_mk("JaccardIndex", num_classes=C, absent_score=0.5), "absent_labels"),
    "JaccardIndex-none": (_mk("JaccardIndex", num_classes=C, reduction="none", ignore_index=2), "absent_labels"),
    "JaccardIndex-sum": (_mk("JaccardIndex", num_classes=C, reduction="sum"), "multiclass_probs"),
    "JaccardIndex-binary": (_mk("JaccardIndex", num_classes=2), "binary_probs"),
    "CohenKappa": (_mk("CohenKappa", num_classes=C), "multiclass_probs"),
    "CohenKappa-linear": (_mk("CohenKappa", num_classes=C, weights="linear"), "multiclass_labels"),
    "CohenKappa-quadratic": (_mk("CohenKappa", num_classes=C, weights="quadratic"), "multiclass_probs"),
    "CohenKappa-binary": (_mk("CohenKappa", num_classes=2, threshold=0.3), "binary_probs"),
    "MatthewsCorrCoef": (_mk("MatthewsCorrCoef", num_classes=C), "multiclass_probs"),
    "MatthewsCorrCoef-labels": (_mk("MatthewsCorrCoef", num_classes=C), "multiclass_labels"),
    "MatthewsCorrCoef-binary": (_mk("MatthewsCorrCoef", num_classes=2), "binary_probs"),
})
for _sq in (False, True):
    CASES[f"HingeLoss-binary-squared{_sq}"] = (_mk("HingeLoss", squared=_sq), "binary_scores")
    CASES[f"HingeLoss-crammer_singer-squared{_sq}"] = (_mk("HingeLoss", squared=_sq), "scores")
    CASES[f"HingeLoss-one_vs_all-squared{_sq}"] = (_mk("HingeLoss", squared=_sq, multiclass_mode="one-vs-all"),
                                                   "scores")
for _lp in (False, True):
    for _red in ("mean", "sum", "none"):
        CASES[f"KLDivergence-log_prob{_lp}-{_red}"] = (_mk("KLDivergence", log_prob=_lp, reduction=_red),
                                                       "log_distributions" if _lp else "distributions")
for _norm in ("l1", "l2", "max"):
    CASES[f"CalibrationError-{_norm}-binary"] = (_mk("CalibrationError", n_bins=7, norm=_norm), "binary_probs")
    CASES[f"CalibrationError-{_norm}-multiclass"] = (_mk("CalibrationError", norm=_norm), "multiclass_probs")
    CASES[f"CalibrationError-{_norm}-mdmc"] = (_mk("CalibrationError", n_bins=10, norm=_norm), "mdmc_probs")

#: cases whose every state is a fixed-shape sum, on inputs a vmapped row can
#: format (integer labels need the class count given): the engines serve
#: them. Left out: list states, and one-vs-all hinge, whose scalar measure
#: becomes (C,) at its first update (the JAX package's masked update fails on it)
DELTA = sorted(k for k in CASES if not k.startswith(("CalibrationError", "KLDivergence-log_probFalse-none",
                                                       "KLDivergence-log_probTrue-none"))
               and not any(w in k for w in ("samples", "samplewise", "multiclass_false", "one_vs_all")))


def _pair(name):
    make, kind = CASES[name]
    return make(mt), make(mp, device="cpu"), kind


@pytest.mark.parametrize("name", sorted(CASES))
def test_update_compute_matches_jax(name):
    jm, pm, kind = _pair(name)
    for seed in (0, 1):
        a, b = _inputs(kind, 48, seed)
        with use_backend("pallas_interpret"):
            jm.update(jnp.asarray(a), jnp.asarray(b))
        pm.update(torch.from_numpy(a), torch.from_numpy(b))
    for k, v in _states(jm).items():
        _assert_same(getattr(pm, k), v)
    with use_backend("pallas_interpret"):
        want = jm.compute()
    _assert_same(pm.compute(), want)
    pm.reset()
    for k, v in pm._defaults.items():
        got = getattr(pm, k)
        assert (got == []) if isinstance(v, list) else torch.equal(got, v)


@pytest.mark.parametrize("name", DELTA)
def test_update_state_masked_matches_jax(name):
    jm, pm, kind = _pair(name)
    a, b = _inputs(kind, 24, 3)
    mask = np.arange(24) < 17
    # garbage in the masked rows: huge and NaN scores, out-of-range labels
    a, b = a.copy(), b.copy()
    if a.dtype == np.float32:
        a[17:] = 1e6
        a[20:] = np.nan
    elif kind != "binary_labels":
        a[17:] = C + 2
    if b.dtype != np.float32 and b.ndim == 1 and "binary" not in kind:
        b[17:] = C + 2
    assert pm.masked_update_strategy() == jm.masked_update_strategy() == "delta"
    with use_backend("pallas_interpret"):
        want = jm.update_state_masked(jm.init_state(), jnp.asarray(a), jnp.asarray(b), mask=jnp.asarray(mask))
    got = pm.update_state_masked(pm.init_state(), torch.from_numpy(a), torch.from_numpy(b),
                                 mask=torch.from_numpy(mask))
    for k, v in want.items():
        _assert_same(got[k], v)
    # the masked update of the valid rows equals the plain update of those rows;
    # an ignored class counts -1 per row delta (in both packages), so there the
    # values agree and the sentinel counts do not
    ref = pm.update_state(pm.init_state(), torch.from_numpy(a[:17]), torch.from_numpy(b[:17]))
    if "ignore_index" in name:
        _assert_same(pm.compute_from(got), pm.compute_from(ref))
    else:
        for k, v in ref.items():
            _assert_same(got[k], v)


@pytest.mark.parametrize("name", DELTA)
def test_compute_runs_under_vmap(name):
    """The batched ``results()`` vmaps ``compute_from`` over streams: no
    branch may read the data, and each stream's value must be the plain
    compute's."""
    _, pm, kind = _pair(name)
    states = [pm.update_state(pm.init_state(), *map(torch.from_numpy, _inputs(kind, 40, s))) for s in range(3)]
    states.append(pm.init_state())  # a stream that saw nothing
    stacked = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    batched = torch.func.vmap(pm.compute_from)(stacked)
    for i, s in enumerate(states):
        _assert_same(batched[i], pm.compute_from(s))


FUNCTIONALS = [
    ("precision", {"average": "macro", "num_classes": C}, "multiclass_probs"),
    ("precision", {"average": "none", "num_classes": C}, "absent_labels"),
    ("precision", {"average": "micro", "mdmc_average": "samplewise"}, "mdmc_probs"),
    ("recall", {"average": "weighted", "num_classes": C}, "multiclass_probs"),
    ("recall", {"average": "samples", "num_classes": C}, "multilabel_probs"),
    ("recall", {"average": "macro", "num_classes": C, "ignore_index": 2, "top_k": 2}, "multiclass_probs"),
    ("precision_recall", {"average": "macro", "num_classes": C}, "multiclass_probs"),
    ("precision_recall", {"average": "micro", "mdmc_average": "global"}, "mdmc_probs"),
    ("specificity", {"average": "macro", "num_classes": C}, "multiclass_probs"),
    ("specificity", {"average": "weighted", "num_classes": C}, "multiclass_labels"),
    ("specificity", {"average": "none", "num_classes": C}, "absent_labels"),
    ("hamming_distance", {}, "multiclass_probs"),
    ("hamming_distance", {"threshold": 0.7}, "multilabel_probs"),
    ("hamming_distance", {"num_classes": C}, "multiclass_labels"),
    ("jaccard_index", {}, "multiclass_probs"),
    ("jaccard_index", {}, "multiclass_labels"),
    ("jaccard_index", {"num_classes": C, "ignore_index": 3, "absent_score": 1.0}, "absent_labels"),
    ("jaccard_index", {"num_classes": C, "reduction": "none"}, "multiclass_probs"),
    ("dice_score", {}, "multiclass_probs"),
    ("dice_score", {"bg": True, "reduction": "none"}, "multiclass_probs"),
    ("dice_score", {"bg": True, "no_fg_score": 0.25, "reduction": "sum"}, "absent_labels_probs"),
    ("dice_score", {}, "mdmc_probs"),
    ("cohen_kappa", {"num_classes": C}, "multiclass_probs"),
    ("cohen_kappa", {"num_classes": C, "weights": "linear"}, "multiclass_labels"),
    ("cohen_kappa", {"num_classes": C, "weights": "quadratic"}, "multiclass_probs"),
    ("matthews_corrcoef", {"num_classes": C}, "multiclass_probs"),
    ("matthews_corrcoef", {"num_classes": 2, "threshold": 0.6}, "binary_probs"),
    ("hinge_loss", {}, "binary_scores"),
    ("hinge_loss", {"squared": True}, "scores"),
    ("hinge_loss", {"multiclass_mode": "one-vs-all"}, "scores"),
    ("kl_divergence", {}, "distributions"),
    ("kl_divergence", {"log_prob": True, "reduction": "sum"}, "log_distributions"),
    ("kl_divergence", {"reduction": "none"}, "distributions"),
    ("calibration_error", {}, "multiclass_probs"),
    ("calibration_error", {"n_bins": 4, "norm": "l2"}, "binary_probs"),
    ("calibration_error", {"n_bins": 9, "norm": "max"}, "mdmc_probs"),
]


@pytest.mark.parametrize("fn,kwargs,kind", FUNCTIONALS)
def test_functional_matches_jax(fn, kwargs, kind):
    if kind == "absent_labels_probs":  # probabilities whose argmax never picks the last class
        a, b = _inputs("multiclass_probs", 64, 6)
        a[:, C - 1] = 0.0
        b = np.minimum(b, C - 2)
    else:
        a, b = _inputs(kind, 64, 6)
    with use_backend("pallas_interpret"):
        want = getattr(mtf, fn)(jnp.asarray(a), jnp.asarray(b), **kwargs)
    got = getattr(mpf, fn)(torch.from_numpy(a), torch.from_numpy(b), device="cpu", **kwargs)
    _assert_same(got, want)


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("debias", [False, True])
def test_calibration_compute_matches_jax(norm, debias):
    """``_ce_compute`` with every norm and ``debias``, on confidences that
    sit on bin boundaries and at 0 (in no bin), and an empty bin."""
    rng = np.random.RandomState(7)
    bounds = np.asarray(jnp.linspace(0, 1, 7, dtype=jnp.float32))
    conf = rng.rand(200).astype(np.float32) * 0.6
    conf[:20] = bounds[np.arange(20) % 7]  # on the boundaries of 6 bins, 0 included
    acc = (rng.rand(200) > 0.4).astype(np.float32)
    assert np.array_equal(_bin_boundaries(6).numpy(), bounds)
    with use_backend("pallas_interpret"):
        want = jax_ce_compute(jnp.asarray(conf), jnp.asarray(acc), jnp.asarray(bounds), norm=norm, debias=debias)
    got = _ce_compute(torch.from_numpy(conf), torch.from_numpy(acc), torch.from_numpy(bounds), norm=norm,
                      debias=debias)
    _assert_same(got, want)


@pytest.mark.parametrize("n_bins", [1, 3, 10, 15, 100])
def test_bin_boundaries_equal_jax_linspace(n_bins):
    want = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
    assert np.array_equal(_bin_boundaries(n_bins).numpy(), want)
    assert np.array_equal(mp.CalibrationError(n_bins=n_bins, device="cpu").bin_boundaries.numpy(),
                          np.asarray(mt.CalibrationError(n_bins=n_bins).bin_boundaries))


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none", None])
def test_reduce_matches_jax(reduction):
    x = np.random.RandomState(8).rand(5, 3).astype(np.float32)
    _assert_same(reduce(torch.from_numpy(x), reduction), jax_reduce(jnp.asarray(x), reduction))


@pytest.mark.parametrize("class_reduction", ["micro", "macro", "weighted", "none", None])
def test_class_reduce_matches_jax(class_reduction):
    rng = np.random.RandomState(9)
    num, denom, w = rng.randint(0, 9, 6), rng.randint(0, 12, 6), rng.randint(1, 5, 6)
    got = class_reduce(*(torch.from_numpy(v) for v in (num, denom, w)), class_reduction=class_reduction)
    _assert_same(got, jax_class_reduce(*(jnp.asarray(v) for v in (num, denom, w)), class_reduction=class_reduction))


def test_reductions_raise_on_unknown_names():
    with pytest.raises(ValueError):
        reduce(torch.zeros(2), "median")
    with pytest.raises(ValueError):
        class_reduce(torch.ones(2), torch.ones(2), torch.ones(2), "geometric")


def test_states_keep_jax_dtypes():
    for name in CASES:
        jm, pm, _ = _pair(name)
        for k, v in jm._defaults.items():
            if isinstance(v, list):
                assert getattr(pm, k) == [], (name, k)
            else:
                assert str(getattr(pm, k).dtype).replace("torch.", "") == str(jnp.asarray(v).dtype), (name, k)


@pytest.mark.parametrize("alias,name,kw", [("IoU", "JaccardIndex", {"num_classes": C}),
                                           ("MatthewsCorrcoef", "MatthewsCorrCoef", {"num_classes": C}),
                                           ("Hinge", "HingeLoss", {})])
def test_deprecated_aliases_warn_and_match(alias, name, kw):
    with pytest.warns(DeprecationWarning):
        old = getattr(mp, alias)(device="cpu", **kw)
    assert isinstance(old, getattr(mp, name))
    with pytest.warns(DeprecationWarning):
        a, b = _inputs("scores", 32, 2)
        _assert_same(mpf.hinge(torch.from_numpy(a), torch.from_numpy(b)),
                     mpf.hinge_loss(torch.from_numpy(a), torch.from_numpy(b)))


def test_exports_follow_jax():
    names = ["CalibrationError", "CohenKappa", "HammingDistance", "Hinge", "HingeLoss", "IoU", "JaccardIndex",
             "KLDivergence", "MatthewsCorrCoef", "MatthewsCorrcoef", "Precision", "Recall", "Specificity"]
    fnames = ["calibration_error", "cohen_kappa", "dice_score", "hamming_distance", "hinge", "hinge_loss",
              "jaccard_index", "kl_divergence", "matthews_corrcoef", "precision", "precision_recall", "recall",
              "specificity"]
    for n in names:
        assert hasattr(mt, n) and n in mp.__all__ and getattr(mp, n) is getattr(mp.classification, n), n
    for n in fnames:
        assert hasattr(mtf, n) and n in mpf.__all__, n
    from metrics_tpu_torch.functional.classification.hinge import MulticlassMode

    assert MulticlassMode.ONE_VS_ALL == "one-vs-all"


def test_argument_checks_match_jax():
    for bad in ({"average": "median"}, {"mdmc_average": "all", "num_classes": C}, {"average": "macro"},
                {"num_classes": C, "ignore_index": C, "average": "macro"}):
        for pkg, kw in ((mt, {}), (mp, {"device": "cpu"})):
            with pytest.raises(ValueError):
                pkg.Precision(**bad, **kw)
    with pytest.raises(ValueError):
        mp.CohenKappa(num_classes=C, weights="cubic", device="cpu")
    with pytest.raises(ValueError):
        mp.HingeLoss(multiclass_mode="all-vs-all", device="cpu")
    with pytest.raises(ValueError):
        mp.KLDivergence(reduction="max", device="cpu")
    with pytest.raises(ValueError):
        mp.CalibrationError(norm="l3", device="cpu")
    with pytest.raises(ValueError):
        mp.CalibrationError(n_bins=0, device="cpu")
    with pytest.raises(RuntimeError):
        mpf.kl_divergence(torch.ones(3, 2), torch.ones(3, 3))
    with pytest.raises(ValueError):
        mpf.hinge_loss(torch.ones(3, 2, 2), torch.ones(3))
    with pytest.raises(ValueError):
        mpf.dice_score(torch.ones(3), torch.ones(3))


@pytest.mark.parametrize("make", [lambda: mp.CalibrationError(device="cpu"),
                                  lambda: mp.KLDivergence(reduction="none", device="cpu"),
                                  lambda: mp.Precision(num_classes=C, average="samples", device="cpu")])
def test_engines_refuse_list_states_with_jax_reason(make):
    pm = make()
    jm = {"CalibrationError": lambda: mt.CalibrationError(), "KLDivergence": lambda: mt.KLDivergence(reduction="none"),
          "Precision": lambda: mt.Precision(num_classes=C, average="samples")}[type(pm).__name__]()
    assert pm.masked_update_strategy() is None
    assert pm.masked_update_unsupported_reason() == jm.masked_update_unsupported_reason()
    assert pm.segmented_update_unsupported_reason() == jm.segmented_update_unsupported_reason()
    assert "list (cat/gather) state" in pm.masked_update_unsupported_reason()
    with pytest.raises(MetricsTPUUserError, match="list"):
        StreamingEngine(pm, EngineConfig(buckets=(8,)))
    with pytest.raises(MetricsTPUUserError, match="list"):
        MultiStreamEngine(pm, 3, EngineConfig(buckets=(8,)))
    with pytest.raises(MetricsTPUUserError, match="list"):
        MultiStreamEngine(mp.MetricCollection({"ok": mp.HammingDistance(device="cpu"), "no": pm}), 3,
                          EngineConfig(buckets=(8,)), stream_shard=True)


def test_calibration_error_sums_through_one_histogram_call(monkeypatch):
    """The three per-bin sums are one weighted histogram call (one K2 launch
    on the card)."""
    ce = importlib.import_module("metrics_tpu_torch.functional.classification.calibration_error")

    calls = []
    real = ce.histogram_accumulate

    def spy(idx, length, weights=None, mask=None):
        calls.append((tuple(idx.shape), length, None if weights is None else tuple(weights.shape)))
        return real(idx, length, weights=weights, mask=mask)

    monkeypatch.setattr(ce, "histogram_accumulate", spy)
    m = mp.CalibrationError(n_bins=15, device="cpu")
    a, b = _inputs("multiclass_probs", 100, 3)
    m.update(torch.from_numpy(a), torch.from_numpy(b))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.compute()
    assert calls == [((100,), 15, (100, 3))]
