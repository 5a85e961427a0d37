"""The port's exact curves, the scan masked strategy and the aggregators
against the JAX package, on the CPU.

AUC, ROC, PrecisionRecallCurve, AveragePrecision, AUROC (default list states
and ``capacity=N`` buffers), BinnedRecallAtFixedPrecision, the curve
functionals, ``ops/masked_curves.py``, the scan masked update
(``Metric._masked_update_scan``), the aggregators and the state bridge of a
capacity state. Each takes the same numpy inputs, made from a seed, as its
``metrics_tpu`` twin. Tolerances: integer states, capacity buffers, ``count``
and ``overflow`` bit-exact; f32 values within ``rtol=1e-6`` plus
``atol=1e-6`` (the sorts and curves see the same f32 inputs; only the f32
sums of ranks, trapezoids and averages may add in another order, and at these
sizes, under 100 rows, they stay far inside it). Masked rows are filled with
garbage: huge and NaN scores, out-of-range labels.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.functional as mtf
import metrics_tpu_torch as mp
import metrics_tpu_torch.functional as mpf
from metrics_tpu.ops import masked_curves as jax_curves
from metrics_tpu.ops.kernels import use_backend
from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine
from metrics_tpu_torch.ops import masked_curves as port_curves
from metrics_tpu_torch.utils.enums import DataType
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.state_bridge import engine_state_from_numpy, state_from_numpy

ATOL = RTOL = 1e-6
C = 4


def _inputs(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "binary":
        return rng.rand(n).astype(np.float32), rng.randint(0, 2, n)
    if kind == "binary_ties":  # five distinct scores: long tie groups
        return (rng.randint(0, 5, n) / 4).astype(np.float32), rng.randint(0, 2, n)
    if kind == "multiclass":
        p = rng.rand(n, C).astype(np.float32)
        return p / p.sum(1, keepdims=True), rng.randint(0, C, n)
    if kind == "multiclass_ties":
        p = (rng.randint(1, 4, (n, C)) / 4).astype(np.float32)
        return p / p.sum(1, keepdims=True), rng.randint(0, C, n)
    if kind == "multiclass_absent":  # the last class is never a label
        p = rng.rand(n, C).astype(np.float32)
        return p / p.sum(1, keepdims=True), rng.randint(0, C - 1, n)
    if kind == "multilabel":
        return rng.rand(n, C).astype(np.float32), rng.randint(0, 2, (n, C))
    raise ValueError(kind)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


def _states(m):
    return {k: getattr(m, k) for k in m._defaults}


def _mk(cls_name, **kw):
    return lambda m, **dev: getattr(m, cls_name)(**kw, **dev)


# --------------------------------------------------------------------------- functionals

FUNCTIONALS = [
    ("roc", {}, "binary"),
    ("roc", {}, "binary_ties"),
    ("roc", {"pos_label": 0}, "binary"),
    ("roc", {"num_classes": C}, "multiclass"),
    ("roc", {"num_classes": C}, "multilabel"),
    ("auroc", {}, "binary"),
    ("auroc", {}, "binary_ties"),
    ("auroc", {"max_fpr": 0.5}, "binary"),
    ("auroc", {"max_fpr": 0.3}, "binary_ties"),
    ("auroc", {"num_classes": C}, "multiclass"),
    ("auroc", {"num_classes": C, "average": "weighted"}, "multiclass"),
    ("auroc", {"num_classes": C, "average": "none"}, "multiclass_ties"),
    ("auroc", {"num_classes": C, "average": None}, "multiclass"),  # both packages raise
    ("auroc", {"num_classes": C, "average": "weighted"}, "multiclass_absent"),
    ("auroc", {"num_classes": C}, "multilabel"),
    ("auroc", {"num_classes": C, "average": "weighted"}, "multilabel"),
    ("auroc", {"num_classes": C, "average": "micro"}, "multilabel"),
    ("auroc", {"num_classes": C, "average": "none"}, "multilabel"),
    ("average_precision", {}, "binary_ties"),
    ("average_precision", {"num_classes": C}, "multiclass"),
    ("average_precision", {"num_classes": C, "average": "weighted"}, "multiclass"),
    ("average_precision", {"num_classes": C, "average": None}, "multiclass_ties"),
    ("average_precision", {"num_classes": C, "average": "micro"}, "multilabel"),
    ("precision_recall_curve", {}, "binary_ties"),
    ("precision_recall_curve", {"num_classes": C}, "multiclass"),
    ("precision_recall_curve", {"num_classes": C}, "multilabel"),
]


@pytest.mark.parametrize("fn,kwargs,kind", FUNCTIONALS)
def test_functional_matches_jax(fn, kwargs, kind):
    a, b = _inputs(kind, 48, 7)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        try:
            want = getattr(mtf, fn)(jnp.asarray(a), jnp.asarray(b), **kwargs)
        except ValueError as e:
            want = e
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        if isinstance(want, ValueError):
            with pytest.raises(ValueError) as err:
                getattr(mpf, fn)(torch.from_numpy(a), torch.from_numpy(b), device="cpu", **kwargs)
            assert str(err.value) == str(want)
        else:
            _assert_same(getattr(mpf, fn)(torch.from_numpy(a), torch.from_numpy(b), device="cpu", **kwargs), want)
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]


@pytest.mark.parametrize("case", ["increasing", "decreasing", "reorder"])
def test_auc_matches_jax(case):
    rng = np.random.RandomState(3)
    x = np.sort(rng.rand(30).astype(np.float32))
    y = rng.rand(30).astype(np.float32)
    if case == "decreasing":
        x = x[::-1].copy()
    if case == "reorder":
        x = rng.permutation(x)
    kw = {"reorder": case == "reorder"}
    _assert_same(mpf.auc(torch.from_numpy(x), torch.from_numpy(y), **kw), mtf.auc(jnp.asarray(x), jnp.asarray(y), **kw))
    jm, pm = mt.AUC(**kw), mp.AUC(device="cpu", **kw)
    for lo in (0, 15):
        jm.update(jnp.asarray(x[lo:lo + 15]), jnp.asarray(y[lo:lo + 15]))
        pm.update(torch.from_numpy(x[lo:lo + 15]), torch.from_numpy(y[lo:lo + 15]))
    _assert_same(pm.compute(), jm.compute())


def test_auc_rejects_what_jax_rejects():
    x = torch.tensor([0.0, 2.0, 1.0])
    with pytest.raises(ValueError, match="neither increasing or decreasing"):
        mpf.auc(x, x)
    with pytest.raises(ValueError, match="same number of elements"):
        mpf.auc(torch.ones(3), torch.ones(4))


def test_weighted_auroc_drops_an_unobserved_class_with_jax_warning():
    a, b = _inputs("multiclass_absent", 48, 2)
    with pytest.warns(UserWarning, match=f"Class {C - 1} had 0 observations"):
        got = mpf.auroc(torch.from_numpy(a), torch.from_numpy(b), num_classes=C, average="weighted")
    with pytest.warns(UserWarning, match=f"Class {C - 1} had 0 observations"):
        want = mtf.auroc(jnp.asarray(a), jnp.asarray(b), num_classes=C, average="weighted")
    _assert_same(got, want)


# --------------------------------------------------------------------------- classes

#: name -> (constructor over a package, input kind)
CLASSES = {
    "AUROC-binary": (_mk("AUROC"), "binary"),
    "AUROC-binary_max_fpr": (_mk("AUROC", max_fpr=0.4), "binary_ties"),
    "AUROC-macro": (_mk("AUROC", num_classes=C), "multiclass"),
    "AUROC-weighted": (_mk("AUROC", num_classes=C, average="weighted"), "multiclass_ties"),
    "AUROC-multilabel": (_mk("AUROC", num_classes=C), "multilabel"),
    "AveragePrecision-binary": (_mk("AveragePrecision"), "binary_ties"),
    "AveragePrecision-macro": (_mk("AveragePrecision", num_classes=C), "multiclass"),
    "AveragePrecision-weighted": (_mk("AveragePrecision", num_classes=C, average="weighted"), "multiclass"),
    "AveragePrecision-multilabel_none": (_mk("AveragePrecision", num_classes=C, average=None), "multilabel"),
    "ROC-binary": (_mk("ROC"), "binary_ties"),
    "ROC-multiclass": (_mk("ROC", num_classes=C), "multiclass"),
    "PrecisionRecallCurve-binary": (_mk("PrecisionRecallCurve"), "binary"),
    "PrecisionRecallCurve-multiclass": (_mk("PrecisionRecallCurve", num_classes=C), "multiclass_ties"),
    "BinnedRecallAtFixedPrecision-binary": (_mk("BinnedRecallAtFixedPrecision", num_classes=1, min_precision=0.5),
                                            "binary"),
    "BinnedRecallAtFixedPrecision-multiclass": (
        _mk("BinnedRecallAtFixedPrecision", num_classes=C, min_precision=0.3, thresholds=11), "multiclass"),
}

#: capacity-mode cases: name -> (constructor, input kind); 2 batches of 24 rows into 64 slots
CAPACITY = {
    "AUROC-binary": (_mk("AUROC", capacity=64), "binary"),
    "AUROC-binary_ties": (_mk("AUROC", capacity=64), "binary_ties"),
    "AUROC-macro": (_mk("AUROC", num_classes=C, capacity=64), "multiclass"),
    "AUROC-weighted": (_mk("AUROC", num_classes=C, average="weighted", capacity=64), "multiclass_ties"),
    "AUROC-none": (_mk("AUROC", num_classes=C, average=None, capacity=64), "multiclass"),
    "AUROC-absent_class": (_mk("AUROC", num_classes=C, average="weighted", capacity=64), "multiclass_absent"),
    "AUROC-multilabel": (_mk("AUROC", num_classes=C, capacity=64), "multilabel"),
    "AveragePrecision-binary": (_mk("AveragePrecision", capacity=64), "binary_ties"),
    "AveragePrecision-macro": (_mk("AveragePrecision", num_classes=C, capacity=64), "multiclass"),
    "AveragePrecision-weighted": (_mk("AveragePrecision", num_classes=C, average="weighted", capacity=64),
                                  "multiclass_ties"),
    "AveragePrecision-none": (_mk("AveragePrecision", num_classes=C, average=None, capacity=64), "multiclass_absent"),
    "ROC-binary": (_mk("ROC", capacity=64), "binary_ties"),
    "ROC-multiclass": (_mk("ROC", num_classes=C, capacity=64), "multiclass"),
    "PrecisionRecallCurve-binary": (_mk("PrecisionRecallCurve", capacity=64), "binary_ties"),
    "PrecisionRecallCurve-multilabel": (_mk("PrecisionRecallCurve", num_classes=C, capacity=64), "multilabel"),
}


def _run_pair(make, kind, n=24, batches=2):
    jm, pm = make(mt), make(mp, device="cpu")
    for seed in range(batches):
        a, b = _inputs(kind, n, seed)
        jm.update(jnp.asarray(a), jnp.asarray(b))
        pm.update(torch.from_numpy(a), torch.from_numpy(b))
    return jm, pm


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_matches_jax(name):
    jm, pm = _run_pair(*CLASSES[name])
    with use_backend("pallas_interpret"):
        want = jm.compute()
    _assert_same(pm.compute(), want)


@pytest.mark.parametrize("name", sorted(CAPACITY))
def test_capacity_mode_matches_jax(name):
    jm, pm = _run_pair(*CAPACITY[name])
    for k, v in _states(jm).items():
        _assert_same(getattr(pm, k), v)  # buffers, count and overflow bit-exact
    assert pm.masked_update_strategy() == jm.masked_update_strategy() == "scan"
    _assert_same(pm.compute(), jm.compute())


@pytest.mark.parametrize("name", ["AUROC-weighted", "AveragePrecision-macro", "ROC-multiclass",
                                  "PrecisionRecallCurve-binary"])
def test_capacity_compute_runs_under_vmap(name):
    """The batched ``results()`` vmaps ``compute_from`` over streams: the
    value of each stream equals its own compute, with no warning."""
    make, kind = CAPACITY[name]
    pm = make(mp, device="cpu")
    states = [pm.update_state(pm.init_state(), *map(torch.from_numpy, _inputs(kind, 20, s))) for s in range(3)]
    states.append(pm.init_state())  # a stream that saw nothing
    stacked = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        batched = torch.func.vmap(pm.compute_from)(stacked)
    for i, s in enumerate(states):
        want = pm.compute_from(s)
        _assert_same([b[i] for b in batched] if isinstance(want, tuple) else batched[i], want)


@pytest.mark.parametrize("cls", ["AUROC", "AveragePrecision"])
def test_capacity_overflow_is_nan_with_jax_warning(cls):
    jm, pm = getattr(mt, cls)(capacity=40), getattr(mp, cls)(capacity=40, device="cpu")
    for seed in range(3):
        a, b = _inputs("binary", 16, seed)
        jm.update(jnp.asarray(a), jnp.asarray(b))
        pm.update(torch.from_numpy(a), torch.from_numpy(b))
    for k, v in _states(jm).items():
        _assert_same(getattr(pm, k), v)
    assert int(pm.count) == 32 and int(pm.overflow) == 1  # the third batch did not fit: no write
    with pytest.warns(UserWarning, match="overflowed") as pw:
        got = pm.compute()
    with pytest.warns(UserWarning, match="overflowed") as jw:
        jm.compute()
    assert str(pw[0].message) == str(jw[0].message)
    assert torch.isnan(got)


def test_a_batch_larger_than_the_capacity_raises_as_jax():
    a, b = _inputs("binary", 20, 0)
    with pytest.raises(ValueError) as je:
        mt.AUROC(capacity=16).update(jnp.asarray(a), jnp.asarray(b))
    with pytest.raises(ValueError) as pe:
        mp.AUROC(capacity=16, device="cpu").update(torch.from_numpy(a), torch.from_numpy(b))
    assert str(pe.value) == str(je.value)


ARGUMENT_ERRORS = [
    ("AUROC", {"capacity": 0}),
    ("AUROC", {"capacity": 2.5}),
    ("AUROC", {"capacity": 8, "max_fpr": 0.5}),
    ("AUROC", {"max_fpr": 1.5}),
    ("AUROC", {"capacity": 8, "pos_label": 0}),
    ("AUROC", {"capacity": 8, "average": "micro"}),
    ("AUROC", {"average": "samples"}),
    ("AveragePrecision", {"capacity": 8, "average": "micro"}),
    ("AveragePrecision", {"capacity": 8, "pos_label": 2}),
    ("AveragePrecision", {"average": "samples"}),
    ("ROC", {"capacity": -1}),
    ("ROC", {"capacity": 8, "pos_label": 0}),
    ("PrecisionRecallCurve", {"capacity": 8, "pos_label": 0}),
]


@pytest.mark.parametrize("cls,kwargs", ARGUMENT_ERRORS)
def test_argument_errors_match_jax(cls, kwargs):
    with pytest.raises(ValueError) as je:
        getattr(mt, cls)(**kwargs)
    with pytest.raises(ValueError) as pe:
        getattr(mp, cls)(device="cpu", **kwargs)
    assert str(pe.value) == str(je.value)


def test_a_row_of_one_infers_the_whole_batch_mode():
    """The scan updates batch-of-1 rows: a (1, C) float row with a (1,) label
    must latch multiclass, as the whole batch does."""
    a, b = _inputs("multiclass", 5, 0)
    for rows in (slice(0, 1), slice(0, 5)):
        m = mp.AUROC(num_classes=C, capacity=8, device="cpu")
        m.update(torch.from_numpy(a[rows]), torch.from_numpy(b[rows]))
        assert m.mode == DataType.MULTICLASS
    m = mp.AUROC(capacity=8, device="cpu")
    m.update(torch.from_numpy(a[:1, 0]), torch.from_numpy(b[:1] % 2))
    assert m.mode == DataType.BINARY


@pytest.mark.parametrize("kind", ["binary", "binary_ties"])
def test_masked_curve_kernels_match_jax(kind):
    a, b = _inputs(kind, 48, 4)
    valid = np.random.RandomState(5).rand(48) > 0.3
    for fn in ("masked_binary_auroc", "masked_binary_average_precision", "masked_binary_roc",
               "masked_binary_pr_curve"):
        want = getattr(jax_curves, fn)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid))
        got = getattr(port_curves, fn)(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(valid))
        _assert_same(list(got) if isinstance(got, tuple) else got, list(want) if isinstance(want, tuple) else want)


# --------------------------------------------------------------------------- the scan strategy

def _garbage_bucket(kind, n, valid, seed):
    a, b = _inputs(kind, n, seed)
    a, b = a.copy(), b.copy()
    a[valid:] = 1e6
    a[valid + 1::2] = np.nan
    if b.ndim == 1:
        b[valid:] = C + 3
    return a, b, np.arange(n) < valid


@pytest.mark.parametrize("make,kind", [
    (_mk("AUROC", num_classes=C, capacity=32), "multiclass"),
    (_mk("AveragePrecision", capacity=32), "binary_ties"),
    (_mk("ROC", num_classes=C, capacity=32), "multilabel"),
])
def test_scan_masked_update_matches_jax(make, kind):
    jm, pm = make(mt), make(mp, device="cpu")
    jstate, pstate = jm.init_state(), pm.init_state()
    for seed, valid in ((0, 9), (1, 12), (2, 3)):
        a, b, mask = _garbage_bucket(kind, 12, valid, seed)
        jstate = jm.update_state_masked(jstate, jnp.asarray(a), jnp.asarray(b), mask=jnp.asarray(mask))
        pstate = pm.update_state_masked(pstate, torch.from_numpy(a), torch.from_numpy(b), mask=torch.from_numpy(mask))
    for k, v in jstate.items():
        _assert_same(pstate[k], v)
    assert int(pstate["count"]) == 24
    # the valid rows applied in one plain update give the same buffers
    ref = pm.init_state()
    for seed, valid in ((0, 9), (1, 12), (2, 3)):
        a, b = _inputs(kind, 12, seed)
        ref = pm.update_state(ref, torch.from_numpy(a[:valid]), torch.from_numpy(b[:valid]))
    for k in ref:
        assert torch.equal(pstate[k], ref[k]), k


@pytest.mark.parametrize("make,kind", [
    (_mk("Accuracy"), "multiclass"),
    (_mk("ConfusionMatrix", num_classes=C), "multiclass"),
    (_mk("MeanMetric"), None),
    (_mk("MaxMetric"), None),
])
def test_scan_equals_delta_on_a_delta_metric(make, kind):
    """On a delta-mergeable metric the sequential fold and the vmapped
    row-delta fold are both exact: they must agree with each other and
    with the JAX package's scan."""
    jm, pm = make(mt), make(mp, device="cpu")
    if kind is None:  # the aggregators' one input, NaN-free in the valid rows
        rng = np.random.RandomState(9)
        args = (rng.randn(12).astype(np.float32) * 3,)
        args[0][8:] = np.nan
    else:
        a, b, _ = _garbage_bucket(kind, 12, 8, 9)
        args = (a, b)
    mask = np.arange(12) < 8
    with use_backend("pallas_interpret"):
        want = jm._masked_update_scan(jm.init_state(), tuple(map(jnp.asarray, args)), {}, jnp.asarray(mask))
    got = pm._masked_update_scan(pm.init_state(), tuple(map(torch.from_numpy, args)), {}, torch.from_numpy(mask))
    delta = pm.update_state_masked(pm.init_state(), *map(torch.from_numpy, args), mask=torch.from_numpy(mask))
    for k, v in want.items():
        _assert_same(got[k], v)
        _assert_same(delta[k], got[k])


def test_collection_reports_each_member_strategy():
    coll = mp.MetricCollection([mp.Accuracy(device="cpu"), mp.AUROC(capacity=8, device="cpu"),
                                mp.AveragePrecision(device="cpu")])
    jcoll = mt.MetricCollection([mt.Accuracy(), mt.AUROC(capacity=8), mt.AveragePrecision()])
    assert coll.masked_update_strategies() == jcoll.masked_update_strategies() == {
        "Accuracy": "delta", "AUROC": "scan", "AveragePrecision": None}
    assert coll.masked_update_unsupported_reason() == jcoll.masked_update_unsupported_reason()


# --------------------------------------------------------------------------- engines

def _ragged(kind, seed, count, hi):
    rng = np.random.RandomState(seed)
    return [_inputs(kind, int(rng.randint(1, hi)), seed * 100 + i) for i in range(count)]


@pytest.mark.parametrize("backend", ["megastep", "auto"])
def test_streaming_engine_serves_a_capacity_member_as_jax(backend):
    """``[Accuracy(), AUROC(capacity=64)]`` through the port's engine, ragged
    batches coalesced: buffers bit-equal to the JAX package's eager capacity
    state, and under megastep the JAX engine's pinned fallback reasons
    (``tests/engine/test_megastep.py``): every dtype the scan member touches
    is demoted."""
    batches = _ragged("binary", 4, 7, 12)
    jcoll = mt.MetricCollection([mt.Accuracy(), mt.AUROC(capacity=64)])
    for a, b in batches:
        jcoll.update(jnp.asarray(a), jnp.asarray(b))
    eng = StreamingEngine(mp.MetricCollection([mp.Accuracy(device="cpu"), mp.AUROC(capacity=64, device="cpu")]),
                          EngineConfig(buckets=(8, 32), kernel_backend=backend, coalesce=8))
    with eng._state_lock:  # the dispatcher finds the whole backlog queued: batches coalesce
        for a, b in batches:
            eng.submit(torch.from_numpy(a), torch.from_numpy(b))
    eng.flush()
    assert eng.stats.batches_coalesced >= 2 and eng.steps < len(batches)
    state = eng.state()
    for k, m in jcoll.items(keep_base=True):
        for s, v in _states(m).items():
            _assert_same(state[k][s], v)
    got = eng.result()
    for k, v in jcoll.compute().items():
        _assert_same(got[k], v)
    want_reasons = {"dtype.bool:strategy": 1, "dtype.float32:strategy": 1, "dtype.int32:strategy": 1}
    assert eng.stats.kernel_fallbacks_by_reason() == (want_reasons if backend == "megastep" else {})


@pytest.mark.parametrize("stream_shard", [False, True])
def test_multistream_engines_refuse_a_scan_member_with_jax_reason(stream_shard):
    pm, jm = mp.AUROC(capacity=16, device="cpu"), mt.AUROC(capacity=16)
    reason = jm.segmented_update_unsupported_reason()
    assert reason and pm.segmented_update_unsupported_reason() == reason
    kw = {"stream_shard": True, "resident_streams": 2} if stream_shard else {}
    coll = mp.MetricCollection({"acc": mp.Accuracy(device="cpu"), "auroc": pm})
    with pytest.raises(MetricsTPUUserError) as err:
        MultiStreamEngine(coll, 4, EngineConfig(buckets=(8,), kernel_backend="megastep"), **kw)
    assert f"member 'auroc': {reason}" in str(err.value)


# --------------------------------------------------------------------------- aggregators

AGGREGATORS = [(cls, strategy) for cls in ("MaxMetric", "MinMetric", "SumMetric", "MeanMetric", "CatMetric")
               for strategy in ("warn", "ignore", 2.5)]


@pytest.mark.parametrize("cls,strategy", AGGREGATORS)
def test_aggregator_matches_jax(cls, strategy):
    jm, pm = getattr(mt, cls)(nan_strategy=strategy), getattr(mp, cls)(nan_strategy=strategy, device="cpu")
    rng = np.random.RandomState(11)
    for i in range(3):
        v = rng.randn(7).astype(np.float32)
        v[i::3] = np.nan
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jm.update(jnp.asarray(v))
        with warnings.catch_warnings(record=True) as pw:
            warnings.simplefilter("always")
            pm.update(torch.from_numpy(v))
        assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    jm.update(1.5)
    pm.update(1.5)
    _assert_same(pm.compute(), jm.compute())


def test_aggregator_error_strategy_and_weights_match_jax():
    for pkg, kw in ((mt, {}), (mp, {"device": "cpu"})):
        with pytest.raises(RuntimeError, match="Encountered `nan`"):
            pkg.SumMetric(nan_strategy="error", **kw).update(np.array([1.0, np.nan], np.float32))
        with pytest.raises(ValueError, match="nan_strategy"):
            pkg.MeanMetric(nan_strategy="drop", **kw)
    jm, pm = mt.MeanMetric(), mp.MeanMetric(device="cpu")
    v, w = np.array([1.0, 2.0, np.nan, 4.0], np.float32), np.array([0.5, 1.0, 2.0, 3.0], np.float32)
    jm.update(jnp.asarray(v), jnp.asarray(w))
    pm.update(torch.from_numpy(v), torch.from_numpy(w))
    _assert_same(pm.compute(), jm.compute())
    assert mp.CatMetric(device="cpu").compute().shape == (0,)


def test_aggregators_warn_and_ignore_under_vmap():
    m = mp.SumMetric(nan_strategy="error", device="cpu")
    v = torch.tensor([1.0, float("nan"), 2.0])
    with pytest.warns(UserWarning, match="treating as 'ignore'"):
        state = m.update_state_masked(m.init_state(), v, mask=torch.ones(3, dtype=torch.bool))
    assert float(state["value"]) == 3.0


@pytest.mark.parametrize("engine", ["streaming", "multistream", "paged"])
def test_mean_metric_through_the_engines(engine):
    rng = np.random.RandomState(13)
    batches = [(i % 3, rng.randn(int(rng.randint(1, 10))).astype(np.float32)) for i in range(9)]
    coll = mp.MetricCollection({"mean": mp.MeanMetric(device="cpu"), "max": mp.MaxMetric(device="cpu"),
                                "sum": mp.SumMetric(device="cpu")})
    cfg = EngineConfig(buckets=(4, 16), kernel_backend="megastep")
    if engine == "streaming":
        eng = StreamingEngine(coll, cfg)
        with eng:
            for _, v in batches:
                eng.submit(torch.from_numpy(v))
        streams = {None: [v for _, v in batches]}
    else:
        kw = {"stream_shard": True, "resident_streams": 2} if engine == "paged" else {}
        eng = MultiStreamEngine(coll, 3, cfg, **kw)
        with eng:
            for sid, v in batches:
                eng.submit(sid, torch.from_numpy(v))
        streams = {s: [v for sid, v in batches if sid == s] for s in range(3)}
    # the delta members demote nothing (the unsharded engine has no megastep layout at all)
    assert not any(r.endswith(":strategy") for r in eng.stats.kernel_fallbacks_by_reason())
    for sid, vs in streams.items():
        jcoll = mt.MetricCollection({"mean": mt.MeanMetric(), "max": mt.MaxMetric(), "sum": mt.SumMetric()})
        for v in vs:
            jcoll.update(jnp.asarray(v))
        got = eng.result() if sid is None else eng.result(sid)
        for k, v in jcoll.compute().items():
            _assert_same(got[k], v)


def test_cat_metric_is_refused_with_jax_reason():
    pm, jm = mp.CatMetric(device="cpu"), mt.CatMetric()
    assert pm.masked_update_unsupported_reason() == jm.masked_update_unsupported_reason()
    with pytest.raises(MetricsTPUUserError, match="list"):
        StreamingEngine(pm, EngineConfig(buckets=(8,)))


# --------------------------------------------------------------------------- bridge, exports

def test_state_bridge_carries_a_jax_capacity_auroc():
    """A JAX capacity AUROC (bool ``valid_buf``, int32 ``count`` and
    ``overflow``, ``mode`` as a host attribute) finishes in the port: its
    state is seated bit-exactly, one more update lands after the JAX rows, and
    the values agree."""
    jm = mt.AUROC(num_classes=C, capacity=64)
    a, b = _inputs("multiclass", 24, 1)
    jm.update(jnp.asarray(a), jnp.asarray(b))
    np_state = jax.tree.map(np.asarray, _states(jm))
    pm = mp.AUROC(num_classes=C, capacity=64, device="cpu")
    state = state_from_numpy(pm, np_state, device="cpu", host_attrs=jm.host_compute_attrs())
    assert pm.mode == DataType.MULTICLASS and state["valid_buf"].dtype == torch.bool
    for k, v in np_state.items():
        _assert_same(state[k], v)
    a2, b2 = _inputs("multiclass", 12, 2)
    jm.update(jnp.asarray(a2), jnp.asarray(b2))
    state = pm.update_state(state, torch.from_numpy(a2), torch.from_numpy(b2))
    for k, v in _states(jm).items():
        _assert_same(state[k], v)
    _assert_same(pm.compute_from(state), jm.compute())


def test_state_bridge_seats_a_capacity_arena_in_the_engine():
    jcoll = mt.MetricCollection([mt.Accuracy(), mt.AUROC(capacity=32)])
    a, b = _inputs("binary", 10, 3)
    jcoll.update(jnp.asarray(a), jnp.asarray(b))
    layout = jcoll.arena_layout()
    jstate = {k: _states(m) for k, m in jcoll.items(keep_base=True)}
    arena = {k: np.asarray(v) for k, v in layout.pack(jstate).items()}
    eng = StreamingEngine(mp.MetricCollection([mp.Accuracy(device="cpu"), mp.AUROC(capacity=32, device="cpu")]),
                          EngineConfig(buckets=(8,), kernel_backend="megastep"))
    engine_state_from_numpy(eng, arena, layout.leaf_slices(), host_attrs={})
    eng._metric["AUROC"].restore_host_compute_attrs(jcoll["AUROC"].host_compute_attrs())
    eng._metric["Accuracy"].restore_host_compute_attrs(jcoll["Accuracy"].host_compute_attrs())
    a2, b2 = _inputs("binary", 6, 4)
    jcoll.update(jnp.asarray(a2), jnp.asarray(b2))
    with eng:
        eng.submit(torch.from_numpy(a2), torch.from_numpy(b2))
    state = eng.state()
    for k, m in jcoll.items(keep_base=True):
        for s, v in _states(m).items():
            _assert_same(state[k][s], v)


def test_exports_follow_jax():
    names = ["AUC", "AUROC", "AveragePrecision", "BinnedRecallAtFixedPrecision", "PrecisionRecallCurve", "ROC",
             "BaseAggregator", "CatMetric", "MaxMetric", "MeanMetric", "MinMetric", "SumMetric"]
    for n in names:
        assert hasattr(mt, n) and n in mp.__all__ and hasattr(mp, n), n
    for n in names[:6]:
        assert getattr(mp, n) is getattr(mp.classification, n), n
    for n in ("auc", "auroc", "average_precision", "precision_recall_curve", "roc"):
        assert hasattr(mtf, n) and n in mpf.__all__ and n in mpf.classification.__all__, n
