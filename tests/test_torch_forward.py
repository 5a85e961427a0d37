"""The port's compiled forward against the JAX package's on the CPU: the
contract of ``tests/bases/test_forward_jit.py``, case for case.

The protocol (first call eager, second builds, later calls reuse; a step that
cannot be built stays eager for good; at most 64 signatures), the deferred
value checks (JAX's exact messages, sticky until ``reset()``), the cache's
keying (no instance pinned, a lookup never calls ``Metric.__eq__``, two
metrics with equal hashes never share an entry), the opt-outs (text-like
string inputs, ``nan_strategy='error'``, both bootstrappers, calls under
``torch.func.vmap``), the wrappers, and the collection's fused step with
every membership change dropping it. The per-metric parity of values and
states is ``tests/test_torch_forward_members.py``.

Tolerances: integer states bit-exact, f32 values within 1e-6 of JAX.
"""
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.metric as jax_metric
import metrics_tpu.utils.checks as jax_checks
import metrics_tpu_torch as mp
import metrics_tpu_torch.metric as port_metric
from metrics_tpu_torch.metric import forward_entry_kinds, keep_forward_eager
import metrics_tpu_torch.utils.checks as port_checks
from metrics_tpu_torch.engine.aot import FORWARD_CACHE
from tests.test_torch_forward_members import assert_tree, jax_entry_kinds

C = 5
N = 48

# The entry kinds after three forwards of one signature, as the JAX package
# leaves them (the card test in tests/test_torch_cuda.py pins the same lists):
# a collection's fused step compiles on its 2nd call, so its members' own
# caches hold one PENDING entry from the 1st call's member loop; the
# regression collection's fused step fails (R2Score's host read), and the
# members then take their own steps, R2Score's eager-only.
FLAGSHIP_KINDS = {"collection": ["compiled"], "acc": ["pending"], "f1": ["pending"], "binned_ap": ["pending"],
                  "confmat": ["pending"]}
DASHBOARD_KINDS = {"collection": ["compiled"], **{k: ["pending"] for k in (
    "precision", "recall", "specificity", "hamming", "jaccard", "kappa", "mcc", "hinge")}}
REGRESSION_KINDS = {"collection": ["eager_only"], **{k: ["compiled"] for k in (
    "mse", "rmse", "mae", "msle", "mape", "smape", "explained_variance", "tweedie")}, "r2": ["eager_only"]}


def _batch(seed, n=N, c=C):
    rng = np.random.RandomState(seed)
    p = rng.rand(n, c).astype(np.float32)
    return p / p.sum(1, keepdims=True), rng.randint(0, c, n)


def _reg_batch(seed, n=N):
    rng = np.random.RandomState(seed)
    t = rng.gamma(2.0, 1.0, n).astype(np.float32)
    return (t * np.exp(rng.normal(0.0, 0.3, n))).astype(np.float32), t


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def _collections(pkg, kind):
    """The flagship, dashboard or regression collection of ``pkg`` (the JAX
    package or the port) at C classes."""
    kw = {"device": "cpu"} if pkg is mp else {}
    if kind == "flagship":
        return pkg.MetricCollection({
            "acc": pkg.Accuracy(**kw), "f1": pkg.F1Score(num_classes=C, average="macro", **kw),
            "binned_ap": pkg.BinnedAveragePrecision(num_classes=C, thresholds=10, **kw),
            "confmat": pkg.ConfusionMatrix(num_classes=C, **kw)})
    if kind == "dashboard":
        return pkg.MetricCollection({
            "precision": pkg.Precision(average="macro", num_classes=C, **kw),
            "recall": pkg.Recall(average="macro", num_classes=C, **kw),
            "specificity": pkg.Specificity(average="macro", num_classes=C, **kw),
            "hamming": pkg.HammingDistance(**kw), "jaccard": pkg.JaccardIndex(num_classes=C, **kw),
            "kappa": pkg.CohenKappa(num_classes=C, **kw), "mcc": pkg.MatthewsCorrCoef(num_classes=C, **kw),
            "hinge": pkg.HingeLoss(**kw)})
    return pkg.MetricCollection({
        "mse": pkg.MeanSquaredError(**kw), "rmse": pkg.MeanSquaredError(squared=False, **kw),
        "mae": pkg.MeanAbsoluteError(**kw), "msle": pkg.MeanSquaredLogError(**kw),
        "mape": pkg.MeanAbsolutePercentageError(**kw), "smape": pkg.SymmetricMeanAbsolutePercentageError(**kw),
        "explained_variance": pkg.ExplainedVariance(**kw), "tweedie": pkg.TweedieDevianceScore(power=1.5, **kw),
        "r2": pkg.R2Score(**kw)})


def _coll_kinds(kinds, coll):
    return {"collection": kinds(coll), **{k: kinds(m) for k, m in coll.items(keep_base=True)}}


@pytest.mark.parametrize("kind,want", [("flagship", FLAGSHIP_KINDS), ("dashboard", DASHBOARD_KINDS),
                                       ("regression", REGRESSION_KINDS)])
def test_collection_fused_forward_matches_jax(kind, want):
    """Three forwards of one signature, then a fourth batch: per-batch values
    and final states against JAX, the members' loop of an eager twin
    bit-exact, the entry kinds equal to JAX's (and to the pinned lists)."""
    jc, pc, twin = _collections(mt, kind), _collections(mp, kind), _collections(mp, kind)
    keep_forward_eager(twin)  # the members' loop, every call
    make = _batch if kind != "regression" else _reg_batch
    for i in range(4):
        batch = make(100 + i)
        jv, pv, tv = jc(*batch), pc(*_t(*batch)), twin(*_t(*batch))
        assert_tree(pv, jv, path=f"{kind} batch {i} vs JAX")
        assert_tree(pv, tv, exact=True, path=f"{kind} batch {i} vs the members' loop")
        if i == 2:
            assert _coll_kinds(jax_entry_kinds, jc) == want
            assert _coll_kinds(forward_entry_kinds, pc) == want
    for k, m in pc.items(keep_base=True):
        assert_tree(m._pack_state(), twin[k]._pack_state(), exact=True, path=f"{kind}.{k} state")
        assert_tree(m._pack_state(), {s: np.asarray(v) for s, v in jc[k]._pack_state().items()}, path=k)
    assert_tree(pc.compute(), jc.compute(), path=f"{kind} compute")


def test_fast_path_matches_eager_values():
    preds, target = _batch(1)
    m_fast = mp.Accuracy(num_classes=C, device="cpu")
    fast = [float(m_fast(*_t(preds, target))) for _ in range(5)]
    eager = float(mp.Accuracy(num_classes=C, device="cpu")(*_t(preds, target)))
    jm = mt.Accuracy(num_classes=C)
    jax_vals = [float(jm(jnp.asarray(preds), jnp.asarray(target))) for _ in range(5)]
    assert forward_entry_kinds(m_fast) == ["compiled"]
    assert fast == [eager] * 5
    np.testing.assert_allclose(fast, jax_vals, rtol=1e-6)
    assert float(m_fast.compute()) == eager


def test_first_call_validates_eagerly():
    for m in (mt.Accuracy(), mp.Accuracy(device="cpu")):
        with pytest.raises(ValueError, match="non-negative"):
            m(*(_t if isinstance(m, mp.Metric) else lambda *x: tuple(map(jnp.asarray, x)))(
                np.array([[0.2, 0.8]], np.float32), np.array([-1])))


def _deferred_raise(pkg, make, good, bad):
    """Warm the compiled path, send ``bad``, and return the message of each of
    three compute() calls, then whether the metric works after reset()."""
    conv = _t if pkg is mp else (lambda *x: tuple(map(jnp.asarray, x)))
    m = make(pkg)
    for _ in range(3):
        m(*conv(*good))
    assert (forward_entry_kinds if pkg is mp else jax_entry_kinds)(m) == ["compiled"]
    m(*conv(*bad))  # bad values on the COMPILED path: forward returns
    msgs = []
    for _ in range(3):
        with pytest.raises(ValueError) as e:
            m.compute()
        msgs.append(str(e.value))
    m.reset()
    m(*conv(*good))
    m.compute()
    return msgs


GOOD = _batch(2)
DEFERRED_CASES = {
    "target_ge_num_classes": (lambda pkg: pkg.Accuracy(num_classes=C, **_dev(pkg)), GOOD, (GOOD[0], np.full(N, 99))),
    "target_negative": (lambda pkg: pkg.Accuracy(num_classes=C, **_dev(pkg)), GOOD, (GOOD[0], np.full(N, -1))),
    "target_ge_implied": (lambda pkg: pkg.ConfusionMatrix(num_classes=C, **_dev(pkg)), GOOD,
                          (GOOD[0], np.full(N, C))),
    "target_not_binary": (lambda pkg: pkg.Accuracy(**_dev(pkg)),
                          (GOOD[0][:, 0], (GOOD[1] > 2).astype(np.int64)), (GOOD[0][:, 0], np.full(N, 3))),
    "tweedie_domain": (lambda pkg: pkg.TweedieDevianceScore(power=1.5, **_dev(pkg)), _reg_batch(3),
                       (_reg_batch(3)[0], -_reg_batch(3)[1])),
}


def _dev(pkg):
    return {"device": "cpu"} if pkg is mp else {}


@pytest.mark.parametrize("case", sorted(DEFERRED_CASES))
def test_deferred_error_is_jax_message_and_sticky_until_reset(case):
    make, good, bad = DEFERRED_CASES[case]
    jax_msgs = _deferred_raise(mt, make, good, bad)
    port_msgs = _deferred_raise(mp, make, good, bad)
    assert port_msgs == jax_msgs
    assert port_msgs[0].endswith(" (detected by a compiled forward step; raised deferred)")


def test_deferred_messages_are_jax_codes():
    """Every code names the same message in both packages, so the larger of
    two codes raises the same text."""
    assert port_checks._DEFERRED_MESSAGES == jax_checks._DEFERRED_MESSAGES
    assert len(port_checks._DEFERRED_MESSAGES) == 10


def test_sync_raises_deferred():
    m = mp.Accuracy(num_classes=C, device="cpu")
    for _ in range(3):
        m(*_t(*GOOD))
    m(*_t(GOOD[0], np.full(N, 99)))
    with pytest.raises(ValueError, match="smaller than `num_classes`"):
        m.sync()


def test_collection_fused_deferred_validation():
    for pkg in (mt, mp):
        conv = _t if pkg is mp else (lambda *x: tuple(map(jnp.asarray, x)))
        mc = pkg.MetricCollection([pkg.Accuracy(num_classes=C, **_dev(pkg))])
        for _ in range(3):
            mc(*conv(*GOOD))
        mc(*conv(GOOD[0], np.full(N, 77)))
        with pytest.raises(ValueError, match="num_classes"):
            mc.compute()
        mc.reset()
        mc(*conv(*GOOD))
        assert 0.0 <= float(mc.compute()["Accuracy"]) <= 1.0


def test_compute_on_step_toggle_not_baked_into_cache():
    m = mp.Accuracy(num_classes=C, compute_on_step=False, device="cpu")
    assert m(*_t(*GOOD)) is None
    assert m(*_t(*GOOD)) is None  # the built step, value suppressed
    m.compute_on_step = True
    assert m(*_t(*GOOD)) is not None  # a new signature: eager, value computed
    assert m(*_t(*GOOD)) is not None and len(forward_entry_kinds(m)) == 2


def test_python_float_args_share_one_signature():
    m = mp.MeanMetric(nan_strategy="ignore", device="cpu")
    jm = mt.MeanMetric(nan_strategy="ignore")
    for i in range(40):
        m(0.25 * i)
        jm(0.25 * i)
    assert forward_entry_kinds(m) == jax_entry_kinds(jm) == ["compiled"]
    np.testing.assert_allclose(float(m.compute()), float(jm.compute()), rtol=1e-6)
    assert float(m.compute()) == np.float32(np.mean([0.25 * i for i in range(40)]))


def test_signature_cache_is_bounded():
    """At most JAX's 64 signatures per instance (``tests/bases/test_forward_jit.py``
    pins JAX's own cache at that bound; a new shape each call never builds)."""
    m = mp.MeanSquaredError(device="cpu")
    assert port_metric.Metric._FORWARD_JIT_MAX_SIGNATURES == jax_metric.Metric._FORWARD_JIT_MAX_SIGNATURES == 64
    for n in range(1, 64 + 20):
        m(torch.zeros(n), torch.zeros(n))
    assert forward_entry_kinds(m) == ["pending"] * 64
    m(torch.zeros(1), torch.zeros(1))  # a known signature still builds
    assert forward_entry_kinds(m) == ["compiled"] + ["pending"] * 63


def test_no_instance_leak_through_the_cache():
    m = mp.Accuracy(num_classes=C, device="cpu")
    mc = mp.MetricCollection([mp.Accuracy(num_classes=C, device="cpu")])
    for _ in range(3):
        m(*_t(*GOOD))
        mc(*_t(*GOOD))
    assert forward_entry_kinds(m) == forward_entry_kinds(mc) == ["compiled"]
    refs = [weakref.ref(m), weakref.ref(mc)]
    n_owners = len(port_metric._FORWARD_JIT_CACHE)
    del m, mc
    gc.collect()
    assert all(r() is None for r in refs), "a compiled step pinned its owner alive"
    assert len(port_metric._FORWARD_JIT_CACHE) <= n_owners - 3  # the metric, the collection, its member


class _SameHash(mp.MeanSquaredError):
    """Every instance hashes alike, as two live metrics may."""

    def __hash__(self):
        return 7


def test_equal_hashes_never_share_an_entry_and_lookups_never_call_eq(monkeypatch):
    def no_eq(self, other):
        raise AssertionError("the forward cache called Metric.__eq__")

    monkeypatch.setattr(mp.Metric, "__eq__", no_eq)
    a, b = _SameHash(device="cpu"), _SameHash(device="cpu")
    assert hash(a) == hash(b)
    xa, ya = _reg_batch(5)
    xb, yb = _reg_batch(6)
    for _ in range(3):
        a(*_t(xa, ya))
        b(*_t(xb, yb))
    ca, cb = port_metric._FORWARD_JIT_CACHE.get(a), port_metric._FORWARD_JIT_CACHE.get(b)
    assert ca is not cb and forward_entry_kinds(a) == forward_entry_kinds(b) == ["compiled"]
    assert next(iter(ca.values())) is not next(iter(cb.values()))
    ref = mp.MeanSquaredError(device="cpu")
    for _ in range(3):
        ref.update(*_t(xb, yb))
    assert float(b.compute()) == float(ref.compute())
    # the trap the cache avoids: a weak-keyed dict compares keys with ==
    monkeypatch.undo()
    assert isinstance(a == b, mp.CompositionalMetric)


def test_clone_and_pickle_start_without_entries():
    import pickle

    m = mp.Accuracy(num_classes=C, device="cpu")
    for _ in range(3):
        m(*_t(*GOOD))
    m(*_t(GOOD[0], np.full(N, 99)))
    for copy in (m.clone(), pickle.loads(pickle.dumps(m))):
        assert port_metric._FORWARD_JIT_CACHE.get(copy) is None
        assert copy._deferred_errcode is None


@pytest.mark.parametrize("name", ["confmat", "sum", "max"])
def test_compute_result_kept_across_a_forward_keeps_its_values(name):
    """``compute()`` of these returns a state tensor itself; a result kept
    across a compiled forward keeps its values in both packages (the step's
    output is rebound, not written into the old tensors)."""
    make = {"confmat": lambda pkg, **kw: pkg.ConfusionMatrix(num_classes=C, **kw),
            "sum": lambda pkg, **kw: pkg.SumMetric(nan_strategy="ignore", **kw),
            "max": lambda pkg, **kw: pkg.MaxMetric(nan_strategy="ignore", **kw)}[name]
    batches = [_batch(40 + i) if name == "confmat" else (_reg_batch(40 + i)[0] + np.float32(10 * i),) for i in range(4)]
    jm, m = make(mt), make(mp, device="cpu")
    for batch in batches[:3]:
        jm(*batch)
        m(*_t(*batch))
    assert forward_entry_kinds(m) == jax_entry_kinds(jm) == ["compiled"]
    kept, jkept = m.compute(), jm.compute()
    kept_values, jkept_values = kept.clone(), np.array(jkept)
    jm(*batches[3])
    m(*_t(*batches[3]))
    assert torch.equal(kept, kept_values)
    np.testing.assert_array_equal(np.asarray(jkept), jkept_values)
    assert not torch.equal(m.compute(), kept_values)
    assert_tree(m.compute(), jm.compute(), path=name)


def test_to_and_astype_drop_the_entries():
    m = mp.MeanSquaredError(device="cpu")
    x, y = _reg_batch(7)
    for _ in range(3):
        m(*_t(x, y))
    assert forward_entry_kinds(m) == ["compiled"]
    m.astype(torch.float64)
    assert forward_entry_kinds(m) == []
    for _ in range(3):
        m(*_t(x, y))
    assert m.sum_squared_error.dtype == torch.float64 and forward_entry_kinds(m) == ["compiled"]
    m.to("cpu")
    assert forward_entry_kinds(m) == []


def test_string_inputs_stay_eager():
    """The port has no text metric yet: a local one holds the JAX package's
    ``WordErrorRate`` rule (a string leaf keeps the call eager)."""

    class CharCount(mp.Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("chars", torch.tensor(0), dist_reduce_fx="sum")

        def update(self, preds):
            self.chars = self.chars + sum(len(s) for s in preds)

        def compute(self):
            return self.chars

    m, jm = CharCount(), mt.WordErrorRate()
    for _ in range(3):
        m(["hello there world"])
        jm(["hello there world"], ["hello there word"])
    assert forward_entry_kinds(m) == jax_entry_kinds(jm) == []
    assert int(m.compute()) == 3 * 17


def test_nan_error_aggregator_stays_eager_and_raises_every_batch():
    for pkg in (mt, mp):
        m = pkg.MeanMetric(nan_strategy="error", **_dev(pkg))
        conv = torch.tensor if pkg is mp else jnp.asarray
        for _ in range(3):
            m(conv([1.0, 2.0]))
        with pytest.raises(RuntimeError, match="nan"):
            m(conv([1.0, float("nan")]))
        assert (forward_entry_kinds if pkg is mp else jax_entry_kinds)(m) == []


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_bootstrappers_stay_eager(strategy):
    """Both draw on the host: a captured step would replay one draw. (JAX
    compiles multinomial, whose key it traces; the port's draws differ
    from JAX's anyway.)"""
    bs = mp.BootStrapper(mp.MeanSquaredError(device="cpu"), num_bootstraps=6, sampling_strategy=strategy, seed=3,
                         raw=True, mean=False, std=False)
    jbs = mt.BootStrapper(mt.MeanSquaredError(), num_bootstraps=6, sampling_strategy=strategy, seed=3,
                          raw=True, mean=False, std=False)
    rng = np.random.RandomState(11)
    for _ in range(4):
        x, y = rng.randn(96).astype(np.float32), rng.randn(96).astype(np.float32)
        raw = bs(*_t(x, y))["raw"]
        jraw = jbs(jnp.asarray(x), jnp.asarray(y))["raw"]
        assert float(raw.std()) > 0  # fresh draws per batch, not a frozen one
        if strategy == "poisson":  # the same seeded numpy draws
            np.testing.assert_allclose(raw.numpy(), np.asarray(jraw), rtol=1e-6, atol=1e-6)
    assert forward_entry_kinds(bs) == []
    assert jax_entry_kinds(jbs) == ([] if strategy == "poisson" else ["compiled"])


def test_minmax_wrapper_tracks_prefix_extremes_without_compiling():
    import warnings

    target = np.array([1, 1, 0, 0])
    for pkg in (mt, mp):
        conv = torch.tensor if pkg is mp else jnp.asarray
        mm = pkg.MinMaxMetric(pkg.Accuracy(**_dev(pkg)))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            mm(conv([0, 1, 0, 0]), conv(target))  # running acc 0.75
            mm(conv([1, 1, 0, 0]), conv(target))  # running acc 0.875
            vals = mm.compute()
        assert (forward_entry_kinds if pkg is mp else jax_entry_kinds)(mm) == []
        assert np.isclose(float(vals["min"]), 0.75) and np.isclose(float(vals["max"]), 0.875)


def test_multioutput_and_tracker_children_compile_as_in_jax():
    rng = np.random.RandomState(12)
    jw, pw = mt.MultioutputWrapper(mt.MeanSquaredError(), num_outputs=2), \
        mp.MultioutputWrapper(mp.MeanSquaredError(device="cpu"), num_outputs=2)
    jt, pt = mt.MetricTracker(mt.MeanSquaredError()), mp.MetricTracker(mp.MeanSquaredError(device="cpu"))
    jt.increment()
    pt.increment()
    for _ in range(4):
        x, y = rng.rand(N, 2).astype(np.float32), rng.rand(N, 2).astype(np.float32)
        assert_tree(pw(*_t(x, y)), jw(jnp.asarray(x), jnp.asarray(y)), path="multioutput")
        assert_tree(pt(*_t(x[:, 0], y[:, 0])), jt(jnp.asarray(x[:, 0]), jnp.asarray(y[:, 0])), path="tracker")
    assert forward_entry_kinds(pw) == jax_entry_kinds(jw) == []
    assert [forward_entry_kinds(c) for c in pw.metrics] == [jax_entry_kinds(c) for c in jw.metrics] \
        == [["compiled"]] * 2
    assert forward_entry_kinds(pt._metrics[-1]) == jax_entry_kinds(jt._metrics[-1]) == ["compiled"]
    assert_tree(pw.compute(), jw.compute(), path="multioutput compute")
    assert_tree(pt.compute(), jt.compute(), path="tracker compute")


def test_collection_forward_compiles_fused():
    mc = mp.MetricCollection([mp.Accuracy(num_classes=C, device="cpu"), mp.F1Score(num_classes=C, device="cpu")],
                             prefix="v_")
    vals = [mc(*_t(*GOOD)) for _ in range(4)]
    assert forward_entry_kinds(mc) == ["compiled"]
    assert set(vals[0]) == {"v_Accuracy", "v_F1Score"}
    for k in vals[0]:
        assert float(vals[0][k]) == float(vals[-1][k])
    assert float(mc.compute()["v_Accuracy"]) == float(vals[0]["v_Accuracy"])


def _membership_changes():
    def setitem(mc):
        mc["F1Score"] = mp.F1Score(num_classes=C, device="cpu")

    def delitem(mc):
        del mc["Precision"]

    def add_metrics(mc):
        mc.add_metrics(mp.F1Score(num_classes=C, device="cpu"))

    def setattr_(mc):
        mc.f1 = mp.F1Score(num_classes=C, device="cpu")

    def delattr_(mc):
        delattr(mc, "Precision")

    return {"setitem": setitem, "delitem": delitem, "pop": lambda mc: mc.pop("Precision"),
            "popitem": lambda mc: mc.popitem(), "clear": lambda mc: mc.clear(), "add_metrics": add_metrics,
            "add_module": lambda mc: mc.add_module("f1", mp.F1Score(num_classes=C, device="cpu")),
            "setattr": setattr_, "delattr": delattr_, "to": lambda mc: mc.to("cpu")}


@pytest.mark.parametrize("change", sorted(_membership_changes()))
def test_collection_membership_change_drops_the_fused_step(change):
    mc = mp.MetricCollection([mp.Accuracy(num_classes=C, device="cpu"), mp.Precision(num_classes=C, device="cpu")])
    for _ in range(3):
        mc(*_t(*GOOD))
    assert forward_entry_kinds(mc) == ["compiled"]
    _membership_changes()[change](mc)
    assert forward_entry_kinds(mc) == [], "a stale fused step survived the change"
    if len(mc):
        out = [mc(*_t(*GOOD)) for _ in range(3)][-1]
        assert set(out) == set(mc.keys()) and forward_entry_kinds(mc) == ["compiled"]


def test_collection_full_state_update_member_uses_snapshot_path():
    def make(pkg, xp):
        class RunningMeanMax(pkg.Metric):
            full_state_update = True

            def __init__(self):
                super().__init__(**_dev(pkg))
                self.add_state("total", xp.asarray(0.0), dist_reduce_fx="sum")
                self.add_state("n", xp.asarray(0.0), dist_reduce_fx="sum")
                self.add_state("peak_mean", xp.asarray(-np.inf), dist_reduce_fx="max")

            def update(self, x):
                self.total = self.total + x.sum()
                self.n = self.n + x.shape[0]
                self.peak_mean = xp.maximum(self.peak_mean, self.total / self.n)

            def compute(self):
                return self.peak_mean

        return RunningMeanMax

    batches = [np.zeros(2, np.float32)] * 3 + [np.full(2, 20.0, np.float32)]
    results = []
    for pkg, xp, conv in ((mt, jnp, jnp.asarray), (mp, torch, torch.from_numpy)):
        cls = make(pkg, xp)
        solo, mc = cls(), pkg.MetricCollection({"rmm": cls()})
        for b in batches:
            solo(conv(b))
            mc(conv(b))
        assert np.isclose(float(mc.compute()["rmm"]), float(solo.compute()))
        assert "compiled" not in (forward_entry_kinds if pkg is mp else jax_entry_kinds)(mc)
        results.append(float(solo.compute()))
    assert results[0] == results[1]


def test_forward_under_vmap_falls_back():
    m = mp.MeanSquaredError(device="cpu")
    x = torch.from_numpy(np.random.RandomState(13).rand(32).astype(np.float32))
    for _ in range(3):
        m(x, x * 1.1)  # the compiled path, warm
    seen = []

    def per_row(p, t):
        seen.append(mp.Metric._forward_signature((p, t), {}))
        return m.update_state(m.init_state(), p, t)

    delta = torch.func.vmap(per_row)(x.reshape(32, 1), (x * 0.9).reshape(32, 1))
    assert seen == [None]
    assert float(m.compute_from({k: v.sum(0) for k, v in delta.items()})) >= 0
    assert forward_entry_kinds(m) == ["compiled"]


def test_failed_build_is_eager_only_and_counted():
    before = FORWARD_CACHE.eager_only
    m = mp.R2Score(device="cpu")
    x, y = _reg_batch(14)
    for _ in range(3):
        m(*_t(x, y))
    assert forward_entry_kinds(m) == ["eager_only"]
    assert FORWARD_CACHE.eager_only == before + 1
    ref = mp.R2Score(device="cpu")
    for _ in range(3):
        ref.update(*_t(x, y))
    assert float(m.compute()) == float(ref.compute())
