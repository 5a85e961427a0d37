"""Regression and pairwise in the port against the JAX package, on the CPU.

The same seeded numpy rows (positive targets, gamma-distributed, and
predictions the targets times log-normal noise, so every Tweedie power and
the log error are defined) go through each of the 11 regression metrics and
functionals of both packages, eagerly; through ``state_from_numpy`` and
``state_dict``; and, for the eight whose value is served, through the port's
megastep ``StreamingEngine`` and paged ``MultiStreamEngine`` against the JAX
package's engines under ``kernel_backend="xla"``. ``R2Score``'s updates are
served and its value is not: the served ``result()``/``results()`` raise in
both packages. Pearson, Spearman and CosineSimilarity are refused with the
JAX package's reasons. The four pairwise functions run every
``reduction``/``zero_diagonal`` case, with and without ``y``.

Tolerances: integer states bit-exact. An f32 sum state is within 1e-6
relative of JAX's, or within the reassociation bound of two sums of the same
terms in different orders, 2 · n · 2⁻²⁴ · Σ|terms| (the terms in float64
from numpy). Values (ratios and differences of such sums) within 1e-5
relative plus 1e-6 absolute; pairwise matrices within 1e-5 relative plus
1e-5 absolute (an f32 matrix product over 16 columns), and euclidean
distances near 0 within the square root of the expansion's rounding bound,
sqrt(8 · d · 2⁻²⁴ · (|x|² + |y|²)), both packages taking the square root of
cancellation noise on a row against itself.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import metrics_tpu as mt
import metrics_tpu.functional as jf
import metrics_tpu_torch as mp
import metrics_tpu_torch.functional as pf
from metrics_tpu.engine import EngineConfig as JaxConfig
from metrics_tpu.engine import MultiStreamEngine as JaxMulti
from metrics_tpu.engine import StreamingEngine as JaxStreaming
from metrics_tpu.ops.kernels import use_backend
from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine
from metrics_tpu_torch.regression.pearson import _final_aggregation
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.state_bridge import state_from_numpy

VALUE_RTOL, VALUE_ATOL = 1e-5, 1e-6
PAIR_TOL = 1e-5
BUCKETS = (8, 32)
S = 5
EPS = 1.17e-06


def _rows(n, seed, cols=None):
    rng = np.random.RandomState(seed)
    shape = (n,) if cols is None else (n, cols)
    t = rng.gamma(2.0, 1.0, shape).astype(np.float32)
    return (t * np.exp(rng.normal(0.0, 0.3, shape))).astype(np.float32), t


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------- the float64 terms of every sum state

def _tweedie_terms(p, t, power):
    p, t = p.astype(np.float64), t.astype(np.float64)
    if power == 0:
        return (t - p) ** 2
    if power == 1:
        return 2 * (t * np.log(t / p) + p - t)
    if power == 2:
        return 2 * (np.log(p / t) + t / p - 1)
    return 2 * (np.maximum(t, 0) ** (2 - power) / ((1 - power) * (2 - power)) - t * p ** (1 - power) / (1 - power)
                + p ** (2 - power) / (2 - power))


def _terms(metric, state_name, p, t):
    """The float64 terms that the f32 sum state ``state_name`` of ``metric``
    adds up over rows ``p``, ``t``, for the reassociation bound."""
    p64, t64 = p.astype(np.float64), t.astype(np.float64)
    name = type(metric).__name__
    if name == "PearsonCorrCoef":  # deviations from a running mean: each term at most (|x| + max|x|)^2
        dp, dt = np.abs(p64) + np.abs(p64).max(), np.abs(t64) + np.abs(t64).max()
        return {"mean_x": p64 / len(p64), "mean_y": t64 / len(t64), "var_x": dp * dp, "var_y": dt * dt,
                "corr_xy": dp * dt, "n_total": np.ones_like(p64)}[state_name]
    table = {
        "MeanSquaredError": {"sum_squared_error": (p64 - t64) ** 2},
        "MeanAbsoluteError": {"sum_abs_error": np.abs(p64 - t64)},
        "MeanSquaredLogError": {"sum_squared_log_error": (np.log1p(p64) - np.log1p(t64)) ** 2},
        "MeanAbsolutePercentageError": {"sum_abs_per_error": np.abs(p64 - t64) / np.maximum(np.abs(t64), EPS),
                                        "total": np.ones_like(t64)},
        "SymmetricMeanAbsolutePercentageError": {
            "sum_abs_per_error": 2 * np.abs(p64 - t64) / np.maximum(np.abs(t64) + np.abs(p64), EPS),
            "total": np.ones_like(t64)},
        "ExplainedVariance": {"sum_error": t64 - p64, "sum_squared_error": (t64 - p64) ** 2, "sum_target": t64,
                              "sum_squared_target": t64 ** 2, "n_obs": np.ones(len(t64))},
        "R2Score": {"sum_squared_error": t64 ** 2, "sum_error": t64, "residual": (t64 - p64) ** 2},
        "TweedieDevianceScore": {"sum_deviance_score": _tweedie_terms(p, t, getattr(metric, "power", 0.0))},
    }
    return table[name][state_name]


def _close_state(got, want, terms=None, what=""):
    """``got`` against JAX's ``want``: integers exact; f32 within 1e-6
    relative, or within the reassociation bound of ``terms``."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype, want.dtype)
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    allowed = 1e-6 * np.abs(want.astype(np.float64))
    if terms is not None:
        terms = np.abs(np.asarray(terms, np.float64))
        allowed = np.maximum(allowed, 2 * terms.shape[0] * 2.0 ** -24 * terms.sum(axis=0))
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(diff <= allowed), (what, got, want, allowed)


def _close_states(metric, got, want, p, t, what=""):
    """Every state of ``metric`` (a collection member or a metric) against JAX's."""
    got = _np(got)
    for k, w in _np(want).items():
        g = got[k]
        if isinstance(w, list):
            assert len(g) == len(w), (what, k)
            for a, b in zip(g, w):
                _close_state(a, b, what=f"{what}.{k}")
            continue
        terms = _terms(metric, k, p, t) if w.dtype.kind == "f" else None
        _close_state(g, w, terms, f"{what}.{k}")


def _close_value(got, want, what=""):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close_value(got[k], want[k], f"{what}.{k}")
        return
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL, atol=VALUE_ATOL, err_msg=what)


# ------------------------------------------------------------------------ the metrics

METRICS = {
    "mse": (lambda m, kw: m.MeanSquaredError(**kw), None),
    "rmse": (lambda m, kw: m.MeanSquaredError(squared=False, **kw), None),
    "mae": (lambda m, kw: m.MeanAbsoluteError(**kw), None),
    "msle": (lambda m, kw: m.MeanSquaredLogError(**kw), None),
    "mape": (lambda m, kw: m.MeanAbsolutePercentageError(**kw), None),
    "smape": (lambda m, kw: m.SymmetricMeanAbsolutePercentageError(**kw), None),
    "explained_variance": (lambda m, kw: m.ExplainedVariance(**kw), None),
    "explained_variance_raw_2d": (lambda m, kw: m.ExplainedVariance(multioutput="raw_values", **kw), 3),
    "explained_variance_weighted_2d": (lambda m, kw: m.ExplainedVariance(multioutput="variance_weighted", **kw), 3),
    "r2": (lambda m, kw: m.R2Score(**kw), None),
    "r2_adjusted": (lambda m, kw: m.R2Score(adjusted=3, **kw), None),
    "r2_raw_2d": (lambda m, kw: m.R2Score(num_outputs=3, multioutput="raw_values", **kw), 3),
    "r2_weighted_2d": (lambda m, kw: m.R2Score(num_outputs=3, multioutput="variance_weighted", **kw), 3),
    "tweedie_0": (lambda m, kw: m.TweedieDevianceScore(power=0.0, **kw), None),
    "tweedie_1": (lambda m, kw: m.TweedieDevianceScore(power=1.0, **kw), None),
    "tweedie_1.5": (lambda m, kw: m.TweedieDevianceScore(power=1.5, **kw), None),
    "tweedie_2": (lambda m, kw: m.TweedieDevianceScore(power=2.0, **kw), None),
    "tweedie_3": (lambda m, kw: m.TweedieDevianceScore(power=3.0, **kw), None),
    "tweedie_-1": (lambda m, kw: m.TweedieDevianceScore(power=-1.0, **kw), None),
    "pearson": (lambda m, kw: m.PearsonCorrCoef(**kw), None),
    "spearman": (lambda m, kw: m.SpearmanCorrCoef(**kw), None),
    "cosine_sum": (lambda m, kw: m.CosineSimilarity(**kw), 4),
    "cosine_mean": (lambda m, kw: m.CosineSimilarity(reduction="mean", **kw), 4),
    "cosine_none": (lambda m, kw: m.CosineSimilarity(reduction="none", **kw), 4),
}


def _both(name):
    build, _ = METRICS[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Spearman's buffer warning
        return build(mt, {}), build(mp, {"device": "cpu"})


def _batches(name, seed, sizes=(7, 1, 12)):
    cols = METRICS[name][1]
    return [_rows(n, seed * 10 + i, cols) for i, n in enumerate(sizes)]


def _concat(batches):
    return np.concatenate([p for p, _ in batches]), np.concatenate([t for _, t in batches])


@pytest.mark.parametrize("name", sorted(METRICS))
def test_eager_states_values_and_forward_match_jax(name):
    jm, pm = _both(name)
    batches = _batches(name, 1)
    for p, t in batches:
        jm.update(jnp.asarray(p), jnp.asarray(t))
        pm.update(torch.from_numpy(p), torch.from_numpy(t))
    p_all, t_all = _concat(batches)
    _close_states(pm, pm._pack_state(), jm._pack_state(), p_all, t_all, name)
    _close_value(pm.compute(), jm.compute(), name)
    # forward: the batch's value, the state accumulated (Pearson through the snapshot path)
    p, t = _rows(9, 99, METRICS[name][1])
    _close_value(pm(torch.from_numpy(p), torch.from_numpy(t)), jm(jnp.asarray(p), jnp.asarray(t)), f"{name} forward")
    _close_value(pm.compute(), jm.compute(), f"{name} after forward")
    assert pm._states_mergeable == jm._states_mergeable
    assert pm.masked_update_strategy() == jm.masked_update_strategy()


FUNCTIONALS = {
    "mean_squared_error": ("mean_squared_error", {}, None),
    "mean_squared_error_rmse": ("mean_squared_error", {"squared": False}, None),
    "mean_absolute_error": ("mean_absolute_error", {}, None),
    "mean_squared_log_error": ("mean_squared_log_error", {}, None),
    "mean_absolute_percentage_error": ("mean_absolute_percentage_error", {}, None),
    "symmetric_mean_absolute_percentage_error": ("symmetric_mean_absolute_percentage_error", {}, None),
    "explained_variance": ("explained_variance", {}, None),
    "explained_variance_raw_2d": ("explained_variance", {"multioutput": "raw_values"}, 3),
    "explained_variance_weighted_2d": ("explained_variance", {"multioutput": "variance_weighted"}, 3),
    "r2_score": ("r2_score", {}, None),
    "r2_score_adjusted": ("r2_score", {"adjusted": 2}, None),
    "r2_score_raw_2d": ("r2_score", {"multioutput": "raw_values"}, 3),
    "tweedie_deviance_score_0": ("tweedie_deviance_score", {"power": 0.0}, None),
    "tweedie_deviance_score_1": ("tweedie_deviance_score", {"power": 1.0}, None),
    "tweedie_deviance_score_1.5": ("tweedie_deviance_score", {"power": 1.5}, None),
    "tweedie_deviance_score_2": ("tweedie_deviance_score", {"power": 2.0}, None),
    "tweedie_deviance_score_3": ("tweedie_deviance_score", {"power": 3.0}, None),
    "pearson_corrcoef": ("pearson_corrcoef", {}, None),
    "spearman_corrcoef": ("spearman_corrcoef", {}, None),
    "cosine_similarity": ("cosine_similarity", {}, 4),
    "cosine_similarity_mean": ("cosine_similarity", {"reduction": "mean"}, 4),
    "cosine_similarity_none": ("cosine_similarity", {"reduction": "none"}, 4),
}


@pytest.mark.parametrize("case", sorted(FUNCTIONALS))
def test_functional_matches_jax(case):
    fn, kw, cols = FUNCTIONALS[case]
    p, t = _rows(33, 5, cols)
    want = getattr(jf, fn)(jnp.asarray(p), jnp.asarray(t), **kw)
    _close_value(getattr(pf, fn)(torch.from_numpy(p), torch.from_numpy(t), **kw), want, case)
    # numpy inputs go to the device the caller names
    _close_value(getattr(pf, fn)(p, t, device="cpu", **kw), want, f"{case} numpy")


@pytest.mark.parametrize("name", sorted(METRICS))
def test_jax_state_seats_in_the_port_and_state_dict_keys_match(name):
    jm, pm = _both(name)
    for p, t in _batches(name, 2):
        jm.update(jnp.asarray(p), jnp.asarray(t))
    np_state = jax.tree.map(np.asarray, jm._pack_state())
    state = state_from_numpy(pm, np_state, device="cpu")
    _close_value(pm.compute_from(state), jm.compute(), name)
    assert sorted(pm.state_dict()) == sorted(jm.state_dict()) == []
    jm.persistent(True)
    pm.persistent(True)
    pm._load_state(state)
    jsd, psd = jm.state_dict(), pm.state_dict()
    assert sorted(psd) == sorted(jsd) == sorted(pm._defaults)
    back = _both(name)[1]
    back.persistent(True)
    back.load_state_dict(jsd)
    _close_value(back.compute_from(back._pack_state()), jm.compute(), f"{name} via state_dict")


# ------------------------------------------------------------------------- served

def _served(m, **kw):
    """The eight members whose value the engines serve."""
    return m.MetricCollection({
        "mse": m.MeanSquaredError(**kw),
        "rmse": m.MeanSquaredError(squared=False, **kw),
        "mae": m.MeanAbsoluteError(**kw),
        "msle": m.MeanSquaredLogError(**kw),
        "mape": m.MeanAbsolutePercentageError(**kw),
        "smape": m.SymmetricMeanAbsolutePercentageError(**kw),
        "explained_variance": m.ExplainedVariance(**kw),
        "tweedie": m.TweedieDevianceScore(power=1.5, **kw),
    })


def _r2(m, **kw):
    return m.MetricCollection({"r2": m.R2Score(**kw)})


def _traffic(n_batches, seed):
    rng = np.random.RandomState(seed)
    sids = rng.randint(0, S, n_batches)
    return [(int(sid), *_rows(int(rng.randint(1, 14)), seed * 100 + i)) for i, sid in enumerate(sids)]


def _stream_rows(traffic, sid):
    """Stream ``sid``'s rows, in submit order (empty for an untouched stream)."""
    rows = [(p, t) for s, p, t in traffic if s == sid]
    return tuple(np.concatenate([r[i] for r in rows]) if rows else np.zeros(0, np.float32) for i in (0, 1))


def _close_collection(coll, got, want, p, t, what):
    for k, member in coll.items(keep_base=True):
        _close_states(member, got[k], want[k], p, t, f"{what}.{k}")


def _port_streaming(make, traffic):
    eng = StreamingEngine(make(mp, device="cpu"), EngineConfig(buckets=BUCKETS, kernel_backend="megastep"))
    with eng:
        for _, p, t in traffic:
            eng.submit(torch.from_numpy(p), torch.from_numpy(t))
    assert eng.stats.kernel_fallbacks_by_reason() == {}
    return eng


def _jax_streaming(make, traffic):
    eng = JaxStreaming(make(mt), JaxConfig(buckets=BUCKETS, kernel_backend="xla", coalesce=1))
    with eng:
        for _, p, t in traffic:
            eng.submit(p, t)
    return eng


def _port_paged(make, traffic):
    eng = MultiStreamEngine(make(mp, device="cpu"), S, EngineConfig(buckets=BUCKETS, kernel_backend="megastep",
                                                                    coalesce=1),
                            stream_shard=True, resident_streams=2)
    with eng:
        for sid, p, t in traffic:
            eng.submit(sid, torch.from_numpy(p), torch.from_numpy(t))
    assert eng.stats.page_outs > 0 and eng.stats.kernel_fallbacks_by_reason() == {}
    return eng


def _jax_paged(make, traffic):
    eng = JaxMulti(
        make(mt), S,
        JaxConfig(buckets=BUCKETS, mesh=Mesh(np.asarray(jax.devices()[:1]), ("dp",)), axis="dp",
                  mesh_sync="deferred", kernel_backend="xla", coalesce=1),
        stream_shard=True, resident_streams=2,
    )
    with eng:
        for sid, p, t in traffic:
            eng.submit(sid, p, t)
            eng.flush()
    return eng


def test_servable_members_and_strategies_match_jax():
    jc, pc = _served(mt), _served(mp, device="cpu")
    for k, member in pc.items(keep_base=True):
        assert member.masked_update_strategy() == jc[k].masked_update_strategy() == "delta", k
        assert member.segmented_update_unsupported_reason() is None
    spell = lambda layout: [(k, o, n, tuple(sh), str(dt).replace("torch.", ""))  # noqa: E731
                            for k, o, n, sh, dt in layout.leaf_slices()]
    for make in (_served, _r2):
        assert spell(make(mp, device="cpu").arena_layout()) == spell(make(mt).arena_layout())


def test_served_states_and_values_through_the_megastep_engine_match_jax():
    traffic = _traffic(12, 1)
    p_all = np.concatenate([p for _, p, _ in traffic])
    t_all = np.concatenate([t for _, _, t in traffic])
    jeng, peng = _jax_streaming(_served, traffic), _port_streaming(_served, traffic)
    _close_collection(peng._metric, peng.state(), jeng.state(), p_all, t_all, "megastep")
    _close_value(peng.result(), jeng.result(), "megastep result")
    eager = _served(mp, device="cpu")
    for _, p, t in traffic:
        eager.update(torch.from_numpy(p), torch.from_numpy(t))
    _close_value(peng.result(), eager.compute(), "megastep result vs eager")


def test_served_states_through_the_paged_engine_match_jax():
    traffic = _traffic(16, 2)
    jeng, peng = _jax_paged(_served, traffic), _port_paged(_served, traffic)
    assert (peng.stats.page_outs, peng.stats.page_ins) == (jeng.stats.page_outs, jeng.stats.page_ins)
    for sid in range(S):
        _close_collection(peng._metric, peng.stream_state(sid), jeng.stream_state(sid), *_stream_rows(traffic, sid),
                          f"stream {sid}")
    got, want = peng.results(), jeng.results()
    for sid in range(S):
        if any(s == sid for s, _, _ in traffic):  # an untouched stream's values are 0/0 in both
            _close_value(got[sid], want[sid], f"results() stream {sid}")
            _close_value(got[sid], peng.result(sid), f"results() vs result({sid})")


def test_r2_updates_are_served_and_its_value_raises_in_both_packages():
    """The folded states equal JAX's; the served value raises in both: JAX's
    ``ConcretizationTypeError`` on the host read of ``n_obs``, the port's
    ``MetricsTPUUserError`` naming it. The eager compute of the served state
    works in both."""
    traffic = _traffic(10, 3)
    p_all = np.concatenate([p for _, p, _ in traffic])
    t_all = np.concatenate([t for _, _, t in traffic])
    jeng, peng = _jax_streaming(_r2, traffic), _port_streaming(_r2, traffic)
    _close_collection(peng._metric, peng.state(), jeng.state(), p_all, t_all, "r2 megastep")
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jeng.result()
    with pytest.raises(MetricsTPUUserError, match=r"reads n_obs on the host \(`int\(n_obs\) < 2`"):
        peng.result()
    _close_value(peng._metric.compute_from(peng.state()), jeng._metric.compute_from(jeng.state()), "r2 eager")
    jmulti = JaxMulti(_r2(mt), S, JaxConfig(buckets=BUCKETS, kernel_backend="xla", coalesce=1))
    with jmulti:
        for sid, p, t in traffic:
            jmulti.submit(sid, p, t)
    unsharded = MultiStreamEngine(_r2(mp, device="cpu"), S, EngineConfig(buckets=BUCKETS, coalesce=1))
    with unsharded:
        for sid, p, t in traffic:
            unsharded.submit(sid, torch.from_numpy(p), torch.from_numpy(t))
    for pmulti in (_port_paged(_r2, traffic), unsharded):
        for sid in range(S):
            _close_collection(pmulti._metric, pmulti.stream_state(sid), jmulti.stream_state(sid),
                              *_stream_rows(traffic, sid), f"r2 stream {sid}")
        with pytest.raises(MetricsTPUUserError, match="reads n_obs on the host"):
            pmulti.results()
        with pytest.raises(MetricsTPUUserError, match="reads n_obs on the host"):
            pmulti.result(0)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jmulti.results()
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jmulti.result(0)


@pytest.mark.parametrize("name", ["pearson", "spearman", "cosine_sum"])
@pytest.mark.parametrize("engine", ["streaming", "multistream", "paged"])
def test_engines_refuse_with_the_jax_reason(name, engine):
    jm, pm = _both(name)
    jc, pc = mt.MetricCollection({"x": jm}), mp.MetricCollection({"x": pm})
    builders = {
        "streaming": (lambda c: JaxStreaming(c, JaxConfig(buckets=BUCKETS, kernel_backend="xla")),
                      lambda c: StreamingEngine(c, EngineConfig(buckets=BUCKETS, kernel_backend="megastep"))),
        "multistream": (lambda c: JaxMulti(c, S, JaxConfig(buckets=BUCKETS, kernel_backend="xla")),
                        lambda c: MultiStreamEngine(c, S, EngineConfig(buckets=BUCKETS))),
        "paged": (None, lambda c: MultiStreamEngine(c, S, EngineConfig(buckets=BUCKETS, kernel_backend="megastep"),
                                                    stream_shard=True, resident_streams=2)),
    }
    jbuild, pbuild = builders[engine]
    with pytest.raises(MetricsTPUUserError) as perr:
        pbuild(pc)
    if jbuild is None:  # the JAX paged form needs a mesh; it refuses by the multistream reason
        jbuild = builders["multistream"][0]
    with pytest.raises(Exception) as jerr:
        jbuild(jc)
    assert str(perr.value) == str(jerr.value)
    want = ("full_state_update metrics read the accumulated state in update" if name == "pearson"
            else "state 'preds' is a list (cat/gather) state")
    assert want in str(perr.value)
    assert pm.masked_update_unsupported_reason() == jm.masked_update_unsupported_reason()


# ---------------------------------------------------------------- Spearman, Tweedie, Pearson

@pytest.mark.parametrize("pattern", ["few_values", "all_tied", "one_tie", "no_ties"])
def test_spearman_ties_get_jax_mean_ranks(pattern):
    from metrics_tpu.functional.regression.spearman import _rank_data as jax_rank
    from metrics_tpu_torch.functional.regression.spearman import _rank_data

    rng = np.random.RandomState(7)
    data = {
        "few_values": rng.randint(0, 4, 40).astype(np.float32),
        "all_tied": np.full(9, 2.5, np.float32),
        "one_tie": np.asarray([3.0, 1.0, 2.0, 1.0, 5.0], np.float32),
        "no_ties": rng.rand(25).astype(np.float32),
    }[pattern]
    got = _rank_data(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_rank(jnp.asarray(data))))
    from scipy.stats import rankdata
    np.testing.assert_array_equal(got, rankdata(data).astype(np.float32))
    other = rng.randint(0, 3, data.size).astype(np.float32)
    _close_value(pf.spearman_corrcoef(torch.from_numpy(data), torch.from_numpy(other)),
                 jf.spearman_corrcoef(jnp.asarray(data), jnp.asarray(other)), pattern)


def test_spearman_dtype_rules_match_jax():
    ints = np.arange(6, dtype=np.int32)
    with pytest.raises(TypeError, match="floating point"):
        jf.spearman_corrcoef(jnp.asarray(ints), jnp.asarray(ints))
    with pytest.raises(TypeError, match="floating point"):
        pf.spearman_corrcoef(torch.from_numpy(ints), torch.from_numpy(ints))
    from metrics_tpu.functional.regression.spearman import _spearman_corrcoef_update as jax_update
    from metrics_tpu_torch.functional.regression.spearman import _spearman_corrcoef_update

    with pytest.raises(TypeError, match="same data type"):
        jax_update(jnp.ones(6, jnp.float32), jnp.ones(6, jnp.float16))
    with pytest.raises(TypeError, match="same data type"):
        _spearman_corrcoef_update(torch.ones(6), torch.ones(6, dtype=torch.float16))
    p, t = _rows(20, 8)
    # sub-f32 floats widen: a half-precision pair ranks as f32
    got = pf.spearman_corrcoef(torch.from_numpy(p).half(), torch.from_numpy(t).half())
    want = jf.spearman_corrcoef(jnp.asarray(p, jnp.float16), jnp.asarray(t, jnp.float16))
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    _close_value(got, want, "half")


@pytest.mark.parametrize("power,preds,targets,match", [
    (0.5, [1.0], [1.0], "not defined for power=0.5"),
    (1.0, [0.0, 1.0], [1.0, 1.0], "'preds' has to be strictly positive and 'targets' cannot be negative"),
    (1.0, [1.0, 1.0], [-1.0, 1.0], "'preds' has to be strictly positive and 'targets' cannot be negative"),
    (2.0, [1.0, 1.0], [0.0, 1.0], "both 'preds' and 'targets' have to be strictly positive"),
    (-1.0, [-1.0, 1.0], [1.0, 1.0], "'preds' has to be strictly positive"),
    (1.5, [1.0, 1.0], [-2.0, 1.0], "'targets' has to be strictly positive and 'preds' cannot be negative"),
    (3.0, [1.0, 2.0], [1.0, 0.0], "both 'preds' and 'targets' have to be strictly positive"),
])
def test_tweedie_domain_errors_match_jax(power, preds, targets, match):
    p, t = np.asarray(preds, np.float32), np.asarray(targets, np.float32)
    with pytest.raises(ValueError, match=match):
        jf.tweedie_deviance_score(jnp.asarray(p), jnp.asarray(t), power=power)
    with pytest.raises(ValueError, match=match):
        pf.tweedie_deviance_score(torch.from_numpy(p), torch.from_numpy(t), power=power)
    if power != 0.5:
        with pytest.raises(ValueError, match=match):
            mp.TweedieDevianceScore(power=power, device="cpu").update(torch.from_numpy(p), torch.from_numpy(t))


def test_tweedie_poisson_zero_target_contributes_zero_as_in_jax():
    p, t = np.asarray([0.5, 2.0, 1.0], np.float32), np.asarray([0.0, 3.0, 1.0], np.float32)
    got = pf.tweedie_deviance_score(torch.from_numpy(p), torch.from_numpy(t), power=1.0)
    assert np.isfinite(float(got))
    _close_value(got, jf.tweedie_deviance_score(jnp.asarray(p), jnp.asarray(t), power=1.0), "poisson zero target")


def test_tweedie_masked_update_skips_the_domain_check_as_jax_does():
    """Masked rows may hold anything: under the vmapped per-row update the
    eager checks do not run, in the port as under JAX's trace."""
    p, t = _rows(12, 9)
    p[8:] = -1.0  # out of the domain, but masked out
    mask = np.arange(12) < 8
    jm, pm = mt.TweedieDevianceScore(power=1.5), mp.TweedieDevianceScore(power=1.5, device="cpu")
    with use_backend("xla"):
        want = jm.update_state_masked(jm.init_state(), jnp.asarray(p), jnp.asarray(t), mask=jnp.asarray(mask))
    got = pm.update_state_masked(pm.init_state(), torch.from_numpy(p), torch.from_numpy(t),
                                 mask=torch.from_numpy(mask))
    _close_states(pm, got, jax.tree.map(np.asarray, want), p[:8], t[:8], "tweedie masked")
    assert int(got["num_observations"]) == 8


@pytest.mark.parametrize("world", [2, 4])
def test_pearson_stacked_moments_fold_as_jax(world):
    """Per-process moments stacked ``(world,)`` by hand fold by Chan's
    formula to JAX's value, and to the one-process value over every row."""
    jm, pm = _both("pearson")
    shards = [_rows(int(n), 40 + w) for w, n in enumerate(np.random.RandomState(world).randint(5, 30, world))]
    states = []
    for p, t in shards:
        one = mt.PearsonCorrCoef()
        one.update(jnp.asarray(p), jnp.asarray(t))
        states.append(jax.tree.map(np.asarray, one._pack_state()))
    stacked = {k: np.stack([s[k] for s in states]) for k in states[0]}
    want = jm.compute_from({k: jnp.asarray(v) for k, v in stacked.items()})
    got = pm.compute_from({k: torch.from_numpy(v) for k, v in stacked.items()})
    _close_value(got, want, "stacked")
    folded = _final_aggregation(*(torch.from_numpy(stacked[k]) for k in
                                  ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")))
    assert float(folded[3]) == sum(len(t) for _, t in shards)
    p_all, t_all = _concat(shards)
    _close_value(got, np.corrcoef(p_all.astype(np.float64), t_all.astype(np.float64))[0, 1].astype(np.float32),
                 "stacked vs numpy")


def test_deprecated_aliases_warn_and_subclass():
    for alias, cls in ((mp.PearsonCorrcoef, mp.PearsonCorrCoef), (mp.SpearmanCorrcoef, mp.SpearmanCorrCoef)):
        with pytest.warns(DeprecationWarning, match="was renamed"):
            m = alias(device="cpu")
        assert isinstance(m, cls)


# ----------------------------------------------------------------------------- pairwise

PAIRWISE = ("pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity",
            "pairwise_manhatten_distance")


@pytest.mark.parametrize("with_y", [False, True], ids=["x_only", "x_and_y"])
@pytest.mark.parametrize("zero_diagonal", [None, True, False])
@pytest.mark.parametrize("reduction", [None, "none", "mean", "sum"])
@pytest.mark.parametrize("fn", PAIRWISE)
def test_pairwise_matches_jax(fn, reduction, zero_diagonal, with_y):
    rng = np.random.RandomState(11)
    x = rng.normal(size=(7, 16)).astype(np.float32)
    y = rng.normal(size=(5, 16)).astype(np.float32) if with_y else None
    want = getattr(jf, fn)(jnp.asarray(x), None if y is None else jnp.asarray(y), reduction=reduction,
                           zero_diagonal=zero_diagonal)
    got = getattr(pf, fn)(torch.from_numpy(x), None if y is None else torch.from_numpy(y), reduction=reduction,
                          zero_diagonal=zero_diagonal)
    assert tuple(got.shape) == tuple(np.shape(want)) and got.dtype == torch.float32
    want = np.asarray(want, np.float64)
    allowed = PAIR_TOL + PAIR_TOL * np.abs(want)
    if fn == "pairwise_euclidean_distance":
        # sqrt(|x|^2 + |y|^2 - 2 x.y) near 0 (a row against itself) is the square root of the
        # expansion's rounding: |sqrt(a) - sqrt(b)| <= sqrt(|a - b|), |a - b| <= 8 d 2^-24 (|x|^2 + |y|^2)
        yy = x if y is None else y
        sq = (x.astype(np.float64) ** 2).sum(1)[:, None] + (yy.astype(np.float64) ** 2).sum(1)[None, :]
        bound = np.sqrt(8 * x.shape[1] * 2.0 ** -24 * sq)
        bound = bound.mean(-1) if reduction == "mean" else bound.sum(-1) if reduction == "sum" else bound
        allowed = np.maximum(allowed, bound)
    assert np.all(np.abs(got.numpy() - want) <= allowed), (got, want)


@pytest.mark.parametrize("fn", PAIRWISE)
def test_pairwise_input_checks_and_integer_inputs_match_jax(fn):
    x = np.arange(12, dtype=np.int32).reshape(4, 3)
    want = getattr(jf, fn)(jnp.asarray(x))
    got = getattr(pf, fn)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PAIR_TOL, atol=PAIR_TOL)
    with pytest.raises(ValueError, match="2D tensor of shape `\\[N, d\\]`"):
        getattr(pf, fn)(torch.zeros(3))
    with pytest.raises(ValueError, match="same as the last dimension"):
        getattr(pf, fn)(torch.zeros(3, 2), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="Expected reduction"):
        getattr(pf, fn)(torch.zeros(3, 2), reduction="max")
