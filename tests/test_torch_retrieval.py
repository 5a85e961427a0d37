"""The port's retrieval metrics and functionals against the JAX package, on the CPU.

The same seeded numpy inputs go to both packages: the eight per-query
functionals, the eight module metrics under every ``empty_target_action``
(``error`` raising JAX's message), ``ignore_index``, graded NDCG targets, a
subclass with its own ``_metric`` (the host loop), the segment internals the
ragged engine reads (the corpus mean, the per-group read, the batched group
scores), the stable sort order of ties, ``+-0`` and NaN, the typed refusals
of the non-ragged engines, and the cat-list states gathered by the port's
eager ``sync()`` at world 2 over gloo (``tests/helpers/torch_sync_worker.py``).

Predictions are rounded to one decimal, so every corpus carries ties.
Tolerance: 1e-6 absolute on every f32 value; integer outputs (sort orders,
group positions, counts) bit-exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.functional.retrieval import _segment as jseg
from metrics_tpu_torch.functional.retrieval import _segment as pseg
from metrics_tpu_torch.utils.checks import deferred_value_checks, traced_rows
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.helpers import torch_sync_worker as w

ATOL = 1e-6
METRICS = ("RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut",
           "RetrievalHitRate", "RetrievalRPrecision", "RetrievalNormalizedDCG")
WITH_K = ("RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut", "RetrievalHitRate", "RetrievalNormalizedDCG")
FUNCTIONALS = {
    "retrieval_average_precision": False, "retrieval_reciprocal_rank": False, "retrieval_r_precision": False,
    "retrieval_precision": True, "retrieval_recall": True, "retrieval_fall_out": True, "retrieval_hit_rate": True,
    "retrieval_normalized_dcg": True,
}


def corpus(seed, n=48, groups=7, graded=False, empty_groups=()):
    """``(preds, target, indexes)`` with one-decimal preds (ties); groups in
    ``empty_groups`` get all-zero targets, every other touched group at
    least one positive and one negative."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, groups, n)
    preds = np.round(rng.rand(n), 1).astype(np.float32)
    target = rng.randint(0, 4 if graded else 2, n)
    for g in np.unique(idx):
        sel = np.flatnonzero(idx == g)
        if g in empty_groups:
            target[sel] = 0
            continue
        target[sel[0]] = 1
        if sel.size > 1:
            target[sel[-1]] = 0
    return preds, target.astype(np.int64), idx.astype(np.int64)


def both(name, **kw):
    return getattr(mp, name)(device="cpu", **kw), getattr(mt, name)(**kw)


def run_both(name, batches, **kw):
    """The port's and JAX's metric updated over ``batches``; returns the two
    computes (or the two raised messages)."""
    port, ref = both(name, **kw)
    for p, t, i in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
        ref.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(i))
    out = []
    for m in (port, ref):
        try:
            out.append(float(m.compute()))
        except ValueError as e:
            out.append(str(e))
    return out


# ----------------------------------------------------------------- functionals


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", sorted(FUNCTIONALS))
def test_functionals_match_jax(name, seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 30))
    preds = np.round(rng.rand(n), 1).astype(np.float32)
    target = rng.randint(0, 4 if name.endswith("dcg") else 2, n)
    if seed == 0:
        target[:] = 0  # a query with no relevant document
    ks = [None, 1, 3, n + 2] if FUNCTIONALS[name] else [None]
    pf, jf = getattr(mp.functional, name), getattr(mt.functional, name)
    for k in ks:
        kw = {} if k is None else {"k": k}
        got = pf(torch.from_numpy(preds), torch.from_numpy(target), **kw)
        want = jf(jnp.asarray(preds), jnp.asarray(target), **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), atol=ATOL, err_msg=f"{name} k={k}")


@pytest.mark.parametrize("bad", ["shape", "empty", "int_preds", "float_target", "non_binary", "k"])
def test_functional_validation_messages_match_jax(bad):
    preds, target = np.asarray([0.2, 0.7, 0.4], np.float32), np.asarray([1, 0, 1])
    kw = {}
    if bad == "shape":
        target = target[:2]
    elif bad == "empty":
        preds, target = preds[:0], target[:0]
    elif bad == "int_preds":
        preds = np.asarray([1, 0, 2])
    elif bad == "float_target":
        target = target.astype(np.float32)
    elif bad == "non_binary":
        target = np.asarray([2, 0, 1])
    else:
        kw = {"k": 0}
    msgs = []
    for f, conv in ((mp.functional.retrieval_precision, torch.from_numpy), (mt.functional.retrieval_precision,
                                                                            jnp.asarray)):
        with pytest.raises(ValueError) as e:
            f(conv(preds), conv(target), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_log2_position_discounts_equal_jax():
    from metrics_tpu.functional.retrieval.ndcg import log2_position_discounts as jdisc
    from metrics_tpu_torch.functional.retrieval.ndcg import log2_position_discounts as pdisc

    np.testing.assert_array_equal(pdisc(513, torch.device("cpu")).numpy(), np.asarray(jdisc(513)))


def test_get_group_indexes_equal_jax():
    from metrics_tpu.utils.data import get_group_indexes as jg
    from metrics_tpu_torch.utils.data import get_group_indexes as pg

    idx = np.asarray([3, 1, 3, 0, 1, 1, 7])
    got, want = pg(torch.from_numpy(idx)), jg(jnp.asarray(idx))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------------- metrics


@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("name", METRICS)
def test_metrics_match_jax_per_action(name, action):
    preds, target, idx = corpus(1, empty_groups=(2,), graded=name.endswith("DCG"))
    batches = [(preds[:20], target[:20], idx[:20]), (preds[20:], target[20:], idx[20:])]
    got, want = run_both(name, batches, empty_target_action=action)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", METRICS)
def test_error_action_raises_jax_message(name):
    # fall-out's degenerate query has no NEGATIVE target: make every target 1 in one group
    preds, target, idx = corpus(2, empty_groups=(3,))
    if name == "RetrievalFallOut":
        target[idx == 3] = 1
    got, want = run_both(name, [(preds, target, idx)], empty_target_action="error")
    assert isinstance(got, str) and got == want
    clean = corpus(2)
    if name == "RetrievalFallOut":
        clean[1][clean[2] == 0] = 0  # a negative in every group
    got, want = run_both(name, [clean], empty_target_action="error")
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("name", WITH_K)
def test_metrics_at_k_match_jax(name, k):
    preds, target, idx = corpus(3, n=60, groups=9, graded=name.endswith("DCG"))
    got, want = run_both(name, [(preds, target, idx)], k=k)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalPrecision", "RetrievalNormalizedDCG"])
def test_ignore_index_matches_jax(name):
    preds, target, idx = corpus(4, n=40)
    target[::5] = -100
    got, want = run_both(name, [(preds, target, idx)], ignore_index=-100)
    np.testing.assert_allclose(got, want, atol=ATOL)
    port = getattr(mp, name)(device="cpu", ignore_index=-100)
    port.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(idx))
    assert sum(int(x.numel()) for x in port.target) == 32  # the 8 ignored rows were dropped eagerly


def test_ndcg_graded_targets_match_jax_and_host_loop():
    preds, target, idx = corpus(5, n=64, groups=6, graded=True)
    got, want = run_both("RetrievalNormalizedDCG", [(preds, target, idx)])
    np.testing.assert_allclose(got, want, atol=ATOL)
    port = mp.RetrievalNormalizedDCG(device="cpu")
    port.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(idx))
    host = port._compute_host(torch.cat(port.indexes), torch.cat(port.preds), torch.cat(port.target))
    np.testing.assert_allclose(float(host), got, atol=ATOL)


def _custom(pkg):
    base = pkg.RetrievalMAP

    class MaxPred(base):
        """Its own _metric: the highest prediction of a relevant document."""

        def _metric(self, preds, target):
            return (preds * target).max()

    return MaxPred


def test_custom_metric_subclass_takes_the_host_loop_as_jax():
    preds, target, idx = corpus(6)
    port, ref = _custom(mp)(device="cpu"), _custom(mt)()
    assert port._segment_dispatch() is None and ref._segment_dispatch() is None
    assert port.grouped_update_spec() is None and port.masked_update_strategy() is None
    port.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(idx))
    ref.update(jnp.asarray(preds), jnp.asarray(target), indexes=jnp.asarray(idx))
    np.testing.assert_allclose(float(port.compute()), float(ref.compute()), atol=ATOL)


@pytest.mark.parametrize("name", METRICS)
def test_segment_path_equals_host_loop(name):
    preds, target, idx = corpus(7, n=80, groups=11, graded=name.endswith("DCG"))
    port = getattr(mp, name)(device="cpu")
    port.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(idx))
    seg = port.compute()
    host = port._compute_host(torch.cat(port.indexes), torch.cat(port.preds), torch.cat(port.target))
    np.testing.assert_allclose(float(seg), float(host), atol=ATOL)


def test_empty_metric_computes_zero_as_jax():
    for name in METRICS:
        port, ref = both(name)
        assert float(port.compute()) == float(ref.compute()) == 0.0


def test_metric_argument_checks_match_jax():
    for kw in ({"empty_target_action": "maybe"}, {"ignore_index": 1.5}, {"k": 0}):
        msgs = []
        for pkg in (mp, mt):
            with pytest.raises(ValueError) as e:
                pkg.RetrievalPrecision(**kw) if pkg is mt else pkg.RetrievalPrecision(device="cpu", **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    port = mp.RetrievalMAP(device="cpu")
    with pytest.raises(ValueError, match="cannot be None"):
        port.update(torch.zeros(3), torch.zeros(3, dtype=torch.int64), indexes=None)
    with pytest.raises(ValueError, match="long integers"):
        port.update(torch.zeros(3), torch.zeros(3, dtype=torch.int64), indexes=torch.zeros(3))


# ------------------------------------------------------------ segment internals


@pytest.mark.parametrize("kind", pseg.KINDS)
def test_segment_mean_and_group_reads_match_jax(kind):
    preds, target, idx = corpus(8, n=50, groups=6, graded=kind == "ndcg", empty_groups=(4,))
    for k in (None, 2):
        for action in ("neg", "pos", "skip"):
            got = pseg.segment_retrieval_mean(torch.from_numpy(preds), torch.from_numpy(target).float(),
                                              torch.from_numpy(idx).int(), kind=kind, k=k,
                                              empty_target_action=action)
            want = jseg.segment_retrieval_mean(jnp.asarray(preds), jnp.asarray(target, jnp.float32),
                                               jnp.asarray(idx, jnp.int32), kind=kind, k=k,
                                               empty_target_action=action)
            np.testing.assert_allclose(float(got), float(want), atol=ATOL)
    # capacity buffers: 5 groups of 8 slots, one empty, one overflowed, garbage past the counts
    rng = np.random.RandomState(9)
    p = np.round(rng.rand(5, 8), 1).astype(np.float32)
    t = rng.randint(0, 3 if kind == "ndcg" else 2, (5, 8)).astype(np.float32)
    counts = np.asarray([3, 0, 8, 11, 5], np.int32)
    t[4] = 0.0  # a degenerate group
    for action in ("neg", "pos", "skip"):
        kw = dict(kind=kind, k=3, empty_target_action=action)
        v, keep, flag = pseg.batched_group_scores(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(counts),
                                                  **kw)
        jv, jkeep, jflag = jseg.batched_group_scores(jnp.asarray(p), jnp.asarray(t), jnp.asarray(counts), **kw)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(flag.numpy(), np.asarray(jflag))
        batched = pseg.grouped_query_score(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(counts), **kw)
        for g in range(5):
            want = float(jseg.grouped_query_score(jnp.asarray(p[g]), jnp.asarray(t[g]), jnp.asarray(counts[g]), **kw))
            one = float(pseg.grouped_query_score(torch.from_numpy(p[g]), torch.from_numpy(t[g]),
                                                 torch.tensor(counts[g]), **kw))
            np.testing.assert_allclose([one, float(batched[g])], [want, want], atol=ATOL, equal_nan=True)


def test_group_read_error_action_raises_eagerly_and_defers_traced():
    p = torch.tensor([0.5, 0.2, 0.0, 0.0])
    t = torch.zeros(4)
    kw = dict(kind="map", empty_target_action="error")
    with pytest.raises(ValueError, match="no positive target"):
        pseg.grouped_query_score(p, t, torch.tensor(2), **kw)
    with traced_rows(), deferred_value_checks() as d:
        v = pseg.grouped_query_score(p, t, torch.tensor(2), **kw)
        r = pseg.segment_retrieval_mean(p, t, torch.tensor([0, 0, 1, 1]), **kw)
    assert np.isnan(float(v)) and np.isnan(float(r))
    from metrics_tpu_torch.utils.checks import _CODE_EMPTY_QUERY_RETRIEVAL

    assert int(d.combined()) == _CODE_EMPTY_QUERY_RETRIEVAL


def test_group_order_of_ties_signed_zeros_and_nan_equals_jax_lexsort():
    score = np.asarray([0.0, -0.0, 0.5, np.nan, 0.5, -0.0, 0.0, np.nan, 1.0, -1.0], np.float32)
    idx = np.asarray([1, 0, 1, 0, 0, 1, 0, 1, 0, 1], np.int64)
    got = pseg._group_order(torch.from_numpy(idx)[None], torch.from_numpy(score)[None])[0].numpy()
    want = np.asarray(jnp.lexsort((-jnp.asarray(score), jnp.asarray(idx))))
    np.testing.assert_array_equal(got, want)
    got1 = pseg._group_order(torch.zeros((1, 7), dtype=torch.int64), torch.from_numpy(score[:7])[None])[0].numpy()
    np.testing.assert_array_equal(got1, np.asarray(jnp.lexsort((-jnp.asarray(score[:7]), jnp.zeros(7, jnp.int32)))))


# ------------------------------------------------------------ engine refusals


def _swap(msg):
    return msg.replace("metrics_tpu_torch.", "metrics_tpu.")


def test_non_ragged_engines_refuse_retrieval_with_jax_pointer():
    from metrics_tpu.engine import EngineConfig as JC, MultiStreamEngine as JM, StreamingEngine as JS
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine

    port, ref = mp.RetrievalMAP(device="cpu"), mt.RetrievalMAP()
    assert port.masked_update_strategy() == ref.masked_update_strategy() == "grouped"
    assert _swap(port.grouped_refusal_reason()) == ref.grouped_refusal_reason()
    for make_port, make_ref in ((lambda: StreamingEngine(port, EngineConfig(buckets=(8,))),
                                 lambda: JS(ref, JC(buckets=(8,)))),
                                (lambda: MultiStreamEngine(port, num_streams=2, config=EngineConfig(buckets=(8,))),
                                 lambda: JM(ref, num_streams=2, config=JC(buckets=(8,))))):
        with pytest.raises(MetricsTPUUserError) as pe:
            make_port()
        with pytest.raises(Exception) as je:
            make_ref()
        assert _swap(str(pe.value)) == str(je.value)
        assert "RaggedEngine" in str(pe.value) and "'indexes'" in str(pe.value)
    with pytest.raises(MetricsTPUUserError, match="ragged path"):
        port.update_state_masked(port.init_state(), torch.zeros(2), torch.zeros(2), torch.zeros(2),
                                 mask=torch.ones(2, dtype=torch.bool))


# --------------------------------------------------------- world 2 over gloo


@pytest.fixture(scope="module")
def pool():
    p = w.RankPool()
    yield p
    p.close()


@pytest.mark.parametrize("interleaved", [False, True])
def test_gathered_cat_lists_give_the_full_corpus_value(pool, interleaved):
    """Each of two gloo ranks holds two queries; ``compute()`` under the
    eager sync gathers the flat cat lists, and the value is the full
    corpus's, in the port alone and in JAX."""
    got = pool.run("retrieval", group="pair", interleaved=interleaved)
    assert got[2] is None
    shards = [w.retrieval_rows(r, interleaved) for r in range(2)]
    full = [np.concatenate([s[j] for s in shards]) for j in range(3)]
    for name in w.retrieval_suite(mp, device="cpu"):
        single = w.retrieval_suite(mp, device="cpu")[name]
        single.update(torch.from_numpy(full[0]), torch.from_numpy(full[1]), indexes=torch.from_numpy(full[2]))
        ref = w.retrieval_suite(mt)[name]
        ref.update(jnp.asarray(full[0]), jnp.asarray(full[1]), indexes=jnp.asarray(full[2]))
        want = float(ref.compute())
        np.testing.assert_allclose(float(single.compute()), want, atol=ATOL)
        for rank in range(2):
            res = got[rank][name]
            np.testing.assert_allclose(float(res["compute"][2]), want, atol=ATOL, err_msg=f"{name} rank {rank}")
            # the gathered lists: rank 0's rows, then rank 1's, flat
            np.testing.assert_array_equal(res["synced"]["indexes"][2], full[2].astype(np.int32))
            np.testing.assert_array_equal(res["synced"]["preds"][2], full[0])
