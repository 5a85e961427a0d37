"""The port's ragged engine against the JAX package's, on the CPU.

Mirrors ``tests/engine/test_ragged.py`` and ``tests/engine/test_ragged_aggregate.py``
except their mesh cases: the typed refusals on both sides,
submit validation, mixed-group and scalar-group submits against JAX's engine
and the eager oracle, the device aggregate against its own oracle under every
``empty_target_action`` and with untouched groups, overflow through one typed
error on both paths, ``group_shard`` with a resident mix against the
unsharded engine, windows (tumbling with ``group_shard``, the sliding fold),
``merge_stacked_states``, zero new captures on replay, the ragged
``summary()`` block and OpenMetrics families, kill/resume, snapshots crossing
between the packages both ways, the multi-stream merge of per-row id
items, and detection's corpus aggregate (``MAP`` on JAX's ``_det_image``
traffic: device bundle, oracle, eager metric and JAX's engine key for key,
tied and zero scores, a declining plan, ``group_shard``, a tumbling pane,
the per-image occupancy read).

The JAX engines run as JAX's own tests run them: no mesh, the default
backend. Where JAX writes a snapshot, ``metrics_tpu.engine.snapshot._use_orbax``
is patched to return False, so it writes the pickle codec the port reads.
Predictions are rounded to one decimal, so ties are everywhere.

Tolerances: ``count``, the seq-ordered capacity buffers and ``_seq`` (and
the raw buffers) bit-exact against JAX's engine; per-group values and
aggregates within 1e-6 absolute of JAX's and of the eager metric; the
device aggregate within 1e-6 relative of the port's own oracle; detection's
COCO values exactly equal everywhere.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.engine.snapshot as jsnap
import metrics_tpu_torch as mp
from metrics_tpu.engine import AotCache as JaxAotCache
from metrics_tpu.engine import EngineConfig as JC
from metrics_tpu.engine import GroupedStateMetric as JGrouped
from metrics_tpu.engine import RaggedEngine as JRagged
from metrics_tpu_torch.engine import (
    AotCache,
    EngineConfig,
    GroupedStateMetric,
    MultiStreamEngine,
    RaggedEngine,
    StreamingEngine,
    WindowPolicy,
)
from metrics_tpu_torch.engine.ragged import _AGG_BLOCK_ROWS
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, TOOLS)
import trace_export  # noqa: E402

ATOL = 1e-6
_JAX_AOT = JaxAotCache()  # equally configured JAX engines share their programs


@pytest.fixture
def jax_pickle(monkeypatch):
    monkeypatch.setattr(jsnap, "_use_orbax", lambda: False)


def plan(seed=3, n_batches=4, rows=12, groups=8, empty_target_groups=(), untouched_groups=(), graded=False):
    """Batches of ``(preds, target, gids)`` with tied one-decimal preds;
    ``empty_target_groups`` get all-zero targets, ``untouched_groups`` no
    row, every other group at least one positive."""
    rng = np.random.RandomState(seed)
    live = [g for g in range(groups) if g not in untouched_groups]
    out = []
    for _ in range(n_batches):
        gids = np.asarray(rng.choice(live, rows), np.int64)
        preds = np.round(rng.rand(rows), 1).astype(np.float32)
        target = rng.randint(0, 3 if graded else 2, rows)
        target[np.isin(gids, list(empty_target_groups))] = 0
        for g in set(gids.tolist()) - set(empty_target_groups):
            sel = np.flatnonzero(gids == g)
            if not target[sel].any():
                target[sel[0]] = 1
        out.append((preds, target.astype(np.int64), gids))
    return out


def eager(pkg, name, batches, **kw):
    m = getattr(pkg, name)(**kw) if pkg is mt else getattr(pkg, name)(device="cpu", **kw)
    conv = jnp.asarray if pkg is mt else torch.from_numpy
    for p, t, g in batches:
        m.update(conv(p), conv(t), indexes=conv(g))
    return float(m.compute())


def port_engine(name="RetrievalMAP", groups=8, capacity=64, buckets=(16,), metric_kw=None, **kw):
    cfg = kw.pop("config", None) or EngineConfig(buckets=buckets)
    return RaggedEngine(getattr(mp, name)(device="cpu", **(metric_kw or {})), num_groups=groups, config=cfg,
                        capacity=capacity, **kw)


def jax_engine(name="RetrievalMAP", groups=8, capacity=64, buckets=(16,), metric_kw=None, **kw):
    cfg = kw.pop("config", None) or JC(buckets=buckets)
    return JRagged(getattr(mt, name)(**(metric_kw or {})), num_groups=groups, config=cfg, capacity=capacity,
                   aot_cache=_JAX_AOT, **kw)


def feed(eng, batches):
    for p, t, g in batches:
        eng.submit_update(p, t, g)
    eng.flush()


def port_state(eng):
    return {k: v.numpy() for k, v in eng.state().items()}


def jax_state(eng):
    return {k: np.asarray(v) for k, v in eng.state().items()}


def assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def seq_ordered(state, capacity):
    """Each group's valid rows in ``_seq`` order (numpy), per field."""
    counts = state["count"]
    valid = np.arange(capacity)[None, :] < np.minimum(counts, capacity)[:, None]
    order = np.argsort(np.where(valid, state["buf__seq"], np.iinfo(np.int32).max), axis=1, kind="stable")
    return {k: np.where(valid, np.take_along_axis(v, order, axis=1), 0) for k, v in state.items()
            if k.startswith("buf_")}


# ----------------------------------------------------------------- typed refusals


def test_ragged_engine_refuses_dense_metric_both_packages():
    with pytest.raises(MetricsTPUUserError, match="grouped_update_spec"):
        RaggedEngine(mp.Accuracy(device="cpu"), num_groups=4, config=EngineConfig(buckets=(8,)))
    with pytest.raises(Exception, match="grouped_update_spec"):
        JRagged(mt.Accuracy(), num_groups=4, config=JC(buckets=(8,)))


def test_ragged_engine_refuses_megastep_both_packages():
    with pytest.raises(MetricsTPUUserError, match="megastep"):
        RaggedEngine(mp.RetrievalMAP(device="cpu"), num_groups=4,
                     config=EngineConfig(buckets=(8,), kernel_backend="megastep"))
    with pytest.raises(Exception, match="megastep"):
        JRagged(mt.RetrievalMAP(), num_groups=4, config=JC(buckets=(8,), kernel_backend="megastep_interpret"))


def test_grouped_wrapper_refuses_eager_update_and_bad_capacity():
    with pytest.raises(MetricsTPUUserError, match="capacity"):
        GroupedStateMetric(mp.RetrievalMAP(device="cpu"), capacity=0)
    w = GroupedStateMetric(mp.RetrievalMAP(device="cpu"), capacity=8)
    with pytest.raises(MetricsTPUUserError, match="ragged engine"):
        w.update(torch.zeros(3), torch.zeros(3), torch.zeros(3))
    assert w.segmented_update_unsupported_reason() is None and w.stacked_merge_unsupported_reason() is None
    assert sorted(w.init_state()) == sorted(JGrouped(mt.RetrievalMAP(), capacity=8).init_state())


def test_submit_validation_matches_jax():
    bad = [((0, np.zeros(3, np.float32)), "2 field arrays"),
           ((0, np.zeros(3, np.float32), np.zeros(2, np.float32)), "leading"),
           ((np.asarray([0, 9, 1]), np.zeros(3, np.float32), np.zeros(3, np.float32)), "out of range"),
           ((np.zeros((3, 1), np.int64), np.zeros(3, np.float32), np.zeros(3, np.float32)), "scalar or a 1-d"),
           ((7, np.zeros(3, np.float32), np.zeros(3, np.float32)), "out of range")]
    eng, ref = port_engine(groups=4, capacity=8), jax_engine(groups=4, capacity=8)
    try:
        for args, match in bad:
            with pytest.raises(MetricsTPUUserError, match=match) as pe:
                eng.submit(*args)
            with pytest.raises(Exception) as je:
                ref.submit(*args)
            assert str(pe.value) == str(je.value)
    finally:
        eng.stop()
        ref.stop()


# ------------------------------------------------------------------ serving parity


@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalNormalizedDCG", "RetrievalMRR", "RetrievalPrecision"])
def test_mixed_group_submits_match_jax_engine_and_eager(name):
    batches = plan(seed=1, graded=name.endswith("DCG"))
    kw = {"k": 3} if name == "RetrievalPrecision" else {}
    want = eager(mt, name, batches, **kw)
    eng, ref = port_engine(name, metric_kw=kw), jax_engine(name, metric_kw=kw)
    with eng, ref:
        feed(eng, batches)
        feed(ref, batches)
        got_state, want_state = port_state(eng), jax_state(ref)
        assert_states_equal(got_state, want_state)  # count, raw buffers and _seq bit-exact
        so, jo = seq_ordered(got_state, 64), seq_ordered(want_state, 64)
        assert_states_equal(so, jo)
        dev, orc = float(eng.result()), float(eng.aggregate(oracle=True))
        per, jper = eng.results(), ref.results()
        one = float(eng.result(3))
        jdev = float(ref.result())
    np.testing.assert_allclose([dev, orc, jdev], [want] * 3, atol=ATOL)
    np.testing.assert_allclose(dev, orc, rtol=1e-6)
    np.testing.assert_allclose([float(per[g]) for g in range(8)], [float(jper[g]) for g in range(8)], atol=ATOL)
    np.testing.assert_allclose(one, float(jper[3]), atol=ATOL)
    assert eng._ingest_seq == ref._ingest_seq == sum(len(b[0]) for b in batches)


def test_scalar_group_submit_and_per_group_read():
    p0 = np.asarray([0.9, 0.2, 0.7], np.float32)
    t0 = np.asarray([1, 0, 1], np.int64)
    eng, ref = port_engine(groups=3, capacity=8, buckets=(8,)), jax_engine(groups=3, capacity=8, buckets=(8,))
    with eng, ref:
        for e in (eng, ref):
            e.submit(0, p0, t0.astype(np.float32))
            e.submit(2, p0[:2], t0[:2].astype(np.float32))
            e.flush()
        got = [float(eng.result(g)) for g in range(3)]
        want = [float(ref.result(g)) for g in range(3)]
        assert_states_equal(port_state(eng), jax_state(ref))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got[0], float(mp.functional.retrieval_average_precision(
        torch.from_numpy(p0), torch.from_numpy(t0))), atol=ATOL)
    assert got[1] == 0.0  # no rows: the eager metric's empty compute


def test_coalesced_scalar_and_array_items_match_jax():
    """Scalar-id and per-row-id items coalesce into one megabatch (the
    multi-stream merge broadcasts the one and concatenates the other)."""
    rng = np.random.RandomState(4)
    items = []
    for i in range(12):
        n = int(rng.randint(1, 6))
        gid = int(rng.randint(0, 5)) if i % 2 else rng.randint(0, 5, n)
        items.append((gid, np.round(rng.rand(n), 1).astype(np.float32), rng.randint(0, 2, n).astype(np.float32)))
    cfg = dict(buckets=(8, 32), coalesce=8, coalesce_window_ms=20.0)
    eng = RaggedEngine(mp.RetrievalMRR(device="cpu"), num_groups=5, config=EngineConfig(**cfg), capacity=32)
    ref = JRagged(mt.RetrievalMRR(), num_groups=5, config=JC(**cfg), capacity=32, aot_cache=_JAX_AOT)
    with eng, ref:
        for e in (eng, ref):
            for gid, p, t in items:
                e.submit(gid, p, t)
            e.flush()
        assert_states_equal(port_state(eng), jax_state(ref))
        np.testing.assert_allclose(float(eng.result()), float(ref.result()), atol=ATOL)
        assert eng.stats.batches_coalesced > 0


def test_merge_sized_takes_per_row_id_items():
    eng = port_engine(groups=6, capacity=8)
    try:
        a = (np.asarray([1, 2, 0], np.int32), (np.zeros(3, np.float32), np.ones(3, np.float32)), {})
        b = (4, (np.zeros(2, np.float32), np.ones(2, np.float32)), {})
        args, kw = eng._merge_sized([(a, 3), (b, 2)])
        np.testing.assert_array_equal(args[0], [1, 2, 0, 4, 4])
        assert args[1].shape == (5,) and kw == {}
        assert eng._group_context([a, b]) == {"group_ids": [0, 1, 2, 4]}
    finally:
        eng.stop()
    plain = MultiStreamEngine(mp.MeanMetric(device="cpu"), num_streams=6, config=EngineConfig(buckets=(8,)))
    try:
        args, _ = plain._merge_sized([((np.asarray([5, 3]), (np.ones(2, np.float32),), {}), 2),
                                     ((1, (np.ones(1, np.float32),), {}), 1)])
        np.testing.assert_array_equal(args[0], [5, 3, 1])
        assert plain._group_context([(np.asarray([5, 3]), (), {}), (1, (), {})]) == {"stream_ids": [1, 3, 5]}
    finally:
        plain.stop()


# --------------------------------------------------------------- the aggregate


@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalNormalizedDCG"])
def test_device_fold_equals_oracle_and_eager_with_empty_groups(name):
    batches = plan(untouched_groups=(1, 6), graded=name.endswith("DCG"))
    want = eager(mt, name, batches)
    eng = port_engine(name)
    with eng:
        feed(eng, batches)
        path, _ = eng.aggregate_path()
        dev, orc = float(eng.aggregate()), float(eng.aggregate(oracle=True))
        stats = eng.stats.ragged_summary()
    assert path == "device"
    np.testing.assert_allclose([dev, orc], [want, want], atol=ATOL)
    np.testing.assert_allclose(dev, orc, rtol=1e-6)
    assert stats["agg_device_reads"] == 1 and stats["agg_oracle_reads"] == 1


@pytest.mark.parametrize("action", ["neg", "skip", "pos"])
def test_all_empty_target_groups_fold_per_action(action):
    batches = plan(empty_target_groups=(0, 3), untouched_groups=(7,))
    want = eager(mt, "RetrievalMAP", batches, empty_target_action=action)
    eng = port_engine(metric_kw={"empty_target_action": action})
    with eng:
        feed(eng, batches)
        dev, orc = float(eng.aggregate()), float(eng.aggregate(oracle=True))
    np.testing.assert_allclose([dev, orc], [want, want], atol=ATOL)


def test_empty_target_error_raises_the_same_message_on_every_path():
    batches = plan(empty_target_groups=(2,))
    with pytest.raises(ValueError) as eager_err:
        eager(mt, "RetrievalMAP", batches, empty_target_action="error")
    eng = port_engine(metric_kw={"empty_target_action": "error"})
    with eng:
        feed(eng, batches)
        with pytest.raises(ValueError) as dev_err:
            eng.aggregate()
        with pytest.raises(ValueError) as orc_err:
            eng.aggregate(oracle=True)
        assert np.isnan(float(eng.result(2)))  # the per-group read defers: NaN
    assert str(dev_err.value) == str(orc_err.value) == str(eager_err.value)


def test_overflow_raises_the_same_typed_error_on_both_paths_and_in_jax():
    rng = np.random.RandomState(0)
    gids = np.asarray([1] * 6 + [2] * 2, np.int64)
    p, t = np.round(rng.rand(8), 1).astype(np.float32), rng.randint(0, 2, 8)
    eng, ref = port_engine(groups=4, capacity=4), jax_engine(groups=4, capacity=4)
    with eng, ref:
        feed(eng, [(p, t, gids)])
        feed(ref, [(p, t, gids)])
        with pytest.raises(MetricsTPUUserError, match="capacity") as dev_err:
            eng.aggregate()
        with pytest.raises(MetricsTPUUserError, match="capacity") as orc_err:
            eng.aggregate(oracle=True)
        with pytest.raises(Exception) as jax_err:
            ref.aggregate()
        assert eng.stats.summary()["ragged"]["overflows"] == 2
        assert np.isnan(float(eng.result(1)))
        assert_states_equal(port_state(eng), jax_state(ref))  # count keeps the true total, 6
    assert str(dev_err.value) == str(orc_err.value) == str(jax_err.value)
    assert "1 (6 rows)" in str(dev_err.value)


def test_masked_and_over_capacity_rows_leave_the_state_as_jax():
    """The ingest step: pad rows (a 5-row batch in an 8-row bucket) and rows
    past capacity go to the scratch cell; counts and buffers equal JAX's."""
    eng, ref = port_engine(groups=3, capacity=2, buckets=(8,)), jax_engine(groups=3, capacity=2, buckets=(8,))
    rows = [(np.asarray([0.1, 0.2, 0.3, 0.4, 0.5], np.float32), np.asarray([1, 0, 1, 1, 0]), np.asarray([0, 0, 0, 2, 0]))]
    with eng, ref:
        feed(eng, rows)
        feed(ref, rows)
        st = port_state(eng)
        assert_states_equal(st, jax_state(ref))
    np.testing.assert_array_equal(st["count"], [4, 0, 1])
    np.testing.assert_array_equal(st["buf_preds"][0], np.asarray([0.1, 0.2], np.float32))


def test_aggregate_oracle_flag_pins_the_host_path():
    batches = plan(seed=9)
    eng = port_engine(aggregate_oracle=True)
    with eng:
        feed(eng, batches)
        path, why = eng.aggregate_path()
        got = float(eng.result())
        stats = eng.stats.ragged_summary()
    assert path == "oracle" and "aggregate_oracle" in why
    np.testing.assert_allclose(got, eager(mt, "RetrievalMAP", batches), atol=ATOL)
    assert stats["agg_device_reads"] == 0 and stats["agg_oracle_reads"] == 1


def test_custom_metric_subclass_is_refused_by_the_ragged_engine():
    class MaxPred(mp.RetrievalMAP):
        def _metric(self, preds, target):
            return (preds * target).max()

    with pytest.raises(MetricsTPUUserError, match="grouped_update_spec"):
        RaggedEngine(MaxPred(device="cpu"), num_groups=4)


# ---------------------------------------------------------------- group_shard


def test_paged_resident_mix_matches_oracle_and_unsharded():
    g = 64
    batches = plan(seed=11, n_batches=6, rows=32, groups=g)
    want = eager(mt, "RetrievalMAP", batches)
    flat = port_engine(groups=g, buckets=(32,))
    paged = port_engine(groups=g, buckets=(32,), group_shard=True, resident_groups=8)
    with flat, paged:
        feed(flat, batches)
        feed(paged, batches)
        dev_flat = float(flat.aggregate())
        path, _ = paged.aggregate_path()
        dev, orc = float(paged.aggregate()), float(paged.aggregate(oracle=True))
        stats = paged.stats.ragged_summary()
        assert paged.stats.page_outs > 0
        assert_states_equal(port_state(paged), port_state(flat))
        per, per_flat = paged.results(), flat.results()
    assert path == "device"
    np.testing.assert_allclose([dev, orc, dev_flat], [want] * 3, atol=ATOL)
    np.testing.assert_allclose(dev, dev_flat, rtol=1e-6)
    touched = len(np.unique(np.concatenate([b[2] for b in batches])))
    assert stats["agg_blocks"] == -(-touched // _AGG_BLOCK_ROWS) == 1
    np.testing.assert_allclose([float(per[i]) for i in range(g)], [float(per_flat[i]) for i in range(g)], atol=ATOL)


def test_paged_sweep_block_count_follows_touched_groups():
    g = 3000
    rng = np.random.RandomState(2)
    gids = rng.choice(g, 2500, replace=False)
    p, t = np.round(rng.rand(2500), 1).astype(np.float32), rng.randint(0, 2, 2500)
    eng = port_engine(groups=g, capacity=4, buckets=(256, 1024), group_shard=True, resident_groups=512)
    with eng:
        feed(eng, [(p, t, gids)])
        dev, orc = float(eng.aggregate()), float(eng.aggregate(oracle=True))
        blocks = eng.stats.ragged_summary()["agg_blocks"]
    assert blocks == 3  # ceil(2500 / 1024): one per block of touched groups, never one per group
    np.testing.assert_allclose(dev, orc, rtol=1e-6)


# ------------------------------------------------------------ the corpus aggregate


def det_image(rng, n_gt, n_classes=3, fp=1, scores=(0.3, 0.6, 0.6, 0.85, 0.95)):
    """``tests/engine/test_ragged_aggregate.py``'s ``_det_image``: dets as
    jittered gt copies (a quarter class-flipped) plus false positives,
    scores from a small tie-heavy set."""
    empty = ({"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
              "labels": np.zeros(0, np.int32)},
             {"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int32)})
    if n_gt == 0:
        return empty
    xy = rng.uniform(0, 150, (n_gt, 2)).astype(np.float32)
    wh = rng.choice([8.0, 30.0, 90.0], (n_gt, 2)).astype(np.float32)
    gtb = np.concatenate([xy, xy + wh], axis=1)
    gtl = rng.randint(0, n_classes, n_gt).astype(np.int32)
    db = gtb + rng.uniform(-3, 3, (n_gt, 4)).astype(np.float32)
    dl = gtl.copy()
    flip = rng.rand(n_gt) < 0.25
    dl[flip] = (dl[flip] + 1) % n_classes
    fxy = rng.uniform(0, 150, (fp, 2)).astype(np.float32)
    fpb = np.concatenate([fxy, fxy + 20], axis=1)
    boxes = np.concatenate([db, fpb], axis=0)
    labels = np.concatenate([dl, rng.randint(0, n_classes, fp).astype(np.int32)])
    return ({"boxes": boxes, "scores": rng.choice(scores, boxes.shape[0]).astype(np.float32), "labels": labels},
            {"boxes": gtb, "labels": gtl})


def det_rounds(seed, groups=6, rounds=2, empty=(2,), **kw):
    """``rounds`` submissions per image id, image ``empty`` with no rows."""
    rng = np.random.RandomState(seed)
    return [[det_image(rng, 0 if i in empty else int(rng.randint(1, 5)), **kw) for i in range(groups)]
            for _ in range(rounds)]


def det_eager(pkg, rounds, **kw):
    """The eager metric over each image's rows of every round, concatenated."""
    m = pkg.MAP(**kw) if pkg is mt else pkg.MAP(device="cpu", **kw)
    preds, tgts = [], []
    for i in range(len(rounds[0])):
        preds.append({k: np.concatenate([r[i][0][k] for r in rounds]) for k in ("boxes", "scores", "labels")})
        tgts.append({k: np.concatenate([r[i][1][k] for r in rounds]) for k in ("boxes", "labels")})
    m.update(preds, tgts)
    return {k: np.asarray(v) for k, v in m.compute().items()}


def det_serve(eng, rounds):
    for r in rounds:
        for i, (p, t) in enumerate(r):
            eng.submit_update([p], [t], [i])
    eng.flush()


def assert_values_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=f"{what}: {k}")


@pytest.mark.parametrize("class_metrics", [False, True])
def test_corpus_aggregate_equals_oracle_eager_and_jax(class_metrics):
    """The device corpus bundle (K9's plain matcher here) equals the oracle,
    the eager metric and JAX's engine key for key: score ties, class flips,
    an empty image, two rounds per image id."""
    rounds = det_rounds(7)
    want = det_eager(mp, rounds, class_metrics=class_metrics)
    assert_values_equal(want, det_eager(mt, rounds, class_metrics=class_metrics), "eager vs JAX's eager")
    eng = RaggedEngine(mp.MAP(class_metrics=class_metrics, device="cpu"), num_groups=6, capacity=32)
    ref = JRagged(mt.MAP(class_metrics=class_metrics), num_groups=6, capacity=32, aot_cache=_JAX_AOT)
    with eng, ref:
        det_serve(eng, rounds)
        det_serve(ref, rounds)
        path = eng.aggregate_path()
        dev = eng.aggregate()
        orc = eng.aggregate(oracle=True)
        jax_dev = {k: np.asarray(v) for k, v in ref.aggregate().items()}
        stats = eng.stats.ragged_summary()
    assert path == ("device", "corpus device bundle + host curve interpolation") == ref.aggregate_path()
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32 for v in dev.values())
    assert_values_equal(dev, want, "device vs eager")
    assert_values_equal(orc, want, "oracle vs eager")
    assert_values_equal(dev, jax_dev, "device vs JAX's engine")
    assert stats["agg_device_reads"] == 1 and stats["agg_oracle_reads"] == 1
    assert float(dev["map"]) > 0.05  # the matching engaged


def test_corpus_sort_keeps_ingest_order_on_tied_and_zero_scores():
    """Scores of 0 (negated to -0.0) and scores equal across rounds: the
    per-image sort keeps ingest order, as the eager stable sort and XLA's do."""
    rounds = det_rounds(12, groups=5, rounds=3, empty=(), scores=(0.0, 0.0, 0.5), fp=2)
    want = det_eager(mp, rounds, class_metrics=True)
    eng = RaggedEngine(mp.MAP(class_metrics=True, device="cpu"), num_groups=5, capacity=48)
    ref = JRagged(mt.MAP(class_metrics=True), num_groups=5, capacity=48, aot_cache=_JAX_AOT)
    with eng, ref:
        det_serve(eng, rounds)
        det_serve(ref, rounds)
        assert_values_equal(eng.aggregate(), want, "device vs eager")
        assert_values_equal(eng.aggregate(), {k: np.asarray(v) for k, v in ref.aggregate().items()}, "vs JAX")


def test_corpus_plan_that_declines_reroutes_to_the_oracle():
    """A plan that declines (here: the budget shrunk to nothing; an empty
    corpus declines too) serves the oracle and records an oracle read, as
    JAX's engine does."""

    class TightMAP(mp.MAP):
        def grouped_corpus_plan(self, counts, scan):
            return None

    rounds = det_rounds(5, groups=4)
    eng = RaggedEngine(TightMAP(device="cpu"), num_groups=4, capacity=32)
    with eng:
        det_serve(eng, rounds)
        assert eng.aggregate_path()[0] == "device"
        got = eng.aggregate()
        stats = eng.stats.ragged_summary()
    assert_values_equal(got, det_eager(mp, rounds), "declined plan vs eager")
    assert stats["agg_device_reads"] == 0 and stats["agg_oracle_reads"] == 1
    empty, jempty = RaggedEngine(mp.MAP(device="cpu"), num_groups=3, capacity=8), JRagged(
        mt.MAP(), num_groups=3, capacity=8, aot_cache=_JAX_AOT)
    with empty, jempty:
        assert_values_equal(empty.aggregate(), {k: np.asarray(v) for k, v in jempty.aggregate().items()}, "empty")
        assert empty.stats.ragged_summary()["agg_oracle_reads"] == 1


def test_corpus_under_group_shard_takes_the_oracle():
    rounds = det_rounds(6, groups=4)
    eng = RaggedEngine(mp.MAP(device="cpu"), num_groups=4, capacity=32, group_shard=True, resident_groups=2)
    with eng:
        det_serve(eng, rounds)
        path = eng.aggregate_path()
        got = eng.aggregate()
    assert path[0] == "oracle" and "group_shard" in path[1]
    assert_values_equal(got, det_eager(mp, rounds), "group_shard vs eager")


def test_corpus_tumbling_window_reads_the_open_pane():
    """A tumbling ring of two-round panes over three rounds: the aggregate is
    the open pane's corpus, the last round, on the device path and the
    oracle alike."""
    rounds = det_rounds(9, groups=4, rounds=3)
    cfg = EngineConfig(buckets=(16,), window=WindowPolicy.tumbling(pane_batches=6))
    eng = RaggedEngine(mp.MAP(device="cpu"), num_groups=4, capacity=32, config=cfg)
    with eng:
        det_serve(eng, rounds)  # a batch per non-empty image and round (image 2 has no rows): 3 a round
        assert eng.aggregate_path()[0] == "device" and eng.rotations == 1
        got, orc = eng.aggregate(), eng.aggregate(oracle=True)
    want = det_eager(mp, rounds[2:])
    assert_values_equal(got, want, "windowed device vs eager")
    assert_values_equal(orc, want, "windowed oracle vs eager")


def test_result_image_id_reads_occupancy_as_jax():
    rounds = det_rounds(4, groups=5)
    eng = RaggedEngine(mp.MAP(device="cpu"), num_groups=5, capacity=32)
    ref = JRagged(mt.MAP(), num_groups=5, capacity=32, aot_cache=_JAX_AOT)
    with eng, ref:
        det_serve(eng, rounds)
        det_serve(ref, rounds)
        every = eng.results()
        for gid in range(5):
            got, want = eng.result(gid), ref.result(gid)
            assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}
            assert {k: int(v) for k, v in every[gid].items()} == {k: int(v) for k, v in want.items()}
    assert {k: int(v) for k, v in every[2].items()} == {"detections": 0, "groundtruths": 0}


# -------------------------------------------------------------------- windows


@pytest.mark.parametrize("group_shard", [False, True])
def test_tumbling_window_reads_the_open_pane(group_shard):
    """Three batches into panes of two: the rotation after batch 2 leaves
    batch 3 alone in the open pane, which the aggregate and the per-group
    reads serve."""
    batches = plan(seed=8, n_batches=3, rows=10, groups=4)
    cfg = EngineConfig(buckets=(16,), window=WindowPolicy.tumbling(pane_batches=2))
    kw = {"group_shard": True, "resident_groups": 2} if group_shard else {}
    eng = port_engine(groups=4, capacity=32, config=cfg, **kw)
    with eng:
        feed(eng, batches)
        assert eng.aggregate_path()[0] == "device" and eng.rotations == 1
        got, orc = float(eng.result()), float(eng.aggregate(oracle=True))
        per = [float(v) for v in eng.results().values()]
    want = eager(mt, "RetrievalMAP", batches[2:])
    np.testing.assert_allclose([got, orc], [want, want], atol=ATOL)
    one = port_engine(groups=4, capacity=32)
    with one:
        feed(one, batches[2:])
        np.testing.assert_allclose(per, [float(v) for v in one.results().values()], atol=ATOL)


@pytest.mark.parametrize("group_shard", [False, True])
def test_sliding_window_fold_matches_oracle(group_shard):
    batches = plan(seed=9, n_batches=3, rows=8, groups=4)
    cfg = EngineConfig(buckets=(8,), window=WindowPolicy.sliding(n_panes=4, pane_batches=1))
    kw = {"group_shard": True, "resident_groups": 3} if group_shard else {}
    eng = port_engine(groups=4, capacity=32, config=cfg, **kw)
    with eng:
        feed(eng, batches)
        path = eng.aggregate_path()[0]
        got = float(eng.result())
    assert path == ("oracle" if group_shard else "device")
    np.testing.assert_allclose(got, eager(mt, "RetrievalMAP", batches), atol=ATOL)


def test_sliding_ring_matches_jax_engine():
    batches = plan(seed=10, n_batches=6, rows=8, groups=5)
    jcfg = JC(buckets=(8,), window=__import__("metrics_tpu.engine", fromlist=["WindowPolicy"]).WindowPolicy.sliding(
        n_panes=2, pane_batches=2))
    eng = port_engine(groups=5, capacity=16, config=EngineConfig(buckets=(8,), window=WindowPolicy.sliding(
        n_panes=2, pane_batches=2)))
    ref = jax_engine(groups=5, capacity=16, config=jcfg)
    with eng, ref:
        feed(eng, batches)
        feed(ref, batches)
        assert_states_equal(port_state(eng), jax_state(ref))
        np.testing.assert_allclose(float(eng.result()), float(ref.result()), atol=ATOL)
    # rotations after batches 2, 4 and 6: the live window is batches 5-6 and an empty pane
    np.testing.assert_allclose(float(eng.result()), eager(mt, "RetrievalMAP", batches[4:]), atol=ATOL)


def test_drift_reads_every_group_of_the_closing_pane():
    """A tumbling ring with a drift detector: each rotation records one
    series per group, the closing pane's per-group values, read batched."""
    from metrics_tpu_torch.engine import DriftDetector

    batches = plan(seed=14, n_batches=4, rows=10, groups=4)
    det = DriftDetector(threshold=0.5)
    cfg = EngineConfig(buckets=(16,), window=WindowPolicy.tumbling(pane_batches=2), drift=det)
    eng = port_engine(groups=4, capacity=32, config=cfg)
    with eng:
        feed(eng, batches[:2])
        assert eng.rotations == 1
    first = port_engine(groups=4, capacity=32)
    with first:
        feed(first, batches[:2])
        want = [float(v) for v in first.results().values()]
    assert eng.stats.drift_evals == 4  # one per group series
    got = [det.history(g)[-1] for g in range(4)]
    np.testing.assert_allclose(got, want, atol=ATOL)


# ------------------------------------------------------ the wrapper's merge


def _merge_inputs(count, buf, seq):
    return {"count": count, "buf_preds": buf, "buf_target": buf, "buf__seq": seq}


def test_merge_stacked_states_compacts_replica_major_as_jax():
    count = np.asarray([[2, 0, 0], [1, 2, 0]], np.int32)
    buf = np.zeros((2, 3, 4), np.float32)
    buf[0, 0, :2] = [1.0, 2.0]
    buf[1, 0, :1] = [3.0]
    buf[1, 1, :2] = [4.0, 5.0]
    seq = np.zeros((2, 3, 4), np.int32)
    seq[0, 0, :2] = [10, 11]
    seq[1, 0, :1] = [12]
    seq[1, 1, :2] = [13, 14]
    got = GroupedStateMetric(mp.RetrievalMAP(device="cpu"), capacity=4).merge_stacked_states(
        {k: torch.from_numpy(v) for k, v in _merge_inputs(count, buf, seq).items()})
    want = JGrouped(mt.RetrievalMAP(), capacity=4).merge_stacked_states(
        {k: jnp.asarray(v) for k, v in _merge_inputs(count, buf, seq).items()})
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["count"].numpy(), [3, 2, 0])
    np.testing.assert_array_equal(got["buf__seq"].numpy()[0, :3], [10, 11, 12])
    assert got["count"].dtype == torch.int32


def test_merge_stacked_states_overflow_sums_the_true_count():
    count = np.asarray([[2], [2]], np.int32)
    buf = np.asarray([[[1.0, 2.0]], [[3.0, 4.0]]], np.float32)
    seq = np.asarray([[[0, 1]], [[2, 3]]], np.int32)
    merged = GroupedStateMetric(mp.RetrievalMAP(device="cpu"), capacity=2).merge_stacked_states(
        {k: torch.from_numpy(v) for k, v in _merge_inputs(count, buf, seq).items()})
    assert int(merged["count"][0]) == 4
    np.testing.assert_array_equal(merged["buf_preds"].numpy()[0], [1.0, 2.0])


# ----------------------------------------------------------- captures, telemetry


def test_replay_after_reset_captures_nothing_new():
    batches = plan(seed=11, n_batches=3)
    cache = AotCache()
    eng = port_engine(aot_cache=cache)
    with eng:
        feed(eng, batches)
        warm = cache.misses
        eng.reset()
        feed(eng, batches)
        assert cache.misses == warm
        np.testing.assert_allclose(float(eng.result()), eager(mt, "RetrievalMAP", batches), atol=ATOL)


def test_summary_block_and_openmetrics_families_on_ragged_engines_only():
    eng = port_engine(groups=5, capacity=8, buckets=(8,))
    ref = jax_engine(groups=5, capacity=8, buckets=(8,))
    with eng, ref:
        for e in (eng, ref):
            e.submit_update(np.asarray([0.9, 0.1, 0.5], np.float32), np.asarray([1, 0, 1]), np.asarray([0, 0, 2]))
            e.flush()
            e.aggregate()
            e.aggregate(oracle=True)
        block, jblock = eng.stats.summary()["ragged"], ref.stats.summary()["ragged"]
        fams = trace_export.parse_openmetrics(eng.metrics_text())
    assert block == jblock
    assert block["groups"] == 5 and block["capacity"] == 8 and block["groups_touched"] == 2
    for fam, want in (("batches", 1), ("rows", 3), ("groups_touched", 2), ("overflows", 0), ("agg_device_reads", 1),
                      ("agg_oracle_reads", 1), ("agg_blocks", 0)):
        f = fams[f"metrics_tpu_engine_ragged_{fam}"]
        assert f["type"] == "counter" and int(f["samples"][0]["value"]) == want, fam
    for fam, want in (("groups", 5), ("capacity", 8)):
        f = fams[f"metrics_tpu_engine_ragged_{fam}"]
        assert f["type"] == "gauge" and int(f["samples"][0]["value"]) == want, fam
    plain = StreamingEngine(mp.MeanMetric(device="cpu"), EngineConfig(buckets=(8,)))
    with plain:
        plain.submit(np.ones(2, np.float32))
        plain.flush()
        assert "ragged" not in plain.metrics_text() and "ragged" not in plain.stats.summary()


def test_engine_report_renders_the_ragged_row():
    import engine_report

    eng = port_engine(groups=5, capacity=8, buckets=(8,))
    with eng:
        eng.submit_update(np.asarray([0.9, 0.1, 0.5], np.float32), np.asarray([1, 0, 1]), np.asarray([0, 0, 2]))
        eng.flush()
        rendered = engine_report.render({"summary": eng.stats.summary(), "recent_steps": []})
    assert "ragged groups" in rendered and "2 of 5 touched" in rendered and "capacity 8" in rendered


# ------------------------------------------------------------------ snapshots


def test_kill_resume_device_aggregate_is_exact(tmp_path):
    batches = plan(seed=5)
    want = eager(mt, "RetrievalMAP", batches)
    cfg = lambda: EngineConfig(buckets=(12,), snapshot_dir=str(tmp_path))  # noqa: E731
    first = port_engine(config=cfg())
    with first:
        feed(first, batches[:2])
        first.snapshot()
    resumed = port_engine(config=cfg())
    with resumed:
        resumed.restore()
        feed(resumed, batches[2:])
        dev, orc = float(resumed.aggregate()), float(resumed.aggregate(oracle=True))
        assert resumed._ingest_seq == sum(len(b[0]) for b in batches)
    np.testing.assert_allclose([dev, orc], [want, want], atol=ATOL)


def test_restore_refusals_match_jax(tmp_path):
    snapdir = str(tmp_path / "plain")
    plain = StreamingEngine(mp.MeanMetric(device="cpu"), EngineConfig(buckets=(8,), snapshot_dir=snapdir))
    with plain:
        plain.submit(np.ones(4, np.float32))
        plain.flush()
        plain.snapshot()
    eng = port_engine(groups=2, capacity=8, config=EngineConfig(buckets=(8,), snapshot_dir=snapdir))
    with eng:
        with pytest.raises(MetricsTPUUserError, match="not written by a ragged"):
            eng.restore()
    snapdir = str(tmp_path / "ragged")
    src = port_engine(groups=4, capacity=8, config=EngineConfig(buckets=(8,), snapshot_dir=snapdir))
    with src:
        src.submit_update(np.asarray([0.5, 0.4], np.float32), np.asarray([1, 0]), np.asarray([0, 1]))
        src.flush()
        src.snapshot()
    for groups, capacity, match in ((4, 16, "capacity=8"), (5, 8, "4 groups")):
        bad = port_engine(groups=groups, capacity=capacity, config=EngineConfig(buckets=(8,), snapshot_dir=snapdir))
        jbad = jax_engine(groups=groups, capacity=capacity, config=JC(buckets=(8,), snapshot_dir=snapdir))
        with bad, jbad:
            with pytest.raises(MetricsTPUUserError, match=match) as pe:
                bad.restore()
            with pytest.raises(Exception) as je:
                jbad.restore()
        assert str(pe.value) == str(je.value)


def test_a_jax_snapshot_restores_into_the_port_and_back(tmp_path, jax_pickle):
    """JAX's engine snapshots mid-plan; the port restores it and replays the
    rest to JAX's straight-through state and value; then the port snapshots
    mid-plan and JAX restores and replays likewise."""
    batches = plan(seed=12, n_batches=6)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    straight = jax_engine()
    with straight:
        feed(straight, batches)
        want_state, want = jax_state(straight), float(straight.result())
    src = jax_engine(config=JC(buckets=(16,), snapshot_dir=jdir))
    with src:
        feed(src, batches[:3])
        src.snapshot()
    port = port_engine(config=EngineConfig(buckets=(16,), snapshot_dir=jdir))
    with port:
        meta = port.restore()
        assert int(meta["ragged"]) == 1 and int(meta["ragged_seq"]) == sum(len(b[0]) for b in batches[:3])
        feed(port, batches[3:])
        assert_states_equal(port_state(port), want_state)
        np.testing.assert_allclose(float(port.result()), want, atol=ATOL)
    mid = port_engine(config=EngineConfig(buckets=(16,), snapshot_dir=pdir))
    with mid:
        feed(mid, batches[:3])
        mid.snapshot()
    back = jax_engine(config=JC(buckets=(16,), snapshot_dir=pdir))
    with back:
        back.restore()
        feed(back, batches[3:])
        assert_states_equal(jax_state(back), want_state)
        np.testing.assert_allclose(float(back.result()), want, atol=ATOL)


def test_a_paged_snapshot_resumes_paged_and_merges_unsharded(tmp_path):
    batches = plan(seed=13, n_batches=6, rows=16, groups=24)
    want = eager(mt, "RetrievalMAP", batches)
    snapdir = str(tmp_path / "paged")
    src = port_engine(groups=24, config=EngineConfig(buckets=(16,), snapshot_dir=snapdir), group_shard=True,
                      resident_groups=4)
    with src:
        feed(src, batches[:3])
        assert src.stats.page_outs > 0
        src.snapshot()
    for kw in ({"group_shard": True, "resident_groups": 4}, {"group_shard": True, "resident_groups": 9}, {}):
        eng = port_engine(groups=24, config=EngineConfig(buckets=(16,), snapshot_dir=snapdir), **kw)
        with eng:
            eng.restore()
            feed(eng, batches[3:])
            dev, orc = float(eng.aggregate()), float(eng.aggregate(oracle=True))
        np.testing.assert_allclose([dev, orc], [want, want], atol=ATOL, err_msg=str(kw))
