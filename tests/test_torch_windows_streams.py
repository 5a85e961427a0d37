"""The port's windowed multi-stream serving and windowed snapshots against the
JAX package's, on the CPU.

* **Unsharded** ``MultiStreamEngine``: the pane axis stacks outside the
  stream axis. Tumbling and sliding rings over seeded Zipf traffic:
  ``results()``, ``result(sid)``, the ``(panes, S, ...)`` ``state()`` and the
  ``(panes, ...)`` ``stream_state(sid)`` equal JAX's; ``reset_stream`` clears
  every live pane of the stream; a drift detector records one series per
  stream, with JAX's alarms.
* **Paged** (``stream_shard=True``): the pane extends the pager's stream
  coordinate. Sliding rings over Zipf traffic with 2 resident slots, so pane
  rows spill: the port under ``"megastep"`` (K6's plain version here), exact
  and q8-staged (``compress_payloads=True``), against JAX's stream-sharded
  engine on a one-device mesh under ``"megastep_interpret"`` when exact and
  ``"xla"`` with compression (ROADMAP §C: JAX's q8 megastep engine is not
  deterministic on the CPU). JAX's refusals of EWMA and drift there.
* **Snapshots** (JAX's pickle codec, orbax off): a windowed snapshot written
  mid-ring by either package, restored by the other and continued, equals the
  writer continuing, for the single-stream, unsharded and paged engines; a
  restore under another policy is refused both ways; a compressed windowed
  snapshot round-trips; a windowed paged snapshot refuses an unsharded target
  and re-homes into another residency.

Integer states must be bit-exact; float states within rtol 1e-6 (the q8
counts: the same decoded values folded the same way).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import metrics_tpu as mt
import metrics_tpu.engine as je
import metrics_tpu.engine.snapshot as jsnap
import metrics_tpu_torch as mp
import metrics_tpu_torch.engine as pe
from metrics_tpu.engine.traffic import zipf_traffic as jax_zipf_traffic
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

C, T, S = 3, 5, 6
RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _jax_pickle_snapshots():
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jsnap, "_use_orbax", lambda: False)
    yield
    mp_.undo()


def _coll(jx, q8=False):
    m, kw = (mt, {}) if jx else (mp, {"device": "cpu"})
    return m.MetricCollection({
        "acc": m.Accuracy(**kw),
        "ap": m.BinnedAveragePrecision(num_classes=C, thresholds=T, sync_precision="q8_block" if q8 else None, **kw),
        "cm": m.ConfusionMatrix(num_classes=C, **kw),
    })


def _traffic(n, seed, streams=S):
    """``(stream_id, preds, target)`` batches of 1-8 rows (probabilities in
    sixteenths), Zipf stream ids."""
    rng = np.random.RandomState(seed)
    out = []
    for sid, _p, _t in jax_zipf_traffic(streams, n, alpha=1.1, seed=seed, max_rows=4):
        k = int(rng.randint(1, 9))
        p = rng.randint(1, 17, size=(k, C)).astype(np.float32)
        out.append((int(sid), (p / p.sum(1, keepdims=True)).astype(np.float32), rng.randint(0, C, k)))
    return out


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _flat(x, prefix=""):
    x = _np(x)
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(x, list):
        out = {}
        for i, v in enumerate(x):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix: x}


def _assert_close(got, want, what=""):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), (what, sorted(g), sorted(w))
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        if b.dtype.kind == "f" or a.dtype.kind == "f":
            np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=RTOL, atol=1e-7,
                                       err_msg=f"{what} {k}")
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), (what, k, a, b)


def _policy(jx, kind, **kw):
    return getattr((je if jx else pe).WindowPolicy, kind)(**kw)


def _multi(jx, window, paged=False, q8=False, resident=2, snapshot=None, every=0, drift=None, coalesce=1):
    e = je if jx else pe
    cfg = dict(buckets=(8, 32), coalesce=coalesce, window=window, drift=drift, snapshot_dir=snapshot,
               snapshot_every=every, compress_payloads=q8)
    if paged:
        if jx:
            cfg.update(mesh=Mesh(np.asarray(jax.devices()[:1]), ("dp",)), axis="dp", mesh_sync="deferred",
                       kernel_backend="xla" if q8 else "megastep_interpret")
        else:
            cfg.update(kernel_backend="megastep")
        return e.MultiStreamEngine(_coll(jx, q8), S, e.EngineConfig(**cfg), stream_shard=True,
                                   resident_streams=resident)
    return e.MultiStreamEngine(_coll(jx, q8), S, e.EngineConfig(**cfg))


def _feed(eng, traffic, flush_each=True):
    with eng:
        for sid, p, t in traffic:
            eng.submit(sid, p, t)
            if flush_each:
                eng.flush()
    return eng


# -------------------------------------------------------------------- unsharded


UNSHARDED = [("tumbling", dict(pane_batches=7)), ("tumbling", dict(pane_batches=5, n_panes=3)),
             ("sliding", dict(n_panes=2, pane_batches=10)), ("sliding", dict(n_panes=3, pane_batches=4))]


@pytest.mark.parametrize("kind,kw", UNSHARDED, ids=[f"{k}-{i}" for i, (k, _) in enumerate(UNSHARDED)])
def test_unsharded_windows_match_jax(kind, kw):
    traffic = _traffic(33, seed=3)
    j, p = (_feed(_multi(jx, _policy(jx, kind, **kw)), traffic, flush_each=False) for jx in (True, False))
    _assert_close(p.results(), j.results(), "results")
    for sid in range(S):
        _assert_close(p.result(sid), j.result(sid), f"result({sid})")
        _assert_close(p.stream_state(sid), j.stream_state(sid), f"stream_state({sid})")
    _assert_close(p.state(), j.state(), "state")
    assert (p.rotations, p.pane_cursor) == (j.rotations, j.pane_cursor)
    assert all(v.shape[:2] == (kw.get("n_panes", 1), S) for v in _flat(p.state()).values())


def test_unsharded_windows_equal_per_stream_oracles():
    traffic = _traffic(30, seed=9)
    eng = _feed(_multi(False, _policy(False, "sliding", n_panes=2, pane_batches=10), coalesce=4), traffic, False)
    got = eng.results()
    for sid in range(S):  # rotations at 10, 20 and 30: the live window is the empty pane + [20:30)
        ref = pe.StreamingEngine(_coll(False), pe.EngineConfig(buckets=(8, 32)))
        rows = [(p, t) for s, p, t in traffic[20:30] if s == sid]
        if not rows:
            assert not _flat(got[sid])["cm."].any()
            continue
        with ref:
            for b in rows:
                ref.submit(*b)
            _assert_close(got[sid], ref.result(), f"stream {sid}")


@pytest.mark.parametrize("paged", [False, True], ids=["unsharded", "paged"])
def test_reset_stream_clears_every_live_pane_as_jax(paged):
    p = np.asarray([[0.75, 0.125, 0.125]] * 2, np.float32)
    right, wrong = np.asarray([0, 0]), np.asarray([1, 1])
    out = []
    for jx in (True, False):
        eng = _multi(jx, _policy(jx, "sliding", n_panes=2, pane_batches=1), paged=paged, resident=12)
        with eng:
            eng.submit(0, p, wrong)  # the pane rotates after this batch
            eng.submit(0, p, right)
            eng.submit(1, p, wrong)
            eng.flush()
            eng.reset_stream(0)
            eng.submit(0, p, right)
            out.append((eng.result(0), eng.result(1), eng.state()))
    assert float(out[1][0]["acc"]) == 1.0 and float(out[1][1]["acc"]) == 0.0
    for g, w in zip(out[1], out[0]):
        _assert_close(g, w)


def test_per_stream_drift_series_match_jax():
    traffic = [(sid, p, t) for sid, p, t in jax_zipf_traffic(4, 60, seed=7, max_rows=8, label_acc=0.92, drift_at=30,
                                                               drift_ramp=4, drift_flip=0.8)]
    dets = []
    for jx in (True, False):
        m = (mt, {}) if jx else (mp, {"device": "cpu"})
        det = (je if jx else pe).DriftDetector(threshold=0.2, up_after=2, down_after=2)
        eng = (je if jx else pe).MultiStreamEngine(m[0].Accuracy(**m[1]), 4, (je if jx else pe).EngineConfig(
            buckets=(32,), coalesce=1, window=_policy(jx, "tumbling", pane_batches=6), drift=det))
        _feed(eng, traffic, flush_each=False)
        dets.append((det, eng))
    (jdet, jeng), (pdet, peng) = dets
    assert [(a.kind, a.key, a.name, a.pane, a.streak) for a in pdet.alarms()] == \
        [(a.kind, a.key, a.name, a.pane, a.streak) for a in jdet.alarms()]
    for a, b in zip(pdet.alarms(), jdet.alarms()):
        np.testing.assert_allclose([a.value, a.baseline, a.delta], [b.value, b.baseline, b.delta], rtol=RTOL)
    assert pdet.alarms("raise") and peng.stats.drift_evals == jeng.stats.drift_evals == 4 * peng.rotations
    for sid in range(4):
        np.testing.assert_allclose(pdet.history(key=sid), jdet.history(key=sid), rtol=RTOL)


# ------------------------------------------------------------------------ paged


@pytest.mark.parametrize("q8", [False, True], ids=["exact", "q8"])
@pytest.mark.parametrize("kind,kw", [("sliding", dict(n_panes=2, pane_batches=12)),
                                     ("tumbling", dict(pane_batches=9, n_panes=2))], ids=["sliding", "tumbling"])
def test_paged_windows_with_pane_spills_match_jax(kind, kw, q8):
    traffic = _traffic(48, seed=23)
    j, p = (_feed(_multi(jx, _policy(jx, kind, **kw), paged=True, q8=q8), traffic) for jx in (True, False))
    assert p.stats.page_outs >= 1 and p.stats.page_outs == j.stats.page_outs
    assert p.stats.page_ins == j.stats.page_ins
    if q8 and kind == "sliding":
        assert p.stats.q8_staged_rows > 0  # K7's form: spilled rows paged back in as int8 codes
    _assert_close(p.results(), j.results(), "results")
    for sid in range(S):
        _assert_close(p.result(sid), j.result(sid), f"result({sid})")
        _assert_close(p.stream_state(sid), j.stream_state(sid), f"stream_state({sid})")
    _assert_close(p.state(), j.state(), "state")
    assert p.telemetry()["windows"] == j.telemetry()["windows"]


def test_paged_refusals_give_the_jax_messages():
    msgs = []
    for jx in (True, False):
        e = je if jx else pe
        got = []
        for window, drift in ((_policy(jx, "ewma", alpha=0.5, pane_batches=2), None),
                              (_policy(jx, "tumbling", pane_batches=2), e.DriftDetector(threshold=0.1))):
            with pytest.raises((MetricsTPUUserError, mt.utils.exceptions.MetricsTPUUserError)) as ei:
                _multi(jx, window, paged=True, drift=drift)
            got.append(str(ei.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_paged_rotation_expires_pane_rows_without_device_work():
    """A paged rotation drops the incoming pane's pager rows from the tables
    (a spilled row from the spill store, a resident one from its slot); the
    arena's bytes are not written."""
    eng = _multi(False, _policy(False, "tumbling", pane_batches=3, n_panes=2), paged=True, resident=12)
    traffic = [(s, np.full((2, C), 1 / C, np.float32), np.zeros(2, np.int64)) for s in (0, 1, 2)]
    with eng:
        for b in traffic:
            eng.submit(*b)
        eng.flush()
        before = {k: v.clone() for k, v in eng._state.items()}
        assert eng.rotations == 1 and eng.pane_cursor == 1 and eng.pager.resident_count() == 3
        for b in traffic:  # pane 1 fills, then rotates back to pane 0: its 3 rows expire
            eng.submit(*b)
        eng.flush()
    assert eng.rotations == 2 and eng.pane_cursor == 0 and eng.pager.resident_count() == 3
    assert all(int(eng.stream_state(s)["cm"]["confmat"][1].sum()) == 2 for s in (0, 1, 2))  # pane 1 kept
    assert all(not eng.result(s)["cm"].any() for s in (0, 1, 2))  # the open pane 0 is fresh
    assert all(torch.equal(before[k][:3], eng._state[k][:3]) for k in before)


# -------------------------------------------------------------------- snapshots


SNAP_CASES = ["streaming-sliding", "streaming-tumbling", "streaming-ewma", "unsharded-sliding", "paged-sliding"]


def _snap_engine(jx, case, d, every=0):
    kind_engine, kind = case.split("-")
    e = je if jx else pe
    if kind == "ewma":
        window = _policy(jx, "ewma", alpha=0.5, pane_batches=3)
    elif kind == "tumbling":
        window = _policy(jx, "tumbling", pane_batches=3, n_panes=2)
    else:
        window = _policy(jx, "sliding", n_panes=3, pane_batches=3)
    if kind_engine == "streaming":
        metric = (mt.MeanMetric() if jx else mp.MeanMetric(device="cpu")) if kind == "ewma" else _coll(jx)
        return e.StreamingEngine(metric, e.EngineConfig(buckets=(8, 32), coalesce=1, window=window, snapshot_dir=d,
                                                        snapshot_every=every))
    return _multi(jx, window, paged=kind_engine == "paged", snapshot=d, every=every)


def _submit(eng, case, b):
    if case.startswith("streaming"):
        sid, p, t = b
        eng.submit(p[:, 0].copy()) if case.endswith("ewma") else eng.submit(p, t)
    else:
        eng.submit(*b)


def _read(eng, case):
    return eng.result() if case.startswith("streaming") else eng.results()


@pytest.mark.parametrize("case", SNAP_CASES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_windowed_snapshot_resumes_mid_ring_in_the_other_package(tmp_path, case, writer):
    traffic = _traffic(14, seed=4)
    d = str(tmp_path / "snap")
    wjx = writer == "jax"
    w = _snap_engine(wjx, case, d, every=5)  # the newest generation lands at cursor 10: one batch into a pane
    with w:
        for b in traffic:
            _submit(w, case, b)
            w.flush()
        want = _read(w, case)
    r = _snap_engine(not wjx, case, d)
    meta = r.restore()
    assert int(meta["batches_done"]) == 10 and int(meta["pane_fill"]) == 1
    assert meta["window"] == w.window.fingerprint()
    with r:
        for b in traffic[int(meta["batches_done"]):]:
            _submit(r, case, b)
            r.flush()
        got = _read(r, case)
    _assert_close(got, want, f"{writer} -> other")
    assert (r.rotations, r.pane_cursor) == (w.rotations, w.pane_cursor)
    _assert_close(r.state(), w.state(), "state")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_policy_restores_are_refused_both_ways(tmp_path, direction):
    wjx = direction == "jax_to_port"
    traffic = _traffic(6, seed=5)
    cases = []
    for name, writer_window, reader_window in (
            ("policy", _policy(wjx, "sliding", n_panes=2, pane_batches=2),
             _policy(not wjx, "tumbling", pane_batches=2)),
            ("to_cumulative", _policy(wjx, "sliding", n_panes=2, pane_batches=2), None),
            ("from_cumulative", None, _policy(not wjx, "sliding", n_panes=2, pane_batches=2))):
        d = str(tmp_path / name)
        e = je if wjx else pe
        w = e.StreamingEngine(_coll(wjx), e.EngineConfig(buckets=(8,), window=writer_window, snapshot_dir=d))
        with w:
            for _, p, t in traffic:
                w.submit(p, t)
            w.snapshot()
        r_e = pe if wjx else je
        r = r_e.StreamingEngine(_coll(not wjx), r_e.EngineConfig(buckets=(8,), window=reader_window, snapshot_dir=d))
        with pytest.raises((MetricsTPUUserError, mt.utils.exceptions.MetricsTPUUserError), match="window policy") as ei:
            r.restore()
        cases.append(str(ei.value))
    assert "'sliding:p2:b2' does not match this engine's 'tumbling:p1:b2'" in cases[0]
    assert "does not match this engine's 'cumulative'" in cases[1]
    assert "'cumulative' does not match this engine's 'sliding:p2:b2'" in cases[2]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_compressed_windowed_snapshot_round_trips_into_the_port(tmp_path, writer):
    traffic = _traffic(9, seed=6)
    d = str(tmp_path / "snap")
    out = []
    for jx in ((writer == "jax"), False):
        e = je if jx else pe
        m = (mt, {}) if jx else (mp, {"device": "cpu"})
        eng = e.StreamingEngine(m[0].MeanSquaredError(**m[1]).set_sync_precision("q8_block"), e.EngineConfig(
            buckets=(8,), coalesce=1, window=_policy(jx, "sliding", n_panes=2, pane_batches=2), snapshot_dir=d,
            compress_payloads=True))
        if not out:
            with eng:
                for _, p, t in traffic:
                    eng.submit(p[:, 0].copy(), (t == 0).astype(np.float32))
                out.append(float(eng.result()))
                eng.snapshot()
        else:
            meta = eng.restore()
            assert meta["window"] == "sliding:p2:b2" and meta["codec"]
            out.append(float(eng.result()))
    assert out[1] == pytest.approx(out[0], rel=1e-2)


def test_windowed_paged_snapshot_refuses_an_unsharded_target_and_rehomes_into_other_slots(tmp_path):
    traffic = _traffic(30, seed=8)
    d = str(tmp_path / "snap")
    msgs = []
    w = _feed(_multi(True, _policy(True, "sliding", n_panes=2, pane_batches=7), paged=True, snapshot=d), traffic)
    w.snapshot()
    for jx in (True, False):
        with pytest.raises((MetricsTPUUserError, mt.utils.exceptions.MetricsTPUUserError)) as ei:
            _multi(jx, _policy(jx, "sliding", n_panes=2, pane_batches=7), snapshot=d).restore()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "same-world" in msgs[1]
    for resident in (2, 5, 12):  # any residency of the same world: every row re-homes through the spill store
        r = _multi(False, _policy(False, "sliding", n_panes=2, pane_batches=7), paged=True, resident=resident,
                   snapshot=d)
        r.restore()
        _assert_close(r.results(), w.results(), f"resident {resident}")
        _assert_close(r.state(), w.state(), f"resident {resident}")


# ------------------------------------------------------- values handed out


@pytest.mark.parametrize("engine", ["streaming", "streaming-sliding", "unsharded", "paged"])
def test_a_kept_result_keeps_its_values_after_later_steps(engine):
    """The engines write their state in place; a compute may return a state
    leaf itself (the confusion matrix does). A value handed out by
    ``result()`` must not be a view of the live state, as the JAX package's
    values are immutable."""
    traffic = _traffic(10, seed=12)
    window = _policy(False, "sliding", n_panes=2, pane_batches=100) if engine.endswith("sliding") else None
    if engine.startswith("streaming"):
        eng = pe.StreamingEngine(_coll(False), pe.EngineConfig(buckets=(8,), window=window))
        read = eng.result
    else:
        eng = _multi(False, None, paged=engine == "paged", resident=S)
        read = lambda: eng.result(traffic[0][0])  # noqa: E731
    with eng:
        for b in traffic[:4]:
            eng.submit(*(b[1:] if engine.startswith("streaming") else b))
        kept = read()
        snapshot = _flat(kept)
        for b in traffic[4:]:
            eng.submit(*(b[1:] if engine.startswith("streaming") else b))
        eng.flush()
        later = _flat(read())
    assert any(not np.array_equal(later[k], snapshot[k]) for k in snapshot)
    for k, v in _flat(kept).items():
        assert np.array_equal(v, snapshot[k]), k
