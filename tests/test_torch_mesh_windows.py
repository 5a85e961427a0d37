"""Windows on a mesh: the port's deferred windowed engines against the JAX
package's, on the CPU.

The port's mesh is four shards on the CPU (``MeshConfig(shape=(4,),
devices=["cpu"] * 4)``); JAX's engines run on ``jax.devices()[:4]``, built
directly (the ``devices`` fixture would mark these tests slow), under
``kernel_backend="xla"``; the port's under ``"megastep"`` (K5's plain version
on every shard's pane row) and ``"auto"``. The same numpy traffic feeds both:

* the deferred windowed ``StreamingEngine`` (tumbling, sliding and EWMA
  rings), its carried ``(world, panes, n)`` form, read mid-pane: the merged
  pane-stacked state and the window's value;
* the windowed ``MultiStreamEngine``, unsharded (each shard its own
  ``(panes, S, ...)`` ring) and stream-sharded (stream ``sid`` on shard
  ``sid % 4`` at pager row ``(sid // 4) * panes + pane``), with the same
  page-ins and page-outs;
* JAX's refusals: step sync with a window, and ``cat`` states;
* the mid-ring reshard of JAX's
  ``test_windowed_reshard_crosses_worlds_mid_ring`` (2 -> 1 at cursor 3,
  then serving on bit-exactly) in both packages, and 4 -> 2 -> 4 against
  world 1;
* a windowed mesh snapshot crossing the packages both ways, JAX writing its
  pickle codec (``_use_orbax`` patched).

Predictions are multiples of 1/64, so every float state (BinnedAP's counts,
MeanMetric's sums) is exact: states are bit-equal to JAX's and to world 1,
whatever order the shards and panes fold in. Values computed from them hold
to rtol 1e-6 (the two packages' computes round apart in the last place).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import metrics_tpu as mt
import metrics_tpu.engine as je
import metrics_tpu.engine.snapshot as jsnap
import metrics_tpu_torch as mp
import metrics_tpu_torch.engine as pe
from metrics_tpu.engine.traffic import zipf_stream_ids
from metrics_tpu_torch.parallel.mesh import MeshConfig
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

W, C, S = 4, 3, 10
BUCKETS = (8, 32)


@pytest.fixture(autouse=True, scope="module")
def _jax_pickle_snapshots():
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jsnap, "_use_orbax", lambda: False)
    yield
    mp_.undo()


def _jmesh(w=W):
    return JaxMesh(np.asarray(jax.devices()[:w]), ("dp",))


def _pmesh(w=W):
    return MeshConfig(shape=(w,), devices=["cpu"] * w).make_mesh()


def _coll(m, **kw):
    return m.MetricCollection({"acc": m.Accuracy(**kw), "cm": m.ConfusionMatrix(num_classes=C, **kw),
                               "ap": m.BinnedAveragePrecision(num_classes=C, thresholds=5, **kw)})


def _mean(m, **kw):
    return m.MeanMetric(**kw)


def _batches(n=14, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for k in rng.randint(2, 40, n):
        p = (rng.randint(0, 65, size=(k, C)) / 64.0).astype(np.float32)
        out.append((p, rng.randint(0, C, k)))
    return out


def _policy(pkg, kind):
    w = pkg.WindowPolicy
    return {"tumbling": lambda: w.tumbling(pane_batches=3), "sliding": lambda: w.sliding(n_panes=3, pane_batches=2),
            "ewma": lambda: w.ewma(alpha=0.5, pane_batches=3)}[kind]()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _same(got, want, path="", rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}", rtol)
        return
    if isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]", rtol)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if rtol and np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7, err_msg=path)
    else:
        assert np.array_equal(got, want), path


def _engine(jax_side, kind, w=W, make=None, backend=None, **cfg):
    """A deferred windowed StreamingEngine of one package at world ``w`` (no
    mesh at ``w == 0``)."""
    e, m = (je, mt) if jax_side else (pe, mp)
    kw = {} if jax_side else {"device": "cpu"}
    extra = dict(buckets=BUCKETS, coalesce=1, window=_policy(e, kind), **cfg)
    if w:
        extra.update(mesh=_jmesh(w) if jax_side else _pmesh(w), mesh_sync="deferred")
        if jax_side:
            extra.update(axis="dp")
    extra["kernel_backend"] = "xla" if jax_side else backend
    return e.StreamingEngine((make or (_mean if kind == "ewma" else _coll))(m, **kw), e.EngineConfig(**extra))


def _submit(kind):
    if kind == "ewma":  # the mean of one column: a float-sum state the decay scales exactly
        return lambda eng, b: eng.submit(torch.from_numpy(b[0][:, 0]) if isinstance(eng, pe.StreamingEngine)
                                         else b[0][:, 0])
    return lambda eng, b: eng.submit(*b)


@pytest.mark.parametrize("kind", ["tumbling", "sliding", "ewma"])
def test_deferred_windowed_engine_equals_jax_mid_pane(kind):
    batches = _batches()
    submit = _submit(kind)
    reads = {}
    for name, jax_side, w, backend in (("jax", True, W, None), ("single", False, 0, None),
                                       ("megastep", False, W, "megastep"), ("auto", False, W, None)):
        eng = _engine(jax_side, kind, w, backend=backend)
        with eng:
            for b in batches[:-1]:  # 13 batches: mid-pane for every policy
                submit(eng, b)
            eng.flush()
            reads[name] = (_np(eng.state()), _np(eng.result()), eng.pane_cursor, eng.rotations)
        if not jax_side and w:
            assert eng._layout.matches(eng._state, world=W, panes=eng._panes if kind != "ewma" else None)
            assert eng.stats.kernel_fallbacks_by_reason() == {}
    want_state, want_value, cursor, rotations = reads["jax"]
    for name in ("single", "megastep", "auto"):
        state, value, c, r = reads[name]
        _same(state, want_state)
        _same(value, want_value, rtol=1e-6)
        assert (c, r) == (cursor, rotations), name


def _ms_traffic(n=36, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for sid in zipf_stream_ids(S, n, alpha=1.05, seed=seed):
        k = int(rng.randint(1, 14))
        p = (rng.randint(0, 65, size=(k, C)) / 64.0).astype(np.float32)
        out.append((int(sid), p, rng.randint(0, C, k)))
    return out


@pytest.mark.parametrize("form", ["unsharded", "stream_shard"])
@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
def test_windowed_multistream_equals_jax(form, kind):
    traffic = _ms_traffic()
    kw = {} if form == "unsharded" else dict(stream_shard=True, resident_streams=1)
    j = je.MultiStreamEngine(_coll(mt), S, je.EngineConfig(
        buckets=BUCKETS, coalesce=1, mesh=_jmesh(), axis="dp", mesh_sync="deferred", kernel_backend="xla",
        window=_policy(je, kind)), **kw)
    with j:
        for b in traffic[:-1]:
            j.submit(*b)
            j.flush()  # JAX's paged engine pages per flushed step
    want = _np(j.state())
    single = pe.MultiStreamEngine(_coll(mp, device="cpu"), S, pe.EngineConfig(
        buckets=BUCKETS, coalesce=1, window=_policy(pe, kind)), **kw)
    with single:
        for b in traffic[:-1]:
            single.submit(*b)
    for backend in ("megastep", None):
        p = pe.MultiStreamEngine(_coll(mp, device="cpu"), S, pe.EngineConfig(
            buckets=BUCKETS, coalesce=1, mesh=_pmesh(), mesh_sync="deferred", kernel_backend=backend,
            window=_policy(pe, kind)), **kw)
        with p:
            for b in traffic[:-1]:
                p.submit(*b)
        _same(_np(p.state()), want)
        _same(_np(p.state()), _np(single.state()))
        assert (p.pane_cursor, p.rotations) == (j.pane_cursor, j.rotations)
        if form == "stream_shard":
            assert (p.stats.page_ins, p.stats.page_outs) == (j.stats.page_ins, j.stats.page_outs)
            assert sum(x["page_outs"] for x in p.pages_by_shard()) == p.stats.page_outs > 0
        got_all, want_all = p.results(), j.results()
        for sid in (0, 3, S - 1):
            _same(_np(p.result(sid)), _np(j.result(sid)), rtol=1e-6)
            _same(_np(got_all[sid]), _np(want_all[sid]), rtol=1e-6)


def test_window_refusals_as_jax():
    """Step sync refuses every rotating window and deferred sync refuses a
    ``cat`` state, with JAX's messages; deferred sync takes the others."""
    for kind in ("tumbling", "sliding", "ewma"):
        make = _mean if kind == "ewma" else _coll
        with pytest.raises(mt.utils.exceptions.MetricsTPUUserError) as jerr:
            je.StreamingEngine(make(mt), je.EngineConfig(buckets=BUCKETS, mesh=_jmesh(), axis="dp",
                                                         window=_policy(je, kind)))
        with pytest.raises(MetricsTPUUserError) as perr:
            pe.StreamingEngine(make(mp, device="cpu"), pe.EngineConfig(buckets=BUCKETS, mesh=_pmesh(),
                                                                       window=_policy(pe, kind)))
        assert str(perr.value) == str(jerr.value) and "mesh_sync='deferred'" in str(perr.value)
    scan = lambda m, **kw: m.AUROC(num_classes=C, capacity=64, **kw)  # noqa: E731
    with pytest.raises(mt.utils.exceptions.MetricsTPUUserError) as jerr:
        je.StreamingEngine(scan(mt), je.EngineConfig(buckets=BUCKETS, mesh=_jmesh(), axis="dp", mesh_sync="deferred",
                                                     window=_policy(je, "tumbling")))
    with pytest.raises(MetricsTPUUserError) as perr:
        pe.StreamingEngine(scan(mp, device="cpu"), pe.EngineConfig(buckets=BUCKETS, mesh=_pmesh(),
                                                                   mesh_sync="deferred",
                                                                   window=_policy(pe, "tumbling")))
    assert str(perr.value) == str(jerr.value) and "cat" in str(perr.value)
    # the same metric serves windowed at world 1, and cumulative on the mesh
    pe.StreamingEngine(scan(mp, device="cpu"), pe.EngineConfig(buckets=BUCKETS, window=_policy(pe, "tumbling")))
    pe.StreamingEngine(scan(mp, device="cpu"), pe.EngineConfig(buckets=BUCKETS, mesh=_pmesh(), mesh_sync="deferred"))


def test_windowed_reshard_crosses_worlds_mid_ring():
    """JAX's test in both packages: a deferred sliding ring at world 2
    shrinks to world 1 after three batches (the world axis merged, the pane
    axis and the cursor kept) and serves on bit-exactly, equal to the
    uninterrupted world-1 ring and to JAX's."""
    bs = _batches(6, seed=8)
    got = {}
    for jax_side in (True, False):
        e, m = (je, mt) if jax_side else (pe, mp)
        win = e.WindowPolicy.sliding(n_panes=3, pane_batches=2)
        mesh = dict(mesh=_jmesh(2), axis="dp") if jax_side else dict(mesh=_pmesh(2))
        coll = _coll(m) if jax_side else _coll(m, device="cpu")
        eng = e.StreamingEngine(coll, e.EngineConfig(buckets=(8,), coalesce=1, mesh_sync="deferred", window=win,
                                                     **mesh))
        with eng:
            for b in bs[:3]:
                eng.submit(*b)
            eng.flush()
            info = eng.reshard(world=1)
            for b in bs[3:]:
                eng.submit(*b)
            got[jax_side] = (_np(eng.result()), _np(eng.state()), eng.pane_cursor)
        assert info == {"from_world": 2, "to_world": 1, "cursor": 3}
    ref = pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(
        buckets=(8,), coalesce=1, window=pe.WindowPolicy.sliding(n_panes=3, pane_batches=2)))
    with ref:
        for b in bs:
            ref.submit(*b)
    _same(got[False][0], _np(ref.result()))  # bit-exact against the uninterrupted ring
    _same(got[False][1], _np(ref.state()))
    _same(got[False][1], got[True][1])
    _same(got[False][0], got[True][0], rtol=1e-6)
    assert got[False][2] == got[True][2] == ref.pane_cursor


@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
def test_windowed_reshard_4_2_4_and_shard_loss_serve_on_as_world_1(kind):
    batches = _batches()
    ref = _engine(False, kind, 0)
    with ref:
        for b in batches:
            ref.submit(*b)
    eng = _engine(False, kind, W, backend="megastep")
    with eng:
        for i, b in enumerate(batches):
            eng.submit(*b)
            eng.flush()
            if i == 4:  # mid-pane: batch 5 of a 3-batch (or 2-batch) pane
                assert eng.reshard(world=2) == {"from_world": W, "to_world": 2, "cursor": 5}
                assert eng.reshard(world=W) == {"from_world": 2, "to_world": W, "cursor": 5}
    _same(_np(eng.state()), _np(ref.state()))
    _same(_np(eng.result()), _np(ref.result()))
    assert (eng.pane_cursor, eng.rotations) == (ref.pane_cursor, ref.rotations)
    # a shard lost for good: the engine reshards to world 2 and serves on
    inj = pe.FaultInjector(0, {"shard_loss": pe.FaultSpec(schedule=(6,), transient=False)})
    lost = _engine(False, kind, W, fault_injector=inj, elastic_min_world=2)
    with lost:
        for b in batches:
            lost.submit(*b)
            lost.flush()
    assert lost._world == 2 and lost.stats.shard_losses == 1
    _same(_np(lost.state()), _np(ref.state()))


def test_windowed_mesh_snapshots_cross_packages(tmp_path):
    """A deferred sliding ring at world 4 snapshotted mid-ring by JAX
    restores into the port's world-4 engine verbatim (every shard's pane
    ring) and into world 1 merged; the port's snapshot restores into JAX's.
    Each then serves the rest of the traffic to the uninterrupted value."""
    batches = _batches()
    half = 7  # three rotations (cursor 0), one batch into the open pane
    ref = _engine(False, "sliding", 0)
    with ref:
        for b in batches:
            ref.submit(*b)
    want = _np(ref.state())
    for jax_side in (True, False):
        src = _engine(jax_side, "sliding", W, snapshot_dir=str(tmp_path / f"src{jax_side}"))
        with src:
            for b in batches[:half]:
                src.submit(*b)
        path = src.snapshot()
        targets = [(False, W), (False, 0)] if jax_side else [(True, W), (True, 0)]
        for dst_jax, w in targets:
            dst = _engine(dst_jax, "sliding", w)
            meta = dst.restore(path)
            assert meta["world"] == W and (meta["pane_cursor"], meta["rotations"], meta["pane_fill"]) == (0, 3, 1)
            if w == W:  # the same world: every shard's ring verbatim
                dst_locals = dst._state if dst_jax else dst._stacked_carried()
                src_locals = src._state if jax_side else src._stacked_carried()
                _same(_np(dst_locals), _np(src_locals))
            with dst:
                for b in batches[half:]:
                    dst.submit(*b)
            _same(_np(dst.state()), want)
            assert dst.pane_cursor == ref.pane_cursor


def test_read_right_after_a_drift_rotation_sees_the_rotated_ring():
    """A deferred sliding ring with a drift detector: the detector's read of
    the closing pane merges the shards just before the rotation writes the
    incoming pane in place. A read right after that rotation must see the
    rotated ring (the expired pane gone), as JAX's and world 1's do. Read
    after every batch, so that every rotation is followed by a read."""
    batches = _batches(9, seed=5)
    submit = _submit("ewma")  # one column into a MeanMetric: a scalar series
    reads, drift = {}, {}
    for name, jax_side, w in (("jax", True, W), ("single", False, 0), ("mesh", False, W)):
        e = je if jax_side else pe
        eng = _engine(jax_side, "sliding", w, make=_mean, drift=e.DriftDetector(threshold=0.05, up_after=1))
        seen = []
        with eng:
            for b in batches:
                submit(eng, b)
                eng.flush()
                seen.append((_np(eng.state()), _np(eng.result()), eng.pane_cursor, eng.rotations))
            drift[name] = eng.drift.history()
        reads[name] = seen
    assert reads["jax"][-1][3] == 4  # four cadence rotations, each read right after
    for name in ("single", "mesh"):
        for (state, value, c, r), (ws, wv, wc, wr) in zip(reads[name], reads["jax"]):
            _same(state, ws)
            _same(value, wv, rtol=1e-6)
            assert (c, r) == (wc, wr), name
        np.testing.assert_allclose(drift[name], drift["jax"], rtol=1e-6)


@pytest.mark.parametrize("kind", ["tumbling", "sliding", "ewma"])
def test_result_rotate_pane_result_on_the_mesh(kind):
    """``result()``, then ``rotate_pane()``, then ``result()`` again with no
    step between: the second read sees the rotated ring (a tumbling pane
    restarted, a sliding ring one pane shorter, EWMA decayed), equal to
    JAX's and to world 1's."""
    batches = _batches(5, seed=6)
    submit = _submit(kind)
    reads = {}
    for name, jax_side, w in (("jax", True, W), ("single", False, 0), ("mesh", False, W)):
        eng = _engine(jax_side, kind, w)
        with eng:
            for b in batches:  # five batches: mid-pane for every policy
                submit(eng, b)
            eng.flush()
            before = (_np(eng.state()), _np(eng.result()))
            eng.rotate_pane()
            reads[name] = before + (_np(eng.state()), _np(eng.result()), eng.pane_cursor, eng.rotations)
    for name in ("single", "mesh"):
        for got, want in zip(reads[name][:4], reads["jax"][:4]):
            _same(got, want, rtol=1e-6)
        assert reads[name][4:] == reads["jax"][4:], name
    # the rotation changed the state (a tumbling pane restarted, the ring's
    # oldest pane cleared, EWMA decayed): the second read is a fresh one
    assert any(not np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(reads["mesh"][0]),
                                                        jax.tree_util.tree_leaves(reads["mesh"][2])))
