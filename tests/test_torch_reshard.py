"""Live resharding, shard loss and the cross-world restore matrix: the port's
mesh engines against the JAX package's, on the CPU (the port's four shards
on the CPU, JAX's engines on four of the eight virtual devices; JAX reshards
onto ``jax.devices()[:w]``).

* ``reshard`` 4 -> 2 -> 4 mid-stream, under step and deferred sync, and on
  the stream-sharded engine (every stream re-homed through the spill store):
  the result of the uninterrupted run, and JAX's;
* ``shard_loss`` for good under ``elastic_min_world=2``: the engine serves on
  at world 2, its result the fault-free one, its counters JAX's;
* the canonical ``elastic`` and ``merge`` plans of JAX's
  ``chaos_injectors()``, each site firing once, the summaries, counters and
  values JAX's;
* snapshots crossing packages and worlds: JAX's deferred engine at 4 into
  the port at 4 (verbatim), 2 (merged, shard 0) and 1 (merged), and the
  port's back into JAX's at 4 and 1;
* a ``cat`` state across worlds refused, the refused reshard rolled back.

Integer states bit-equal; the float states here are counts or dyadic sums,
bit-equal too. JAX's snapshots go through its pickle codec (orbax off).
"""
import dataclasses

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
from metrics_tpu.engine.chaos_smoke import chaos_injectors
from metrics_tpu.engine.traffic import zipf_stream_ids
from metrics_tpu_torch.parallel.mesh import MeshConfig
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

W, C = 4, 3
BUCKETS = (8, 32)


@pytest.fixture(autouse=True, scope="module")
def _jax_pickle_snapshots():
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jsnap, "_use_orbax", lambda: False)
    yield
    mp_.undo()


def _side(jax_side, w=W):
    """``(engine module, mesh, extra config, collection factory)`` of one package."""
    if jax_side:
        return (je, JaxMesh(np.asarray(jax.devices()[:w]), ("dp",)), {"axis": "dp", "kernel_backend": "xla"},
                lambda **kw: mt.MetricCollection([mt.Accuracy(), mt.ConfusionMatrix(num_classes=C),
                                                  mt.BinnedAveragePrecision(num_classes=C, thresholds=5)]))
    # "auto" consults the kernel fault site as JAX's "xla" does: never
    return (pe, MeshConfig(shape=(w,), devices=["cpu"] * w).make_mesh(), {"kernel_backend": None},
            lambda **kw: mp.MetricCollection([mp.Accuracy(device="cpu"), mp.ConfusionMatrix(num_classes=C, device="cpu"),
                                              mp.BinnedAveragePrecision(num_classes=C, thresholds=5, device="cpu")]))


def _batches(n=10, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for k in rng.randint(2, 40, n):
        p = (rng.randint(0, 65, size=(k, C)) / 64.0).astype(np.float32)
        out.append((p, rng.randint(0, C, k)))
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
        return
    if isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
        return
    assert got.shape == want.shape and np.array_equal(got, want), path


def _run(jax_side, mode="deferred", reshard_at=None, inj=None, **cfg):
    e, mesh, kw, coll = _side(jax_side)
    eng = e.StreamingEngine(coll(), e.EngineConfig(buckets=BUCKETS, coalesce=1, mesh=mesh, mesh_sync=mode,
                                                   fault_injector=inj, **kw, **cfg))
    with eng:
        for i, b in enumerate(_batches()):
            eng.submit(*b)
            eng.flush()
            if i == reshard_at:
                assert eng.reshard(world=2)["to_world"] == 2
                assert eng.reshard(world=W) == {"from_world": 2, "to_world": W, "cursor": i + 1}
    return eng


@pytest.mark.parametrize("mode", ["step", "deferred"])
def test_reshard_4_2_4_equals_uninterrupted_and_jax(mode):
    ref = _np(_run(False, mode).state())
    p, j = _run(False, mode, reshard_at=4), _run(True, mode, reshard_at=4)
    _same(_np(p.state()), ref)
    _same(_np(p.state()), _np(j.state()))
    assert p.stats.reshard_summary() == j.stats.reshard_summary()
    assert p._world == W and "reshards 2" in p.metrics_text().replace("metrics_tpu_engine_", "").replace("_total", "")


@pytest.mark.parametrize("mode", ["step", "deferred"])
def test_shard_loss_serves_on_at_world_2_as_jax(mode):
    ref = _np(_run(False, mode).state())
    runs = {}
    for jax_side in (True, False):
        e = je if jax_side else pe
        inj = e.FaultInjector(0, {"shard_loss": e.FaultSpec(schedule=(3,), transient=False)})
        runs[jax_side] = (_run(jax_side, mode, inj=inj, elastic_min_world=2), inj)
    (j, jinj), (p, pinj) = runs[True], runs[False]
    _same(_np(p.state()), ref)
    _same(_np(p.state()), _np(j.state()))
    assert p._world == j._world == 2 and p.stats.shard_losses == 1
    assert pinj.summary() == jinj.summary()
    assert p.stats.reshard_summary() == j.stats.reshard_summary()
    assert (p.stats.rollbacks, p.stats.retries) == (j.stats.rollbacks, j.stats.retries)
    # without the floor the loss goes sticky, as in JAX
    inj = pe.FaultInjector(0, {"shard_loss": pe.FaultSpec(schedule=(0,), transient=False)})
    with pytest.raises(pe.EngineDispatchError, match="shard_loss"):
        _run(False, mode, inj=inj)


def _port_injector(canonical):
    return pe.FaultInjector(canonical.seed, {site: pe.FaultSpec(**dataclasses.asdict(spec))
                                             for site, spec in canonical.plan.items()})


@pytest.mark.parametrize("plan", ["elastic", "merge"])
def test_canonical_mesh_plans_as_jax(plan):
    """JAX's ``elastic`` plan (admission, a transient shard loss, both reshard
    sites under a manual reshard) and ``merge`` plan (a transient boundary
    merge failure) on the deferred engine at W = 4."""
    out = {}
    for jax_side in (True, False):
        canonical = chaos_injectors()[plan]
        inj = canonical if jax_side else _port_injector(canonical)
        e = je if jax_side else pe
        cfg = {"admission": e.AdmissionPolicy(rows_per_s=1e9, burst_rows=1e9)} if plan == "elastic" else {}
        eng = _run(jax_side, "deferred", reshard_at=5 if plan == "elastic" else None, inj=inj, **cfg)
        st = eng.stats
        out[jax_side] = (_np(eng.result()), inj.summary(), (st.retries, st.rollbacks, st.reshards, st.merges),
                         _np(eng.state()))
    (jv, js, jc, jstate), (pv, ps, pc, pstate) = out[True], out[False]
    assert ps == js and pc == jc
    assert all(n == 1 for n in ps["fired"].values()) and set(ps["fired"]) == set(chaos_injectors()[plan].plan)
    _same(pstate, jstate)
    _same(pstate, _np(_run(False, "deferred").state()))  # the fault-free run's
    for k in jv:  # the two packages' computes round apart in the last place
        np.testing.assert_allclose(np.asarray(pv[k], np.float32), np.asarray(jv[k], np.float32), rtol=1e-6, err_msg=k)


def _snap_engine(jax_side, w, snapdir=None, mode="deferred"):
    e, mesh, kw, coll = _side(jax_side, max(w, 1))
    cfg = dict(buckets=BUCKETS, coalesce=1, snapshot_dir=snapdir, **kw)
    if w:
        cfg.update(mesh=mesh, mesh_sync=mode)
    return e.StreamingEngine(coll(), e.EngineConfig(**cfg))


def test_snapshots_cross_packages_and_worlds(tmp_path):
    batches = _batches()
    half = len(batches) // 2
    ref = _np(_run(False, "deferred").state())

    def finish(eng):
        with eng:
            for b in batches[half:]:
                eng.submit(*b)
        return _np(eng.state())

    for jax_side in (True, False):  # JAX at 4 -> the port; the port at 4 -> JAX
        src = _snap_engine(jax_side, W, str(tmp_path / f"src{jax_side}"))
        with src:
            for b in batches[:half]:
                src.submit(*b)
        path = src.snapshot()
        targets = [(False, W), (False, 2), (False, 0)] if jax_side else [(True, W), (True, 0)]
        for dst_jax, w in targets:
            dst = _snap_engine(dst_jax, w)
            meta = dst.restore(path)
            assert meta["world"] == W and meta["mesh_sync"] == "deferred" and meta["batches_done"] == half
            if w == W:  # the same world restores every shard's local state verbatim
                dst_locals = dst._stacked_carried() if not dst_jax else dst._state
                src_locals = src._state if jax_side else src._stacked_carried()
                _same(_np(dst_locals), _np(src_locals))
            _same(finish(dst), ref)
    # a step-sync (global) snapshot embeds into shard 0 of a deferred engine
    src = _snap_engine(False, W, str(tmp_path / "step"), mode="step")
    with src:
        for b in batches[:half]:
            src.submit(*b)
    path = src.snapshot()
    dst = _snap_engine(True, W)
    dst.restore(path)
    _same(finish(dst), ref)
    dst = _snap_engine(False, W)
    dst.restore(path)
    locals_ = _np(dst._layout.unpack_stacked(dst._stacked_carried()))
    _same(jax.tree.map(lambda x: x[0], locals_), _np(dst.state()))  # shard 0 holds it all, the rest the init state
    _same(finish(dst), ref)


def test_cat_state_across_worlds_is_refused_and_rolled_back(tmp_path):
    make = lambda m, **kw: m.AUROC(num_classes=C, capacity=64, **kw)  # noqa: E731
    engines = {}
    for jax_side in (True, False):
        e, mesh, kw, _ = _side(jax_side)
        metric = make(mt) if jax_side else make(mp, device="cpu")
        eng = e.StreamingEngine(metric, e.EngineConfig(buckets=BUCKETS, mesh=mesh, mesh_sync="deferred",
                                                       snapshot_dir=str(tmp_path / str(jax_side)),
                                                       **{k: v for k, v in kw.items() if k == "axis"}))
        with eng:
            for b in _batches(n=6):
                eng.submit(*b)
        before = _np(eng.state())
        with pytest.raises((MetricsTPUUserError, mt.utils.exceptions.MetricsTPUUserError), match="cat"):
            eng.reshard(world=2)
        assert eng._world == W
        _same(_np(eng.state()), before)  # rolled back: it serves on as it was
        with eng:
            eng.submit(*_batches(n=1, seed=7)[0])
        engines[jax_side] = eng
    _same(_np(engines[False].state()), _np(engines[True].state()))
    path = engines[False].snapshot()
    e, mesh2, _, _ = _side(False, 2)
    two = pe.StreamingEngine(make(mp, device="cpu"), pe.EngineConfig(buckets=BUCKETS, mesh=mesh2, mesh_sync="deferred"))
    fresh = _np(two.state())
    with pytest.raises(MetricsTPUUserError, match="cat-state buffers scale with the shard count"):
        two.restore(path)
    _same(_np(two.state()), fresh)


def test_reshard_keeps_shard_0_on_the_metrics_device(monkeypatch):
    """A reshard's target keeps shard 0 on the metric's device: ``world=``
    takes the built mesh's own devices first, in order, however they are
    numbered (an engine on cuda:1..4 shrinks to cuda:1..2 and grows back to
    cuda:1..4); a ``mesh=`` starting elsewhere is refused and rolled back."""
    from metrics_tpu_torch.engine.pipeline import _reshard_devices
    from metrics_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 5)
    cuda = [torch.device("cuda", i) for i in range(5)]
    home = cuda[1:]
    assert _reshard_devices(home, 2) == cuda[1:3]
    assert _reshard_devices(home, 4) == home
    assert _reshard_devices(home, 5) == home + cuda[:1]
    assert _reshard_devices(home, 1) == [cuda[1]]
    assert _reshard_devices([torch.device("cpu")], 3) == [torch.device("cpu")] * 3
    with pytest.raises(MetricsTPUUserError, match="exceeds the 5"):
        _reshard_devices(home, 6)
    monkeypatch.undo()
    ref = _np(_run(False, "deferred").state())
    _, mesh, kw, coll = _side(False)
    eng = pe.StreamingEngine(coll(), pe.EngineConfig(buckets=BUCKETS, coalesce=1, mesh=mesh, mesh_sync="deferred",
                                                     **kw))
    batches = _batches()
    with eng:
        for b in batches[:5]:
            eng.submit(*b)
        eng.flush()
        before = _np(eng.state())
        with pytest.raises(MetricsTPUUserError, match="first device"):
            eng.reshard(mesh=Mesh(np.asarray([cuda[1]] * 2, dtype=object), ("dp",)))
        assert eng._world == W and eng._mesh is mesh
        _same(_np(eng.state()), before)
        for b in batches[5:]:
            eng.submit(*b)
    _same(_np(eng.state()), ref)
    assert eng.stats.reshards == 0


@pytest.mark.parametrize("how", ["reshard", "shard_loss"])
def test_stream_sharded_reshard_rehomes_every_stream_as_jax(how):
    """The stream-sharded tenancy resharded 4 -> 2 -> 4 mid-stream, or a
    shard lost for good under ``elastic_min_world=2`` (the group's unrouted
    rows re-route on the survivors): every stream equal to the
    uninterrupted run's, on both packages."""
    S = 10
    rng = np.random.RandomState(3)
    traffic = []
    for sid in zipf_stream_ids(S, 30, alpha=1.05, seed=3):
        k = int(rng.randint(1, 10))
        traffic.append((int(sid), (rng.randint(0, 65, size=(k, C)) / 64.0).astype(np.float32), rng.randint(0, C, k)))
    states = {}
    for jax_side in (True, False):
        for faulted in (False, True):
            e, mesh, kw, coll = _side(jax_side)
            inj = (e.FaultInjector(0, {"shard_loss": e.FaultSpec(schedule=(9,), transient=False)})
                   if faulted and how == "shard_loss" else None)
            eng = e.MultiStreamEngine(coll(), S, e.EngineConfig(buckets=BUCKETS, coalesce=1, mesh=mesh,
                                                                mesh_sync="deferred", fault_injector=inj,
                                                                elastic_min_world=2, **kw),
                                      stream_shard=True, resident_streams=2)
            with eng:
                for i, b in enumerate(traffic):
                    eng.submit(*b)
                    eng.flush()
                    if faulted and how == "reshard" and i == 12:
                        eng.reshard(world=2)
                        assert eng._pager.world == 2 and eng.resident_streams == 2
                    if faulted and how == "reshard" and i == 20:
                        eng.reshard(world=W)
            states[(jax_side, faulted)] = _np(eng.state())
            if faulted:
                assert eng._world == (W if how == "reshard" else 2)
                assert eng.stats.reshards == (2 if how == "reshard" else 1)
                if not jax_side:
                    assert len(eng.pages_by_shard()) == eng._world
    for key, state in states.items():
        _same(state, states[(False, False)], str(key))
