"""The port's fault layer wired through its engines, against the JAX
package's, on the CPU.

* **The canonical plans**: JAX's ``chaos_injectors()`` (``metrics_tpu/engine/
  chaos_smoke.py``) minus the plan naming a site the port still refuses
  (the fleet's; the ``windows`` and ``ewma`` plans run in
  ``tests/test_torch_windows.py``, the mesh's ``elastic`` and ``merge`` in
  ``tests/test_torch_reshard.py``). The same
  seeded plan drives a JAX engine and a port engine over the same numpy
  traffic; ``inj.summary()``, the recovery counters, the quarantine ledger,
  the restored cursor and the results must agree: integer states bit-equal
  and float states within 0 (the traffic is dyadic, as ``chaos_traffic()``
  makes it). The JAX single-stream engines run under
  ``"megastep_interpret"``, the port's under ``"megastep"``.
* **Each newly wired site** (11 of them), alone in a plan: it fires at the
  same occurrence in both packages, with the same recovery.
* **The single-behaviour tests** of ``tests/engine/test_faults.py``, on the
  port: screening, the ledger, retry exhaustion, shrink-on-retry, the
  watchdog, dead dispatchers, sticky contexts, ``kernel_fault_scope``.
* **Paged**: JAX's q8-staged megastep engine is not deterministic on the
  CPU (ROADMAP §C), so the paging plan holds JAX's paged engine under
  ``"xla"`` against the port's under ``"auto"``; the port's q8 paged engine
  demoted mid-stream, with rows staged, is held against its undemoted twin
  (bit-equal) and against JAX under ``"xla"``.

JAX's stream-sharded engine runs on a one-device mesh and consults the
``shard_loss`` site on every step; the port's paged engine has no mesh
(A.11), so that site's call count is left out of the paged summaries. JAX's
snapshots go through its pickle codec (orbax off), as in
``tests/test_torch_snapshot.py``.
"""
import dataclasses
import threading
import time

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
from metrics_tpu.engine.chaos_smoke import (
    SSHARD_RESIDENT,
    SSHARD_STREAMS,
    chaos_injectors,
    chaos_traffic,
    stream_shard_traffic,
)
from metrics_tpu.ops import kernels as jk
from metrics_tpu_torch.ops import kernels as pk
from metrics_tpu_torch.ops.binned_update import binned_counts

BUCKETS = (8, 32)
#: the sites this slice wires into the port's engines
NEW_SITES = ("ingest", "coalesce", "compile", "step", "kernel", "watchdog", "page_out", "page_in", "quant_encode",
             "quant_decode", "dispatcher_kill")
PORTED = set(NEW_SITES) | {"snapshot_write", "snapshot_corrupt", "snapshot_read", "pane_rotate", "drift_eval",
                            "admission", "shard_loss", "merge", "reshard_snapshot", "reshard_restore", "host_loss",
                            "fleet_barrier"}
#: sites only a mesh consults (JAX's stream-sharded engine runs on one)
MESH_ONLY = ("shard_loss", "merge")
COUNTERS = ("retries", "rollbacks", "kernel_demotions", "coalesce_degraded", "coalesce_shrinks", "watchdog_timeouts",
            "quarantined_batches", "quarantined_rows", "snapshot_failures", "snapshot_fallbacks", "snapshots",
            "resumes", "page_outs", "page_ins")
POISON = (np.asarray([np.nan, 0.25], np.float32), np.asarray([1, 0], np.int32))


@pytest.fixture(autouse=True, scope="module")
def _jax_pickle_snapshots():
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jsnap, "_use_orbax", lambda: False)
    yield
    mp_.undo()


class _Side:
    """One package's engine API, so a scenario runs the same code on both."""

    def __init__(self, name):
        self.name = name
        self.jax = name == "jax"
        self.m = mt if self.jax else mp
        self.e = je if self.jax else pe
        self.mega = "megastep_interpret" if self.jax else "megastep"
        self.paged_backend = "xla" if self.jax else None

    def coll(self, q8=False):
        kw = {} if self.jax else {"device": "cpu"}
        c = self.m.MetricCollection([self.m.Accuracy(**kw), self.m.MeanSquaredError(**kw)])
        return c.set_sync_precision("q8_block") if q8 else c

    def injector(self, canonical):
        """``canonical`` (a JAX injector) as this package's injector: same seed, same plan."""
        if self.jax:
            return canonical
        return pe.FaultInjector(canonical.seed, {site: pe.FaultSpec(**dataclasses.asdict(spec))
                                                 for site, spec in canonical.plan.items()})

    def config(self, **kw):
        return self.e.EngineConfig(**kw)

    def paged(self, coll, cfg_kw, resident=SSHARD_RESIDENT, streams=SSHARD_STREAMS):
        if self.jax:
            cfg_kw = dict(cfg_kw, mesh=Mesh(np.asarray(jax.devices()[:1]), ("dp",)), axis="dp", mesh_sync="deferred")
        return self.e.MultiStreamEngine(coll, streams, self.config(**cfg_kw), stream_shard=True,
                                        resident_streams=resident)


SIDES = (_Side("jax"), _Side("port"))


def _values(v):
    return {k: np.asarray(x) for k, x in v.items()}


def _counters(eng):
    st = eng.stats
    return {k: int(getattr(st, k)) for k in COUNTERS}


def _summary(inj, drop=()):
    s = inj.summary()
    return {part: {k: v for k, v in d.items() if k not in drop} for part, d in s.items()}


def _ledger(eng):
    return [(r.cursor, r.rows, r.reason, r.stream_id) for r in eng.quarantine()]


def _same_values(got, want, rtol=0.0):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=k)
        else:
            assert np.array_equal(g, w, equal_nan=True), (k, g, w)


def _canonical():
    return {name: inj for name, inj in chaos_injectors().items() if set(inj.plan) <= PORTED}


def test_canonical_plans_in_scope_are_those_of_ported_sites():
    # every site is consulted now (the fleet's since the fleet runtime): every plan is in scope
    assert sorted(_canonical()) == sorted(chaos_injectors()) == [
        "chaos", "dispatcher_kill", "elastic", "ewma", "fleet", "merge", "paging", "quant", "snapshot_read", "windows"]
    for inj in _canonical().values():
        pe.EngineConfig(fault_injector=SIDES[1].injector(inj))


def _fleet_plan(side, snapdir, injector):
    """JAX's chaos fleet phase: a one-host fleet serves the seeded Zipf
    stream, cuts once and reads every stream; under the ``fleet`` plan the
    first barrier entry and the first fold fail transiently and retry."""
    from metrics_tpu.engine.chaos_smoke import zipf_fleet_traffic

    f = __import__("metrics_tpu.engine.fleet" if side.jax else "metrics_tpu_torch.engine.fleet", fromlist=["_"])
    fleet = f.FleetEngine(side.coll(), f.FleetConfig(
        num_streams=6, snapshot_dir=snapdir,
        engine=side.config(buckets=(8, 32), coalesce=1, fault_injector=injector)))
    with fleet:
        for sid, p, t in zipf_fleet_traffic():
            fleet.ingest(sid, p, t)
        fleet.fleet_snapshot()
        out = {sid: _values(r) for sid, r in fleet.results().items()}
    return out, _counters(fleet.engine)


def test_fleet_plan_retries_the_barrier_and_the_fold_as_jax(tmp_path):
    """The canonical ``fleet`` plan on both packages' degenerate fleets: each
    site fires once and retries; every stream's value equals the fault-free
    twin's and JAX's, with the same counters and fault summary."""
    got = {}
    for side in SIDES:
        inj = side.injector(_canonical()["fleet"])
        faulty = _fleet_plan(side, str(tmp_path / side.name), inj)
        clean = _fleet_plan(side, str(tmp_path / f"{side.name}_clean"), None)
        assert inj.fired.get("fleet_barrier", 0) == 1 and inj.fired.get("host_loss", 0) == 1
        for sid in clean[0]:
            for k in clean[0][sid]:
                assert np.array_equal(faulty[0][sid][k], clean[0][sid][k], equal_nan=True), (side.name, sid, k)
        got[side.name] = (faulty, _summary(inj))
    assert got["port"][0][1] == got["jax"][0][1]
    assert got["port"][1] == got["jax"][1]
    for sid, vals in got["jax"][0][0].items():
        for k, v in vals.items():
            np.testing.assert_allclose(got["port"][0][0][sid][k], v, rtol=1e-6, atol=0, equal_nan=True)


# ------------------------------------------------------------------ the canonical plans


def _chaos_sweep(side, snapdir):
    """The single-device sweep (plan ``chaos``) and the kill + restore past the
    corrupt LATEST (plan ``snapshot_read``), as JAX's chaos smoke runs them."""
    _, traffic = chaos_traffic()
    injs = _canonical()
    inj = side.injector(injs["chaos"])
    eng = side.e.StreamingEngine(side.coll(), side.config(
        buckets=BUCKETS, coalesce=8, kernel_backend=side.mega, screen=side.e.ScreenPolicy(non_finite="quarantine"),
        snapshot_every=2, snapshot_dir=snapdir, snapshot_keep=4, fault_injector=inj))
    with eng:
        for b in traffic:
            eng.submit(*b)
        got = _values(eng.result())
    out = {"values": got, "summary": _summary(inj), "counters": _counters(eng), "ledger": _ledger(eng),
           "demoted": eng._kernel_tag()}
    read = side.injector(injs["snapshot_read"])
    resumed = side.e.StreamingEngine(side.coll(), side.config(
        buckets=BUCKETS, coalesce=1, screen=side.e.ScreenPolicy(non_finite="quarantine"), snapshot_dir=snapdir,
        fault_injector=read))
    meta = resumed.restore()
    cursor = int(meta["batches_done"])
    with resumed:
        for b in traffic[cursor:]:
            resumed.submit(*b)
        out["replayed"] = _values(resumed.result())
    out.update(cursor=cursor, skipped=int(meta.get("generations_skipped", 0)), resume_summary=_summary(read),
               resume_counters=_counters(resumed))
    return out


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    return {s.name: _chaos_sweep(s, str(tmp_path_factory.mktemp(f"chaos_{s.name}"))) for s in SIDES}


def test_chaos_sweep_fires_and_recovers_as_jax(sweep):
    j, p = sweep["jax"], sweep["port"]
    assert p["summary"] == j["summary"]
    assert p["counters"] == j["counters"]
    c = p["counters"]
    # JAX's smoke's own claims, on the port
    assert c["rollbacks"] >= 3 and c["retries"] >= 3 and c["kernel_demotions"] == 1
    assert c["watchdog_timeouts"] == 1 and c["coalesce_degraded"] >= 3 and c["snapshot_failures"] == 1
    assert (j["demoted"], p["demoted"]) == ("xla", "auto")


def test_chaos_sweep_quarantine_ledger_matches_jax(sweep):
    assert sweep["port"]["ledger"] == sweep["jax"]["ledger"]
    (cursor, rows, reason, sid), = sweep["port"]["ledger"]
    assert (cursor, rows, sid) == (2, 2, None) and "non-finite" in reason


def test_chaos_sweep_results_equal_jax_and_the_fault_free_run(sweep):
    clean, _ = chaos_traffic()
    ref = pe.StreamingEngine(SIDES[1].coll(), pe.EngineConfig(buckets=BUCKETS))
    with ref:
        for b in clean:
            ref.submit(*b)
        want = _values(ref.result())
    _same_values(sweep["port"]["values"], sweep["jax"]["values"])
    _same_values(sweep["port"]["values"], want)


def test_chaos_restore_falls_back_past_the_corrupt_latest_as_jax(sweep):
    j, p = sweep["jax"], sweep["port"]
    assert p["cursor"] == j["cursor"] == 6 and p["skipped"] == j["skipped"] == 1
    assert p["resume_summary"] == j["resume_summary"]
    assert p["resume_counters"] == j["resume_counters"]
    assert p["resume_counters"]["retries"] == 1 and p["resume_counters"]["snapshot_fallbacks"] == 1
    _same_values(p["replayed"], j["replayed"])
    _same_values(p["replayed"], p["values"])


def _quant_plan(side, snapdir):
    clean, _ = chaos_traffic()
    inj = side.injector(_canonical()["quant"])
    cfg = dict(buckets=BUCKETS, coalesce=1, snapshot_dir=snapdir, compress_payloads=True, fault_injector=inj)
    eng = side.e.StreamingEngine(side.coll(), side.config(**cfg))
    with eng:
        for b in clean[:4]:
            eng.submit(*b)
        eng.snapshot()  # quant_encode fires and retries
    res = side.e.StreamingEngine(side.coll(), side.config(**cfg))
    meta = res.restore()  # quant_decode fires and retries
    with res:
        for b in clean[4:]:
            res.submit(*b)
        values = _values(res.result())
    return {"values": values, "summary": _summary(inj), "cursor": int(meta["batches_done"]),
            "codec": str(meta.get("codec", "")), "retries": (eng.stats.retries, res.stats.retries)}


def test_quant_plan_retries_the_codec_as_jax(tmp_path):
    j, p = (_quant_plan(s, str(tmp_path / s.name)) for s in SIDES)
    assert p["summary"] == j["summary"] and p["summary"]["fired"] == {"quant_encode": 1, "quant_decode": 1}
    assert p["cursor"] == j["cursor"] == 4 and p["codec"] == j["codec"] != ""
    assert p["retries"] == j["retries"] == (1, 1)
    _same_values(p["values"], j["values"])


def _paging_plan(side, snapdir):
    """JAX's paging phase: 6 streams in 2 slots, a snapshot with rows spilled."""
    traffic = stream_shard_traffic()
    inj = side.injector(_canonical()["paging"])
    eng = side.paged(side.coll(), dict(buckets=BUCKETS, coalesce=1, kernel_backend=side.paged_backend,
                                       snapshot_dir=snapdir, fault_injector=inj))
    with eng:
        for sid, p, t in traffic[:12]:
            eng.submit(sid, p, t)
        eng.snapshot()
        spilled = eng.pager.spilled_count() if not side.jax else eng._pager.spilled_count()
        for sid, p, t in traffic[12:]:
            eng.submit(sid, p, t)
        eng.flush()
        summary = _summary(inj, MESH_ONLY)
        results = {sid: _values(r) for sid, r in eng.results().items()}
    return {"results": results, "summary": summary, "counters": _counters(eng), "spilled": spilled}


def test_paging_plan_matches_jax_xla(tmp_path):
    j, p = (_paging_plan(s, str(tmp_path / s.name)) for s in SIDES)
    assert p["summary"] == j["summary"] and p["summary"]["fired"] == {"page_out": 1, "page_in": 1}
    for k in ("retries", "page_outs", "page_ins", "snapshots"):
        assert p["counters"][k] == j["counters"][k], k
    assert p["counters"]["retries"] == 2 and p["spilled"] == j["spilled"] >= 1
    for sid in j["results"]:
        _same_values(p["results"][sid], j["results"][sid])


def _dead_dispatcher(side):
    inj = side.injector(_canonical()["dispatcher_kill"])
    kw = {} if side.jax else {"device": "cpu"}
    eng = side.e.StreamingEngine(side.m.Accuracy(**kw), side.config(buckets=(8,), max_queue=2, fault_injector=inj))
    p, t = np.asarray([0.9, 0.2], np.float32), np.asarray([1, 0], np.int32)
    eng.start()
    eng.submit(p, t)
    deadline, sticky = time.monotonic() + 10.0, None
    while time.monotonic() < deadline and sticky is None:
        try:
            eng.submit(p, t, timeout=0.2)
        except side.e.EngineDispatchError as e:
            sticky = e
        except side.e.BackpressureTimeout:
            continue
    assert sticky is not None and "dispatcher_kill" in str(sticky)
    assert not eng._worker.is_alive()
    eng.reset()  # drains the dead queue, clears the error, re-arms
    eng.submit(p, t)
    value = float(eng.result())
    eng.stop()
    return {"value": value, "fired": dict(inj.fired), "calls": inj.calls.get("dispatcher_kill")}


def test_dead_dispatcher_plan_surfaces_then_recovers_as_jax():
    j, p = (_dead_dispatcher(s) for s in SIDES)
    assert p == j == {"value": 1.0, "fired": {"dispatcher_kill": 1}, "calls": 2}


# ------------------------------------------------------------------ each wired site alone


def _dyadic_batches(seed=1, sizes=(5, 17, 8, 32, 3)):
    rng = np.random.RandomState(seed)
    return [((rng.randint(0, 65, size=n) / 64.0).astype(np.float32), (rng.rand(n) > 0.5).astype(np.int32))
            for n in sizes]


SITE_PLANS = {
    "ingest": dict(schedule=(0,)),
    "coalesce": dict(rate=1.0),
    "compile": dict(schedule=(1,)),
    "step": dict(schedule=(1, 3)),
    "kernel": dict(schedule=(0,)),
    "watchdog": dict(schedule=(0,)),
    "page_out": dict(schedule=(0,)),
    "page_in": dict(schedule=(1,)),
    "quant_encode": dict(schedule=(0,)),
    "quant_decode": dict(schedule=(0,)),
    "dispatcher_kill": dict(schedule=(0,), transient=False, fatal=True),
}


def _site_run(side, site):
    inj = side.injector(je.FaultInjector(100 + NEW_SITES.index(site), {site: je.FaultSpec(**SITE_PLANS[site])}))
    if site == "dispatcher_kill":
        return {"dead": _dead_dispatcher_with(side, inj), "summary": _summary(inj)}
    if site in ("page_out", "page_in", "quant_encode", "quant_decode"):
        q8 = site.startswith("quant")
        eng = side.paged(side.coll(q8), dict(buckets=BUCKETS, coalesce=1, kernel_backend=side.paged_backend,
                                             compress_payloads=q8, fault_injector=inj))
        with eng:
            for sid, p, t in stream_shard_traffic():
                eng.submit(sid, p, t)
            eng.flush()
            summary = _summary(inj, MESH_ONLY)
            results = {sid: _values(r) for sid, r in eng.results().items()}
        return {"summary": summary, "counters": _counters(eng), "results": results}
    eng = side.e.StreamingEngine(side.coll(), side.config(
        buckets=BUCKETS, coalesce=8 if site == "coalesce" else 1,
        kernel_backend=side.mega if site == "kernel" else None, fault_injector=inj))
    with eng:
        for b in _dyadic_batches():
            eng.submit(*b)
        values = _values(eng.result())
    return {"summary": _summary(inj), "counters": _counters(eng), "values": values, "megasteps": eng.stats.megasteps}


def _dead_dispatcher_with(side, inj):
    kw = {} if side.jax else {"device": "cpu"}
    eng = side.e.StreamingEngine(side.m.Accuracy(**kw), side.config(buckets=(8,), coalesce=1, max_queue=2,
                                                                     fault_injector=inj))
    p, t = np.asarray([0.9, 0.2], np.float32), np.asarray([1, 0], np.int32)
    eng.start()
    eng.submit(p, t)
    with pytest.raises(side.e.EngineDispatchError, match="dispatcher_kill") as ei:
        eng.flush()
    eng.reset()
    eng.submit(p, t)
    value = float(eng.result())
    eng.stop()
    return {"value": value, "cursor": ei.value.cursor}


@pytest.mark.parametrize("site", NEW_SITES)
def test_each_wired_site_fires_and_recovers_as_jax(site):
    j, p = (_site_run(s, site) for s in SIDES)
    assert p["summary"] == j["summary"]
    assert p["summary"]["fired"].get(site, 0) >= 1
    if site == "dispatcher_kill":
        assert p["dead"] == j["dead"] == {"value": 1.0, "cursor": 0}
        return
    for k in COUNTERS:
        assert p["counters"][k] == j["counters"][k], k
    if "results" in p:
        for sid in j["results"]:
            _same_values(p["results"][sid], j["results"][sid], rtol=1e-6 if site.startswith("quant") else 0.0)
        return
    _same_values(p["values"], j["values"])
    _same_values(p["values"], _oracle(_dyadic_batches()))
    expected = {"ingest": ("retries", 1), "compile": ("rollbacks", 1), "step": ("rollbacks", 2),
                "kernel": ("kernel_demotions", 1), "watchdog": ("watchdog_timeouts", 1),
                "coalesce": ("coalesce_degraded", 5)}[site]
    assert p["counters"][expected[0]] == expected[1]
    if site == "coalesce":
        assert p["megasteps"] == j["megasteps"] == 0


def _oracle(batches):
    eager = SIDES[1].coll()
    for b in batches:
        eager.update(*(torch.from_numpy(a) for a in b))
    return _values(eager.compute())


# ------------------------------------------------------------------ single behaviours


def _acc():
    return mp.Accuracy(device="cpu")


def _mse():
    return mp.MeanSquaredError(device="cpu")


P2, T2 = np.asarray([0.9, 0.2], np.float32), np.asarray([1, 0], np.int32)


def test_nonfinite_quarantine_excludes_batch_and_ledger_is_exact():
    batches = _dyadic_batches(seed=0)
    traffic = batches[:2] + [POISON] + batches[2:]
    eng = pe.StreamingEngine(SIDES[1].coll(), pe.EngineConfig(buckets=BUCKETS,
                                                              screen=pe.ScreenPolicy(non_finite="quarantine")))
    with eng:
        for b in traffic:
            eng.submit(*b)
        got = _values(eng.result())
    _same_values(got, _oracle(batches))
    q = eng.quarantine()
    assert len(q) == 1 and (q[0].cursor, q[0].rows, q[0].stream_id) == (2, 2, None) and "non-finite" in q[0].reason
    assert q[0].payload[0][0] is POISON[0]  # the ledger keeps the host payload
    assert (eng.stats.quarantined_batches, eng.stats.quarantined_rows) == (1, 2)
    assert eng._batches_done == len(traffic)  # the cursor advanced past the quarantined batch


def test_screen_error_action_is_sticky_with_cursor_context():
    eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), screen=pe.ScreenPolicy(non_finite="error")))
    eng.start()
    eng.submit(*POISON)
    with pytest.raises(pe.EngineDispatchError, match="dispatcher failed") as ei:
        eng.flush()
    assert "screen policy" in str(ei.value) and "cursor=0" in str(ei.value) and ei.value.cursor == 0
    eng.reset()
    eng.submit(P2, T2)
    assert float(eng.result()) == 1.0
    eng.stop()


def test_screen_warn_action_accepts_batch():
    eng = pe.StreamingEngine(_mse(), pe.EngineConfig(buckets=(8,), screen=pe.ScreenPolicy(non_finite="warn")))
    with eng:
        with pytest.warns(UserWarning, match="non-finite"):
            eng.submit(np.asarray([np.nan], np.float32), np.asarray([0.0], np.float32))
            eng.flush()
        assert eng.stats.quarantined_batches == 0
        assert np.isnan(float(eng.result()))  # accepted means accepted


def test_id_range_screening():
    eng = pe.StreamingEngine(_acc(), pe.EngineConfig(
        buckets=(8,), screen=pe.ScreenPolicy(non_finite="ignore", id_range=(0, 1))))
    with eng:
        eng.submit(P2, T2)
        eng.submit(P2, np.asarray([7, 0], np.int32))
        assert float(eng.result()) == 1.0
    q = eng.quarantine()
    assert len(q) == 1 and "out of range" in q[0].reason and q[0].cursor == 1


def test_quarantine_ledger_capacity_keeps_newest():
    eng = pe.StreamingEngine(_mse(), pe.EngineConfig(buckets=(8,), screen=pe.ScreenPolicy(non_finite="quarantine"),
                                                     quarantine_capacity=2))
    with eng:
        for _ in range(4):
            eng.submit(np.asarray([np.inf], np.float32), np.asarray([0.0], np.float32))
        eng.flush()
    assert eng.stats.quarantined_batches == 4
    assert [r.cursor for r in eng.quarantine()] == [2, 3]
    eng.clear_quarantine()
    assert eng.quarantine() == []


def test_retry_exhaustion_goes_sticky_with_bucket_context_then_reset_recovers():
    inj = pe.FaultInjector(seed=6, plan={"step": pe.FaultSpec(schedule=(0, 1))})
    eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), coalesce=1, fault_injector=inj, max_retries=1))
    eng.start()
    eng.submit(P2, T2)
    with pytest.raises(pe.EngineDispatchError, match="dispatcher failed") as ei:
        eng.flush()
    assert "bucket=8" in str(ei.value) and "cursor=0" in str(ei.value)
    assert isinstance(ei.value.__cause__, pe.InjectedFault)
    assert (eng.stats.rollbacks, eng.stats.retries) == (2, 1)
    # the rollback left the state as it was before the failed step: the init state
    assert all(int(leaf.abs().sum()) == 0 for leaf in eng._state.values())
    eng.reset()
    eng.submit(P2, T2)
    assert float(eng.result()) == 1.0
    eng.stop()


def test_megabatch_failure_shrinks_to_singletons():
    batches = _dyadic_batches(seed=5, sizes=(2, 2, 2))
    inj = pe.FaultInjector(seed=11, plan={"step": pe.FaultSpec(schedule=(0,), transient=False)})
    # the coalesce window holds the group open until every batch is queued: one megabatch
    eng = pe.StreamingEngine(SIDES[1].coll(), pe.EngineConfig(buckets=(8,), coalesce=8, coalesce_window_ms=300.0,
                                                              fault_injector=inj))
    eng.start()
    for b in batches:
        eng.submit(*b)
    got = _values(eng.result())
    eng.stop()
    _same_values(got, _oracle(batches))
    assert eng.stats.coalesce_shrinks == 1 and eng.stats.rollbacks == 1 and eng.stats.steps == 3


def test_shrink_requires_transactional_shadow():
    batches = _dyadic_batches(seed=6, sizes=(2, 2))
    inj = pe.FaultInjector(seed=23, plan={"step": pe.FaultSpec(schedule=(0,), transient=False)})
    eng = pe.StreamingEngine(SIDES[1].coll(), pe.EngineConfig(buckets=(8,), coalesce=8, coalesce_window_ms=300.0,
                                                              fault_injector=inj, transactional=False))
    eng.start()
    for b in batches:
        eng.submit(*b)
    with pytest.raises(pe.EngineDispatchError, match="dispatcher failed"):
        eng.flush()
    assert eng.stats.coalesce_shrinks == 0 and eng.stats.rollbacks == 0  # no shadow: no rollback, no re-run
    assert eng._shadow is None
    eng.reset()
    eng.stop()


def test_transactional_default_follows_jax_rule_for_donated_state():
    # the CPU is always transactional (JAX: donation is off there)
    assert pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,)))._transactional is True
    armed = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), step_timeout_s=5.0))
    assert armed._transactional is True and armed._watchdog_enabled is True
    explicit = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), step_timeout_s=5.0, transactional=False))
    assert explicit._transactional is False
    planned = pe.StreamingEngine(_acc(), pe.EngineConfig(
        buckets=(8,), fault_injector=pe.FaultInjector(0, {"watchdog": pe.FaultSpec(schedule=(3,))})))
    assert planned._watchdog_enabled is True
    jarmed = je.StreamingEngine(mt.Accuracy(), je.EngineConfig(buckets=(8,), step_timeout_s=5.0))
    assert jarmed._transactional is armed._transactional


def test_real_watchdog_passes_fast_steps():
    eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), step_timeout_s=30.0))
    with eng:
        eng.submit(P2, T2)
        assert float(eng.result()) == 1.0
    assert eng.stats.watchdog_timeouts == 0 and eng.stats.rollbacks == 0


def test_flush_on_mid_flush_dispatcher_death_raises_instead_of_hanging():
    inj = pe.FaultInjector(seed=18, plan={"dispatcher_kill": pe.FaultSpec(schedule=(0,), transient=False, fatal=True)})
    eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), coalesce=1, max_queue=8, fault_injector=inj))
    eng.start()
    for _ in range(3):
        eng.submit(P2, T2)
    done, box = threading.Event(), {}

    def call_flush():
        try:
            eng.flush()
        except BaseException as e:  # noqa: BLE001
            box["err"] = e
        done.set()

    threading.Thread(target=call_flush, daemon=True).start()
    assert done.wait(10.0), "flush() hung on the dead dispatcher's backlog"
    assert isinstance(box.get("err"), pe.EngineDispatchError)
    eng.stop()


def test_fatal_death_with_pending_lookahead_keeps_queue_consistent():
    inj = pe.FaultInjector(seed=19, plan={"dispatcher_kill": pe.FaultSpec(schedule=(0,), transient=False, fatal=True)})
    eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), coalesce=4, coalesce_window_ms=500.0, max_queue=8,
                                                     fault_injector=inj))
    eng.start()
    # A, then an incompatible B (extra-dim preds): B becomes the dequeued look-ahead while A's group dies
    eng.submit(P2, T2)
    eng.submit(np.zeros((2, 3), np.float32), T2)
    deadline = time.monotonic() + 10.0
    while eng._worker.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not eng._worker.is_alive()
    assert eng._queue.unfinished_tasks == 0  # the look-ahead B was marked done
    eng.reset()
    eng.submit(P2, T2)
    done = threading.Event()
    threading.Thread(target=lambda: (float(eng.result()) == 1.0) and done.set(), daemon=True).start()
    assert done.wait(10.0), "post-reset flush hung on a leaked task count"
    eng.stop()


def test_stop_then_reset_on_killed_engine_does_not_deadlock():
    inj = pe.FaultInjector(seed=16, plan={"dispatcher_kill": pe.FaultSpec(schedule=(0,), transient=False, fatal=True)})
    eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), max_queue=4, fault_injector=inj))
    eng.start()
    eng.submit(P2, T2)
    deadline = time.monotonic() + 10.0
    while eng._worker.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    for _ in range(2):
        try:
            eng.submit(P2, T2, timeout=0.2)
        except (pe.EngineDispatchError, pe.BackpressureTimeout):
            break
    eng.stop()
    done = threading.Event()
    threading.Thread(target=lambda: (eng.reset(), done.set()), daemon=True).start()
    assert done.wait(10.0), "reset() deadlocked on the dead engine's backlog"
    eng.submit(P2, T2)
    assert float(eng.result()) == 1.0
    eng.stop()


def test_submit_timeout_without_error_is_backpressure():
    eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), max_queue=1))
    eng.start = lambda: eng  # the dispatcher never runs: pure backpressure
    eng.submit(P2, T2, timeout=0.2)
    with pytest.raises(pe.BackpressureTimeout, match="timed out"):
        eng.submit(P2, T2, timeout=0.3)


def test_sticky_error_names_cursor_and_bucket_and_chains_cause():
    eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,)))
    eng.start()
    eng.submit(P2, T2)
    eng.flush()
    eng.submit(np.asarray([0.5, 0.5], np.float32), np.asarray([1, 0, 1], np.int32))
    with pytest.raises(pe.EngineDispatchError, match="dispatcher failed") as ei:
        eng.flush()
    assert "cursor=1" in str(ei.value) and "bucket=8" in str(ei.value)
    assert ei.value.cursor == 1 and ei.value.bucket == 8 and ei.value.__cause__ is not None
    eng.stop()


def test_multistream_sticky_error_names_stream_ids_and_supports_timeout():
    eng = pe.MultiStreamEngine(_acc(), 4, pe.EngineConfig(buckets=(8,), coalesce=1))
    eng.start()
    eng.submit(3, np.asarray([0.5, 0.5], np.float32), np.asarray([1, 0, 1], np.int32), timeout=5.0)
    with pytest.raises(pe.EngineDispatchError, match=r"stream_ids=\[3\]"):
        eng.flush()
    eng.stop()


@pytest.mark.parametrize("stream_shard", [False, True])
def test_multistream_quarantine_records_stream_id(stream_shard):
    cfg = pe.EngineConfig(buckets=(8,), coalesce=1, screen=pe.ScreenPolicy(non_finite="quarantine"))
    eng = pe.MultiStreamEngine(_acc(), 4, cfg, stream_shard=stream_shard,
                               resident_streams=2 if stream_shard else None)
    with eng:
        eng.submit(1, P2, T2)
        eng.submit(2, *POISON)
        assert float(eng.result(1)) == 1.0
    q = eng.quarantine()
    assert len(q) == 1 and q[0].stream_id == 2 and q[0].cursor == 1
    jeng = je.MultiStreamEngine(mt.Accuracy(), 4, je.EngineConfig(buckets=(8,), coalesce=1,
                                                                  screen=je.ScreenPolicy(non_finite="quarantine")))
    with jeng:
        jeng.submit(1, P2, T2)
        jeng.submit(2, *POISON)
        jeng.flush()
    assert [(r.cursor, r.rows, r.reason, r.stream_id) for r in jeng.quarantine()] == _ledger(eng)


def test_rollback_writes_the_state_in_place():
    inj = pe.FaultInjector(seed=3, plan={"step": pe.FaultSpec(schedule=(0, 2)),
                                         "kernel": pe.FaultSpec(schedule=(1,)),
                                         "watchdog": pe.FaultSpec(schedule=(3,))})
    eng = pe.StreamingEngine(SIDES[1].coll(), pe.EngineConfig(buckets=BUCKETS, coalesce=1, kernel_backend="megastep",
                                                              fault_injector=inj))
    ptrs = {k: v.data_ptr() for k, v in eng._state.items()}
    with eng:
        for b in _dyadic_batches():
            eng.submit(*b)
        eng.flush()
        assert {k: v.data_ptr() for k, v in eng._state.items()} == ptrs
        got = _values(eng.result())
    _same_values(got, _oracle(_dyadic_batches()))
    st = eng.stats
    assert (st.rollbacks, st.kernel_demotions, st.watchdog_timeouts) == (4, 1, 1)
    assert eng._megastep_plan is None and eng._kernel_tag() == "auto"
    assert eng._shadow is not None and set(eng._shadow) == set(ptrs)


# ------------------------------------------------------------------ kernel_fault_scope


def _kernel_calls():
    """One call of each entry the hook guards, on CPU tensors."""
    rng = np.random.RandomState(0)
    rows = torch.from_numpy((rng.randint(0, 65, size=(6, 4)) / 64.0).astype(np.float32))
    mask = torch.tensor([True] * 5 + [False])
    ids = torch.tensor([0, 1, 0, 2, 1, 0])
    ops = np.zeros(4, np.int32)
    return {
        "fold_rows": lambda: pk.fold_rows_masked(torch.zeros(4), rows, mask, "sum"),
        "segment_reduce": lambda: pk.segment_reduce_masked(torch.zeros(3, 4), rows, mask, ids, 3, "sum"),
        "megastep_fold": lambda: pk.megastep_fold(torch.zeros(4), rows, mask, ops),
        "megastep_segment": lambda: pk.megastep_segment(torch.zeros(3, 4), rows, mask, ids, 3, ops),
        "histogram": lambda: pk.histogram_accumulate(ids, 3, mask=mask),
        "binned_counts": lambda: binned_counts(rows[:, :2], rows[:, 2:] > 0.5, torch.linspace(0, 1, 5)),
    }


@pytest.mark.parametrize("kernel", ["fold_rows", "segment_reduce", "megastep_fold", "megastep_segment", "histogram",
                                    "binned_counts"])
def test_kernel_fault_scope_raises_and_never_falls_back(kernel):
    calls = []

    def hook(name):
        calls.append(name)
        raise RuntimeError("injected kernel failure")

    fn = _kernel_calls()[kernel]
    want = fn()
    with pk.kernel_fault_scope(hook):
        with pytest.raises(RuntimeError, match="injected kernel failure"):
            fn()
    assert calls == [kernel]
    got = fn()  # the scope is gone: nothing is called, the entry works
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert calls == [kernel]
    # the JAX package raises the same way under its interpret policy (it falls back only under "pallas")
    if kernel == "fold_rows":
        import jax.numpy as jnp

        with jk.kernel_fault_scope(hook), jk.use_backend("pallas_interpret"):
            with pytest.raises(RuntimeError, match="injected kernel failure"):
                jk.fold_rows_masked(jnp.zeros((4,)), jnp.ones((6, 4)), jnp.ones((6,), bool), "sum")


def test_kernel_fault_scope_is_thread_local_and_nests():
    seen = []
    outer, inner = (lambda k: seen.append(("outer", k))), (lambda k: seen.append(("inner", k)))
    fold = _kernel_calls()["fold_rows"]
    with pk.kernel_fault_scope(outer):
        fold()
        with pk.kernel_fault_scope(inner):
            fold()
        other = threading.Thread(target=fold)  # another thread sees no hook
        other.start()
        other.join()
        fold()
    fold()
    assert seen == [("outer", "fold_rows"), ("inner", "fold_rows"), ("outer", "fold_rows")]


# ------------------------------------------------------------------ paged: the q8 demotion


def _q8_traffic():
    from metrics_tpu.engine.traffic import zipf_stream_ids

    rng = np.random.RandomState(5)
    out = []
    for sid in zipf_stream_ids(6, 16, alpha=1.05, seed=5):
        n = int(rng.randint(1, 14))
        p = rng.rand(n, 3).astype(np.float32)
        out.append((int(sid), p / p.sum(1, keepdims=True), rng.randint(0, 3, n)))
    return out


def _q8_coll(m, **kw):
    return m.MetricCollection({
        "acc": m.Accuracy(**kw),
        "ap": m.BinnedAveragePrecision(num_classes=3, thresholds=5, sync_precision="q8_block", **kw),
        "cm": m.ConfusionMatrix(num_classes=3, **kw),
    })


def _port_q8(traffic, inj=None):
    eng = pe.MultiStreamEngine(_q8_coll(mp, device="cpu"), 6, pe.EngineConfig(
        buckets=BUCKETS, kernel_backend="megastep", coalesce=1, compress_payloads=True, fault_injector=inj),
        stream_shard=True, resident_streams=2)
    staged_at = []
    do_step = eng._do_step

    def watched(*a, **kw):  # the staged slots each step attempt sees
        staged_at.append(int(eng._q8_stage[0]["flags"].sum()) if eng._q8_keys else 0)
        return do_step(*a, **kw)

    eng._do_step = watched
    with eng:
        for sid, p, t in traffic:
            eng.submit(sid, torch.from_numpy(p), torch.from_numpy(t))
        eng.flush()
    return eng, staged_at


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree)


def test_paged_q8_demotion_with_rows_staged_loses_none():
    traffic = _q8_traffic()
    twin, staged_at = _port_q8(traffic)
    assert twin.stats.q8_staged_rows > 0
    # demote at the first step that decodes staged slots
    first = next(i for i, n in enumerate(staged_at) if n > 0)
    inj = pe.FaultInjector(seed=1, plan={"kernel": pe.FaultSpec(schedule=(first,))})
    demoted, seen = _port_q8(traffic, inj)
    assert seen[first] > 0 and seen[first + 1] == seen[first]  # the demoted retry saw the same staged slots
    st = demoted.stats
    assert st.kernel_demotions == 1 and st.rollbacks == 1 and inj.fired == {"kernel": 1}
    assert demoted._megastep_plan is None and not demoted._q8_enabled and demoted._q8_keys == ()
    assert all(n == 0 for n in seen[first + 2:])  # nothing is staged after the demotion
    for sid in range(6):
        want, got = _np_tree(twin.stream_state(sid)), _np_tree(demoted.stream_state(sid))
        for k in want:
            for s in want[k]:
                assert np.array_equal(got[k][s], want[k][s]), (sid, k, s)
    # and against JAX's paged engine under "xla" (host decode, the same arithmetic)
    jeng = je.MultiStreamEngine(_q8_coll(mt), 6, je.EngineConfig(
        buckets=BUCKETS, mesh=Mesh(np.asarray(jax.devices()[:1]), ("dp",)), axis="dp", mesh_sync="deferred",
        kernel_backend="xla", coalesce=1, compress_payloads=True), stream_shard=True, resident_streams=2)
    with jeng:
        for sid, p, t in traffic:
            jeng.submit(sid, p, t)
            jeng.flush()
    for sid in range(6):
        want, got = _np_tree(jeng.stream_state(sid)), _np_tree(demoted.stream_state(sid))
        for k in want:
            for s, w in want[k].items():
                if w.dtype.kind == "f":
                    np.testing.assert_allclose(got[k][s], w, rtol=1e-6, atol=0, err_msg=f"{sid} {k}.{s}")
                else:
                    assert np.array_equal(got[k][s], w), (sid, k, s)


def test_a_real_error_is_never_demoted():
    """Only an injected ``kernel`` fault demotes: a real failure of the step
    rolls back and goes sticky, the engine stays on its megastep kernels."""
    eng = pe.StreamingEngine(SIDES[1].coll(), pe.EngineConfig(buckets=(8,), coalesce=1, kernel_backend="megastep"))
    boom = RuntimeError("CUDA error: an illegal memory access was encountered")

    def broken(*a, **kw):
        raise boom

    eng._megastep_plan.apply_masked = broken
    eng.start()
    eng.submit(*_dyadic_batches()[0])
    with pytest.raises(pe.EngineDispatchError, match="illegal memory access") as ei:
        eng.flush()
    assert ei.value.__cause__ is boom
    assert eng.stats.kernel_demotions == 0 and eng.stats.rollbacks == 1 and eng.stats.retries == 0
    assert eng._kernel_tag() == "megastep"
    eng.stop()
