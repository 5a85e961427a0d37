"""The port's stream-sharded and windowed fleet serving against the JAX
package's, on the CPU.

One port test per test function of ``tests/engine/test_fleet_tenancy.py``,
on both packages' degenerate fleets over the same seeded Zipf plan: the
stream-shard refusals and the windowed ones (ewma, wall-clock cadence,
``cat`` states, the pane/cut cadence, a direct submit), oracle parity
through the pager's spills, tumbling and sliding rings, the cut -> restore
-> exact replay and the re-homing across resident budgets, the paged pieces
merged into one engine, the hierarchical fold's byte legs, and the
OpenMetrics and report surfaces. Each host runs the paged form on a
one-device deferred local mesh, as JAX's does; RESIDENT slots << S, so
every run pages through the host-RAM spill store. Counts bit-equal, floats
within 1e-6.
"""
import os
import sys

import numpy as np
import pytest
import torch

import metrics_tpu.engine.snapshot as jsnap
from metrics_tpu.parallel.collectives import hierarchical_fold_bytes as jax_fold_bytes
from metrics_tpu_torch.metric import StateSpec
from metrics_tpu_torch.parallel.collectives import hierarchical_fold_bytes, sync_payload_bytes
from metrics_tpu_torch.engine.traffic import zipf_traffic
from test_torch_fleet import JAX, PORT, _np, _same_states, _same_values

S = 8
RESIDENT = 3
BUCKETS = (8, 16)


@pytest.fixture(autouse=True, scope="module")
def _jax_pickle_snapshots():
    patch = pytest.MonkeyPatch()
    patch.setattr(jsnap, "_use_orbax", lambda: False)
    yield
    patch.undo()


def _traffic(n=36, seed=9):
    return zipf_traffic(S, n, seed=seed)


def _engine_cfg(side, window=None, mesh=True):
    kw = {"mesh": side.local_mesh(), "axis": "dp", "mesh_sync": "deferred"} if mesh else {}
    return side.e.EngineConfig(buckets=BUCKETS, window=window, **kw)


def _sharded(side, window=None, resident=RESIDENT, **fleet_kw):
    cfg = side.f.FleetConfig(num_streams=S, stream_shard=True, resident_streams=resident,
                             engine=_engine_cfg(side, window), **fleet_kw)
    return side.f.FleetEngine(side.col(), cfg)


def _oracle(side, traffic, window=None):
    eng = side.e.MultiStreamEngine(side.col(), S, side.e.EngineConfig(buckets=BUCKETS, window=window))
    with eng:
        for sid, p, t in traffic:
            eng.submit(sid, p, t)
        return _np(eng.results())


def _windows(side, kind, pane_batches, n_panes):
    W = side.e.WindowPolicy
    return W.tumbling(pane_batches=pane_batches, n_panes=n_panes) if kind == "tumbling" else \
        W.sliding(n_panes=n_panes, pane_batches=pane_batches)


def _refused(make, match):
    for side in (JAX, PORT):
        with pytest.raises(side.user_error, match=match):
            make(side)


# ------------------------------------------------------------ refusal matrix


def test_stream_shard_without_num_streams_refused():
    _refused(lambda side: side.f.FleetEngine(side.col(), side.f.FleetConfig(stream_shard=True)), "needs num_streams")


def test_resident_streams_without_stream_shard_refused():
    _refused(lambda side: side.f.FleetEngine(side.col(), side.f.FleetConfig(num_streams=S, resident_streams=2)),
             "only applies with")


def test_windowed_fleet_refuses_ewma():
    _refused(lambda side: side.f.FleetEngine(side.col(), side.f.FleetConfig(
        num_streams=S, engine=side.e.EngineConfig(window=side.e.WindowPolicy.ewma(alpha=0.5, pane_batches=2)))),
        "serve ewma single-process")


def test_windowed_fleet_refuses_wall_clock_cadence():
    _refused(lambda side: side.f.FleetEngine(side.col(), side.f.FleetConfig(
        num_streams=S, engine=side.e.EngineConfig(window=side.e.WindowPolicy.tumbling(pane_seconds=1.0)))),
        "shared plan cursor")


def test_windowed_fleet_refuses_cat_state_metrics():
    def make(side):
        auroc = side.m.AUROC(capacity=64) if side.jax else side.m.AUROC(capacity=64, device="cpu")
        return side.f.FleetEngine(auroc, side.f.FleetConfig(
            num_streams=S, engine=side.e.EngineConfig(buckets=BUCKETS,
                                                      window=side.e.WindowPolicy.tumbling(pane_batches=2))))

    _refused(make, "cat/scan-strategy")


def test_windowed_fleet_pane_batches_must_ride_cut_cadence(tmp_path):
    _refused(lambda side: side.f.FleetEngine(side.col(), side.f.FleetConfig(
        num_streams=S, snapshot_dir=str(tmp_path), snapshot_every=8,
        engine=side.e.EngineConfig(window=side.e.WindowPolicy.tumbling(pane_batches=12)))), "multiple of")


def test_windowed_fleet_refuses_direct_submit():
    for side in (JAX, PORT):
        fleet = side.f.FleetEngine(side.col(), side.f.FleetConfig(
            num_streams=S, engine=side.e.EngineConfig(buckets=BUCKETS,
                                                      window=side.e.WindowPolicy.tumbling(pane_batches=4))))
        with fleet:
            with pytest.raises(side.user_error, match=r"ingest\(\)"):
                fleet.submit(0, np.zeros(2, np.float32), np.zeros(2, np.int32))


# --------------------------------------------------------- degenerate parity


def test_sharded_degenerate_fleet_matches_oracle_through_spill():
    traffic = _traffic()
    out = {}
    for side in (JAX, PORT):
        fleet = _sharded(side)
        with fleet:
            for b in traffic:
                fleet.ingest(*b)
            got, state = _np(fleet.results()), _np(fleet.fleet_state())
        _same_values(got, _oracle(side, traffic), f"{side.name} vs its oracle")
        st = fleet.engine.stats
        assert 0 < st.fleet_resident_rows <= RESIDENT
        assert st.fleet_spill_rows > 0 and st.fleet_spill_rows + st.fleet_resident_rows <= S
        assert st.fleet_spill_bytes > 0
        assert fleet.engine._pager.tenancy_stats()["capacity_rows"] == RESIDENT
        out[side.name] = (got, state, (st.fleet_resident_rows, st.fleet_spill_rows))
    _same_values(out["port"][0], out["jax"][0])
    _same_states(out["port"][1], out["jax"][1])
    assert out["port"][2] == out["jax"][2]


def test_sharded_fleet_payload_legs_are_analytic():
    blocks = {}
    for side in (JAX, PORT):
        fleet = _sharded(side)
        with fleet:
            for b in _traffic(12):
                fleet.ingest(*b)
            fleet.results()
        st = fleet.engine.stats
        fold = jax_fold_bytes if side.jax else hierarchical_fold_bytes
        legs = fold(fleet.engine._fleet_leaf_info(), fleet.num_hosts)
        assert st.fleet_merges == 1
        assert st.fleet_payload_intra_bytes == legs["intra_bytes"] > 0
        assert (st.fleet_payload_exact_bytes, st.fleet_payload_quant_bytes) == fleet._fleet_payload_split()
        block = fleet.telemetry()["fleet"]
        assert block["payload_intra_bytes"] == legs["intra_bytes"]
        assert block["tenancy"]["spill_rows"] == st.fleet_spill_rows
        blocks[side.name] = (legs, block["sync_payload_bytes"])
    # every leaf of the collection is 32-bit: bytes and JAX's u32 words agree on every leg
    assert blocks["port"] == blocks["jax"]


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_hierarchical_fold_bytes_legs(hosts):
    """The legs over host-logical leaves of mixed widths: the intra leg is
    the leaves' bytes, as JAX counts them; the cross legs are the port's
    ``sync_payload_bytes`` at world = hosts (bytes where JAX counts u32
    words); with every leaf 32-bit all three equal JAX's."""
    import jax
    import jax.numpy as jnp

    def leaves(mk, dt):
        return [("sum", mk((S, 3), dt("float32")), None), ("sum", mk((S,), dt("int32")), None),
                ("max", mk((S, 2), dt("float32")), None), ("sum", mk((S, 5), dt("float32")), "q8_block")]

    port32 = leaves(StateSpec, lambda n: getattr(torch, n))
    jax32 = leaves(jax.ShapeDtypeStruct, lambda n: getattr(jnp, n))
    got = hierarchical_fold_bytes(port32, hosts)
    assert got == jax_fold_bytes(jax32, hosts)
    assert got["cross_exact_bytes"] + got["cross_quant_bytes"] == sync_payload_bytes(port32, hosts)
    narrow = port32 + [("cat", StateSpec((S, 7), torch.uint8), None)]
    jax_narrow = jax32 + [("cat", jax.ShapeDtypeStruct((S, 7), jnp.uint8), None)]
    got = hierarchical_fold_bytes(narrow, hosts)
    assert got["intra_bytes"] == jax_fold_bytes(jax_narrow, hosts)["intra_bytes"]
    assert got["cross_exact_bytes"] + got["cross_quant_bytes"] == sync_payload_bytes(narrow, hosts)


@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
def test_sharded_windowed_fleet_matches_windowed_oracle(kind):
    traffic = _traffic(42)
    out = {}
    for side in (JAX, PORT):
        window = _windows(side, kind, 12, 3)
        fleet = _sharded(side, window=window)
        with fleet:
            for b in traffic:
                fleet.ingest(*b)
            got, state = _np(fleet.results()), _np(fleet.fleet_state())
        _same_values(got, _oracle(side, traffic, window=window), f"{side.name} vs its windowed oracle")
        assert fleet.engine.stats.pane_rotations == len(traffic) // 12
        out[side.name] = (got, state)
    _same_values(out["port"][0], out["jax"][0])
    _same_states(out["port"][1], out["jax"][1])


def test_sharded_windowed_fleet_zero_steady_compiles():
    traffic = _traffic(24)
    for side in (JAX, PORT):
        fleet = _sharded(side, window=_windows(side, "tumbling", 12, 2))
        with fleet:
            for b in traffic:
                fleet.ingest(*b)
            first = _np(fleet.results())
            warm = fleet.engine.aot_cache.misses
            fleet.reset()
            for b in traffic:
                fleet.ingest(*b)
            _same_values(_np(fleet.results()), first, f"{side.name} replay")
            assert fleet.engine.aot_cache.misses == warm


# ------------------------------------------------------------ restore matrix


def test_sharded_windowed_fleet_cut_restore_exact_replay(tmp_path):
    """Kill/resume through a spill AND a rotation: the piece carries the
    paged arena and the pager's spilled rows, the cut rode the rotation,
    and replaying the rest of the plan lands on the uninterrupted result."""
    traffic = _traffic(42)
    out = {}
    for side in (JAX, PORT):
        window = _windows(side, "tumbling", 12, 3)
        d = str(tmp_path / side.name)
        fleet = _sharded(side, window=window, snapshot_dir=d, snapshot_every=6)
        with fleet:
            for b in traffic[:30]:  # cuts at 6 .. 30, rotations at 12 and 24
                fleet.ingest(*b)
            fleet.flush()
        assert fleet.engine._pager.tenancy_stats()["spilled_rows"] > 0
        resumed = _sharded(side, window=window, snapshot_dir=d, snapshot_every=6)
        meta = resumed.restore()
        assert int(meta["fleet_plan_cursor"]) == 30 and int(meta["stream_shard"]) == 1
        with resumed:
            for b in traffic[30:]:
                resumed.ingest(*b)
            got = _np(resumed.results())
        _same_values(got, _oracle(side, traffic, window=window), f"{side.name} resumed vs its oracle")
        out[side.name] = got
    _same_values(out["port"], out["jax"])


def test_sharded_windowed_restore_rehomes_across_resident_budget(tmp_path):
    """The same world, another resident_streams: the windowed piece re-homes
    through the spill store and replay stays exact."""
    traffic = _traffic(42)
    out = {}
    for side in (JAX, PORT):
        window = _windows(side, "sliding", 12, 3)
        d = str(tmp_path / side.name)
        fleet = _sharded(side, window=window, snapshot_dir=d, snapshot_every=6)
        with fleet:
            for b in traffic[:30]:
                fleet.ingest(*b)
            fleet.flush()
        wider = _sharded(side, window=window, resident=RESIDENT + 2, snapshot_dir=d, snapshot_every=6)
        wider.restore()
        with wider:
            for b in traffic[30:]:
                wider.ingest(*b)
            got = _np(wider.results())
        _same_values(got, _oracle(side, traffic, window=window), f"{side.name} re-homed vs its oracle")
        out[side.name] = got
    _same_values(out["port"], out["jax"])


def test_windowed_sshard_snapshot_refuses_cross_world_restore(tmp_path):
    for side in (JAX, PORT):
        window = side.e.WindowPolicy.tumbling(pane_batches=4, n_panes=2)

        def make():
            return side.e.MultiStreamEngine(side.col(), S, _engine_cfg(side, window), stream_shard=True,
                                            resident_streams=RESIDENT)

        eng = make()
        with eng:
            for sid, p, t in _traffic(8):
                eng.submit(sid, p, t)
            eng.flush()
            state, meta = eng._snapshot_doc()
        meta["world"] = 2  # what a two-shard host writes
        d = str(tmp_path / side.name)
        side.e.save_snapshot(d, state, meta, host_attrs=eng._metric.host_compute_attrs())
        with pytest.raises(side.user_error, match="same-world"):
            make().restore(d)


@pytest.mark.parametrize("windowed", [False, True], ids=["cumulative", "tumbling"])
def test_restore_sharded_fleet_into_single_engine(tmp_path, windowed):
    """The paged pieces reassemble from arena, spilled and init rows (pane
    rows regrouped under a ring) and fold into one unsharded engine, equal
    to the oracle and to JAX's merge."""
    traffic = _traffic(30)
    out = {}
    for side in (JAX, PORT):
        window = _windows(side, "tumbling", 6, 3) if windowed else None
        d = str(tmp_path / side.name / "fleet")
        fleet = _sharded(side, window=window, snapshot_dir=d, snapshot_every=6)
        with fleet:
            for b in traffic:
                fleet.ingest(*b)
            fleet.flush()
        single = side.e.MultiStreamEngine(side.col(), S, side.e.EngineConfig(buckets=BUCKETS, window=window))
        meta = side.f.restore_fleet_into(single, d)
        assert int(meta["stream_shard"]) == 0 and int(meta["num_hosts"]) == 1
        with single:
            got = _np(single.results())
        _same_values(got, _oracle(side, traffic, window=window), f"{side.name} merged vs its oracle")
        out[side.name] = got
    _same_values(out["port"], out["jax"])


# ------------------------------------------------------------------ surfaces


def _tools():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import engine_report
    import trace_export

    return engine_report, trace_export


def test_openmetrics_tenancy_families_strict_parse_both_directions():
    _, trace_export = _tools()
    legs = {}
    for side in (JAX, PORT):
        fleet = _sharded(side)
        with fleet:
            for b in _traffic(12):
                fleet.ingest(*b)
            fleet.results()
        fams = trace_export.parse_openmetrics(fleet.metrics_text())
        for fam in ("fleet_spill_rows", "fleet_spill_bytes", "fleet_resident_rows"):
            assert f"metrics_tpu_engine_{fam}" in fams, fam
        by_leg = {s["labels"]["leg"]: s["value"] for s in fams["metrics_tpu_engine_fleet_payload_bytes"]["samples"]}
        assert set(by_leg) == {"intra", "cross"} and by_leg["intra"] > 0 and by_leg["cross"] > 0
        st = fleet.engine.stats
        assert by_leg["cross"] == st.fleet_payload_exact_bytes + st.fleet_payload_quant_bytes
        legs[side.name] = by_leg
    assert legs["port"] == legs["jax"]
    eng = PORT.e.MultiStreamEngine(PORT.col(), S, _engine_cfg(PORT), stream_shard=True, resident_streams=RESIDENT)
    with eng:
        for sid, p, t in _traffic(8):
            eng.submit(sid, p, t)
        eng.results()
    text = eng.metrics_text()
    assert "fleet_" not in text
    trace_export.parse_openmetrics(text)


def test_engine_report_renders_fleet_tenancy_row():
    engine_report, _ = _tools()
    fleet = _sharded(PORT)
    with fleet:
        for b in _traffic(12):
            fleet.ingest(*b)
        fleet.results()
    rendered = engine_report.render({"summary": fleet.telemetry(), "recent_steps": []})
    assert "fleet tenancy" in rendered and "host RAM" in rendered
