"""The port's fleet runtime against the JAX package's, on the CPU.

One port test per test of ``tests/engine/test_fleet.py``, each run on both
packages' DEGENERATE fleets (one host: the same fold, barrier, snapshot-cut
protocol and restore matrix as H > 1, with no process group) over the same
seeded plan: the same refusals by type, results with counts bit-equal and
floats within 1e-6, the folded global states bit-equal. Host-count paths
(piece refusals, the fleet -> single merge) stamp a fabricated two-host
topology onto ordinary engines, as the JAX tests do. One more test crosses
the packages: JAX's degenerate fleet writes pickle-codec pieces
(``_use_orbax`` patched) that the port's ``restore_fleet_into`` merges to
JAX's value, and the port's pieces merge in JAX's.
"""
import os
import sys

import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.engine as je
import metrics_tpu.engine.snapshot as jsnap
import metrics_tpu_torch as mp
import metrics_tpu_torch.engine as pe
from metrics_tpu.engine import fleet as jf
from metrics_tpu.engine.traffic import zipf_traffic as jax_zipf_traffic
from metrics_tpu.utils.exceptions import MetricsTPUUserError as JaxUserError
from metrics_tpu_torch.engine import fleet as pf
from metrics_tpu_torch.engine.traffic import zipf_traffic
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

S = 6
BUCKETS = (8, 16)
RTOL = 1e-6
#: one capture/program cache a package for the file's engines
_AOT = {"jax": je.AotCache(), "port": pe.AotCache()}


@pytest.fixture(autouse=True, scope="module")
def _jax_pickle_snapshots():
    patch = pytest.MonkeyPatch()
    patch.setattr(jsnap, "_use_orbax", lambda: False)
    yield
    patch.undo()


class _Side:
    """One package's engine surface, for running a test twice."""

    def __init__(self, name):
        self.name = name
        self.jax = name == "jax"
        self.m = mt if self.jax else mp
        self.e = je if self.jax else pe
        self.f = jf if self.jax else pf
        self.user_error = JaxUserError if self.jax else MetricsTPUUserError

    def col(self):
        kw = {} if self.jax else {"device": "cpu"}
        return self.m.MetricCollection([self.m.Accuracy(**kw), self.m.MeanSquaredError(**kw)])

    def local_mesh(self):
        if self.jax:
            import jax
            from jax.sharding import Mesh

            return Mesh(np.asarray(jax.devices()[:1]), ("dp",))
        from metrics_tpu_torch.parallel.mesh import Mesh

        return Mesh(["cpu"], ("dp",))

    def fleet(self, num_streams=S, aot=True, **kw):
        engine = kw.pop("engine", None) or self.e.EngineConfig(buckets=BUCKETS)
        cfg = self.f.FleetConfig(num_streams=num_streams, engine=engine, **kw)
        return self.f.FleetEngine(self.col(), cfg, aot_cache=_AOT[self.name] if aot else None)

    def multi(self, **cfg):
        return self.e.MultiStreamEngine(self.col(), S, self.e.EngineConfig(buckets=BUCKETS, **cfg))


JAX, PORT = _Side("jax"), _Side("port")


def _traffic(n=24, seed=9):
    got = zipf_traffic(S, n, seed=seed)
    want = jax_zipf_traffic(S, n, seed=seed)
    assert all(a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]) for a, b in zip(got, want))
    return got


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer) or want.dtype == np.bool_:
        assert np.array_equal(got, want), (what, got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, equal_nan=True, err_msg=what)


def _same_values(got, want, what="values"):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same_values(got[k], want[k], f"{what}[{k}]")
    else:
        _close(got, want, what)


def _same_states(got, want, what="state"):
    """Folded global states, bit-equal (counts and dyadic sums)."""
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same_states(got[k], want[k], f"{what}[{k}]")
    else:
        assert np.array_equal(np.asarray(got), np.asarray(want)), (what, got, want)


def _serve(side, fleet, traffic):
    with fleet:
        for b in traffic:
            fleet.ingest(*b)
        return _np(fleet.results()), _np(fleet.fleet_state())


def _oracle(side, traffic, **cfg):
    eng = side.multi(**cfg)
    with eng:
        for sid, p, t in traffic:
            eng.submit(sid, p, t)
        return _np(eng.results())


def _both_raise(fn, jax_type, port_type, match):
    with pytest.raises(jax_type, match=match):
        fn(JAX)
    with pytest.raises(port_type, match=match):
        fn(PORT)


# ------------------------------------------------------------- construction


def test_fleet_config_validation():
    for kw, match in (({"num_processes": 2, "process_id": 2}, "process_id"), ({"num_processes": 0}, "positive")):
        _both_raise(lambda side: side.f.FleetEngine(side.col(), side.f.FleetConfig(**kw)),
                    jf.FleetTopologyError, pf.FleetTopologyError, match)


def test_step_sync_local_mesh_refused():
    _both_raise(lambda side: side.f.FleetEngine(side.col(), side.f.FleetConfig(
        engine=side.e.EngineConfig(mesh=side.local_mesh(), axis="dp", mesh_sync="step"))),
        JaxUserError, MetricsTPUUserError, "deferred")


def test_snapshot_every_without_dir_refused_at_construction():
    _both_raise(lambda side: side.f.FleetEngine(side.col(), side.f.FleetConfig(num_streams=S, snapshot_every=8)),
                JaxUserError, MetricsTPUUserError, "requires snapshot_dir")


def test_inner_snapshot_config_refused(tmp_path):
    _both_raise(lambda side: side.f.FleetEngine(side.col(), side.f.FleetConfig(
        engine=side.e.EngineConfig(snapshot_dir=str(tmp_path), snapshot_every=2))),
        JaxUserError, MetricsTPUUserError, "cut protocol")


def test_windowed_fleet_constructs_and_rotates_on_the_plan_cursor():
    traffic = _traffic(16)
    out = {}
    for side in (JAX, PORT):
        window = side.e.WindowPolicy.tumbling(pane_batches=8, n_panes=2)
        fleet = side.fleet(engine=side.e.EngineConfig(buckets=BUCKETS, window=window))
        got, state = _serve(side, fleet, traffic)
        _same_values(got, _oracle(side, traffic, window=window), f"{side.name} vs its oracle")
        assert fleet.engine.stats.pane_rotations == 2
        out[side.name] = (got, state)
    _same_values(out["port"][0], out["jax"][0])
    _same_states(out["port"][1], out["jax"][1])


# ------------------------------------------------------- degenerate serving


def test_degenerate_fleet_matches_multistream_oracle():
    traffic = _traffic()
    out = {}
    for side in (JAX, PORT):
        fleet = side.fleet()
        with fleet:
            for b in traffic:
                assert fleet.ingest(*b)  # a one-host fleet owns every stream
            got, state, one = _np(fleet.results()), _np(fleet.fleet_state()), _np(fleet.result(2))
        _same_values(got, _oracle(side, traffic), f"{side.name} vs its oracle")
        _same_values(one, got[2], "result(2)")
        assert fleet.streams_owned == list(range(S)) and fleet.home(5) == 0
        out[side.name] = (got, state)
    _same_values(out["port"][0], out["jax"][0])
    _same_states(out["port"][1], out["jax"][1])


def test_degenerate_fleet_single_metric_mode():
    rng = np.random.RandomState(0)
    batches = [((rng.randint(0, 65, size=n) / 64.0).astype(np.float32), (rng.rand(n) > 0.5).astype(np.int32))
               for n in (5, 8, 3, 6)]
    out = {}
    for side in (JAX, PORT):
        plain = side.e.StreamingEngine(side.col(), side.e.EngineConfig(buckets=BUCKETS))
        with plain:
            for b in batches:
                plain.submit(*b)
            want = _np(plain.result())
        fleet = side.fleet(num_streams=None)
        with fleet:
            for b in batches:
                fleet.ingest(*b)
            got, state = _np(fleet.result()), _np(fleet.fleet_state())
        _same_states(got, want, f"{side.name} vs its plain engine")
        with pytest.raises(side.user_error, match="multi-stream"):
            fleet.results()
        out[side.name] = (got, state)
    _same_values(out["port"][0], out["jax"][0])
    _same_states(out["port"][1], out["jax"][1])


def test_submit_foreign_stream_refused_names_home_host():
    for side in (JAX, PORT):
        fleet = side.fleet()
        fleet._H = 2  # the field a real two-process construction sets
        with fleet:
            with pytest.raises(side.f.FleetTopologyError, match="homes on host 1"):
                fleet.submit(1, np.zeros(2, np.float32), np.zeros(2, np.int32))
            fleet.submit(2, np.asarray([0.5, 1.0], np.float32), np.asarray([1, 0], np.int32))


# ------------------------------------------------------ snapshot-cut protocol


def test_fleet_snapshot_meta_and_restore_cycle(tmp_path):
    traffic = _traffic()
    out = {}
    for side in (JAX, PORT):
        d = str(tmp_path / side.name)
        fleet = side.fleet(snapshot_dir=d, snapshot_every=8)
        with fleet:
            for b in traffic[:20]:  # cuts at plan 8 and 16
                fleet.ingest(*b)
            fleet.flush()
        st = fleet.engine.stats
        assert st.fleet_cuts == 2 and st.fleet_barriers == 2
        assert side.f.last_consistent_cut(d, 1) == 1
        resumed = side.fleet(snapshot_dir=d, snapshot_every=8)
        meta = resumed.restore()
        assert int(meta["num_hosts"]) == 1 and int(meta["process_id"]) == 0
        assert int(meta["fleet_cut"]) == 1 and int(meta["fleet_plan_cursor"]) == 16
        assert resumed.global_cursor == 16
        got, state = _serve(side, resumed, traffic[16:])
        _same_values(got, _oracle(side, traffic), f"{side.name} resumed vs its oracle")
        out[side.name] = (got, state)
    _same_values(out["port"][0], out["jax"][0])
    _same_states(out["port"][1], out["jax"][1])


def test_explicit_cut_index_and_validation(tmp_path):
    for side in (JAX, PORT):
        d = str(tmp_path / side.name)
        fleet = side.fleet(snapshot_dir=d)
        with fleet:
            fleet.ingest(0, np.asarray([0.5], np.float32), np.asarray([1], np.int32))
            fleet.fleet_snapshot(cut=3)
            with pytest.raises(side.user_error, match=">= 0"):
                fleet.fleet_snapshot(cut=-1)
        assert side.f.last_consistent_cut(d, 1) == 3


def test_fleet_snapshot_requires_dir():
    for side in (JAX, PORT):
        fleet = side.fleet()
        with pytest.raises(side.user_error, match="snapshot_dir"):
            fleet.fleet_snapshot()
        with pytest.raises(side.user_error, match="snapshot_dir"):
            fleet.restore()


def test_barrier_disagreement_is_typed():
    for side in (JAX, PORT):
        fleet = side.fleet()
        fleet._barrier_program = lambda: (lambda x: np.asarray([5], np.int32))
        with pytest.raises(side.f.FleetBarrierError, match="disagree"):
            fleet._barrier(3)
        assert fleet.engine.stats.fleet_barriers == 0


# ------------------------------------------------------------ restore matrix


def test_pre_fleet_snapshot_restores_with_default_topology(tmp_path):
    """A snapshot with no host-topology meta restores as one process's."""
    traffic = _traffic(12)
    out = {}
    for side in (JAX, PORT):
        eng = side.multi()
        with eng:
            for sid, p, t in traffic:
                eng.submit(sid, p, t)
            eng.flush()
            state, meta = eng._snapshot_doc()
            want = _np(eng.results())
        for key in ("num_hosts", "process_id"):
            meta.pop(key, None)
        d = str(tmp_path / side.name)
        side.e.save_snapshot(d, state, meta, host_attrs=eng._metric.host_compute_attrs())
        fresh = side.multi()
        assert int(fresh.restore(d).get("batches_done", -1)) == len(traffic)
        with fresh:
            got = _np(fresh.results())
        _same_values(got, want, f"{side.name} restored")
        out[side.name] = got
    _same_values(out["port"], out["jax"])


def _fabricated_fleet_dir(side, root, traffic, num_hosts=2, local_mesh=False):
    """A ``num_hosts``-host fleet snapshot written without a process group:
    per host an ordinary engine stamped with the fleet topology serves its
    homed share and writes its piece and cut marker, the bytes a real
    fleet's hosts write. ``local_mesh``: each host on a one-device deferred
    mesh, so the pieces carry the shard-stacked form."""
    fleet_dir = root / side.name / "fleet"
    mesh_kw = {"mesh": side.local_mesh(), "axis": "dp", "mesh_sync": "deferred"} if local_mesh else {}
    for pid in range(num_hosts):
        host_dir = fleet_dir / f"host_{pid:03d}"
        eng = side.multi(snapshot_dir=str(host_dir), **mesh_kw)
        eng._fleet_hosts = num_hosts
        eng._fleet_pid = pid
        eng._fleet_cut = 0
        eng._fleet_plan_cursor = len(traffic)
        with eng:
            for sid, p, t in traffic:
                if sid % num_hosts == pid:
                    eng.submit(sid, p, t)
            path = eng.snapshot()
        with open(host_dir / "fleet_cut_000000", "w") as f:
            f.write(os.path.basename(path))
    return fleet_dir


@pytest.mark.parametrize("local_mesh", [False, True], ids=["plain", "deferred_mesh"])
def test_restore_fleet_into_single_engine(tmp_path, local_mesh):
    """Two fabricated host pieces (plain engines, or one-device deferred
    meshes whose pieces fold the shard axis and the host axis) merge into
    one single-process engine, equal to the oracle and to JAX's merge."""
    traffic = _traffic()
    out = {}
    for side in (JAX, PORT):
        fleet_dir = _fabricated_fleet_dir(side, tmp_path, traffic, local_mesh=local_mesh)
        single = side.multi()
        meta = side.f.restore_fleet_into(single, str(fleet_dir))
        assert int(meta["merged_from_hosts"]) == 2 and int(meta["num_hosts"]) == 1
        with single:
            got = _np(single.results())
        _same_values(got, _oracle(side, traffic), f"{side.name} merged vs its oracle")
        out[side.name] = got
    _same_values(out["port"], out["jax"])


def test_fleet_piece_refuses_plain_restore(tmp_path):
    for side in (JAX, PORT):
        fleet_dir = _fabricated_fleet_dir(side, tmp_path, _traffic(8))
        with pytest.raises(side.user_error, match="restore_fleet_into"):
            side.multi().restore(str(fleet_dir / "host_001"))


def test_restore_fleet_into_refusals(tmp_path):
    for side in (JAX, PORT):
        fleet_dir = _fabricated_fleet_dir(side, tmp_path, _traffic(8))
        with pytest.raises(side.f.FleetTopologyError, match="num_hosts=3"):
            side.f.last_consistent_cut(str(fleet_dir), 3)
        target = side.multi()
        target._fleet_hosts, target._fleet_pid = 2, 1
        with pytest.raises(side.f.FleetTopologyError, match="SINGLE-PROCESS"):
            side.f.restore_fleet_into(target, str(fleet_dir))
        os.unlink(fleet_dir / "host_001" / "fleet_cut_000000")  # a torn dir
        with pytest.raises(FileNotFoundError, match="consistent"):
            side.f.restore_fleet_into(side.multi(), str(fleet_dir))


def test_adopt_single(tmp_path):
    traffic = _traffic(10)
    out = {}
    for side in (JAX, PORT):
        src_dir = tmp_path / side.name
        src = side.multi(snapshot_dir=str(src_dir))
        with src:
            for sid, p, t in traffic:
                src.submit(sid, p, t)
            src.snapshot()
            want = _np(src.results())
        fleet = side.fleet()
        assert int(fleet.adopt_single(str(src_dir)).get("batches_done", -1)) == len(traffic)
        with fleet:
            got = _np(fleet.results())
        _same_values(got, want, f"{side.name} adopted")
        out[side.name] = got
    _same_values(out["port"], out["jax"])


def test_adopt_single_refuses_fleet_piece(tmp_path):
    for side in (JAX, PORT):
        fleet_dir = _fabricated_fleet_dir(side, tmp_path, _traffic(8))
        with pytest.raises(side.f.FleetTopologyError, match="single-process snapshot"):
            side.fleet().adopt_single(str(fleet_dir / "host_000"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fleet_pieces_merge_across_packages(tmp_path, writer):
    """A degenerate fleet of one package serves the plan with cuts every 8
    batches and is killed after 20; the OTHER package's
    ``restore_fleet_into`` merges the pieces of the last consistent cut (16)
    into a single-process engine: bit-equal states and the writer's values
    at the cut, which the writer's own merge gives too."""
    traffic = _traffic()
    src, dst = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    d = str(tmp_path / "fleet")
    fleet = src.fleet(snapshot_dir=d, snapshot_every=8)
    with fleet:
        for b in traffic[:20]:
            fleet.ingest(*b)
        fleet.flush()
    want = _oracle(src, traffic[:16])
    out = {}
    for side in (src, dst):
        single = side.multi()
        meta = side.f.restore_fleet_into(single, d)
        assert int(meta["fleet_cut"]) == 1 and int(meta["merged_from_hosts"]) == 1
        with single:
            out[side.name] = (_np(single.results()), _np(single.state()))
    _same_values(out[dst.name][0], want, f"{dst.name} merge of {src.name}'s pieces")
    _same_states(out[dst.name][1], out[src.name][1], "merged states")


# ----------------------------------------------------------------- fault sites


def test_host_loss_transient_retries_and_sticky_is_typed():
    traffic = _traffic(8)
    out = {}
    for side in (JAX, PORT):
        inj = side.e.FaultInjector(seed=3, plan={"host_loss": side.e.FaultSpec(schedule=(0,))})
        fleet = side.fleet(engine=side.e.EngineConfig(buckets=BUCKETS, fault_injector=inj))
        with fleet:
            for b in traffic:
                fleet.ingest(*b)
            got = _np(fleet.results())
        _same_values(got, _oracle(side, traffic), f"{side.name} after a transient host_loss")
        assert inj.fired.get("host_loss", 0) == 1 and fleet.engine.stats.retries >= 1
        out[side.name] = got
        sticky = side.e.FaultInjector(seed=3, plan={"host_loss": side.e.FaultSpec(schedule=(0,), transient=False)})
        doomed = side.fleet(engine=side.e.EngineConfig(buckets=BUCKETS, fault_injector=sticky))
        with doomed:
            doomed.ingest(0, np.asarray([0.5], np.float32), np.asarray([1], np.int32))
            with pytest.raises(side.f.FleetHostLostError, match="last consistent snapshot cut"):
                doomed.results()
    _same_values(out["port"], out["jax"])


def test_fleet_barrier_fault_retries(tmp_path):
    for side in (JAX, PORT):
        inj = side.e.FaultInjector(seed=5, plan={"fleet_barrier": side.e.FaultSpec(schedule=(0,))})
        d = str(tmp_path / side.name)
        fleet = side.fleet(engine=side.e.EngineConfig(buckets=BUCKETS, fault_injector=inj), snapshot_dir=d)
        with fleet:
            fleet.ingest(0, np.asarray([0.5], np.float32), np.asarray([1], np.int32))
            fleet.fleet_snapshot()
        assert inj.fired.get("fleet_barrier", 0) == 1 and fleet.engine.stats.retries >= 1
        assert side.f.last_consistent_cut(d, 1) == 0


# ------------------------------------------------------------------- surfaces


def _tools():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import engine_report
    import trace_export

    return engine_report, trace_export


def test_openmetrics_host_families_present_and_absent():
    _, trace_export = _tools()
    traffic = _traffic(8)
    texts = []
    for _ in range(2):  # a single-process engine: byte-stable, no fleet family
        eng = PORT.multi()
        with eng:
            for sid, p, t in traffic:
                eng.submit(sid, p, t)
            eng.results()
        texts.append(eng.metrics_text())
    assert texts[0] == texts[1] and "fleet_" not in texts[0]
    trace_export.parse_openmetrics(texts[0])
    fams = {}
    for side in (JAX, PORT):
        rec = side.e.TraceRecorder() if side.jax else side.e.TraceRecorder(device="cpu")
        fleet = side.fleet(engine=side.e.EngineConfig(buckets=BUCKETS, trace=rec))
        with fleet:
            for b in traffic:
                fleet.ingest(*b)
            fleet.results()
        fams[side.name] = trace_export.parse_openmetrics(fleet.metrics_text())
    for fam in ("fleet_ingested", "fleet_skipped", "fleet_merges", "fleet_barriers", "fleet_snapshot_cuts",
                "fleet_sync_payload_bytes", "fleet_num_hosts", "fleet_streams_owned", "fleet_payload_bytes"):
        full = f"metrics_tpu_engine_{fam}"
        assert full in fams["port"] and full in fams["jax"], fam
    for fam in ("fleet_ingested", "fleet_skipped", "fleet_merges", "fleet_barriers", "fleet_snapshot_cuts"):
        full = f"metrics_tpu_engine_{fam}"
        port_samples = {tuple(sorted(s.get("labels", {}).items())): s["value"] for s in fams["port"][full]["samples"]}
        jax_samples = {tuple(sorted(s.get("labels", {}).items())): s["value"] for s in fams["jax"][full]["samples"]}
        assert port_samples == jax_samples, fam
        assert any(dict(k).get("host") == "0" for k in port_samples), fam


def test_engine_report_renders_fleet_section_and_degrades():
    engine_report, _ = _tools()
    fleet = PORT.fleet()
    with fleet:
        for b in _traffic(8):
            fleet.ingest(*b)
        fleet.results()
    rendered = engine_report.render({"summary": fleet.telemetry(), "recent_steps": []})
    assert "fleet host" in rendered and "fleet boundaries" in rendered and "0 of 1" in rendered
    plain = pe.StreamingEngine(PORT.col(), pe.EngineConfig(buckets=BUCKETS))
    with plain:
        plain.submit(np.asarray([0.5], np.float32), np.asarray([1], np.int32))
        plain.result()
    assert "fleet host" not in engine_report.render({"summary": plain.telemetry(), "recent_steps": []})


def test_fleet_telemetry_block():
    blocks = {}
    for side in (JAX, PORT):
        fleet = side.fleet()
        with fleet:
            for b in _traffic(8):
                fleet.ingest(*b)
            fleet.results()
        block = fleet.telemetry()["fleet"]
        assert block["num_hosts"] == 1 and block["process_id"] == 0 and block["streams_owned"] == S
        assert block["ingested"] == 8 and block["skipped"] == 0
        assert block["merges"] == 1 and block["merge_us_total"] > 0
        assert block["sync_payload_bytes"]["exact"] > 0
        blocks[side.name] = block
        plain = side.e.StreamingEngine(side.col(), side.e.EngineConfig(buckets=BUCKETS))
        assert "fleet" not in plain.telemetry()
    drop = ("merge_us_total",)
    assert {k: v for k, v in blocks["port"].items() if k not in drop} == \
        {k: v for k, v in blocks["jax"].items() if k not in drop}


def test_fleet_payload_counters_do_not_double_count_local_merges():
    """A host on a local deferred mesh pays the host-local merge (its own
    sync_payload counters) and the fleet fold (the fleet's, once a fold);
    the fleet block reports the fold's bytes alone."""
    for side in (JAX, PORT):
        fleet = side.fleet(engine=side.e.EngineConfig(buckets=BUCKETS, mesh=side.local_mesh(), axis="dp",
                                                      mesh_sync="deferred"))
        with fleet:
            for b in _traffic(8):
                fleet.ingest(*b)
            fleet.results()
        per_fold = fleet._fleet_payload_split()
        st = fleet.engine.stats
        assert st.fleet_merges == 1
        assert (st.fleet_payload_exact_bytes, st.fleet_payload_quant_bytes) == per_fold
        assert fleet.telemetry()["fleet"]["sync_payload_bytes"]["exact"] == per_fold[0]
        assert st.sync_payload_exact_bytes > 0


def test_zero_steady_compiles_after_warmup():
    traffic = _traffic(16)
    for side in (JAX, PORT):
        fleet = side.fleet(aot=False)
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
