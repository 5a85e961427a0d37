"""The port's flight recorder (``metrics_tpu_torch/engine/trace.py``) and its
wiring through the engines, against the JAX package's, on the CPU.

* **Recorder and histogram**: the cases of ``tests/engine/test_trace.py``,
  on the port (a recorder built with ``device="cpu"`` folds through the plain
  version of K2), plus bucket counts and the OpenMetrics text equal to the
  JAX package's for the same observations.
* **Engines**: the stage spans, links, events and histograms of
  ``tests/engine/test_trace.py`` on the port's engines.
* **Across the packages**: the same seeded chaos plan (``tests/
  test_torch_chaos.py``'s canonical plans in scope: the sweep with its
  restore, paging, the codec, the dead dispatcher) gives both packages the
  same ``canonical_sequence()``. One mapping, written here and in ROADMAP
  §C: JAX's ``kernel_demotion`` event says ``backend="xla"``, the port's
  ``"auto"`` (its demotion is ``megastep -> auto``). The port's Chrome trace
  and OpenMetrics text pass ``tools/trace_export.py``'s validators and its
  telemetry renders through ``tools/engine_report.py --json``; the counter
  samples of ``metrics_text()`` equal JAX's for one deterministic run.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading

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
from metrics_tpu_torch.engine.trace import ENGINE_TRACE
from metrics_tpu_torch.ops.kernels import kernel_fault_scope
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, TOOLS)

import trace_export  # noqa: E402

BUCKETS = (8, 32)


@pytest.fixture(autouse=True, scope="module")
def _jax_pickle_snapshots():
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jsnap, "_use_orbax", lambda: False)
    yield
    mp_.undo()


def _rec(**kw):
    return pe.TraceRecorder(device="cpu", **kw)


def _dyadic(rng, n):
    return (rng.randint(0, 65, size=n) / 64.0).astype(np.float32)


def _traffic(n_batches=5, seed=0):
    rng = np.random.RandomState(seed)
    return [(_dyadic(rng, n), (rng.rand(n) > 0.5).astype(np.int32)) for n in rng.randint(2, 30, size=n_batches)]


def _coll():
    return mp.MetricCollection([mp.Accuracy(device="cpu"), mp.MeanSquaredError(device="cpu")])


# ------------------------------------------------------------------- recorder


class TestRecorder:
    def test_ring_is_bounded_and_counts_drops(self):
        rec = _rec(capacity=4)
        for i in range(10):
            rec.event("e", n=i)
        assert [r["args"]["n"] for r in rec.records()] == [6, 7, 8, 9]
        assert rec.dropped == 6

    def test_trace_ids_are_counter_ordered_and_group_derives(self):
        rec = _rec()
        assert [rec.new_trace() for _ in range(3)] == ["t1", "t2", "t3"]
        assert pe.TraceRecorder.group_trace(["t2", "t3"]) == "g2"
        assert pe.TraceRecorder.group_trace([]) == ENGINE_TRACE

    def test_begin_without_end_records_nothing(self):
        rec = _rec()
        rec.begin("abandoned", trace="t1")
        assert rec.spans() == []

    def test_canonical_sequence_excludes_timing_and_equals_jax(self):
        def run(rec):
            h = rec.begin("span", trace="t1", track="x", bucket=8)
            rec.end(h)
            rec.complete("wait", trace="t1", dur_us=123.0, track="x")
            rec.event("fault", track="x", site="step", occurrence=2)
            return rec.canonical_sequence()

        assert run(_rec()) == run(_rec()) == run(je.TraceRecorder())

    def test_invalid_capacity_rejected(self):
        with pytest.raises(ValueError, match="capacity"):
            _rec(capacity=0)

    def test_the_card_is_the_default_device(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has a card: the default is valid here")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pe.TraceRecorder()

    def test_thread_safety_no_loss_under_capacity(self):
        rec = _rec(capacity=10_000)

        def worker(k):
            for i in range(200):
                rec.event("e", worker=k, n=i)

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(rec.events()) == 800 and rec.dropped == 0

    def test_the_dispatcher_thread_tracks_as_dispatcher(self):
        rec = _rec()
        for name in ("metrics-tpu-torch-engine", "other"):
            t = threading.Thread(target=lambda: rec.event("e"), name=name)
            t.start()
            t.join()
        assert [r["track"] for r in rec.records()] == ["dispatcher", "other"]


# ------------------------------------------------------------- histogram path


class TestHistogram:
    def test_bucket_counts_match_numpy_and_jax(self):
        vals = np.random.RandomState(7).gamma(2.0, 500.0, size=257)
        edges = (100.0, 500.0, 1000.0, 5000.0)
        h = pe.FixedBucketHistogram("h_us", edges, device="cpu")
        jh = je.FixedBucketHistogram("h_us", edges)
        for v in vals:
            h.observe(v)
            jh.observe(v)
        want = np.bincount(np.searchsorted(np.asarray(edges), vals, side="left"), minlength=len(edges) + 1)
        assert np.array_equal(h.bucket_counts(), want)
        assert np.array_equal(h.bucket_counts(), jh.bucket_counts())
        assert h.count == 257 and h.sum == pytest.approx(float(vals.sum()), rel=1e-12)
        assert h.snapshot() == jh.snapshot()
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert h.quantile(q) == jh.quantile(q)

    def test_incremental_flush_accumulates(self):
        h = pe.FixedBucketHistogram("h_us", (10.0, 20.0), device="cpu")
        h.observe(5.0)
        assert h.count == 1
        h.observe(15.0)
        h.observe(25.0)
        assert h.count == 3 and list(h.bucket_counts()) == [1, 1, 1]

    def test_bad_edges_rejected(self):
        for edges in ((10.0, 10.0), ()):
            with pytest.raises(ValueError, match="ascending"):
                pe.FixedBucketHistogram("h", edges, device="cpu")

    def test_concurrent_observe_and_scrape_loses_nothing(self):
        h = pe.FixedBucketHistogram("h_us", (10.0, 100.0, 1000.0), device="cpu")
        n_per_writer, writers = 2000, 3
        stop = threading.Event()
        snaps = []

        def write(seed):
            rng = np.random.RandomState(seed)
            for _ in range(n_per_writer):
                h.observe(float(rng.gamma(2.0, 50.0)))

        def scrape():
            while not stop.is_set():
                snaps.append(h.snapshot())

        readers = [threading.Thread(target=scrape) for _ in range(2)]
        ws = [threading.Thread(target=write, args=(s,)) for s in range(writers)]
        for t in readers + ws:
            t.start()
        for t in ws:
            t.join()
        stop.set()
        for t in readers:
            t.join()
        assert h.count == n_per_writer * writers
        assert int(h.bucket_counts().sum()) == n_per_writer * writers
        assert all(s["count"] == sum(s["counts"]) for s in snaps)

    def test_pending_is_bounded_without_scrapes(self):
        h = pe.FixedBucketHistogram("h_us", (10.0, 100.0), device="cpu")
        for i in range(h.FOLD_PENDING_AT + 7):
            h.observe(float(i % 200))
        assert len(h._pending) < h.FOLD_PENDING_AT
        assert h.count == h.FOLD_PENDING_AT + 7

    def test_lazy_histograms_inherit_recorder_buckets(self):
        edges = (5.0, 50.0)
        rec = _rec(latency_buckets_us=edges)
        rec.observe("custom_latency_us", 30.0)
        by_name = {h.name: h for h in rec.histograms()}
        assert by_name["custom_latency_us"].edges == edges == by_name["step_latency_us"].edges
        assert all(h.device == torch.device("cpu") for h in by_name.values())

    def test_a_fold_never_consults_the_kernel_fault_hook(self):
        """Observability must not move a chaos plan's ``kernel`` occurrences:
        the fold runs with no hook in scope."""
        seen = []
        h = pe.FixedBucketHistogram("h_us", (10.0,), device="cpu")
        with kernel_fault_scope(seen.append):
            for v in (1.0, 20.0, 3.0):
                h.observe(v)
            h.flush()
            pe.FixedBucketHistogram("x", (1.0,), device="cpu").observe(0.5)
        assert seen == [] and list(h.bucket_counts()) == [2, 1]


class TestSummaryParity:
    def test_slowest_ranking_matches_trace_export(self):
        rec = _rec()
        for tid in ("t1", "t2", "t3"):
            rec.complete("submit", trace=tid, dur_us=1.0, track="MainThread")
        rec.complete("queue_wait", trace="g1", dur_us=500.0, track="dispatcher")
        rec.complete("coalesce", trace="g1", dur_us=100.0, track="dispatcher", links=("t1", "t2"))
        rec.complete("queue_wait", trace="g3", dur_us=10.0, track="dispatcher")
        rec.complete("coalesce", trace="g3", dur_us=400.0, track="dispatcher", links=("t3",))
        ranked = rec.summary(slowest=2)["slowest_traces"]
        assert [(t["trace"], t["dur_us"]) for t in ranked] == [("g1", 600.0), ("g3", 410.0)]
        lines = trace_export.summarize(rec.to_chrome_trace(), slowest=2).splitlines()
        assert [ln.split()[0] for ln in lines[1:3]] == ["g1", "g3"]

    def test_submit_only_traces_are_not_journeys(self):
        rec = _rec()
        rec.complete("submit", trace="t1", dur_us=9_000.0, track="MainThread")
        rec.complete("queue_wait", trace="g1", dur_us=9_100.0, track="dispatcher")
        rec.complete("coalesce", trace="g1", dur_us=50.0, track="dispatcher", links=("t1",))
        assert [t["trace"] for t in rec.summary(slowest=5)["slowest_traces"]] == ["g1"]


class TestOpenMetrics:
    def test_render_equals_jax_byte_for_byte(self):
        def render(e, **kw):
            h = e.FixedBucketHistogram("lat_us", (1.0, 2.0), **kw)
            h.observe(0.5)
            h.observe(5.0)
            return e.render_openmetrics({"steps": 3}, [h], labeled_counters={"faults_injected": ("site", {"step": 2})},
                                        gauges={"programs": 4})

        text = render(pe, device="cpu")
        assert text == render(je)
        lines = text.splitlines()
        assert 'metrics_tpu_engine_lat_us_bucket{le="1"} 1' in lines
        assert 'metrics_tpu_engine_lat_us_bucket{le="+Inf"} 2' in lines
        assert lines[-1] == "# EOF"
        trace_export.parse_openmetrics(text)


# ------------------------------------------------------------- engine wiring


def _run(engine, batches, read=True):
    with engine:
        for b in batches:
            engine.submit(*b)
        return engine.result() if read else engine.flush()


class TestEngineTracing:
    def test_submit_spans_link_into_groups_and_the_untraced_twin_agrees(self):
        rec = _rec()
        batches = _traffic(5)
        got = _run(pe.StreamingEngine(_coll(), pe.EngineConfig(buckets=BUCKETS, trace=rec)), batches)
        submits, groups = rec.spans("submit"), rec.spans("coalesce")
        assert len(submits) == len(batches)
        assert sorted(t for g in groups for t in g["args"]["links"]) == sorted(s["trace"] for s in submits)
        for g in groups:
            assert g["trace"] == "g" + g["args"]["links"][0].lstrip("t")
        want = _run(pe.StreamingEngine(_coll(), pe.EngineConfig(buckets=BUCKETS)), batches)
        for k in want:
            assert torch.equal(got[k], want[k])

    def test_pipeline_stage_spans_present(self):
        rec = _rec()
        _run(pe.StreamingEngine(_coll(), pe.EngineConfig(buckets=BUCKETS, trace=rec)), _traffic(3))
        names = {s["name"] for s in rec.spans()}
        assert {"submit", "queue_wait", "coalesce", "pad", "aot", "device_step", "result"} <= names
        aot = rec.spans("aot")
        assert aot[0]["args"]["cache"] == "miss" and {a["args"]["cache"] for a in aot} <= {"hit", "miss"}
        steps = rec.spans("device_step")
        assert [s["args"]["step"] for s in steps] == list(range(len(steps)))
        assert all(s["args"]["bucket"] in BUCKETS for s in steps)

    def test_tracing_off_records_nothing_and_rejects_export(self):
        eng = pe.StreamingEngine(_coll(), pe.EngineConfig(buckets=BUCKETS))
        assert eng.trace is None
        _run(eng, _traffic(1))
        with pytest.raises(MetricsTPUUserError, match="TraceRecorder"):
            eng.export_trace("unused.json")
        text = eng.metrics_text()
        assert "metrics_tpu_engine_steps_total 1" in text.splitlines() and text.rstrip().endswith("# EOF")

    def test_bad_trace_config_rejected(self):
        with pytest.raises(MetricsTPUUserError, match="TraceRecorder"):
            pe.StreamingEngine(mp.Accuracy(device="cpu"), pe.EngineConfig(trace=object()))

    def test_fault_events_and_recovery_spans(self):
        rec = _rec()
        inj = pe.FaultInjector(3, {"step": pe.FaultSpec(schedule=(0,)), "kernel": pe.FaultSpec(schedule=(0,))})
        eng = pe.StreamingEngine(_coll(), pe.EngineConfig(buckets=BUCKETS, kernel_backend="megastep",
                                                          fault_injector=inj, trace=rec))
        _run(eng, _traffic(3, seed=1))
        assert rec.fault_sites() == {"kernel": 1, "step": 1}
        assert len(rec.events("rollback")) >= 2 and len(rec.events("retry")) >= 1
        (demotion,) = rec.events("kernel_demotion")
        assert demotion["args"] == {"backend": "auto"}

    def test_quarantine_event_carries_cursor_and_reason(self):
        rec = _rec()
        eng = pe.StreamingEngine(_coll(), pe.EngineConfig(
            buckets=BUCKETS, screen=pe.ScreenPolicy(non_finite="quarantine"), trace=rec))
        poison = (np.asarray([np.nan, 0.5], np.float32), np.asarray([1, 0], np.int32))
        with eng:
            eng.submit(*_traffic(1, seed=2)[0])
            eng.flush()
            eng.submit(*poison)
            eng.result()
        (ev,) = rec.events("quarantine")
        assert ev["args"]["cursor"] == 1 and ev["args"]["rows"] == 2 and "non-finite" in ev["args"]["reason"]

    def test_snapshot_write_and_restore_spans(self, tmp_path):
        rec = _rec()
        eng = pe.StreamingEngine(_coll(), pe.EngineConfig(buckets=BUCKETS, snapshot_dir=str(tmp_path), trace=rec))
        with eng:
            eng.submit(*_traffic(1, seed=3)[0])
            eng.snapshot()
        assert len(rec.spans("snapshot_write")) == 1
        meta = pe.StreamingEngine(_coll(), pe.EngineConfig(buckets=BUCKETS, snapshot_dir=str(tmp_path),
                                                           trace=rec)).restore()
        (sp,) = rec.spans("snapshot_restore")
        assert sp["args"] == {"cursor": int(meta["batches_done"]), "generations_skipped": 0}

    def test_latency_histograms_feed_from_steps(self):
        rec = _rec()
        eng = pe.StreamingEngine(_coll(), pe.EngineConfig(buckets=BUCKETS, trace=rec))
        _run(eng, _traffic(4, seed=4))
        hists = {h.name: h for h in rec.histograms()}
        assert hists["step_latency_us"].count == eng.stats.steps
        assert hists["result_latency_us"].count == 1 and hists["queue_wait_us"].count == 4

    def test_telemetry_carries_the_trace_section_and_renders(self, tmp_path):
        rec = _rec()
        eng = pe.StreamingEngine(_coll(), pe.EngineConfig(buckets=BUCKETS, trace=rec))
        _run(eng, _traffic(3, seed=5))
        doc = eng.telemetry()
        assert doc["trace"]["spans"] > 0 and doc["trace"]["slowest_traces"]
        assert doc["compile_cache"]["misses"] >= 1
        path = tmp_path / "tele.json"
        eng.export_telemetry(str(path))
        exported = json.loads(path.read_text())
        assert exported["trace"]["spans"] == doc["trace"]["spans"] and exported["recent_steps"]
        out = subprocess.run([sys.executable, os.path.join(TOOLS, "engine_report.py"), str(path), "--json"],
                             capture_output=True, text=True, check=True).stdout
        rendered = json.loads(out)
        assert rendered["summary"]["steps"] == eng.stats.steps and rendered["trace"]["spans"] > 0
        assert "trace" not in pe.StreamingEngine(_coll(), pe.EngineConfig(buckets=BUCKETS)).telemetry()

    def test_chrome_export_schema_and_flows(self, tmp_path):
        rec = _rec()
        eng = pe.StreamingEngine(_coll(), pe.EngineConfig(buckets=BUCKETS, trace=rec))
        _run(eng, _traffic(3, seed=6))
        doc = json.loads(open(eng.export_trace(str(tmp_path / "trace.json"))).read())
        assert trace_export.validate_chrome_trace(doc) == [] and trace_export.validate_links(doc) == []
        names = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
        assert "dispatcher" in names
        flows = [e for e in doc["traceEvents"] if e["ph"] in ("s", "f")]
        assert len(flows) == 6


class TestMultiStreamTracing:
    def test_stream_id_on_spans(self):
        rec = _rec()
        eng = pe.MultiStreamEngine(mp.Accuracy(device="cpu"), 4, pe.EngineConfig(buckets=(8,), trace=rec))
        rng = np.random.RandomState(0)
        with eng:
            for sid in (2, 0, 2):
                eng.submit(sid, _dyadic(rng, 4), (rng.rand(4) > 0.5).astype(np.int32))
            eng.result(2)
        assert [s["args"]["stream_id"] for s in rec.spans("submit")] == [2, 0, 2]
        groups = rec.spans("coalesce")
        assert sorted({sid for g in groups for sid in g["args"]["stream_ids"]}) == [0, 2]
        (res,) = rec.spans("result")
        assert res["args"]["stream_id"] == 2

    def test_paged_engine_traces_routing_and_paging(self):
        rec = _rec()
        eng = pe.MultiStreamEngine(_coll(), SSHARD_STREAMS, pe.EngineConfig(buckets=BUCKETS, coalesce=1, trace=rec),
                                   stream_shard=True, resident_streams=SSHARD_RESIDENT)
        with eng:
            for sid, p, t in stream_shard_traffic():
                eng.submit(sid, p, t)
            eng.flush()
        assert len(rec.spans("route")) == eng.stats.batches_submitted
        assert sum(s["args"]["rows"] for s in rec.spans("page_out")) == eng.stats.page_outs > 0
        assert sum(s["args"]["rows"] for s in rec.spans("page_in")) == eng.stats.page_ins > 0
        hists = {h.name: h.count for h in rec.histograms()}
        assert hists["page_out_us"] == len(rec.spans("page_out")) and hists["route_us"] == len(rec.spans("route"))
        paging = eng.telemetry()["paging"]
        assert paging["resident_streams"] == SSHARD_RESIDENT and paging["spilled_streams"] >= 1


# ------------------------------------------------------------ across the packages


def _injector(jx, canonical):
    if jx:
        return canonical
    return pe.FaultInjector(canonical.seed, {s: pe.FaultSpec(**dataclasses.asdict(sp))
                                             for s, sp in canonical.plan.items()})


def _pkg(jx):
    return je if jx else pe


def _both_coll(jx):
    if jx:
        return mt.MetricCollection([mt.Accuracy(), mt.MeanSquaredError()])
    return _coll()


def _both_rec(jx):
    return je.TraceRecorder(capacity=1 << 14) if jx else _rec(capacity=1 << 14)


def _sweep_plan(jx, d):
    """JAX's chaos sweep (plan ``chaos``) and the restore past the corrupt
    LATEST (plan ``snapshot_read``) into one recorder."""
    e = _pkg(jx)
    _, traffic = chaos_traffic()
    injs, rec = chaos_injectors(), _both_rec(jx)
    eng = e.StreamingEngine(_both_coll(jx), e.EngineConfig(
        buckets=BUCKETS, coalesce=8, kernel_backend="megastep_interpret" if jx else "megastep",
        screen=e.ScreenPolicy(non_finite="quarantine"), snapshot_every=2, snapshot_dir=d, snapshot_keep=4,
        fault_injector=_injector(jx, injs["chaos"]), trace=rec))
    with eng:
        for b in traffic:
            eng.submit(*b)
        eng.result()
    res = e.StreamingEngine(_both_coll(jx), e.EngineConfig(
        buckets=BUCKETS, coalesce=1, screen=e.ScreenPolicy(non_finite="quarantine"), snapshot_dir=d,
        fault_injector=_injector(jx, injs["snapshot_read"]), trace=rec))
    cursor = int(res.restore()["batches_done"])
    with res:
        for b in traffic[cursor:]:
            res.submit(*b)
        res.result()
    return rec, [eng, res]


def _paging_plan(jx, d):
    e = _pkg(jx)
    rec = _both_rec(jx)
    kw = dict(buckets=BUCKETS, coalesce=1, kernel_backend="xla" if jx else None, snapshot_dir=d,
              fault_injector=_injector(jx, chaos_injectors()["paging"]), trace=rec)
    if jx:
        kw.update(mesh=Mesh(np.asarray(jax.devices()[:1]), ("dp",)), axis="dp", mesh_sync="deferred")
    eng = e.MultiStreamEngine(_both_coll(jx), SSHARD_STREAMS, e.EngineConfig(**kw), stream_shard=True,
                              resident_streams=SSHARD_RESIDENT)
    traffic = stream_shard_traffic()
    with eng:
        for sid, p, t in traffic[:12]:
            eng.submit(sid, p, t)
        eng.snapshot()
        for sid, p, t in traffic[12:]:
            eng.submit(sid, p, t)
        eng.result(1)
    return rec, [eng]


def _quant_plan(jx, d):
    e = _pkg(jx)
    clean, _ = chaos_traffic()
    rec = _both_rec(jx)
    inj = _injector(jx, chaos_injectors()["quant"])
    cfg = dict(buckets=BUCKETS, coalesce=1, snapshot_dir=d, compress_payloads=True, fault_injector=inj, trace=rec)
    eng = e.StreamingEngine(_both_coll(jx), e.EngineConfig(**cfg))
    with eng:
        for b in clean[:4]:
            eng.submit(*b)
        eng.snapshot()
    res = e.StreamingEngine(_both_coll(jx), e.EngineConfig(**cfg))
    res.restore()
    with res:
        for b in clean[4:]:
            res.submit(*b)
        res.result()
    return rec, [eng, res]


def _dead_plan(jx, d):
    e = _pkg(jx)
    rec = _both_rec(jx)
    acc = mt.Accuracy() if jx else mp.Accuracy(device="cpu")
    eng = e.StreamingEngine(acc, e.EngineConfig(buckets=(8,), coalesce=1, max_queue=2, trace=rec,
                                                fault_injector=_injector(jx, chaos_injectors()["dispatcher_kill"])))
    p, t = np.asarray([0.9, 0.2], np.float32), np.asarray([1, 0], np.int32)
    eng.start()
    eng.submit(p, t)
    with pytest.raises(e.EngineDispatchError, match="dispatcher_kill"):
        eng.flush()
    eng.reset()
    eng.submit(p, t)
    eng.result()
    eng.stop()
    return rec, [eng]


PLANS = {"sweep": _sweep_plan, "paging": _paging_plan, "quant": _quant_plan, "dispatcher_kill": _dead_plan}


def _map_jax_names(seq):
    """JAX's canonical sequence in the port's vocabulary: the one difference
    is the demotion target (ROADMAP §C)."""
    def arg(name, k, v):
        return "auto" if (name, k, v) == ("kernel_demotion", "backend", "xla") else v

    return {track: [(kind, name, tr, tuple((k, arg(name, k, v)) for k, v in args)) for kind, name, tr, args in recs]
            for track, recs in seq.items()}


@pytest.fixture(scope="module")
def plan_runs(tmp_path_factory):
    return {name: {side: fn(side == "jax", str(tmp_path_factory.mktemp(f"{name}_{side}")))
                   for side in ("jax", "port")}
            for name, fn in PLANS.items()}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_one_seeded_plan_gives_both_packages_one_canonical_sequence(plan_runs, plan):
    (jrec, _), (prec, _) = plan_runs[plan]["jax"], plan_runs[plan]["port"]
    assert jrec.dropped == prec.dropped == 0
    want, got = _map_jax_names(jrec.canonical_sequence()), prec.canonical_sequence()
    assert set(got) == set(want)
    for track in want:
        assert got[track] == want[track], track
    assert prec.fault_sites() == jrec.fault_sites()
    assert sum(len(v) for v in got.values()) > 10


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_every_firing_of_the_plan_is_a_fault_event(plan_runs, plan):
    (prec, engines) = plan_runs[plan]["port"]
    fired = {}
    for eng in engines:
        for site, n in eng.stats.faults_by_site().items():
            fired[site] = fired.get(site, 0) + n
    assert prec.fault_sites() == fired and fired


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_the_ports_chaos_trace_passes_the_validators(plan_runs, plan):
    prec, _ = plan_runs[plan]["port"]
    doc = json.loads(json.dumps(prec.to_chrome_trace()))
    assert trace_export.validate_chrome_trace(doc) == []
    assert trace_export.validate_links(doc) == []
    assert trace_export.fault_sites(doc) == prec.fault_sites()


#: the capture cache's families: JAX's cache also holds its compiled COMPUTE
#: programs, the port's holds captured steps only (its compute runs eagerly)
CACHE_FAMILIES = ("metrics_tpu_engine_compile_cache_misses", "metrics_tpu_engine_compile_cache_hits",
                  "metrics_tpu_engine_compiled_programs")


def _counter_samples(text):
    fams = trace_export.parse_openmetrics(text)
    return {(s["name"], tuple(sorted(s["labels"].items()))): s["value"]
            for name, f in fams.items() if f["type"] in ("counter", "gauge") and name not in CACHE_FAMILIES
            for s in f["samples"]}


@pytest.mark.parametrize("paged", [False, True], ids=["single", "paged"])
def test_metrics_text_counters_equal_jax_for_a_deterministic_run(plan_runs, paged):
    """One deterministic run per package (every group a singleton): every
    counter and gauge sample of ``metrics_text()`` agrees, histograms aside
    (their values are latencies) and the capture cache's families aside
    (:data:`CACHE_FAMILIES`). The paging plan's JAX engine runs on a
    one-device mesh (its mesh-only merge counter stays 0, as the port's)."""
    plan = "paging" if paged else "quant"
    (jrec, jengines), (prec, pengines) = plan_runs[plan]["jax"], plan_runs[plan]["port"]
    for je_, pe_ in zip(jengines, pengines):
        jtext, ptext = je_.metrics_text(), pe_.metrics_text()
        got, want = _counter_samples(ptext), _counter_samples(jtext)
        assert got == want
        hists = [f for f, v in trace_export.parse_openmetrics(ptext).items() if v["type"] == "histogram"]
        assert "metrics_tpu_engine_step_latency_us" in hists
