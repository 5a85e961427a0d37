"""The port's admission control and degradation ladder
(``metrics_tpu_torch/engine/admission.py`` and its engine wiring), against
the JAX package's, on the CPU.

* **Units**: the token bucket, policy, detector and ladder cases of
  ``tests/engine/test_admission.py``, each scripted sequence run through
  both packages with the same outcomes (a logical clock makes every
  admission a pure function of the script).
* **Engine wiring** on the port: a rejected submit never takes a cursor, a
  back-pressure timeout refunds, per-stream identity, the ``admission``
  fault site retries, the OpenMetrics families, the rungs' effects, a
  ladder owned by one engine, shed rejections ticking the ladder.
* **Across the packages**: one paged engine each (16 streams in 2 slots, the
  JAX engine on a one-device mesh) on the same hot-spot-shift traffic of
  ``engine/traffic.py``, the detector armed on the spill rate only (the
  timing signals disarmed) and one batch per group (a flush after each
  submit), gives the same admitted and shed batches, the same ladder
  transitions, the same deferred reads and bit-equal states, which also
  equal a fault-free unsharded oracle fed the admitted batches.
"""
import threading

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import metrics_tpu as mt
import metrics_tpu.engine as je
import metrics_tpu.engine.admission as ja
import metrics_tpu_torch as mp
import metrics_tpu_torch.engine as pe
import metrics_tpu_torch.engine.admission as pa
from metrics_tpu_torch.engine.traffic import zipf_traffic
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

PACKAGES = {"jax": ja, "port": pa}


class _Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _batch(n=2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 65, size=n) / 64.0).astype(np.float32), (rng.rand(n) > 0.5).astype(np.int32)


def _outcome(fn):
    """What a call gives: its value, or the rejection's fields."""
    try:
        return ("ok", fn())
    except ja.AdmissionRejected as e:
        return ("rejected", e.retry_after_s, e.priority, e.shed, e.stream_id, str(e))
    except pa.AdmissionRejected as e:
        return ("rejected", e.retry_after_s, e.priority, e.shed, e.stream_id, str(e))
    except ValueError as e:
        return ("ValueError", str(e))


def _both(script):
    """``script(module)`` -> outcomes, for both packages; they must agree."""
    got = {name: script(mod) for name, mod in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# ---------------------------------------------------------------- token bucket


def test_token_bucket_burst_refill_and_backwards_clock_as_jax():
    def script(m):
        b = m.TokenBucket(capacity=4.0, rate=2.0, now=0.0)
        out = [b.take(4, 0.0), b.take(2, 0.0), b.take(2, 1.0), b.take(1, 1.0), b.take(5, 1.0)]
        c = m.TokenBucket(capacity=4.0, rate=1.0, now=10.0)
        c.take(4, 10.0)
        return out + [c.take(1, 5.0), c.take(1, 11.0)]

    out = _both(script)
    assert out[:5] == [0.0, 1.0, 0.0, 0.5, float("inf")] and out[5] > 0.0 and out[6] == 0.0


# ------------------------------------------------------------ admission policy


def test_policy_rejection_priorities_and_streams_as_jax():
    def script(m):
        clk = _Clock()
        pol = m.AdmissionPolicy(rows_per_s=2.0, burst_rows=4.0, clock=clk, priorities={7: 0}, class_rates={0: 4.0})
        out = [_outcome(lambda: pol.admit(None, 4)), _outcome(lambda: pol.admit(None, 2))]
        clk.t = 1.0
        out += [_outcome(lambda: pol.admit(None, 2)), _outcome(lambda: pol.admit(7, 4)), _outcome(lambda: pol.admit(3, 4))]
        clk.t = 1.5
        out += [_outcome(lambda: pol.admit(7, 4)), _outcome(lambda: pol.admit(3, 4)), _outcome(lambda: pol.admit(1, 9))]
        return out, pol.counters()

    out, counters = _both(script)
    assert out[1][:4] == ("rejected", 1.0, 1, False) and out[2] == ("ok", 1)
    assert out[5] == ("ok", 0) and out[6][0] == "rejected" and out[7][1] == float("inf")
    assert counters["admitted"] == {1: 3, 0: 2} and counters["rejected"] == {1: 3}


def test_shed_switch_and_refund_as_jax():
    def script(m):
        pol = m.AdmissionPolicy(rows_per_s=1.0, burst_rows=4.0, priorities={9: 2}, default_priority=1, clock=_Clock())
        pol.shed_lowest(True)
        out = [pol.is_shed(9), pol.is_shed(0), pol.shed_floor(), _outcome(lambda: pol.admit(9, 1)),
               _outcome(lambda: pol.admit(0, 4))]
        pol.refund(0, 4)
        out.append(_outcome(lambda: pol.admit(0, 4)))
        pol.shed_lowest(False)
        out += [pol.shed_floor(), _outcome(lambda: pol.admit(9, 1)), pol.lowest_priority()]
        return out, pol.counters()

    out, counters = _both(script)
    assert out[:3] == [True, False, 2] and out[3][3] is True and out[3][1] == float("inf")
    assert out[5] == ("ok", 1) and out[6] is None and out[7] == ("ok", 2) and out[8] == 2
    assert counters == {"admitted": {1: 1, 2: 1}, "rejected": {}, "shed": {2: 1}}


def test_policy_arguments_refused_as_jax():
    _both(lambda m: [_outcome(lambda: m.AdmissionPolicy(rows_per_s=0)), _outcome(lambda: m.AdmissionPolicy(burst_rows=-1))])


def test_counters_exact_under_concurrent_submits():
    pol = pa.AdmissionPolicy(rows_per_s=1e12, burst_rows=1e12)
    n, m = 8, 500

    def worker(tid):
        for _ in range(m):
            pol.admit(tid, 1)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(pol.counters()["admitted"].values()) == n * m


# ---------------------------------------------------------- detector and ladder


def test_detector_hysteresis_as_jax():
    def script(m):
        d = m.OverloadDetector(queue_p99_us=100.0, clear_frac=0.5)
        out = [d.assess({"queue_p99_us": v}) for v in (99.0, 100.0, 60.0, 49.0)]
        d2 = m.OverloadDetector(queue_p99_us=100.0, spill_rate=0.5)
        out += [d2.assess({"spill_rate": 0.5}),
                m.OverloadDetector(queue_p99_us=None, spill_rate=None, queue_depth_frac=None).assess({"spill_rate": 9.0}),
                _outcome(lambda: m.OverloadDetector(clear_frac=0.0))]
        return out

    assert _both(script)[:6] == [False, True, True, False, True, False]


def _hot(v):
    return {"queue_p99_us": 10.0 if v else 0.0}


def test_ladder_walk_is_a_pure_function_of_the_verdicts_as_jax():
    script = [True] * 7 + [False] * 9 + [True] * 3 + [False] * 20

    def run(m):
        lad = m.DegradationLadder(detector=m.OverloadDetector(queue_p99_us=1.0, clear_frac=1.0), up_after=2,
                                  down_after=3)
        return [lad.tick(_hot(v)) for v in script], lad.level

    moves, level = _both(run)
    assert [t for t in moves if t is not None][0] == (0, 1) and level == 0


def test_ladder_streaks_reset_and_rungs_are_checked_as_jax():
    def run(m):
        lad = m.DegradationLadder(detector=m.OverloadDetector(queue_p99_us=1.0, clear_frac=1.0), up_after=3,
                                  down_after=2)
        out = [lad.tick(_hot(v)) for v in (True, True, False, True, True, True)]
        out += [lad.rung(1), m.LADDER_RUNGS]
        out += [_outcome(lambda: m.DegradationLadder(rungs=r)) [0] for r in
                (("widen_coalesce", "shed"), ("shed", "widen_coalesce"), ("widen_coalesce", "nope"))]
        out.append(_outcome(lambda: m.DegradationLadder(up_after=0))[0])
        lad.reset()
        return out + [lad.level]

    out = _both(run)
    assert out[:6] == [None] * 5 + [(0, 1)]
    assert out[7] == ("widen_coalesce", "quantize_sync", "defer_cold_reads", "shed")
    assert out[8:] == ["ok", "ValueError", "ValueError", "ValueError", 0]


# ------------------------------------------------------------- engine wiring


def _acc():
    return mp.Accuracy(device="cpu")


class TestEngineWiring:
    def test_rejected_submit_never_takes_a_cursor(self):
        clk = _Clock()
        pol = pe.AdmissionPolicy(rows_per_s=1.0, burst_rows=2.0, clock=clk)
        eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), admission=pol))
        p, t = _batch()
        with eng:
            eng.submit(p, t)
            with pytest.raises(pe.AdmissionRejected):
                eng.submit(p, t)
            clk.t = 10.0
            eng.submit(p, t)
            eng.flush()
            assert eng._batches_done == 2
        adm = eng.stats.admission_summary()
        assert adm["admitted_by_priority"] == {"1": 2} and adm["rejected_by_priority"] == {"1": 1}
        assert eng.telemetry()["admission"] == adm

    def test_backpressure_timeout_refunds_admission_tokens(self):
        pol = pe.AdmissionPolicy(rows_per_s=1e-6, burst_rows=2.0, clock=_Clock())
        eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), max_queue=1, admission=pol))
        eng.start = lambda: eng  # the dispatcher never runs: pure backpressure
        p, t = _batch(1)
        eng.submit(p, t, timeout=0.1)
        for _ in range(3):
            with pytest.raises(pe.BackpressureTimeout):
                eng.submit(p, t, timeout=0.05)
        assert pol.counters()["admitted"] == {1: 1} and pol.counters()["rejected"] == {}

    def test_multistream_admission_uses_stream_identity(self):
        pol = pe.AdmissionPolicy(rows_per_s=1.0, burst_rows=2.0, clock=_Clock(), priorities={1: 3})
        eng = pe.MultiStreamEngine(_acc(), 2, pe.EngineConfig(buckets=(8,), admission=pol))
        p, t = _batch()
        with eng:
            eng.submit(0, p, t)
            eng.submit(1, p, t)
            with pytest.raises(pe.AdmissionRejected) as ei:
                eng.submit(1, p, t)
            assert ei.value.stream_id == 1 and ei.value.priority == 3
            eng.flush()

    def test_admission_fault_site_retries_transiently(self):
        inj = pe.FaultInjector(5, {"admission": pe.FaultSpec(schedule=(0,))})
        rec = pe.TraceRecorder(device="cpu")
        eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), admission=pe.AdmissionPolicy(),
                                                         fault_injector=inj, trace=rec))
        p, t = _batch()
        with eng:
            eng.submit(p, t)
            value = float(eng.result())
        assert value == float(np.mean((p >= 0.5) == t.astype(bool)))
        assert inj.fired.get("admission") == 1 and eng.stats.retries == 1
        assert rec.fault_sites() == {"admission": 1} and len(rec.events("retry")) == 1

    def test_config_rejects_wrong_types(self):
        with pytest.raises(MetricsTPUUserError, match="AdmissionPolicy"):
            pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), admission=object()))
        with pytest.raises(MetricsTPUUserError, match="DegradationLadder"):
            pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), ladder=object()))

    def test_openmetrics_admission_families_parse_strictly(self):
        import os
        import sys

        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
        import trace_export

        pol = pe.AdmissionPolicy(priorities={1: 2}, clock=_Clock())
        pol.shed_lowest(True)
        eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), admission=pol))
        p, t = _batch()
        with eng:
            eng.submit(p, t)
            eng.flush()
        families = trace_export.parse_openmetrics(eng.metrics_text())
        assert "metrics_tpu_engine_admission_admitted" in families
        assert families["metrics_tpu_engine_ladder_level"]["type"] == "gauge"
        plain = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,)))
        with plain:
            plain.submit(p, t)
            plain.flush()
        fams = trace_export.parse_openmetrics(plain.metrics_text())
        assert not any(k.startswith("metrics_tpu_engine_admission") for k in fams)
        assert "metrics_tpu_engine_ladder_level" not in fams


class _ScriptedDetector(pa.OverloadDetector):
    """Verdicts from a script: the rung tests must not depend on timing."""

    def __init__(self, script):
        super().__init__(queue_p99_us=1.0)
        self.script = list(script)

    def assess(self, signals):
        return self.script.pop(0) if self.script else False


class TestLadderEngineIntegration:
    def test_rungs_apply_and_release_on_engine_state(self):
        pol = pe.AdmissionPolicy(priorities={1: 2}, clock=_Clock())
        lad = pe.DegradationLadder(detector=_ScriptedDetector([True] * 3 + [False] * 8),
                                   rungs=("widen_coalesce", "defer_cold_reads", "shed"), up_after=1, down_after=2,
                                   widen_window_ms=7.5)
        cfg = pe.EngineConfig(buckets=(8,), admission=pol, ladder=lad)
        eng = pe.MultiStreamEngine(_acc(), 2, cfg)
        p, t = _batch()
        with eng:
            eng.submit(0, p, t)
            eng.flush()
            assert eng._cfg.coalesce_window_ms == 7.5 and cfg.coalesce_window_ms == 0.0  # a private copy
            eng.submit(0, p, t)
            eng.flush()
            assert eng._defer_cold_reads
            eng.submit(0, p, t)
            eng.flush()
            assert pol.shed_floor() == 2
            with pytest.raises(pe.AdmissionRejected) as ei:
                eng.submit(1, p, t)
            assert ei.value.shed and eng.stats.ladder_level == 3
            v1 = eng.result(0)
            v2 = eng.result(0)
            assert v1 is v2 and eng.stats.deferred_reads == 1
            for _ in range(5):
                eng.submit(0, p, t)
                eng.flush()
            assert eng.stats.ladder_level == 0 and eng._cfg.coalesce_window_ms == 0.0
            assert not eng._defer_cold_reads and pol.shed_floor() is None and eng._result_cache == {}
            eng.submit(1, p, t)
            eng.flush()
        assert eng.stats.ladder_transitions == 6

    def test_a_ladder_cannot_drive_two_engines(self):
        import gc

        lad = pe.DegradationLadder()
        e1 = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), ladder=lad))
        with pytest.raises(MetricsTPUUserError, match="already driving"):
            pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), ladder=lad))
        del e1
        gc.collect()
        pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), ladder=lad))

    def test_shed_rejections_tick_the_ladder_so_shed_only_traffic_recovers(self):
        pol = pe.AdmissionPolicy(priorities={0: 2}, default_priority=1, clock=_Clock())
        lad = pe.DegradationLadder(detector=_ScriptedDetector([True]), rungs=("shed",), up_after=1, down_after=2)
        eng = pe.MultiStreamEngine(_acc(), 2, pe.EngineConfig(buckets=(8,), admission=pol, ladder=lad))
        p, t = _batch()
        with eng:
            eng.submit(1, p, t)
            eng.flush()
            assert pol.shed_floor() == 2
            for _ in range(2):
                with pytest.raises(pe.AdmissionRejected):
                    eng.submit(0, p, t)
            assert eng.stats.ladder_level == 0 and pol.shed_floor() is None
            eng.submit(0, p, t)
            eng.flush()

    def test_quantize_rung_is_a_recorded_no_op(self):
        rec = pe.TraceRecorder(device="cpu")
        lad = pe.DegradationLadder(detector=_ScriptedDetector([True, False]), rungs=("quantize_sync",), up_after=1,
                                   down_after=1)
        eng = pe.StreamingEngine(_acc(), pe.EngineConfig(buckets=(8,), ladder=lad, trace=rec))
        p, t = _batch()
        with eng:
            eng.submit(p, t)
            eng.flush()
            assert eng._precision_tag == "exact"
            eng.submit(p, t)
            eng.flush()
        assert [(e["args"]["action"], e["args"]["level"], e["args"]["rung"]) for e in rec.events("ladder")] == [
            ("escalate", 1, "quantize_sync"), ("deescalate", 0, "quantize_sync")]
        assert eng.stats.ladder_transitions == 2


# ------------------------------------------------------------ across the packages

S, RESIDENT, BUCKETS = 16, 2, (8, 32)
SHED_CLASS, SHED_STREAMS = 2, (14, 15)
N_MAIN, SHIFT_AT = 56, 28


def _overload_run(jx):
    """The hot-spot shift, then deterministic spill pressure until the shed
    rung, a shed probe, a deferred read, and a recovery tail."""
    e, m = (je, mt) if jx else (pe, mp)
    kw = {} if jx else {"device": "cpu"}
    coll = m.MetricCollection([m.Accuracy(**kw), m.MeanSquaredError(**kw)])
    rec = je.TraceRecorder(capacity=1 << 15) if jx else pe.TraceRecorder(capacity=1 << 15, device="cpu")
    admission = e.AdmissionPolicy(rows_per_s=1e9, burst_rows=1e9,
                                  priorities={sid: SHED_CLASS for sid in SHED_STREAMS}, default_priority=1)
    ladder = e.DegradationLadder(detector=e.OverloadDetector(queue_p99_us=None, spill_rate=0.25,
                                                             queue_depth_frac=None),
                                 rungs=("widen_coalesce", "defer_cold_reads", "shed"), up_after=2, down_after=2)
    cfg = dict(buckets=BUCKETS, coalesce=1, admission=admission, ladder=ladder, trace=rec)
    if jx:
        cfg.update(mesh=Mesh(np.asarray(jax.devices()[:1]), ("dp",)), axis="dp", mesh_sync="deferred")
    eng = e.MultiStreamEngine(coll, S, e.EngineConfig(**cfg), stream_shard=True, resident_streams=RESIDENT)
    traffic = zipf_traffic(S, N_MAIN, alpha=1.6, seed=31, max_rows=6, shift_at=SHIFT_AT, shift_rotation=S // 2)
    # three streams cycling through two slots: every touch evicts (LRU)
    pump = [(4 + 4 * (i % 3), p, t) for i, (_, p, t) in enumerate(zipf_traffic(3, 40, seed=77, max_rows=4))]
    recovery = zipf_traffic(2, 24, seed=91, max_rows=4)
    fed, shed, deferred = [], [], []

    def feed(tag, b):
        try:
            eng.submit(*b)
        except e.AdmissionRejected as err:
            assert err.shed
            shed.append(tag)
            return
        eng.flush()
        fed.append((tag, b))

    with eng:
        for i, b in enumerate(traffic):
            feed(("main", i), b)
        for i, b in enumerate(pump):
            if eng.stats.ladder_level == len(ladder.rungs):
                break
            feed(("pump", i), b)
        top = eng.stats.ladder_level
        feed(("probe", 0), (SHED_STREAMS[1], np.asarray([0.5], np.float32), np.asarray([1], np.int32)))
        cold = next(sid for sid in range(S) if sid not in SHED_STREAMS and eng._pager.slot_of(
            *((sid % 1, sid // 1) if jx else (0, sid))) is None)
        eng.result(cold)
        eng.result(cold)
        deferred.append(eng.stats.deferred_reads)
        for i, b in enumerate(recovery):
            feed(("recovery", i), b)
        feed(("probe", 1), (SHED_STREAMS[1], np.asarray([0.5], np.float32), np.asarray([1], np.int32)))
        states = {sid: {k: np.asarray(v) for k, v in r.items()} for sid, r in eng.results().items()}
    transitions = [(ev["args"]["action"], ev["args"]["level"], ev["args"]["rung"]) for ev in rec.events("ladder")]
    return {"fed": [tag for tag, _ in fed], "batches": [b for _, b in fed], "shed": shed, "top": top,
            "transitions": transitions, "deferred": deferred, "states": states,
            "counters": admission.counters(), "level": eng.stats.ladder_level,
            "page_outs": eng.stats.page_outs, "spans": {s["name"] for s in rec.spans()}}


@pytest.fixture(scope="module")
def overload():
    return {"jax": _overload_run(True), "port": _overload_run(False)}


def test_the_ladder_escalates_to_shed_and_walks_back_down_as_jax(overload):
    j, p = overload["jax"], overload["port"]
    assert p["transitions"] == j["transitions"]
    assert p["top"] == j["top"] == 3 and p["level"] == j["level"] == 0
    walk = [("escalate", 1, "widen_coalesce"), ("escalate", 2, "defer_cold_reads"), ("escalate", 3, "shed"),
            ("deescalate", 2, "shed"), ("deescalate", 1, "defer_cold_reads"), ("deescalate", 0, "widen_coalesce")]
    # the Zipf misses flap the lower rungs; the pump's thrash climbs to shed
    # and the recovery tail walks all the way down
    assert p["transitions"][-6:] == walk
    assert p["page_outs"] == j["page_outs"] > 0 and {"page_in", "page_out", "route"} <= p["spans"]


def test_admitted_and_shed_batches_equal_jax(overload):
    j, p = overload["jax"], overload["port"]
    assert p["fed"] == j["fed"] and p["shed"] == j["shed"]
    assert ("probe", 0) in p["shed"] and ("probe", 1) in p["fed"]
    assert p["counters"] == j["counters"] and sum(p["counters"]["shed"].values()) == len(p["shed"])
    assert p["deferred"] == j["deferred"] == [1]


def test_states_bit_equal_jax_and_the_oracle_over_the_admitted_batches(overload):
    j, p = overload["jax"], overload["port"]
    oracle = pe.MultiStreamEngine(mp.MetricCollection([_acc(), mp.MeanSquaredError(device="cpu")]), S,
                                  pe.EngineConfig(buckets=BUCKETS))
    with oracle:
        for b in p["batches"]:
            oracle.submit(*b)
        want = {sid: {k: v.numpy() for k, v in r.items()} for sid, r in oracle.results().items()}
    for sid in range(S):
        for k in want[sid]:
            assert np.array_equal(p["states"][sid][k], j["states"][sid][k], equal_nan=True), (sid, k)
            assert np.array_equal(p["states"][sid][k], want[sid][k], equal_nan=True), (sid, k)
