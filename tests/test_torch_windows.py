"""The port's windowed serving against the JAX package's, on the CPU: the
window policy, the single-stream engine's tumbling, sliding and EWMA rings,
drift alarms at every rotation, and the ``windows``/``ewma`` chaos plans.

* **Policy**: ``fingerprint()`` strings byte-identical for every kind and
  cadence; validation and eligibility refusals with the same messages.
* **Engine parity**: the same seeded batches (dyadic values, so float sums
  are exact) into a JAX ``StreamingEngine`` and the port's under the same
  policy, ``result()`` read mid-pane at every pane and at the end, then the
  pane-stacked ``state()`` and the telemetry's ``windows`` block. Integer
  states must be bit-exact; float states and values agree within rtol 1e-6
  (the computes run in different libraries; the sums are exact). The
  flagship collection (accuracy, macro F1, binned AP, confusion matrix) runs
  under ``"megastep"`` (K5's plain version here) against JAX's
  ``"megastep_interpret"``; the min/max members, the mean and the
  scan-strategy capacity AUROC under the default backends.
* **Drift**: ``windows_smoke``'s seeded label-drift run (``zipf_traffic(...,
  drift_at=36)``) raises the same ``DriftAlarm`` list in both packages.
* **Chaos**: JAX's ``windows`` plan (a transient ``pane_rotate`` and
  ``drift_eval``) and ``ewma`` plan give the same injector summaries, the same
  ``canonical_sequence()`` and the same results, with exactly one decay per
  rotation (the result bit-equal to a fault-free twin's).
* **Cumulative engines** carry no window families in their telemetry or
  OpenMetrics, and an explicit cumulative policy changes nothing.

Multi-stream, paged and snapshot parity are ``tests/test_torch_windows_streams.py``'s.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.engine as je
import metrics_tpu_torch as mp
import metrics_tpu_torch.engine as pe
from metrics_tpu.engine.chaos_smoke import chaos_injectors, chaos_traffic
from metrics_tpu.engine.traffic import zipf_traffic as jax_zipf_traffic
from metrics_tpu_torch.engine.traffic import zipf_traffic
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, TOOLS)

import trace_export  # noqa: E402

C, T = 3, 5
RTOL = 1e-6


# ------------------------------------------------------------------ both packages


class _Side:
    def __init__(self, jx):
        self.jax = jx
        self.m = mt if jx else mp
        self.e = je if jx else pe
        self.kw = {} if jx else {"device": "cpu"}

    def metric(self, name):
        m, kw = self.m, self.kw
        if name == "flagship":
            return m.MetricCollection({
                "acc": m.Accuracy(**kw), "f1": m.F1Score(num_classes=C, average="macro", **kw),
                "ap": m.BinnedAveragePrecision(num_classes=C, thresholds=T, **kw),
                "cm": m.ConfusionMatrix(num_classes=C, **kw)})
        if name == "minmax":
            return m.MetricCollection({"min": m.MinMetric(**kw), "max": m.MaxMetric(**kw), "mean": m.MeanMetric(**kw)})
        if name == "mean":
            return m.MetricCollection({"mean": m.MeanMetric(**kw), "sum": m.SumMetric(**kw)})
        if name == "scan":
            return m.AUROC(capacity=64, **kw)
        if name == "acc_mse":
            return m.MetricCollection([m.Accuracy(**kw), m.MeanSquaredError(**kw)])
        raise ValueError(name)

    def policy(self, kind, **kw):
        return getattr(self.e.WindowPolicy, kind)(**kw)

    def backend(self, mega):
        if not mega:
            return None
        return "megastep_interpret" if self.jax else "megastep"

    def injector(self, canonical):
        if self.jax:
            return canonical
        return pe.FaultInjector(canonical.seed, {s: pe.FaultSpec(**dataclasses.asdict(sp))
                                                 for s, sp in canonical.plan.items()})

    def recorder(self):
        return je.TraceRecorder(capacity=1 << 14) if self.jax else pe.TraceRecorder(device="cpu", capacity=1 << 14)


JAX, PORT = _Side(True), _Side(False)
SIDES = (JAX, PORT)


def _dyadic(rng, n):
    return (rng.randint(0, 65, size=n) / 64.0).astype(np.float32)


def _batches(name, n, seed):
    """``n`` seeded batches of 2-8 rows for metric ``name`` (dyadic floats)."""
    rng = np.random.RandomState(seed)
    out = []
    for k in rng.randint(2, 9, size=n):
        if name == "flagship":
            p = rng.randint(1, 17, size=(k, C)).astype(np.float32)
            out.append(((p / p.sum(1, keepdims=True)).astype(np.float32), rng.randint(0, C, k)))
        elif name in ("minmax", "mean"):
            out.append(((rng.randint(-64, 65, size=k) / 16.0).astype(np.float32),))
        else:  # scan, acc_mse: binary scores and labels
            out.append((_dyadic(rng, k), (rng.rand(k) > 0.5).astype(np.int32)))
    return out


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
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


# ------------------------------------------------------------------------ policy


POLICIES = [
    ("cumulative", {}), ("tumbling", dict(pane_batches=3)), ("tumbling", dict(pane_batches=2, n_panes=4)),
    ("tumbling", dict(pane_seconds=0.25)), ("tumbling", dict(pane_seconds=1e-3, n_panes=2)),
    ("sliding", dict(n_panes=3, pane_batches=2)), ("sliding", dict(n_panes=2, pane_seconds=60.0)),
    ("sliding", dict(n_panes=12, pane_seconds=3600.0)), ("ewma", dict(alpha=0.5, pane_batches=1)),
    ("ewma", dict(alpha=0.1, pane_seconds=2.5)), ("ewma", dict(alpha=1 / 3, pane_batches=7)),
]


@pytest.mark.parametrize("kind,kw", POLICIES, ids=[f"{k}-{i}" for i, (k, _) in enumerate(POLICIES)])
def test_policy_fingerprint_and_queries_are_the_jax_ones(kind, kw):
    jp, pp = JAX.policy(kind, **kw), PORT.policy(kind, **kw)
    assert pp.fingerprint() == jp.fingerprint()
    assert (pp.stacked, pp.panes, pp.decay) == (jp.stacked, jp.panes, jp.decay)
    for args in [(0, 0, 0.0, 0.0), (5, 0, 0.0, 0.0), (7, 3, 0.0, 0.0), (12, 9, 3.0, 0.5), (3, 3, 7300.0, 10.0)]:
        assert pp.rotations_due(*args) == jp.rotations_due(*args), args
    # the clock is an injection seam, not semantics
    if kind != "cumulative":
        assert PORT.policy(kind, clock=lambda: 0.0, **kw).fingerprint() == jp.fingerprint()
    assert tuple(pe.WINDOW_KINDS) == tuple(je.windows.WINDOW_KINDS)


BAD_POLICIES = [
    dict(kind="hopping"), dict(kind="cumulative", pane_batches=2), dict(kind="cumulative", n_panes=3),
    dict(kind="tumbling"), dict(kind="tumbling", pane_batches=2, pane_seconds=1.0),
    dict(kind="ewma", alpha=0.0, pane_batches=1), dict(kind="ewma", alpha=1.0, pane_batches=1),
    dict(kind="ewma", alpha=0.5, pane_batches=1, n_panes=2), dict(kind="sliding", n_panes=1, pane_batches=1),
    dict(kind="tumbling", n_panes=0, pane_batches=1), dict(kind="sliding", n_panes=3, pane_batches=1, alpha=0.5),
]


@pytest.mark.parametrize("kw", BAD_POLICIES, ids=[str(i) for i in range(len(BAD_POLICIES))])
def test_policy_validation_gives_the_jax_messages(kw):
    msgs = []
    for side in SIDES:
        with pytest.raises(ValueError) as ei:
            side.e.WindowPolicy(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


ELIGIBILITY = [
    ("acc_mse", "ewma", dict(alpha=0.5, pane_batches=1)), ("minmax", "ewma", dict(alpha=0.5, pane_batches=1)),
    ("mean", "ewma", dict(alpha=0.5, pane_batches=1)), ("scan", "sliding", dict(n_panes=2, pane_batches=1)),
    ("flagship", "sliding", dict(n_panes=2, pane_batches=1)), ("scan", "ewma", dict(alpha=0.5, pane_batches=1)),
    ("flagship", "tumbling", dict(pane_seconds=1.0)), ("scan", "tumbling", dict(pane_batches=2)),
]


@pytest.mark.parametrize("name,kind,kw", ELIGIBILITY, ids=[f"{n}-{k}" for n, k, _ in ELIGIBILITY])
def test_eligibility_reasons_are_the_jax_ones(name, kind, kw):
    jp, pp = JAX.policy(kind, **kw), PORT.policy(kind, **kw)
    jm, pm = JAX.metric(name), PORT.metric(name)
    assert pp.unsupported_reason(pm) == jp.unsupported_reason(jm)
    assert pp.fleet_unsupported_reason(pm) == jp.fleet_unsupported_reason(jm)


def _refusal(side, case):
    e = side.e
    win = side.policy("tumbling", pane_batches=2)
    if case == "drift_without_window":
        return lambda: e.StreamingEngine(side.metric("acc_mse"), e.EngineConfig(drift=e.DriftDetector(threshold=0.1)))
    if case == "raise_on_alarm":
        return lambda: e.StreamingEngine(side.metric("acc_mse"), e.EngineConfig(
            window=win, drift=e.DriftDetector(threshold=0.1, raise_on_alarm=True)))
    if case == "ewma_on_int_states":
        return lambda: e.StreamingEngine(side.metric("acc_mse"), e.EngineConfig(
            window=side.policy("ewma", alpha=0.5, pane_batches=1)))
    if case == "window_type":
        return lambda: e.StreamingEngine(side.metric("acc_mse"), e.EngineConfig(window="tumbling"))
    if case == "drift_type":
        return lambda: e.StreamingEngine(side.metric("acc_mse"), e.EngineConfig(window=win, drift=0.1))
    if case == "rotate_pane_cumulative":
        return lambda: e.StreamingEngine(side.metric("acc_mse"), e.EngineConfig()).rotate_pane()
    raise ValueError(case)


@pytest.mark.parametrize("case", ["drift_without_window", "raise_on_alarm", "ewma_on_int_states", "window_type",
                                  "drift_type", "rotate_pane_cumulative"])
def test_engine_refusals_give_the_jax_messages(case):
    msgs = []
    for side in SIDES:
        with pytest.raises(side.m.utils.exceptions.MetricsTPUUserError if side.jax else MetricsTPUUserError) as ei:
            _refusal(side, case)()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------- engine parity


ENGINE_CASES = [
    ("flagship", "tumbling", dict(pane_batches=3), True), ("flagship", "sliding", dict(n_panes=3, pane_batches=2), True),
    ("flagship", "tumbling", dict(pane_batches=4, n_panes=2), False),
    ("minmax", "tumbling", dict(pane_batches=2), False), ("minmax", "sliding", dict(n_panes=3, pane_batches=1), False),
    ("scan", "tumbling", dict(pane_batches=3), False), ("scan", "sliding", dict(n_panes=2, pane_batches=2), False),
    ("mean", "ewma", dict(alpha=0.5, pane_batches=1), False), ("mean", "ewma", dict(alpha=0.3, pane_batches=2), False),
    ("mean", "ewma", dict(alpha=0.25, pane_batches=3), True),
]


def _run_windowed(side, name, kind, kw, mega, batches, coalesce=1):
    eng = side.e.StreamingEngine(side.metric(name), side.e.EngineConfig(
        buckets=(8, 32), coalesce=coalesce, kernel_backend=side.backend(mega), window=side.policy(kind, **kw)))
    reads = []
    pane = kw.get("pane_batches", 1)
    with eng:
        for i, b in enumerate(batches):
            eng.submit(*b)
            if i % pane == pane // 2:  # mid-pane (the first batch of a 1-batch pane)
                reads.append(eng.result())
        reads.append(eng.result())
    return eng, reads


@pytest.mark.parametrize("name,kind,kw,mega", ENGINE_CASES,
                         ids=[f"{n}-{k}-{i}" for i, (n, k, _, _) in enumerate(ENGINE_CASES)])
def test_streaming_windows_match_jax(name, kind, kw, mega):
    batches = _batches(name, 13, seed=len(name) + 3 * len(kind))
    (jeng, jreads), (peng, preads) = (_run_windowed(side, name, kind, kw, mega, batches) for side in SIDES)
    assert len(preads) == len(jreads) >= 4
    for i, (g, w) in enumerate(zip(preads, jreads)):
        _assert_close(g, w, f"read {i}")
    _assert_close(peng.state(), jeng.state(), "state")
    assert (peng.rotations, peng.pane_cursor) == (jeng.rotations, jeng.pane_cursor)
    assert peng.telemetry()["windows"] == jeng.telemetry()["windows"]
    if kind == "ewma":
        assert peng.stats.ewma_decays == peng.rotations == jeng.stats.ewma_decays
    else:
        assert all(v.shape[0] == kw.get("n_panes", 1) for v in _flat(peng.state()).values())


def test_tumbling_equals_a_fresh_engine_per_pane():
    batches = _batches("flagship", 12, seed=0)
    eng = pe.StreamingEngine(PORT.metric("flagship"), pe.EngineConfig(
        buckets=(8,), coalesce=1, kernel_backend="megastep", window=pe.WindowPolicy.tumbling(pane_batches=3)))

    def fresh(bs):
        e = pe.StreamingEngine(PORT.metric("flagship"), pe.EngineConfig(buckets=(8,)))
        with e:
            for b in bs:
                e.submit(*b)
            return e.result()

    with eng:
        for i, b in enumerate(batches):
            eng.submit(*b)
            start = ((i + 1) // 3) * 3  # a boundary batch closes its pane: the open pane is then empty
            if start == i + 1:
                assert not _flat(eng.result())["cm."].any()
            else:
                _assert_close(eng.result(), fresh(batches[start:i + 1]), f"batch {i}")
    assert eng.rotations == 4


def test_coalesced_groups_never_cross_a_pane_boundary():
    """The dispatcher may coalesce up to 8 queued batches, held on its state
    lock while every batch queues; no group crosses a pane boundary, so the
    result equals the one-batch-a-step run's (and JAX's)."""
    batches = _batches("flagship", 17, seed=4)
    policy = dict(n_panes=2, pane_batches=3)
    eng = pe.StreamingEngine(PORT.metric("flagship"), pe.EngineConfig(
        buckets=(8, 32), coalesce=8, max_queue=64, window=pe.WindowPolicy.sliding(**policy)))
    eng.start()
    with eng._state_lock:
        for b in batches:
            eng.submit(*b)
    eng.flush()
    got = eng.result()
    eng.stop()
    assert eng.stats.batches_coalesced > 0 and eng.rotations == 5
    _, jreads = _run_windowed(JAX, "flagship", "sliding", policy, False, batches)
    _assert_close(got, jreads[-1])


def test_rotation_captures_nothing_and_keeps_the_step_keys():
    """A rotation changes which pane row a step is handed, never its key: the
    cache's misses and the engine's step memo stay as they were across >= 3
    rotations (on the card the same holds for the captured graphs)."""
    batches = _batches("flagship", 16, seed=1)
    eng = pe.StreamingEngine(PORT.metric("flagship"), pe.EngineConfig(
        buckets=(8,), coalesce=1, kernel_backend="megastep", window=pe.WindowPolicy.sliding(n_panes=3, pane_batches=2)))
    with eng:
        for b in batches[:3]:
            eng.submit(*b)
        eng.result()
        misses, keys, rot = eng.aot_cache.misses, set(eng._program_memo), eng.rotations
        for b in batches[3:]:
            eng.submit(*b)
        eng.result()
    assert eng.rotations - rot >= 3
    assert eng.aot_cache.misses == misses and set(eng._program_memo) == keys


def test_each_pane_row_holds_exactly_its_own_batches():
    """The ring's rows against per-pane fresh states: the step writes the
    current pane's row and leaves the others as they were."""
    batches = _batches("flagship", 10, seed=6)
    eng = pe.StreamingEngine(PORT.metric("flagship"), pe.EngineConfig(
        buckets=(8,), coalesce=1, kernel_backend="megastep", window=pe.WindowPolicy.tumbling(pane_batches=2, n_panes=4)))
    with eng:
        for b in batches:
            eng.submit(*b)
        ring = eng.state()
    # rotations at 2, 4, 6, 8, 10: pane p holds batches [2p+8, 2p+10) if p == 0 (the ring wrapped) ...
    owners = {0: batches[8:10], 1: [], 2: batches[4:6], 3: batches[6:8]}
    for pane, bs in owners.items():
        fresh = pe.StreamingEngine(PORT.metric("flagship"), pe.EngineConfig(buckets=(8,)))
        with fresh:
            for b in bs:
                fresh.submit(*b)
            want = fresh.state()
        _assert_close({k: {s: v[pane] for s, v in m.items()} for k, m in ring.items()}, want, f"pane {pane}")
    assert eng.pane_cursor == 1  # the open pane, freshly cleared at the last boundary


def test_rotate_pane_matches_jax():
    batches = _batches("mean", 7, seed=8)
    out = []
    for side in SIDES:
        res = []
        for kind, kw in (("sliding", dict(n_panes=2, pane_batches=100)), ("ewma", dict(alpha=0.5, pane_batches=100))):
            eng = side.e.StreamingEngine(side.metric("mean"), side.e.EngineConfig(
                buckets=(8,), coalesce=1, window=side.policy(kind, **kw)))
            with eng:
                for i, b in enumerate(batches):
                    eng.submit(*b)
                    if i % 3 == 2:
                        eng.rotate_pane()
                res.append((eng.result(), eng.rotations, eng.pane_cursor))
        out.append(res)
    for (gv, gr, gc), (wv, wr, wc) in zip(out[1], out[0]):
        _assert_close(gv, wv)
        assert (gr, gc) == (wr, wc)


# --------------------------------------------------------------- time cadence


def _clocked(side, drift=None):
    clock = {"t": 0.0}
    eng = side.e.StreamingEngine(side.metric("acc_mse"), side.e.EngineConfig(
        buckets=(8,), coalesce=1, window=side.policy("tumbling", pane_seconds=10.0, clock=lambda: clock["t"]),
        drift=drift))
    return eng, clock


def test_pane_seconds_rotate_on_the_injectable_clock_as_jax():
    p, t = np.asarray([0.75, 0.25], np.float32), np.asarray([1, 0], np.int32)
    out = []
    for side in SIDES:
        eng, clock = _clocked(side)
        with eng:
            eng.submit(p, t)
            eng.flush()
            r0 = eng.rotations
            clock["t"] = 25.0  # two panes elapsed: both rotate at the next batch, pane by pane
            eng.submit(p, t)
            eng.flush()
            out.append((r0, eng.rotations, _flat(eng.result())))
    assert out[0][:2] == out[1][:2] == (0, 2)
    _assert_close(out[1][2], out[0][2])


def test_empty_catch_up_panes_are_not_drift_observations():
    p, t = np.asarray([0.9, 0.2], np.float32), np.asarray([1, 0], np.int32)
    dets = []
    for side in SIDES:
        det = side.e.DriftDetector(threshold=0.1, up_after=1, baseline="first")
        eng, clock = _clocked(side, drift=det)
        with eng:
            for now in (0.0, 35.0, 45.0):  # three empty panes elapse before the second batch
                clock["t"] = now
                eng.submit(p, t)
                eng.flush()
        assert eng.rotations >= 4
        dets.append(det)
    assert dets[1].history(name="Accuracy") == dets[0].history(name="Accuracy") == [1.0, 1.0]
    assert dets[1].alarms() == [] and dets[1].summary() == dets[0].summary()


# ------------------------------------------------------------------------ drift


def _drift_run(side, traffic):
    det = side.e.DriftDetector(threshold=0.2, up_after=2, down_after=2, baseline="first")
    rec = side.recorder()
    eng = side.e.StreamingEngine(side.metric("acc_mse").__class__([side.m.Accuracy(**side.kw)]), side.e.EngineConfig(
        buckets=(32,), coalesce=1, window=side.policy("tumbling", pane_batches=6), drift=det, trace=rec))
    with eng:
        for _sid, p, t in traffic:
            eng.submit(p, t)
        eng.flush()
    return det, eng, rec


def test_seeded_label_drift_raises_the_same_alarms_in_both_packages():
    kw = dict(num_streams=4, n_batches=72, seed=7, max_rows=8, label_acc=0.92, drift_at=36, drift_ramp=6,
              drift_flip=0.8)
    jt, pt = jax_zipf_traffic(**kw), zipf_traffic(**kw)
    assert all(np.array_equal(a, b) for x, y in zip(jt, pt) for a, b in zip(x[1:], y[1:]))
    (jdet, jeng, jrec), (pdet, peng, prec) = _drift_run(JAX, jt), _drift_run(PORT, pt)
    assert len(pdet.alarms("raise")) >= 1
    assert [dataclasses.astuple(a) for a in pdet.alarms()] == [dataclasses.astuple(a) for a in jdet.alarms()]
    assert pdet.history(name="Accuracy") == jdet.history(name="Accuracy")
    assert peng.stats.drift_evals == peng.rotations == jeng.stats.drift_evals == 12
    assert peng.stats.drift_alarms == jeng.stats.drift_alarms >= 1
    assert peng.telemetry()["windows"] == jeng.telemetry()["windows"]
    assert prec.events("drift_alarm") and [e["args"] for e in prec.events("drift_alarm")] == \
        [e["args"] for e in jrec.events("drift_alarm")]
    assert [e["args"] for e in prec.events("pane_rotate")] == [e["args"] for e in jrec.events("pane_rotate")]
    # the same seed twice: the same alarm list
    again, _, _ = _drift_run(PORT, zipf_traffic(**kw))
    assert [a.describe() for a in again.alarms()] == [a.describe() for a in pdet.alarms()]


# ------------------------------------------------------------------------ chaos


def _chaos_plan(side, plan):
    """JAX's windowed chaos probe (``chaos_smoke.windowed_engine_config`` /
    ``ewma_engine_config``) with the plan's injector, and its fault-free twin,
    each flushed after every batch (occurrences stay timing-free)."""
    _, clean = chaos_traffic()
    injs = chaos_injectors()
    out = {}
    for name, inj in (("chaos", side.injector(injs[plan])), ("twin", None)):
        rec = side.recorder()
        det = side.e.DriftDetector(threshold=0.05, up_after=1, down_after=1)
        if plan == "windows":
            metric = side.metric("acc_mse")
            cfg = side.e.EngineConfig(buckets=(8, 32), coalesce=1, window=side.policy("sliding", n_panes=2,
                                                                                      pane_batches=3),
                                      drift=det, fault_injector=inj, trace=rec)
        else:
            metric = side.m.MeanMetric(**side.kw)
            cfg = side.e.EngineConfig(buckets=(8, 32), coalesce=1, window=side.policy("ewma", alpha=0.5, pane_batches=3),
                                      fault_injector=inj, trace=rec)
        eng = side.e.StreamingEngine(metric, cfg)
        with eng:
            for b in clean:
                eng.submit(*(b if plan == "windows" else b[:1]))
                eng.flush()
            value = eng.result()
        out[name] = dict(eng=eng, inj=inj, rec=rec, det=det, value=value)
    return out


@pytest.mark.parametrize("plan", ["windows", "ewma"])
def test_window_chaos_plans_match_jax(plan):
    j, p = _chaos_plan(JAX, plan), _chaos_plan(PORT, plan)
    pinj, jinj = p["chaos"]["inj"], j["chaos"]["inj"]
    assert pinj.summary() == jinj.summary()
    assert pinj.fired.get("pane_rotate", 0) == 1
    assert p["chaos"]["rec"].canonical_sequence() == j["chaos"]["rec"].canonical_sequence()
    assert p["chaos"]["rec"].fault_sites() == j["chaos"]["rec"].fault_sites()
    for side in (j, p):
        # the retried rotation cleared or decayed once: bit-equal to the twin
        g, w = _flat(side["chaos"]["value"]), _flat(side["twin"]["value"])
        assert all(np.array_equal(g[k], w[k]) for k in w)
        e, t = side["chaos"]["eng"], side["twin"]["eng"]
        assert e.rotations == t.rotations > 0 and e.stats.retries >= 1
    _assert_close(p["chaos"]["value"], j["chaos"]["value"])
    pe_, je_ = p["chaos"]["eng"], j["chaos"]["eng"]
    if plan == "ewma":
        assert pe_.stats.ewma_decays == pe_.rotations == je_.stats.ewma_decays
    else:
        assert pinj.fired.get("drift_eval", 0) == 1
        for name in ("Accuracy", "MeanSquaredError"):  # a pane of only NaN-free... NaN compares equal here
            got = p["chaos"]["det"].history(name=name)
            np.testing.assert_array_equal(got, p["twin"]["det"].history(name=name))
            np.testing.assert_allclose(got, j["chaos"]["det"].history(name=name), rtol=RTOL)
        assert p["chaos"]["det"].evals == p["twin"]["det"].evals == pe_.rotations


def test_a_windowed_step_rolls_back_its_pane_row_only():
    """A transient ``step`` fault after the step wrote the pane row: the
    rollback puts that row back, the retry folds it once, the other panes
    are untouched; the result equals the fault-free run's and JAX's."""
    batches = _batches("flagship", 9, seed=11)
    vals = []
    for side in SIDES:
        inj = side.e.FaultInjector(5, {"step": side.e.FaultSpec(schedule=(1, 4, 7))})
        eng = side.e.StreamingEngine(side.metric("flagship"), side.e.EngineConfig(
            buckets=(8,), coalesce=1, kernel_backend=side.backend(True), fault_injector=inj,
            window=side.policy("sliding", n_panes=2, pane_batches=2)))
        with eng:
            for b in batches:
                eng.submit(*b)
                eng.flush()
            vals.append((eng.result(), eng.state(), eng.stats.rollbacks))
    _assert_close(vals[1][0], vals[0][0])
    _assert_close(vals[1][1], vals[0][1])
    assert vals[1][2] == vals[0][2] == 3


def test_a_demoted_windowed_engine_keeps_its_pane_rows():
    """An injected ``kernel`` fault demotes ``megastep -> auto`` mid-ring; the
    per-leaf step writes the same pane rows: every read equals the undemoted
    twin's, and JAX's (demoted ``-> xla``)."""
    batches = _batches("flagship", 11, seed=12)
    policy = dict(n_panes=3, pane_batches=2)
    out = []
    for side in SIDES + (PORT,):
        inj = side.e.FaultInjector(0, {"kernel": side.e.FaultSpec(schedule=(4,))}) if len(out) < 2 else None
        eng = side.e.StreamingEngine(side.metric("flagship"), side.e.EngineConfig(
            buckets=(8,), coalesce=1, kernel_backend=side.backend(True), fault_injector=inj,
            window=side.policy("sliding", **policy)))
        reads = []
        with eng:
            for b in batches:
                eng.submit(*b)
                reads.append(eng.result())
        out.append((reads, eng.state(), eng.stats.kernel_demotions))
    (jreads, jstate, jdem), (preads, pstate, pdem), (treads, tstate, tdem) = out
    assert jdem == pdem == 1 and tdem == 0
    for g, w, t in zip(preads, jreads, treads):
        _assert_close(g, w)
        _assert_close(g, t)
    _assert_close(pstate, tstate)
    _assert_close(pstate, jstate)


# ------------------------------------------------------------- observability


def test_windows_block_and_openmetrics_match_jax(tmp_path):
    import json

    import engine_report

    docs, fams = [], []
    for side in SIDES:
        eng = side.e.StreamingEngine(side.metric("mean"), side.e.EngineConfig(
            buckets=(4,), coalesce=1, window=side.policy("ewma", alpha=0.5, pane_batches=1)))
        with eng:
            for v in ([1.0, 2.0], [3.0], [4.0, 0.5]):
                eng.submit(np.asarray(v, np.float32))
            eng.result()
        families = trace_export.parse_openmetrics(eng.metrics_text())
        fams.append({k: v for k, v in families.items() if any(w in k for w in ("pane", "ewma", "drift"))})
        path = tmp_path / f"{'jax' if side.jax else 'port'}.json"
        eng.export_telemetry(str(path))
        docs.append(json.loads(path.read_text()))
    assert fams[1] == fams[0] and "metrics_tpu_engine_pane_rotations" in fams[1]
    assert docs[1]["summary"]["windows"] == docs[0]["summary"]["windows"]
    assert docs[1]["summary"]["windows"]["policy"] == "ewma:a0.5:b1"
    assert docs[1]["summary"]["windows"]["ewma_decays"] == 3
    rendered = engine_report.render(docs[1])
    assert "windows" in rendered and "ewma decays" in rendered


def test_cumulative_engines_carry_no_window_families():
    batches = _batches("flagship", 6, seed=2)
    engines = []
    for window in (None, pe.WindowPolicy.cumulative()):
        eng = pe.StreamingEngine(PORT.metric("flagship"), pe.EngineConfig(buckets=(8,), coalesce=1, window=window))
        with eng:
            for b in batches:
                eng.submit(*b)
            eng.result()
        assert "pane" not in eng.metrics_text() and "drift" not in eng.metrics_text()
        assert "windows" not in eng.telemetry()
        assert eng.window is None and eng.rotations == 0
        engines.append(eng)
    _assert_close(engines[1].state(), engines[0].state())
    assert set(engines[1]._program_memo) == set(engines[0]._program_memo)
    strip = [l for l in engines[0].metrics_text().splitlines() if "compile_cache" not in l]
    assert [l for l in engines[1].metrics_text().splitlines() if "compile_cache" not in l] == strip
