"""The port's telemetry ring (``metrics_tpu_torch/engine/stats.py``) against
the JAX package's ``EngineStats``, on the CPU.

The ring is bounded at ``telemetry_capacity``. For one deterministic run per
package (the chaos sweep with its restore, the paging plan, a plain
coalesce-1 run; every group a singleton) the COUNT fields of ``summary()``,
``fault_summary()`` and ``paging_summary()`` agree; the timing fields
(``ingest_us``, ``blocked_sync_us`` percentiles, ``host_time_shares``, the
mesh block's microseconds, ``queue_depth_max``) and the capture cache's
block (``compile_cache``: JAX's also holds its compiled compute programs)
are left out. The port's own counters (``warmup_steps``,
``result_device_calls`` and the paging block's ``q8_staged_rows``) are
extra keys. JAX's snapshots go through its pickle codec (orbax off).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
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

BUCKETS = (8, 32)
#: summary fields that are times, or that depend on the producer's timing
TIMING = ("ingest_us", "host_time_shares", "compile_cache", "queue_depth_max")
#: the port's own counters, which the JAX package's summary does not carry
PORT_ONLY = ("warmup_steps", "result_device_calls", "q8_staged_rows")


@pytest.fixture(autouse=True, scope="module")
def _jax_pickle_snapshots():
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jsnap, "_use_orbax", lambda: False)
    yield
    mp_.undo()


def _coll(jx):
    if jx:
        return mt.MetricCollection([mt.Accuracy(), mt.MeanSquaredError()])
    return mp.MetricCollection([mp.Accuracy(device="cpu"), mp.MeanSquaredError(device="cpu")])


def _injector(jx, canonical):
    if jx:
        return canonical
    return pe.FaultInjector(canonical.seed, {s: pe.FaultSpec(**dataclasses.asdict(sp))
                                             for s, sp in canonical.plan.items()})


def _sweep(jx, d):
    e = je if jx else pe
    _, traffic = chaos_traffic()
    injs = chaos_injectors()
    eng = e.StreamingEngine(_coll(jx), e.EngineConfig(
        buckets=BUCKETS, coalesce=8, kernel_backend="megastep_interpret" if jx else "megastep",
        screen=e.ScreenPolicy(non_finite="quarantine"), snapshot_every=2, snapshot_dir=d, snapshot_keep=4,
        fault_injector=_injector(jx, injs["chaos"])))
    with eng:
        for b in traffic:
            eng.submit(*b)
        eng.flush()
    res = e.StreamingEngine(_coll(jx), e.EngineConfig(
        buckets=BUCKETS, coalesce=1, screen=e.ScreenPolicy(non_finite="quarantine"), snapshot_dir=d,
        fault_injector=_injector(jx, injs["snapshot_read"])))
    cursor = int(res.restore()["batches_done"])
    with res:
        for b in traffic[cursor:]:
            res.submit(*b)
        res.flush()
    return [eng, res]


def _paging(jx, d):
    e = je if jx else pe
    kw = dict(buckets=BUCKETS, coalesce=1, kernel_backend="xla" if jx else None, snapshot_dir=d,
              fault_injector=_injector(jx, chaos_injectors()["paging"]))
    if jx:
        kw.update(mesh=Mesh(np.asarray(jax.devices()[:1]), ("dp",)), axis="dp", mesh_sync="deferred")
    eng = e.MultiStreamEngine(_coll(jx), SSHARD_STREAMS, e.EngineConfig(**kw), stream_shard=True,
                              resident_streams=SSHARD_RESIDENT)
    traffic = stream_shard_traffic()
    with eng:
        for sid, p, t in traffic[:12]:
            eng.submit(sid, p, t)
        eng.snapshot()
        for sid, p, t in traffic[12:]:
            eng.submit(sid, p, t)
        eng.flush()
    return [eng]


def _plain(jx, d):
    e = je if jx else pe
    _, traffic = chaos_traffic()
    clean = [b for b in traffic if np.all(np.isfinite(b[0]))]
    eng = e.StreamingEngine(_coll(jx), e.EngineConfig(buckets=BUCKETS, coalesce=1, telemetry_capacity=4))
    with eng:
        for b in clean:
            eng.submit(*b)
        eng.flush()
    return [eng]


RUNS = {"sweep": _sweep, "paging": _paging, "plain": _plain}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {name: {side: fn(side == "jax", str(tmp_path_factory.mktemp(f"{name}_{side}")))
                   for side in ("jax", "port")}
            for name, fn in RUNS.items()}


def _counts(summary):
    out = {k: v for k, v in summary.items() if k not in TIMING + PORT_ONLY}
    out["blocked_sync_us"] = {"count": summary["blocked_sync_us"]["count"]}
    if "paging" in out:
        out["paging"] = {k: v for k, v in out["paging"].items() if k not in PORT_ONLY}
    if "mesh_sync" in out:
        out["mesh_sync"] = {"mode": out["mesh_sync"]["mode"], "merges": out["mesh_sync"]["merges"]}
    return out


@pytest.mark.parametrize("run", sorted(RUNS))
def test_summary_count_fields_equal_jax(runs, run):
    for j, p in zip(runs[run]["jax"], runs[run]["port"]):
        js, ps = j.stats.summary(), p.stats.summary()
        assert _counts(ps) == _counts(js)
        assert set(js) - set(TIMING) <= set(ps)  # every JAX block is there


@pytest.mark.parametrize("run", sorted(RUNS))
def test_fault_and_paging_blocks_equal_jax(runs, run):
    for j, p in zip(runs[run]["jax"], runs[run]["port"]):
        assert p.stats.fault_summary() == j.stats.fault_summary()
        jp, pp = j.stats.paging_summary(), p.stats.paging_summary()
        assert (pp is None) == (jp is None)
        if pp is not None:
            assert {k: v for k, v in pp.items() if k not in PORT_ONLY} == jp


def test_the_blocks_of_layers_not_ported_are_none(runs):
    for eng in runs["sweep"]["port"] + runs["paging"]["port"]:
        s = eng.stats
        assert s.windows_summary() is s.ragged_summary() is s.fleet_summary() is s.reshard_summary() is None
        assert s.admission_summary() is None


def test_the_ring_is_bounded_at_telemetry_capacity(runs):
    (j,), (p,) = runs["plain"]["jax"], runs["plain"]["port"]
    assert p.stats.capacity == 4 and p.stats.steps > 4
    recent = p.stats.recent()
    assert [r["step"] for r in recent] == list(range(p.stats.steps - 4, p.stats.steps))
    assert [(r["step"], r["bucket"], r["valid"], r["coalesced"]) for r in recent] == \
        [(r["step"], r["bucket"], r["valid"], r["coalesced"]) for r in j.stats.recent()]
    for r in recent:
        assert {"ingest_us", "pad_us", "queue_wait_us", "wall_us", "queue_depth"} <= set(r)


def test_the_ports_counters_appear_in_the_summary(runs):
    (p,) = runs["paging"]["port"]
    s = p.stats.summary()
    assert s["warmup_steps"] == p.stats.warmup_steps == 0  # nothing is captured on the CPU
    assert s["result_device_calls"] == p.stats.result_device_calls
    assert s["paging"]["q8_staged_rows"] == p.stats.q8_staged_rows
    assert s["mesh_sync"]["mode"] == "stream_shard"


def test_to_json_and_export_round_trip(runs, tmp_path):
    (p,) = runs["plain"]["port"]
    doc = json.loads(p.stats.to_json({"hits": 1}, extra={"trace": {"spans": 0}}))
    assert doc["summary"]["compile_cache"] == {"hits": 1} and doc["trace"] == {"spans": 0}
    assert len(doc["recent_steps"]) == 4
    path = tmp_path / "nested" / "tele.json"
    p.stats.export(str(path))
    assert json.loads(path.read_text())["summary"]["steps"] == p.stats.steps


def test_capacity_must_be_positive():
    with pytest.raises(ValueError, match="positive"):
        pe.EngineStats(0)
