"""The port's fault layer against the JAX package's, and the engine paths it
drives, on the CPU.

* ``FaultInjector``: for the same seed and plan, the Nth ``fire(site)`` and
  ``check(site)`` agree with JAX's at every site, and so does ``summary()``;
* ``corrupt_snapshot`` flips the same bytes for the same ``RandomState``;
* ``is_transient`` and ``ScreenPolicy.screen`` give JAX's verdicts;
* the engine's snapshot sites: a periodic write fault is contained and
  counted, an explicit ``snapshot()`` raises, a transient read is retried
  inside ``restore()`` (counted), an injected corruption falls back one
  generation with exact replay, and a plan naming a site of a layer the
  port does not have yet raises ``NotPortedError`` (the other sites are
  ``tests/test_torch_chaos.py``'s);
* ``utils/checkpoint.py`` crosses both ways with JAX's pickle checkpoint.

The JAX package writes orbax checkpoints when orbax is installed, which the
port cannot read (orbax imports JAX); the checkpoint tests monkeypatch
``metrics_tpu.utils.checkpoint._ORBAX_AVAILABLE`` to False so it writes its
pickle codec. No JAX file changes.
"""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.engine.faults as jf
import metrics_tpu.utils.checkpoint as jckpt
import metrics_tpu_torch as mp
import metrics_tpu_torch.engine.faults as pf
from metrics_tpu_torch.engine import EngineConfig, FaultInjector, FaultSpec, SnapshotCorruptError, StreamingEngine
from metrics_tpu_torch.engine.snapshot import latest_snapshot, load_snapshot, save_snapshot
from metrics_tpu_torch.utils.checkpoint import load_metric_state, save_metric_state
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError, NotPortedError

PORTED_SITES = ("ingest", "coalesce", "compile", "step", "kernel", "watchdog", "page_out", "page_in", "quant_encode",
                "quant_decode", "snapshot_write", "snapshot_corrupt", "snapshot_read", "dispatcher_kill")


def _plan(mod, site):
    """A plan mixing a schedule, a rate and a fire cap, as either package spells it."""
    return {site: mod.FaultSpec(schedule=(1, 4, 9), rate=0.3, max_fires=12, transient=site != "dispatcher_kill",
                                fatal=site == "dispatcher_kill")}


@pytest.mark.parametrize("site", jf.FAULT_SITES)
def test_injector_fires_as_jax_at_every_site(site):
    assert pf.FAULT_SITES == jf.FAULT_SITES
    seed = 1000 + jf.FAULT_SITES.index(site)
    j, p = jf.FaultInjector(seed, _plan(jf, site)), pf.FaultInjector(seed, _plan(pf, site))
    assert [p.fire(site) for _ in range(60)] == [j.fire(site) for _ in range(60)]
    # check() raises the same typed fault at the same occurrences
    for _ in range(40):
        outcome = []
        for inj, mod in ((j, jf), (p, pf)):
            try:
                inj.check(site)
                outcome.append(None)
            except mod.InjectedFault as e:
                outcome.append(("fault", e.occurrence, e.transient, e.fatal))
            except mod.StepTimeoutError as e:
                outcome.append(("timeout", str(e)))
        assert outcome[0] == outcome[1]
    assert p.summary() == j.summary()
    assert p.has_site(site) and not p.has_site("ingest" if site != "ingest" else "step")
    assert np.array_equal(p.snapshot_rng().rand(4), j.snapshot_rng().rand(4))


def test_injector_sites_are_independent_and_unknown_sites_refused():
    plan = {s: pf.FaultSpec(rate=0.5) for s in ("step", "snapshot_read")}
    a, b = pf.FaultInjector(7, plan), pf.FaultInjector(7, plan)
    seq = [a.fire("snapshot_read") for _ in range(20)]
    for _ in range(13):  # calls at another site never shift this site's stream
        b.fire("step")
    assert [b.fire("snapshot_read") for _ in range(20)] == seq
    with pytest.raises(ValueError, match="unknown fault site"):
        pf.FaultInjector(0, {"nope": pf.FaultSpec()})


def _payload_file(path, seed):
    rng = np.random.RandomState(seed)
    with open(path, "wb") as f:
        f.write(rng.bytes(4096))


@pytest.mark.parametrize("seed", range(4))
def test_corrupt_snapshot_flips_the_bytes_jax_flips(tmp_path, seed):
    for layout in ("file", "dir"):
        paths = []
        for pkg in ("jax", "port"):
            root = tmp_path / f"{layout}_{pkg}"
            if layout == "dir":
                root.mkdir()
                _payload_file(str(root / "small"), seed + 50)
                (root / "sub").mkdir()
                _payload_file(str(root / "sub" / "big"), seed)
                with open(root / "sub" / "big", "ab") as f:
                    f.write(b"x" * 512)
            else:
                _payload_file(str(root), seed)
            paths.append(str(root))
        nj = jf.corrupt_snapshot(paths[0], np.random.RandomState(seed), flips=6)
        np_ = pf.corrupt_snapshot(paths[1], np.random.RandomState(seed), flips=6)
        assert nj == np_ == 6
        for rel in ([""] if layout == "file" else ["small", os.path.join("sub", "big")]):
            with open(os.path.join(paths[0], rel) if rel else paths[0], "rb") as fj, \
                    open(os.path.join(paths[1], rel) if rel else paths[1], "rb") as fp:
                assert fj.read() == fp.read()


def test_is_transient_verdicts_match_jax():
    cases = [
        lambda m: m.InjectedFault("step", 0, transient=True),
        lambda m: m.InjectedFault("step", 3, transient=False),
        lambda m: m.StepTimeoutError("stuck"),
        lambda m: RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
        lambda m: RuntimeError("UNAVAILABLE: socket closed"),
        lambda m: RuntimeError("DEADLINE_EXCEEDED"),
        lambda m: RuntimeError("ABORTED by peer"),
        lambda m: ValueError("shape mismatch"),
        lambda m: m.SnapshotCorruptError("p", "g", "r"),
    ]
    assert [pf.is_transient(c(pf)) for c in cases] == [jf.is_transient(c(jf)) for c in cases]
    assert [pf.is_transient(c(pf)) for c in cases] == [True, False, True, True, True, True, True, False, False]


def _screen_payloads():
    rng = np.random.RandomState(3)
    x = rng.rand(6, 3).astype(np.float32)
    nan = x.copy()
    nan[2, 1] = np.nan
    ids = np.asarray([0, 1, 2, 9, 1, 0])
    return [
        ((x, ids.clip(0, 2)), {}),
        ((nan, ids.clip(0, 2)), {}),
        ((x, ids), {}),
        ((x, ids.clip(0, 2), np.zeros(4, np.float32)), {}),
        ((x,), {"target": ids.clip(0, 2), "w": np.ones(6, np.float32)}),
        ((x,), {"target": ids, "extra": None, "n": 3}),
    ]


@pytest.mark.parametrize("policy", [
    dict(),
    dict(non_finite="error", id_range=(0, 2)),
    dict(non_finite="ignore", id_range=(0, 2), id_range_action="error"),
    dict(uniform_batch=True, id_range=(0, 5)),
    dict(non_finite="warn", id_range=(0, 2), id_range_action="warn", uniform_batch=True,
         uniform_batch_action="error"),
])
def test_screen_verdicts_match_jax(policy):
    j, p = jf.ScreenPolicy(**policy), pf.ScreenPolicy(**policy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for payload in _screen_payloads():
            want = j.screen(payload, 6)
            assert p.screen(payload, 6) == want
            # tensors are screened as their host values
            tensors = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in payload[0])
            assert p.screen((tensors, payload[1]), 6) == want
    with pytest.raises(ValueError, match="ScreenPolicy.non_finite"):
        pf.ScreenPolicy(non_finite="drop")


# ------------------------------------------------------------------ the engine's snapshot sites


def _batches(seed=1, sizes=(10, 20, 9, 31, 16, 8)):
    rng = np.random.RandomState(seed)
    return [((rng.randint(0, 65, size=n) / 64.0).astype(np.float32), (rng.rand(n) > 0.5).astype(np.int32))
            for n in sizes]


def _collection():
    return mp.MetricCollection([mp.Accuracy(device="cpu"), mp.MeanSquaredError(device="cpu")])


def _values(v):
    return {k: np.asarray(x) for k, x in v.items()}


def _oracle(batches):
    eager = _collection()
    for b in batches:
        eager.update(*(torch.from_numpy(a) for a in b))
    return _values(eager.compute())


def test_periodic_snapshot_write_failure_is_contained(tmp_path):
    batches = _batches(seed=2, sizes=(8, 8, 8, 8))
    inj = FaultInjector(seed=20, plan={"snapshot_write": FaultSpec(schedule=(0,))})
    eng = StreamingEngine(_collection(), EngineConfig(buckets=(8,), coalesce=1, snapshot_every=2,
                                                      snapshot_dir=str(tmp_path), fault_injector=inj))
    with eng:
        for b in batches:
            eng.submit(*b)
        got = _values(eng.result())
    assert eng.stats.snapshot_failures == 1 and eng.stats.snapshots == 1  # the @4 save landed after the @2 failed
    assert eng.stats.faults_by_site() == {"snapshot_write": 1}
    for k, v in _oracle(batches).items():
        assert np.array_equal(got[k], v), k
    resumed = StreamingEngine(_collection(), EngineConfig(buckets=(8,), snapshot_dir=str(tmp_path)))
    assert resumed.restore()["batches_done"] == 4


def test_explicit_snapshot_call_raises_on_write_fault(tmp_path):
    inj = FaultInjector(seed=21, plan={"snapshot_write": FaultSpec(schedule=(0,))})
    eng = StreamingEngine(mp.Accuracy(device="cpu"),
                          EngineConfig(buckets=(8,), snapshot_dir=str(tmp_path), fault_injector=inj))
    with eng:
        eng.submit(np.asarray([0.9, 0.2], np.float32), np.asarray([1, 0], np.int32))
        with pytest.raises(pf.InjectedFault, match="injected fault"):
            eng.snapshot()
        assert latest_snapshot(str(tmp_path)) is None  # nothing landed
        eng.snapshot()  # the fault cleared; the explicit path works again
    assert eng.stats.snapshots == 1 and eng.stats.snapshot_failures == 0


def test_transient_snapshot_read_is_retried_inside_restore(tmp_path):
    eng = StreamingEngine(mp.MeanSquaredError(device="cpu"), EngineConfig(buckets=(8,), snapshot_dir=str(tmp_path)))
    with eng:
        eng.submit(np.asarray([1.0, 0.5], np.float32), np.asarray([0.5, 0.5], np.float32))
        eng.snapshot()
    inj = FaultInjector(seed=22, plan={"snapshot_read": FaultSpec(schedule=(0,))})
    resumed = StreamingEngine(mp.MeanSquaredError(device="cpu"),
                              EngineConfig(buckets=(8,), snapshot_dir=str(tmp_path), fault_injector=inj))
    meta = resumed.restore()
    assert meta["batches_done"] == 1 and resumed.stats.retries == 1
    assert resumed.stats.faults_by_site() == {"snapshot_read": 1}
    with resumed:
        assert float(resumed.result()) == pytest.approx(0.125)
    # a sticky read fault exhausts the budget and raises; the engine is untouched
    sticky = FaultInjector(seed=23, plan={"snapshot_read": FaultSpec(schedule=(0,), transient=False)})
    other = StreamingEngine(mp.MeanSquaredError(device="cpu"),
                            EngineConfig(buckets=(8,), snapshot_dir=str(tmp_path), fault_injector=sticky))
    with pytest.raises(pf.InjectedFault, match="sticky"):
        other.restore()
    assert other.stats.retries == 0 and other.stats.resumes == 0 and other._batches_done == 0


def test_injected_corruption_falls_back_one_generation_with_exact_replay(tmp_path):
    batches = _batches()
    want = _oracle(batches)
    # the third save (@6) rots on disk after LATEST moved to it
    inj = FaultInjector(seed=24, plan={"snapshot_corrupt": FaultSpec(schedule=(2,))})
    eng = StreamingEngine(_collection(), EngineConfig(buckets=(16, 32), coalesce=1, snapshot_every=2,
                                                      snapshot_dir=str(tmp_path), snapshot_keep=3,
                                                      fault_injector=inj))
    with eng:
        for b in batches:
            eng.submit(*b)
        eng.flush()
    assert eng.stats.snapshots == 3 and eng.stats.faults_by_site() == {"snapshot_corrupt": 1}
    with pytest.raises(SnapshotCorruptError):
        load_snapshot(str(tmp_path))
    resumed = StreamingEngine(_collection(), EngineConfig(buckets=(16, 32), snapshot_dir=str(tmp_path)))
    meta = resumed.restore()
    assert meta["generations_skipped"] == 1 and meta["batches_done"] == 4
    assert resumed.stats.snapshot_fallbacks == 1
    with resumed:
        for b in batches[meta["batches_done"]:]:
            resumed.submit(*b)
        got = _values(resumed.result())
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("site", [s for s in jf.FAULT_SITES if s not in PORTED_SITES])
def test_plan_naming_an_unported_site_is_refused(site):
    with pytest.raises(NotPortedError, match=site):
        EngineConfig(fault_injector=FaultInjector(0, {site: FaultSpec(schedule=(0,))}))


def test_recovery_config_checks():
    cfg = EngineConfig(snapshot_every=2, snapshot_keep=3, max_retries=0, backoff_base_ms=0.0,
                       fault_injector=FaultInjector(0, {s: FaultSpec() for s in PORTED_SITES}))
    assert (cfg.snapshot_every, cfg.snapshot_keep, cfg.max_retries) == (2, 3, 0)
    with pytest.raises(MetricsTPUUserError, match="requires snapshot_dir"):
        StreamingEngine(mp.Accuracy(device="cpu"), cfg)
    with pytest.raises(MetricsTPUUserError, match="max_retries"):
        StreamingEngine(mp.Accuracy(device="cpu"), EngineConfig(max_retries=-1))
    with pytest.raises(MetricsTPUUserError, match="snapshot_dir"):
        StreamingEngine(mp.Accuracy(device="cpu")).snapshot()
    for field in ("trace", "telemetry_capacity", "admission", "ladder", "window", "drift", "elastic_min_world"):
        with pytest.raises(NotPortedError, match=field):
            EngineConfig(**{field: None})
    # the fault layer's own fields are accepted, with the JAX package's defaults and checks
    cfg = EngineConfig()
    want = mt.engine.EngineConfig()
    for field in ("screen", "quarantine_capacity", "step_timeout_s", "transactional", "degrade_kernel"):
        assert getattr(cfg, field) == getattr(want, field), field
    with pytest.raises(MetricsTPUUserError, match="step_timeout_s"):
        StreamingEngine(mp.Accuracy(device="cpu"), EngineConfig(step_timeout_s=-1.0))
    with pytest.raises(MetricsTPUUserError, match="ScreenPolicy"):
        StreamingEngine(mp.Accuracy(device="cpu"), EngineConfig(screen="nan"))
    with pytest.raises(MetricsTPUUserError, match="FaultInjector"):
        StreamingEngine(mp.Accuracy(device="cpu"), EngineConfig(fault_injector=object()))


# ------------------------------------------------------------------ utils/checkpoint.py


def _cls_rows(seed, n=40, c=3):
    rng = np.random.RandomState(seed)
    p = rng.rand(n, c).astype(np.float32)
    return p / p.sum(1, keepdims=True), rng.randint(0, c, n)


def _members(m, **kw):
    return m.MetricCollection({"acc": m.Accuracy(**kw), "cm": m.ConfusionMatrix(num_classes=3, **kw),
                               "mse": m.MeanSquaredError(**kw)})


def _update(metric, rows, torch_side):
    p, t = rows
    if isinstance(metric, (mp.MetricCollection, mt.MetricCollection)):
        mse_args = (p[:, 0], (t == 0).astype(np.float32))
        for k, m in metric.items(keep_base=True):
            args = mse_args if k == "mse" else (p, t)
            m.update(*((torch.from_numpy(a) for a in args) if torch_side else (jnp.asarray(a) for a in args)))
    else:
        metric.update(*((torch.from_numpy(p), torch.from_numpy(t)) if torch_side else (jnp.asarray(p), jnp.asarray(t))))


def _computed(metric):
    v = metric.compute()
    return {k: np.asarray(x) for k, x in v.items()} if isinstance(v, dict) else np.asarray(v)


@pytest.mark.parametrize("kind", ["metric", "collection"])
def test_checkpoint_crosses_both_ways_with_jax(tmp_path, monkeypatch, kind):
    monkeypatch.setattr(jckpt, "_ORBAX_AVAILABLE", False)
    make = (lambda m, **kw: m.ConfusionMatrix(num_classes=3, **kw)) if kind == "metric" else _members
    first, second = _cls_rows(1), _cls_rows(2)
    # JAX writes, the port loads and finishes the stream
    j = make(mt)
    _update(j, first, False)
    jckpt.save_metric_state(j, str(tmp_path / "jax.pkl"))
    _update(j, second, False)
    p = make(mp, device="cpu")
    load_metric_state(p, str(tmp_path / "jax.pkl"))
    _update(p, second, True)
    want, got = _computed(j), _computed(p)
    for k in (want if isinstance(want, dict) else [None]):
        g, w = (got[k], want[k]) if k else (got, want)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=str(k))
    # the port writes, JAX loads and finishes the stream
    p2 = make(mp, device="cpu")
    _update(p2, first, True)
    save_metric_state(p2, str(tmp_path / "port.pkl"))
    j2 = make(mt)
    jckpt.load_metric_state(j2, str(tmp_path / "port.pkl"))
    _update(j2, second, False)
    got2 = _computed(j2)
    for k in (want if isinstance(want, dict) else [None]):
        g, w = (got2[k], want[k]) if k else (got2, want)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=str(k))


def test_checkpoint_synced_at_world_one_and_orbax_refused(tmp_path):
    m = mp.ConfusionMatrix(num_classes=3, device="cpu")
    _update(m, _cls_rows(4), True)
    save_metric_state(m, str(tmp_path / "s.pkl"), synced=True)  # no process group: the state itself
    fresh = mp.ConfusionMatrix(num_classes=3, device="cpu")
    load_metric_state(fresh, str(tmp_path / "s.pkl"))
    assert torch.equal(fresh.confmat, m.confmat)
    os.makedirs(tmp_path / "orbax_ckpt")
    with pytest.raises(MetricsTPUUserError, match="orbax"):
        load_metric_state(fresh, str(tmp_path / "orbax_ckpt"))


def test_snapshot_write_names_a_bf16_leaf_without_ml_dtypes(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_ml_dtypes(name, *a, **kw):
        if name == "ml_dtypes":
            raise ImportError("no ml_dtypes")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_ml_dtypes)
    with pytest.raises(TypeError, match=r"state\.bfloat16.*ml_dtypes"):
        save_snapshot(str(tmp_path), {"bfloat16": torch.ones(3, dtype=torch.bfloat16)}, {"step": 1})
    assert latest_snapshot(str(tmp_path)) is None
