"""Carrying metric state from the JAX package into the port and back.

A stream begun in ``metrics_tpu`` is taken to numpy halfway, bridged into
``metrics_tpu_torch`` with ``state_from_numpy``, finished there, and must give
the JAX package's own result for the whole stream.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.ops.kernels import use_backend
from metrics_tpu_torch.utils.state_bridge import state_from_numpy, state_to_numpy

C, T = 4, 9


def _collection(m, **kw):
    return m.MetricCollection({
        "acc": m.Accuracy(**kw),
        "f1": m.F1Score(num_classes=C, average="macro", **kw),
        "ap": m.BinnedAveragePrecision(num_classes=C, thresholds=T, **kw),
        "cm": m.ConfusionMatrix(num_classes=C, **kw),
    })


def _batches(k, n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(k):
        p = rng.rand(n, C).astype(np.float32)
        out.append((p / p.sum(1, keepdims=True), rng.randint(0, C, n)))
    return out


def _flat(v):
    return np.stack([np.asarray(x) for x in v]) if isinstance(v, list) else np.asarray(v)


def test_stream_bridged_from_jax_halfway_gives_the_jax_result():
    jc, pc = _collection(mt), _collection(mp, device="cpu")
    batches = _batches(4, 48, 0)
    with use_backend("pallas_interpret"):
        js = jc.init_state()
        for p, t in batches[:2]:
            js = jc.update_state(js, jnp.asarray(p), jnp.asarray(t))
        half = jax.tree.map(np.asarray, js)
        for p, t in batches[2:]:
            js = jc.update_state(js, jnp.asarray(p), jnp.asarray(t))
        want = jc.compute_from(js)
    ps = state_from_numpy(pc, half, device="cpu", host_attrs=jc.host_compute_attrs())
    for p, t in batches[2:]:
        ps = pc.update_state(ps, torch.from_numpy(p), torch.from_numpy(t))
    got = pc.compute_from(ps)
    for k in want:
        g = np.stack([x.numpy() for x in got[k]]) if isinstance(got[k], list) else got[k].numpy()
        np.testing.assert_allclose(g, _flat(want[k]), rtol=0, atol=1e-6)
    back = state_to_numpy(ps)
    for k, member in jax.tree.map(np.asarray, js).items():
        for s, w in member.items():
            assert back[k][s].dtype == w.dtype
            np.testing.assert_array_equal(back[k][s], w)


def test_bridged_single_metric_computes_without_an_update():
    jm, pm = mt.Accuracy(), mp.Accuracy(device="cpu")
    (p, t), = _batches(1, 64, 1)
    js = jm.update_state(jm.init_state(), jnp.asarray(p), jnp.asarray(t))
    ps = state_from_numpy(pm, jax.tree.map(np.asarray, js), device="cpu", host_attrs=jm.host_compute_attrs())
    np.testing.assert_allclose(pm.compute_from(ps).numpy(), np.asarray(jm.compute_from(js)), atol=1e-6)


def test_bridge_checks_shapes_and_names():
    pm = mp.ConfusionMatrix(num_classes=C, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        state_from_numpy(pm, {"confmat": np.zeros((C + 1, C), np.int32)}, device="cpu")
    with pytest.raises(KeyError):
        state_from_numpy(pm, {}, device="cpu")
    state = state_from_numpy(pm, {"confmat": np.ones((C, C), np.int64)}, device="cpu")
    assert state["confmat"].dtype == torch.int32


def test_engine_arena_carries_across_both_ways():
    """A JAX engine's packed arena (here packed by the JAX layout from a JAX
    state) seats in the port's StreamingEngine, which finishes the stream;
    the port engine's arena unpacks with the JAX layout to the JAX state."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine
    from metrics_tpu_torch.utils.state_bridge import engine_state_from_numpy, engine_state_to_numpy

    jc = _collection(mt)
    batches = _batches(4, 40, 2)
    js = jc.init_state()
    with use_backend("pallas_interpret"):
        for i, (p, t) in enumerate(batches):
            js = jc.update_state(js, jnp.asarray(p), jnp.asarray(t))
            if i == 1:
                half = jc.arena_layout().pack(js)
    engine = StreamingEngine(_collection(mp, device="cpu"), EngineConfig(buckets=(16, 64), kernel_backend="megastep"))
    engine_state_from_numpy(engine, {k: np.asarray(v) for k, v in half.items()}, jc.arena_layout().leaf_slices(),
                            host_attrs=jc.host_compute_attrs())
    for p, t in batches[2:]:
        engine.submit(torch.from_numpy(p), torch.from_numpy(t))
    arena, payload = engine_state_to_numpy(engine)
    assert payload is None
    back = jc.arena_layout().unpack({k: jnp.asarray(v) for k, v in arena.items()})
    for k, member in js.items():
        for s, w in member.items():
            np.testing.assert_array_equal(np.asarray(back[k][s]), np.asarray(w))
    with pytest.raises(ValueError, match="pager payload"):
        engine_state_from_numpy(engine, arena, jc.arena_layout().leaf_slices(), pager_payload={})


def _bf16(x):
    return torch.tensor(x, dtype=torch.bfloat16)


def _assert_bf16_round_trip(port_state, jax_state):
    """``jax_state`` (JAX arrays) carries ``port_state``'s bf16 leaves as
    bf16, bit for bit, and its other leaves unchanged."""
    for k, v in port_state.items():
        assert str(jax_state[k].dtype) == str(v.dtype).replace("torch.", ""), k
        np.testing.assert_array_equal(np.asarray(jax_state[k]).astype(np.float64), v.double().numpy())


def test_bf16_mean_metric_state_keeps_its_dtype_both_ways():
    pm = mp.MeanMetric(device="cpu").astype(torch.bfloat16)
    state = {"value": pm.init_state()["value"] + _bf16(6.75), "weight": pm.init_state()["weight"] + _bf16(3.0)}
    assert {v.dtype for v in state.values()} == {torch.bfloat16}
    host = state_to_numpy(state)
    assert {v.dtype.name for v in host.values()} == {"bfloat16"}
    js = jax.tree.map(jnp.asarray, host)
    _assert_bf16_round_trip(state, js)
    jm = mt.MeanMetric().astype(jnp.bfloat16)
    assert float(jm.compute_from(js)) == float(pm.compute_from(state)) == 2.25
    back = state_from_numpy(pm, jax.tree.map(np.asarray, js), device="cpu")
    for k in state:
        assert back[k].dtype == torch.bfloat16 and torch.equal(back[k], state[k])


def test_bf16_mean_squared_error_state_crosses_to_jax_and_back():
    """A bf16 ``MeanSquaredError`` updated on bf16 rows (its sum stays bf16,
    its count int32) crosses to JAX, which computes the same value and
    updates it further in bf16; that state comes back to the port as bf16."""
    pm = mp.MeanSquaredError(device="cpu").astype(torch.bfloat16)
    jm = mt.MeanSquaredError().astype(jnp.bfloat16)
    rng = np.random.RandomState(3)
    p, t = rng.rand(2, 16).astype(np.float32) * 4
    state = pm.update_state(pm.init_state(), torch.from_numpy(p).bfloat16(), torch.from_numpy(t).bfloat16())
    assert state["sum_squared_error"].dtype == torch.bfloat16 and state["total"].dtype == torch.int32
    js = jax.tree.map(jnp.asarray, state_to_numpy(state))
    _assert_bf16_round_trip(state, js)
    np.testing.assert_array_equal(np.asarray(jm.compute_from(js), np.float64), pm.compute_from(state).double().numpy())
    back = state_from_numpy(pm, jax.tree.map(np.asarray, js), device="cpu")
    assert all(torch.equal(back[k], state[k]) and back[k].dtype == state[k].dtype for k in state)
    js2 = jm.update_state(js, jnp.asarray(t, jnp.bfloat16), jnp.asarray(p, jnp.bfloat16))
    assert js2["sum_squared_error"].dtype == jnp.bfloat16
    back2 = state_from_numpy(pm, jax.tree.map(np.asarray, js2), device="cpu")
    assert back2["sum_squared_error"].dtype == torch.bfloat16 and int(back2["total"]) == 32
    np.testing.assert_array_equal(back2["sum_squared_error"].double().numpy(),
                                  np.asarray(js2["sum_squared_error"]).astype(np.float64))


def test_bf16_engine_arena_keeps_its_dtype_both_ways():
    """A bf16 ``MeanSquaredError`` served by the port's megastep engine: its
    arena's bf16 buffer goes to numpy and JAX as bf16, and back into a second
    port engine bit for bit."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine
    from metrics_tpu_torch.utils.state_bridge import engine_state_from_numpy, engine_state_to_numpy

    def engine():
        return StreamingEngine(mp.MeanSquaredError(device="cpu").astype(torch.bfloat16),
                               EngineConfig(buckets=(8, 32), kernel_backend="megastep"))

    eng = engine()
    rng = np.random.RandomState(4)
    with eng:
        for n in (3, 9, 5):
            p, t = rng.rand(2, n).astype(np.float32) * 4
            eng.submit(torch.from_numpy(p).bfloat16(), torch.from_numpy(t).bfloat16())
    assert sorted(eng.arena_layout.dtype_keys) == ["bfloat16", "int32"]
    arena, payload = engine_state_to_numpy(eng)
    assert payload is None and arena["bfloat16"].dtype.name == "bfloat16"
    jarena = {k: jnp.asarray(v) for k, v in arena.items()}
    assert jarena["bfloat16"].dtype == jnp.bfloat16
    twin = engine()
    engine_state_from_numpy(twin, {k: np.asarray(v) for k, v in jarena.items()}, eng.arena_layout.leaf_slices())
    for k, buf in eng._state.items():
        assert twin._state[k].dtype == buf.dtype and torch.equal(twin._state[k], buf), k
    assert int(twin.state()["total"]) == 17


def test_bf16_leaf_without_ml_dtypes_raises_naming_the_leaf(monkeypatch):
    """numpy has bfloat16 only through ml_dtypes: without it the bridge
    raises, naming the leaf, and never widens."""
    import sys

    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(TypeError, match=r"state\.sum_squared_error.*ml_dtypes"):
        state_to_numpy({"sum_squared_error": _bf16(1.0), "total": torch.tensor(1, dtype=torch.int32)})


def _bf16_sum(pkg, **kw):
    """A metric with a genuinely bf16 ``sum`` state (and an int32 count) in
    ``pkg``: the JAX package's ``astype`` keeps a metric's f32 defaults, so
    its served arenas are bf16 only for a state registered as bf16."""
    xp, bf16, i32 = (jnp, jnp.bfloat16, jnp.int32) if pkg is mt else (torch, torch.bfloat16, torch.int32)

    class Bf16Sum(pkg.Metric):
        def __init__(self):
            super().__init__(**kw)
            self.add_state("total", xp.zeros((), dtype=bf16), dist_reduce_fx="sum")
            self.add_state("sq", xp.zeros((), dtype=bf16), dist_reduce_fx="sum")
            self.add_state("n", xp.zeros((), dtype=i32), dist_reduce_fx="sum")

        def update(self, x):
            cast = (lambda v: v.astype(bf16)) if pkg is mt else (lambda v: v.to(bf16))
            self.total = self.total + cast(x.sum())
            self.sq = self.sq + cast((x * x).sum())
            self.n = self.n + x.shape[0]

        def compute(self):
            return self.total

    return Bf16Sum()


@pytest.mark.parametrize("q8", [False, True], ids=["exact", "q8"])
def test_bf16_paged_pager_payload_crosses_as_bf16_both_ways(q8):
    """A bf16 ``sum`` state on the paged engine (5 streams, 2 resident
    slots, so rows spill): the port's pager payload holds the spilled bf16
    rows as bf16, the dtype JAX's ``snapshot_payload()`` gives for the same
    arena; JAX → port → numpy and port → numpy → port keep every row's bits.
    With ``compress_payloads`` (``total`` quantized) the exact section of the
    bf16 buffer (``sq``) crosses as bf16, the q8 codes and scales as int8 and
    f32."""
    from jax.sharding import Mesh

    from metrics_tpu.engine import EngineConfig as JaxConfig
    from metrics_tpu.engine import MultiStreamEngine as JaxMulti
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine
    from metrics_tpu_torch.utils.state_bridge import engine_state_from_numpy, engine_state_to_numpy

    streams = 5
    prec = {"sync_precision": {"total": "q8_block"}} if q8 else {}

    def port():
        return MultiStreamEngine(_bf16_sum(mp, device="cpu", **prec), streams,
                                 EngineConfig(buckets=(8,), kernel_backend="megastep", coalesce=1,
                                              compress_payloads=q8),
                                 stream_shard=True, resident_streams=2)

    rng = np.random.RandomState(7)
    traffic = [(int(rng.randint(streams)), rng.rand(int(rng.randint(1, 6))).astype(np.float32) * 4)
               for _ in range(14)]
    jeng = JaxMulti(_bf16_sum(mt, **prec), streams,
                    JaxConfig(buckets=(8,), mesh=Mesh(np.asarray(jax.devices()[:1]), ("dp",)), axis="dp",
                              mesh_sync="deferred", kernel_backend="xla", coalesce=1, compress_payloads=q8),
                    stream_shard=True, resident_streams=2)
    peng = port()
    with jeng, peng:
        for sid, x in traffic:
            jeng.submit(sid, jnp.asarray(x, jnp.bfloat16))
            jeng.flush()
            peng.submit(sid, torch.from_numpy(x).bfloat16())
    jpay = jeng._pager.snapshot_payload()
    arena, pay = engine_state_to_numpy(peng)
    assert "spill_coords" in pay and sorted(pay) == sorted(jpay)
    assert {k: v.dtype.name for k, v in pay.items()} == {k: np.asarray(v).dtype.name for k, v in jpay.items()}
    assert any(v.dtype.name == "bfloat16" for v in pay.values())
    # port -> numpy -> port: every spilled row's bits come back
    twin = port()
    engine_state_from_numpy(twin, arena, peng.arena_layout.leaf_slices(), pay)
    _, again = engine_state_to_numpy(twin)
    for k, v in pay.items():
        assert again[k].dtype == v.dtype and np.array_equal(again[k].view(np.uint8), v.view(np.uint8)), k
    # JAX -> port -> numpy: JAX's payload comes back as it was
    seated = port()
    jarena = {k: np.asarray(v) for k, v in jeng._state.items()}
    engine_state_from_numpy(seated, jarena, jeng.arena_layout.leaf_slices(), jpay)
    _, back = engine_state_to_numpy(seated)
    for k, v in jpay.items():
        v = np.asarray(v)
        assert back[k].dtype == v.dtype and np.array_equal(back[k].view(np.uint8), v.view(np.uint8)), k
