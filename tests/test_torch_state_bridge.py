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
