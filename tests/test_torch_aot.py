"""The port's step cache (``engine/aot.py``) against the JAX package's AOT contract.

On the CPU a cache entry is the step run eagerly (the kernels' plain versions
sync with the host, so nothing is captured), but the keys and counters are
the JAX package's (``tests/engine/test_engine.py``'s compile budget): a cold
engine makes at most one miss per bucket and payload signature, plus one in
JAX for its compute program; a warm twin engine over an equally configured
metric, sharing the cache, makes none, and ends with the same state. The
same numpy inputs from a seed go through the JAX engine and the port's.
"""
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.engine import AotCache as JaxCache
from metrics_tpu.engine import EngineConfig as JaxConfig
from metrics_tpu.engine import StreamingEngine as JaxStreaming
from metrics_tpu.engine.aot import metric_fingerprint as jax_fingerprint
from metrics_tpu_torch.engine import AotCache, EngineConfig, MultiStreamEngine, StreamingEngine, metric_fingerprint
from metrics_tpu_torch.metric import StateSpec

C = 3
BUCKETS = (8, 32)


def _collection(m, num_classes=C, thresholds=5, **kw):
    return m.MetricCollection({
        "acc": m.Accuracy(**kw),
        "f1": m.F1Score(num_classes=num_classes, average="macro", **kw),
        "ap": m.BinnedAveragePrecision(num_classes=num_classes, thresholds=thresholds, **kw),
        "cm": m.ConfusionMatrix(num_classes=num_classes, **kw),
    })


def _port(**kw):
    return _collection(mp, device="cpu", **kw)


def _ragged(seed=0, sizes=(5, 17, 8, 32, 3, 70, 1, 12)):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        p = rng.rand(n, C).astype(np.float32)
        out.append((p / p.sum(1, keepdims=True), rng.randint(0, C, n)))
    return out


def _run(eng, batches):
    with eng:
        for p, t in batches:
            eng.submit(p, t)
    return eng.state()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_equal(got, want):
    got, want = _np(got), _np(want)
    for k in want:
        for s, w in want[k].items():
            assert got[k][s].dtype == w.dtype and np.array_equal(got[k][s], w), (k, s)


@pytest.mark.parametrize("backend", ["auto", "megastep"])
def test_compile_budget_and_warm_cache_zero_captures(backend):
    batches = _ragged()
    jcache = JaxCache()
    jeng = JaxStreaming(_collection(mt), JaxConfig(buckets=BUCKETS), aot_cache=jcache)
    want = _run(jeng, batches)
    assert jcache.misses <= len(BUCKETS) + 1

    cache = AotCache()
    cfg = EngineConfig(buckets=BUCKETS, kernel_backend=backend)
    first = _run(StreamingEngine(_port(), cfg, aot_cache=cache), batches)
    assert cache.misses <= len(BUCKETS) + 1 and len(cache) == cache.misses, cache.stats()
    assert set(cache.stats()) == {"programs", "hits", "misses", "capture_seconds"}
    cold = cache.misses
    twin = StreamingEngine(_port(), cfg, aot_cache=cache)
    second = _run(twin, batches)
    assert cache.misses == cold and cache.hits > 0, cache.stats()
    assert twin.stats.warmup_steps == 0  # nothing is captured on the CPU, nor warmed up
    _assert_equal(first, want)
    _assert_equal(second, want)
    assert float(twin.result()["acc"]) == pytest.approx(float(jeng.result()["acc"]), abs=1e-6)


def test_reset_and_restream_hits_cache():
    batches = _ragged(seed=3, sizes=(9, 30, 4))
    eng = StreamingEngine(_port(), EngineConfig(buckets=BUCKETS))
    first = _run(eng, batches)
    misses = eng.aot_cache.misses
    eng.reset()
    assert eng.steps == 0
    second = _run(eng, batches)
    assert eng.aot_cache.misses == misses
    _assert_equal(second, first)


def test_engines_of_another_kind_never_share_a_step():
    """One cache under a masked engine, an unsharded and a paged multi-stream
    engine over equal collections: their carried states and steps differ, so
    each captures its own."""
    cache = AotCache()
    p, t = _ragged(seed=4, sizes=(6,))[0]
    engines = [StreamingEngine(_port(), EngineConfig(buckets=(8,)), aot_cache=cache),
               MultiStreamEngine(_port(), 4, EngineConfig(buckets=(8,)), aot_cache=cache),
               MultiStreamEngine(_port(), 4, EngineConfig(buckets=(8,), kernel_backend="megastep"), aot_cache=cache,
                                 stream_shard=True, resident_streams=2)]
    for i, eng in enumerate(engines):
        with eng:
            if i:
                eng.submit(1, p, t)
            else:
                eng.submit(p, t)
        assert cache.misses == i + 1
    kinds = {key[0] for key in cache.program_keys()}
    assert kinds == {"update+k.auto", "segmented.4+k.auto", "paged.2+k.megastep"}


def test_metric_fingerprint_follows_configuration():
    assert metric_fingerprint(_port()) == metric_fingerprint(_port())
    assert metric_fingerprint(_port()) != metric_fingerprint(_port(thresholds=7))
    assert metric_fingerprint(_port()) != metric_fingerprint(_port(num_classes=4))
    assert metric_fingerprint(mp.Accuracy(device="cpu")) != metric_fingerprint(mp.Accuracy(threshold=0.3, device="cpu"))
    assert metric_fingerprint(mp.Accuracy(device="cpu")) != metric_fingerprint(mp.Accuracy(top_k=2, device="cpu"))
    # the JAX package draws the same lines on the same configurations
    same = jax_fingerprint(_collection(mt)) == jax_fingerprint(_collection(mt))
    differs = jax_fingerprint(_collection(mt)) != jax_fingerprint(_collection(mt, thresholds=7))
    assert same and differs
    # states are inputs, not configuration: an updated metric keeps its fingerprint
    m = mp.ConfusionMatrix(num_classes=C, device="cpu")
    before = metric_fingerprint(m)
    m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 2, 2]))
    assert metric_fingerprint(m) == before


def test_latched_host_attrs_enter_the_key():
    """Accuracy's input mode is latched from the first batch before any key
    is built (so a warm twin, which replays and never runs the update's
    Python, can compute), and the latched mode is part of the fingerprint."""
    eng = StreamingEngine(mp.Accuracy(device="cpu"), EngineConfig(buckets=(8,)))
    assert eng._needs_attr_latch
    fresh = metric_fingerprint(mp.Accuracy(device="cpu"))
    p, t = _ragged(seed=5, sizes=(4,))[0]
    with eng:
        eng.submit(p, t)
    assert not eng._needs_attr_latch and eng._metric.mode is not None
    assert metric_fingerprint(eng._metric) != fresh
    assert eng.aot_cache.program_keys()[0][1] == metric_fingerprint(eng._metric)


def test_signature_and_program_key():
    """numpy and torch leaves of one dtype and shape share a signature;
    values key by value; every key component separates."""
    sig = AotCache.signature_of
    assert sig(((np.zeros((4, 3), np.float32),), {"k": 2})) == sig(((torch.zeros(4, 3),), {"k": 2}))
    assert sig(((np.zeros((4, 3), np.float32),), {})) != sig(((np.zeros((4, 3), np.float64),), {}))
    assert sig(((np.zeros((4, 3), np.float32),), {"k": 2})) != sig(((np.zeros((4, 3), np.float32),), {"k": 3}))
    assert sig((StateSpec((8,), torch.bool),)) == sig((torch.zeros(8, dtype=torch.bool),))
    cache = AotCache()
    base = dict(kind="update", metric_fp="f", arg_tree=(torch.zeros(3),), backend="auto", device="cpu",
                precision="exact")
    key = cache.program_key(**base)
    for field, other in (("kind", "segmented.4"), ("metric_fp", "g"), ("arg_tree", (torch.zeros(4),)),
                         ("backend", "megastep"), ("device", "cuda:0"), ("precision", "q8:abc")):
        assert cache.program_key(**dict(base, **{field: other})) != key, field
    layout = _port().arena_layout()
    assert cache.program_key(**base, layout=layout) != key
