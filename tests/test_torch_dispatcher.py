"""The port's dispatcher thread, queue and coalescing against the JAX package's.

The contract of ``metrics_tpu/engine/pipeline.py``'s dispatcher, held on the
CPU: coalescing changes the number of steps, never a result. Masked updates
are row-exact and concatenation keeps submission order, so any grouping of the
queue folds to the same state; every state here is an integer count (or an
f32 sum of integer counts), so "the same" is bit for bit. The same numpy
inputs, made from a seed, go through the JAX engines (built as
``tests/engine/test_coalesce.py`` builds them) and the port's.

A backlog is made deterministic by holding the engine's state lock while
submitting: the dispatcher takes its first batch and waits on the lock, so
every later batch is queued when it next drains the queue.
"""
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.engine import AotCache as JaxCache
from metrics_tpu.engine import EngineConfig as JaxConfig
from metrics_tpu.engine import MultiStreamEngine as JaxMulti
from metrics_tpu.engine import StreamingEngine as JaxStreaming
from metrics_tpu_torch.engine import (
    BackpressureTimeout,
    EngineConfig,
    EngineDispatchError,
    MultiStreamEngine,
    StreamingEngine,
)
from metrics_tpu_torch.utils.data import _aux_leaves_equal

C, S = 3, 6
_JAX_CACHE = JaxCache()  # one compile per (bucket, fingerprint) for the whole file


def _collection(m, **kw):
    return m.MetricCollection({
        "acc": m.Accuracy(**kw),
        "ap": m.BinnedAveragePrecision(num_classes=C, thresholds=5, **kw),
        "cm": m.ConfusionMatrix(num_classes=C, **kw),
    })


def _port():
    return _collection(mp, device="cpu")


def _batches(seed=0, sizes=(5, 17, 8, 32, 3, 70, 1)):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        p = rng.rand(n, C).astype(np.float32)
        out.append((p / p.sum(1, keepdims=True), rng.randint(0, C, n)))
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_equal(got, want):
    got, want = _np(got), _np(want)
    for k in want:
        for s, w in want[k].items():
            assert got[k][s].dtype == w.dtype and np.array_equal(got[k][s], w), (k, s)


def _backlogged(eng, submits):
    """Run ``submits(eng)`` while the engine's state lock is held, so the
    dispatcher finds the whole backlog queued; then drain."""
    with eng._state_lock:
        submits(eng)
    eng.flush()


@pytest.mark.parametrize("coalesce", [1, 4, 64])
def test_any_grouping_is_bit_identical(coalesce):
    batches = _batches()
    eager = _port()
    state = eager.init_state()
    for p, t in batches:
        state = eager.update_state(state, torch.from_numpy(p), torch.from_numpy(t))
    jeng = JaxStreaming(_collection(mt), JaxConfig(buckets=(8, 32), coalesce=coalesce), aot_cache=_JAX_CACHE)
    with jeng:
        for p, t in batches:
            jeng.submit(p, t)
        want = jeng.state()
    peng = StreamingEngine(_port(), EngineConfig(buckets=(8, 32), coalesce=coalesce))
    _backlogged(peng, lambda e: [e.submit(p, t) for p, t in batches])
    _assert_equal(peng.state(), want)
    _assert_equal(peng.state(), state)
    if coalesce == 1:
        assert peng.stats.megasteps == 0
    else:
        assert peng.stats.megasteps >= 1 and peng.steps < sum(-(-len(t) // 32) for _, t in batches)


def test_coalescing_reduces_dispatches_and_reports_megasteps():
    """A backlog of 16 four-row batches drains into shared steps."""
    batches = _batches(seed=1, sizes=(4,) * 16)
    eng = StreamingEngine(_port(), EngineConfig(buckets=(64,), coalesce=16, max_queue=64))
    _backlogged(eng, lambda e: [e.submit(p, t) for p, t in batches])
    st = eng.stats
    assert eng.steps < len(batches) and st.megasteps >= 1 and st.batches_coalesced >= 2
    assert eng._batches_done == len(batches) == st.batches_submitted  # the cursor counts batches, not steps
    assert st.rows_in == 64


def test_tensor_and_numpy_batches_coalesce_apart():
    """Tensors concatenate with tensors and numpy with numpy: a kind change
    ends the group; the result does not depend on the inputs' kind."""
    batches = _batches(seed=2, sizes=(3, 4, 5, 6))
    eng = StreamingEngine(_port(), EngineConfig(buckets=(32,), coalesce=8))

    def submits(e):
        for i, (p, t) in enumerate(batches):
            if i % 2:
                e.submit(torch.from_numpy(p), torch.from_numpy(t))
            else:
                e.submit(p, t)

    _backlogged(eng, submits)
    ref = StreamingEngine(_port(), EngineConfig(buckets=(32,), coalesce=1))
    with ref:
        for p, t in batches:
            ref.submit(p, t)
    _assert_equal(eng.state(), ref.state())
    assert eng.stats.megasteps == 0  # every neighbour differs in kind


def test_incompatible_broadcast_argument_breaks_the_group():
    eng = StreamingEngine(_port(), EngineConfig(buckets=(8,), coalesce=8))
    a = (np.asarray([0.5, 0.25], np.float32), np.asarray([1, 0], np.int32))
    b = (np.asarray([0.75], np.float32), np.asarray([1], np.int32))
    assert eng._coalescible((a, {}), (b, {}))
    # same structure, different non-batch leaf -> not coalescible
    assert not eng._coalescible((a, {"w": 2.0}), (b, {"w": 3.0}))
    assert eng._coalescible((a, {"w": 2.0}), (b, {"w": 2.0}))
    # batch-carried dtype drift -> not coalescible
    c = (np.asarray([0.75], np.float64), np.asarray([1], np.int32))
    assert not eng._coalescible((a, {}), (c, {}))
    # a numpy batch behind a tensor batch, or a different structure -> not coalescible
    ta = tuple(torch.from_numpy(x) for x in a)
    assert not eng._coalescible((ta, {}), (b, {}))
    assert eng._coalescible((ta, {}), (tuple(torch.from_numpy(x) for x in b), {}))
    assert not eng._coalescible((a, {}), (b + (np.zeros(1),), {}))


def test_coalescible_agrees_with_jax():
    """The port's rules give the JAX package's verdict on the same numpy items."""
    jeng = JaxStreaming(_collection(mt), JaxConfig(buckets=(8,), coalesce=8), aot_cache=_JAX_CACHE)
    peng = StreamingEngine(_port(), EngineConfig(buckets=(8,), coalesce=8))
    a = (np.asarray([0.5, 0.25], np.float32), np.asarray([1, 0], np.int32))
    items = [
        (a, {}),
        ((np.asarray([0.75], np.float32), np.asarray([1], np.int32)), {}),
        ((np.asarray([0.75], np.float64), np.asarray([1], np.int32)), {}),
        ((np.asarray([[0.75]], np.float32), np.asarray([1], np.int32)), {}),
        (a, {"w": 2.0}),
        (a, {"w": np.arange(3)}),
        (a, {"w": np.arange(4)}),
    ]
    for x in items:
        for y in items:
            assert peng._coalescible(x, y) == jeng._coalescible(x, y), (x, y)


def test_aux_equality_is_conservative():
    big = np.zeros(10_000, np.float32)
    assert not _aux_leaves_equal(big, big.copy())  # too big to compare: refuse
    assert _aux_leaves_equal(big, big)  # identity is free
    assert _aux_leaves_equal(np.float32(2.0), np.float32(2.0))
    assert not _aux_leaves_equal(np.arange(3), np.arange(4))
    assert _aux_leaves_equal(torch.arange(3), torch.arange(3))
    assert not _aux_leaves_equal(torch.arange(3), torch.arange(3).float())  # dtype drift
    assert not _aux_leaves_equal(torch.arange(3), np.arange(3))  # a tensor is never a numpy array
    assert not _aux_leaves_equal(torch.zeros(10_000), torch.zeros(10_000))
    assert not _aux_leaves_equal(torch.arange(3).to("meta"), torch.arange(3).to("meta"))  # off the CPU: never read
    assert not _aux_leaves_equal(object(), object())


def _traffic(n_batches, seed):
    rng = np.random.RandomState(seed)
    sids = rng.randint(0, S, n_batches)
    out = []
    for sid in sids:
        n = int(rng.randint(1, 14))
        p = rng.rand(n, C).astype(np.float32)
        out.append((int(sid), p / p.sum(1, keepdims=True), rng.randint(0, C, n)))
    return out


def _jax_multi(traffic, paged):
    cfg = dict(buckets=(8, 32), coalesce=1)
    if paged:
        cfg.update(mesh=Mesh(np.asarray(jax.devices()[:1]), ("dp",)), axis="dp", mesh_sync="deferred",
                   kernel_backend="megastep_interpret")
    eng = JaxMulti(_collection(mt), S, JaxConfig(**cfg), aot_cache=_JAX_CACHE,
                   **(dict(stream_shard=True, resident_streams=2) if paged else {}))
    with eng:
        for sid, p, t in traffic:
            eng.submit(sid, p, t)
            eng.flush()
    return eng


@pytest.mark.parametrize("paged", [False, True])
def test_cross_stream_megabatches_match_jax(paged):
    """Queued batches of different streams form one megabatch (the per-row
    id column carries them), and every stream ends equal to the JAX engine's
    uncoalesced run, exactly."""
    traffic = _traffic(20, 7 + paged)
    jeng = _jax_multi(traffic, paged)
    peng = MultiStreamEngine(_port(), S, EngineConfig(buckets=(8, 32), coalesce=8, kernel_backend="megastep"),
                             **(dict(stream_shard=True, resident_streams=2) if paged else {}))
    _backlogged(peng, lambda e: [e.submit(sid, p, t) for sid, p, t in traffic])
    assert peng.stats.megasteps >= 1 and peng.steps < len(traffic)
    if paged:
        assert peng.stats.page_outs > 0
    for sid in range(S):
        _assert_equal(peng.stream_state(sid), jeng.stream_state(sid))


def test_a_failing_batch_surfaces_from_flush():
    """A batch the metric refuses becomes the dispatcher's sticky error,
    raised from flush (no hang) with its context; reset recovers."""
    eng = StreamingEngine(_port(), EngineConfig(buckets=(8,), coalesce=1))
    p, t = _batches(seed=3, sizes=(4,))[0]
    eng.submit(p, t)
    eng.submit(np.zeros((3, C + 2), np.float32), np.zeros(3, np.int64))  # too many classes
    done = threading.Event()
    caught = []

    def reader():
        try:
            eng.flush()
        except EngineDispatchError as e:
            caught.append(e)
        done.set()

    threading.Thread(target=reader, daemon=True).start()
    assert done.wait(timeout=60)
    (err,) = caught
    assert err.cursor == 1 and err.bucket == 8 and err.__cause__ is not None
    with pytest.raises(EngineDispatchError):
        eng.submit(p, t)
    with pytest.raises(EngineDispatchError):
        eng.result()
    eng.reset()
    with eng:
        eng.submit(p, t)
    assert eng.steps == 1 and int(eng.state()["cm"]["confmat"].sum()) == 4


def test_submit_timeout_raises_backpressure_and_stop_is_idempotent():
    eng = StreamingEngine(_port(), EngineConfig(buckets=(8,), max_queue=1, coalesce=1))
    p, t = _batches(seed=4, sizes=(2,))[0]
    with eng._state_lock:  # the dispatcher takes one batch and waits
        eng.submit(p, t)
        deadline = threading.Event()
        while eng._queue.qsize() and not deadline.wait(0.01):
            pass
        eng.submit(p, t)  # fills the queue
        with pytest.raises(BackpressureTimeout, match="queue full"):
            eng.submit(p, t, timeout=0.05)
    eng.stop()
    eng.stop()
    assert eng.steps == 2 and eng.stats.batches_submitted == 2
    # a stopped engine restarts on the next submit
    eng.submit(p, t)
    eng.stop()
    assert eng.steps == 3


def test_zero_row_batches_only_advance_the_cursor():
    eng = StreamingEngine(_port(), EngineConfig(buckets=(8,), coalesce=4))
    with eng:
        eng.submit(np.zeros((0, C), np.float32), np.zeros(0, np.int64))
        eng.submit(*_batches(seed=5, sizes=(3,))[0])
    assert eng.steps == 1 and eng._batches_done == 2
