"""The port's engines against the JAX package's, stream by stream, on the CPU.

* ``StreamingEngine`` under ``kernel_backend="megastep"`` (K5's plain version
  here) against JAX's under ``"megastep_interpret"``;
* the unsharded ``MultiStreamEngine`` (K4's plain version) against JAX's;
* the paged ``MultiStreamEngine`` (``stream_shard=True``, 2 resident slots
  for 6 streams, so rows spill) under ``"megastep"``, exact and with
  ``compress_payloads=True`` (binned AP quantized q8_block), against JAX's
  stream-sharded engine on a one-device mesh: under ``"megastep_interpret"``
  when exact, under ``"xla"`` with compression. The JAX engine's q8-staged
  run under ``"megastep_interpret"`` is not deterministic on this tree: in
  about one run in three its binned-AP counts come out smaller than the
  exact run's, as if staged decodes were lost (cause not established; the
  staging flags are host arrays the dispatcher clears right after
  dispatching the step). So the port is held against the same engine under
  ``"xla"``, which decodes spilled rows on the host with the same
  arithmetic;
* the port's q8-staged run (decode on touch) against its twin that decodes
  on the host: bit-identical;
* an engine state carried across: half the traffic on the JAX paged engine,
  the rest on the port, against the all-JAX run;
* the typed refusals.

The JAX paged engines coalesce nothing (``coalesce=1``) and are flushed after
every batch; the port's paged engines pin ``coalesce=1`` too, so both packages
page the same streams at the same steps (a q8 spill taken at another step
quantizes differently). The port's ``StreamingEngine`` pins ``coalesce=1`` where
the test counts one step per batch; coalesced parity is
``tests/test_torch_dispatcher.py``'s. Integer
states must be bit-exact; the f32 states hold integer counts (exact) or, where
a row was spilled through the q8 codec, the same decoded values folded the
same way (rtol 1e-6).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.engine import EngineConfig as JaxConfig
from metrics_tpu.engine import MultiStreamEngine as JaxMulti
from metrics_tpu.engine import StreamingEngine as JaxStreaming
from metrics_tpu.engine.traffic import zipf_stream_ids
from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine
from metrics_tpu_torch.utils.exceptions import KernelBackendError, MetricsTPUUserError, NotPortedError
from metrics_tpu_torch.utils.state_bridge import engine_state_from_numpy, engine_state_to_numpy

C, T, S = 3, 5, 6
BUCKETS = (8, 32)


def _coll(m, q8=False, **kw):
    return m.MetricCollection({
        "acc": m.Accuracy(**kw),
        "ap": m.BinnedAveragePrecision(num_classes=C, thresholds=T, sync_precision="q8_block" if q8 else None, **kw),
        "cm": m.ConfusionMatrix(num_classes=C, **kw),
    })


def _port(q8=False):
    return _coll(mp, q8, device="cpu")


def _traffic(n_batches, seed):
    """``(stream_id, preds, target)`` batches of 1-13 rows, Zipf stream ids."""
    rng = np.random.RandomState(seed)
    out = []
    for sid in zipf_stream_ids(S, n_batches, alpha=1.05, seed=seed):
        n = int(rng.randint(1, 14))
        p = rng.rand(n, C).astype(np.float32)
        out.append((int(sid), p / p.sum(1, keepdims=True), rng.randint(0, C, n)))
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_states(got, want, exact=True):
    got, want = _np(got), _np(want)
    for k in want:
        for s, w in want[k].items():
            g = got[k][s]
            assert g.dtype == w.dtype and g.shape == w.shape, (k, s)
            if exact or w.dtype.kind != "f":
                assert np.array_equal(g, w), (k, s, g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f"{k}.{s}")


def _jax_paged(q8, traffic):
    eng = JaxMulti(
        _coll(mt, q8), S,
        JaxConfig(buckets=BUCKETS, mesh=Mesh(np.asarray(jax.devices()[:1]), ("dp",)), axis="dp",
                  mesh_sync="deferred", kernel_backend="xla" if q8 else "megastep_interpret", coalesce=1,
                  compress_payloads=q8),
        stream_shard=True, resident_streams=2,
    )
    with eng:
        for sid, p, t in traffic:
            eng.submit(sid, p, t)
            eng.flush()
    return eng


def _port_paged(q8, traffic, stage=True):
    eng = MultiStreamEngine(_port(q8), S, EngineConfig(buckets=BUCKETS, kernel_backend="megastep", coalesce=1,
                                                       compress_payloads=q8),
                            stream_shard=True, resident_streams=2)
    if not stage:
        eng._q8_enabled = False
        eng._q8_reset_stage()
    for sid, p, t in traffic:
        eng.submit(sid, torch.from_numpy(p), torch.from_numpy(t))
    eng.flush()  # the dispatcher has folded every batch: the pager's stats are final
    return eng


@pytest.fixture(scope="module")
def paged_q8():
    """The q8 paged traffic, its all-JAX engine and the port's engine (shared
    by the parity, the twin and the bridge tests: one JAX engine for three)."""
    traffic = _traffic(16, 5)
    return traffic, _jax_paged(True, traffic), _port_paged(True, traffic)


def test_streaming_engine_megastep_matches_jax():
    traffic = _traffic(8, 1)
    jeng = JaxStreaming(_coll(mt), JaxConfig(buckets=BUCKETS, kernel_backend="megastep_interpret"))
    with jeng:
        for _, p, t in traffic:
            jeng.submit(p, t)
        want, want_value = jeng.state(), jeng.result()
    peng = StreamingEngine(_port(), EngineConfig(buckets=BUCKETS, kernel_backend="megastep", coalesce=1))
    with peng:
        for _, p, t in traffic:
            peng.submit(torch.from_numpy(p), torch.from_numpy(t))
    assert peng.stats.kernel_fallbacks_by_reason() == {} and peng.steps == len(traffic)
    _assert_states(peng.state(), want)
    got_value = peng.result()
    np.testing.assert_allclose(got_value["acc"].numpy(), np.asarray(want_value["acc"]), atol=1e-6)
    np.testing.assert_array_equal(got_value["cm"].numpy(), np.asarray(want_value["cm"]))


def test_unsharded_multistream_matches_jax():
    traffic = _traffic(10, 2)
    jeng = JaxMulti(_coll(mt), S, JaxConfig(buckets=BUCKETS, coalesce=1))
    with jeng:
        for sid, p, t in traffic:
            jeng.submit(sid, p, t)
        want = jeng.state()
    peng = MultiStreamEngine(_port(), S, EngineConfig(buckets=BUCKETS, kernel_backend="megastep"))
    for sid, p, t in traffic:
        peng.submit(sid, torch.from_numpy(p), torch.from_numpy(t))
    # the stream-stacked arena has no op row: megastep degrades to K4 per leaf
    assert peng.stats.kernel_fallbacks_by_reason() == {"engine:stacked_layout": 1}
    _assert_states(peng.state(), want)
    sid = traffic[0][0]
    _assert_states(peng.stream_state(sid), jax.tree.map(lambda x: x[sid], want))


def test_paged_multistream_matches_jax():
    traffic = _traffic(14, 3)
    jeng = _jax_paged(False, traffic)
    peng = _port_paged(False, traffic)
    assert peng.stats.page_outs > 0 and peng.stats.page_ins > 0
    assert (peng.stats.page_outs, peng.stats.page_ins) == (jeng.stats.page_outs, jeng.stats.page_ins)
    for sid in range(S):
        _assert_states(peng.stream_state(sid), jeng.stream_state(sid))


def test_paged_multistream_q8_matches_jax(paged_q8):
    _, jeng, peng = paged_q8
    assert peng._q8_keys == ("float32",)
    assert peng.stats.page_ins > 0 and peng.stats.page_outs > 0
    for sid in range(S):
        _assert_states(peng.stream_state(sid), jeng.stream_state(sid), exact=False)


def test_q8_staged_decode_is_bit_identical_to_host_decode(paged_q8):
    traffic, _, fast = paged_q8
    twin = _port_paged(True, traffic, stage=False)
    assert twin._q8_keys == ()
    for sid in range(S):
        _assert_states(fast.stream_state(sid), twin.stream_state(sid), exact=True)


def test_paged_engine_state_carries_from_jax_to_port(paged_q8):
    traffic, want_eng, _ = paged_q8
    half = len(traffic) // 2
    jeng = _jax_paged(True, traffic[:half])
    arena = {k: np.asarray(v) for k, v in jeng._state.items()}
    peng = MultiStreamEngine(_port(True), S, EngineConfig(buckets=BUCKETS, kernel_backend="megastep", coalesce=1,
                                                          compress_payloads=True),
                             stream_shard=True, resident_streams=2)
    engine_state_from_numpy(peng, arena, jeng.arena_layout.leaf_slices(), jeng._pager.snapshot_payload(),
                            host_attrs=jeng._metric.host_compute_attrs())
    for sid, p, t in traffic[half:]:
        peng.submit(sid, torch.from_numpy(p), torch.from_numpy(t))
    for sid in range(S):
        _assert_states(peng.stream_state(sid), want_eng.stream_state(sid), exact=False)
    back, payload = engine_state_to_numpy(peng)
    assert all(back[k].shape == arena[k].shape for k in arena)
    assert np.array_equal(payload["slots"], peng.pager.snapshot_payload()["slots"])
    wrong = MultiStreamEngine(_coll(mp, device="cpu"), S, EngineConfig(buckets=BUCKETS), stream_shard=True)
    slices = list(jeng.arena_layout.leaf_slices())
    with pytest.raises(ValueError, match="leaf_slices"):
        engine_state_from_numpy(wrong, arena, slices[::-1], jeng._pager.snapshot_payload())


def test_typed_refusals():
    for backend in ("xla", "pallas_interpret", "megastep_interpret"):
        with pytest.raises(KernelBackendError, match="device"):
            StreamingEngine(_port(), EngineConfig(kernel_backend=backend))
    with pytest.raises(NotPortedError, match="trace"):
        EngineConfig(trace=object())
    with pytest.raises(NotPortedError, match="mesh"):
        EngineConfig(mesh=object(), mesh_sync="deferred")
    with pytest.raises(TypeError):
        EngineConfig(bucket=(8,))
    with pytest.raises(MetricsTPUUserError, match="resident_streams"):
        MultiStreamEngine(_port(), S, EngineConfig(buckets=BUCKETS), resident_streams=2)
    with pytest.raises(MetricsTPUUserError, match="cannot be served"):
        MultiStreamEngine(mp.StatScores(reduce="samples", device="cpu"), S, EngineConfig(buckets=BUCKETS))
    with pytest.raises(MetricsTPUUserError, match="out of range"):
        MultiStreamEngine(_port(), S).submit(S, np.zeros((2, C), np.float32), np.zeros(2, np.int64))
    # an engine without an arena cannot take the megastep path: it says so
    eng = StreamingEngine(_port(), EngineConfig(buckets=BUCKETS, kernel_backend="megastep", use_arena=False))
    assert eng.stats.kernel_fallbacks_by_reason() == {"engine:no_arena": 1}


def test_engine_reset_and_stream_reset():
    traffic = _traffic(6, 4)
    for eng in (MultiStreamEngine(_port(), S, EngineConfig(buckets=BUCKETS)),
                MultiStreamEngine(_port(), S, EngineConfig(buckets=BUCKETS), stream_shard=True, resident_streams=2)):
        for sid, p, t in traffic:
            eng.submit(sid, torch.from_numpy(p), torch.from_numpy(t))
        sid = traffic[0][0]
        assert int(eng.stream_state(sid)["cm"]["confmat"].sum()) > 0
        eng.reset_stream(sid)
        assert int(eng.stream_state(sid)["cm"]["confmat"].sum()) == 0
        eng.reset()
        assert all(int(eng.stream_state(s)["cm"]["confmat"].sum()) == 0 for s in range(S))
