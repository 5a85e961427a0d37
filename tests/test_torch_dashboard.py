"""The classification dashboard through the port's engines, and the batched
``results()``, against the JAX package on the CPU.

The dashboard collection (macro Precision, Recall and Specificity,
HammingDistance, JaccardIndex, CohenKappa, MatthewsCorrCoef, HingeLoss; 3
classes) goes through the port's ``StreamingEngine`` under ``"megastep"``,
its unsharded ``MultiStreamEngine`` and its paged one (``stream_shard=True``,
2 resident slots for 6 streams, so rows spill), and through the JAX
package's engines under ``kernel_backend="xla"`` on the same traffic. Integer
states must be bit-exact; the hinge measure (an f32 sum folded in another
order) and the f32 values within ``rtol=1e-6`` plus ``atol=1e-6``.

``MultiStreamEngine.results()`` must be one batched computation for any S:
``EngineStats.result_device_calls`` rises by exactly 1 per call at two
values of S in both forms, as ``tests/engine/test_stream_shard.py`` pins for
the JAX package, and every stream's value equals the port's per-stream
``result()`` and the JAX engine's ``results()``, spilled, q8-encoded and
never-touched streams included.
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
from metrics_tpu_torch.engine.multistream import _values_to_host

C, S = 3, 6
BUCKETS = (8, 32)
TOL = 1e-6


def _dashboard(m, **kw):
    return m.MetricCollection({
        "precision": m.Precision(num_classes=C, average="macro", **kw),
        "recall": m.Recall(num_classes=C, average="macro", **kw),
        "specificity": m.Specificity(num_classes=C, average="macro", **kw),
        "hamming": m.HammingDistance(**kw),
        "jaccard": m.JaccardIndex(num_classes=C, **kw),
        "kappa": m.CohenKappa(num_classes=C, **kw),
        "mcc": m.MatthewsCorrCoef(num_classes=C, **kw),
        "hinge": m.HingeLoss(**kw),
    })


def _flagship_q8(m, **kw):
    return m.MetricCollection({
        "acc": m.Accuracy(**kw),
        "ap": m.BinnedAveragePrecision(num_classes=C, thresholds=5, sync_precision="q8_block", **kw),
        "jaccard": m.JaccardIndex(num_classes=C, **kw),
    })


def _traffic(num_streams, n_batches, seed):
    """``(stream_id, preds, target)`` batches of 1-13 rows, Zipf stream ids."""
    rng = np.random.RandomState(seed)
    out = []
    for sid in zipf_stream_ids(num_streams, n_batches, alpha=1.05, seed=seed):
        n = int(rng.randint(1, 14))
        p = rng.rand(n, C).astype(np.float32)
        out.append((int(sid), p / p.sum(1, keepdims=True), rng.randint(0, C, n)))
    return out


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
        return
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, equal_nan=True)


def _jax_paged(coll, num_streams, traffic, q8=False):
    eng = JaxMulti(
        coll, num_streams,
        JaxConfig(buckets=BUCKETS, mesh=Mesh(np.asarray(jax.devices()[:1]), ("dp",)), axis="dp",
                  mesh_sync="deferred", kernel_backend="xla", coalesce=1, compress_payloads=q8),
        stream_shard=True, resident_streams=2,
    )
    with eng:
        for sid, p, t in traffic:
            eng.submit(sid, p, t)
            eng.flush()
    return eng


def _port_multi(coll, num_streams, traffic, paged, q8=False):
    kw = {"stream_shard": True, "resident_streams": 2} if paged else {}
    eng = MultiStreamEngine(coll, num_streams, EngineConfig(buckets=BUCKETS, kernel_backend="megastep", coalesce=1,
                                                            compress_payloads=q8), **kw)
    with eng:
        for sid, p, t in traffic:
            eng.submit(sid, torch.from_numpy(p), torch.from_numpy(t))
    return eng


def test_dashboard_streaming_engine_matches_jax():
    traffic = _traffic(S, 10, 1)
    jeng = JaxStreaming(_dashboard(mt), JaxConfig(buckets=BUCKETS, kernel_backend="xla", coalesce=1))
    with jeng:
        for _, p, t in traffic:
            jeng.submit(p, t)
    peng = StreamingEngine(_dashboard(mp, device="cpu"), EngineConfig(buckets=BUCKETS, kernel_backend="megastep"))
    with peng:
        for _, p, t in traffic:
            peng.submit(torch.from_numpy(p), torch.from_numpy(t))
    assert peng.stats.kernel_fallbacks_by_reason() == {}
    _assert_same(peng.state(), jeng.state())
    _assert_same(peng.result(), jeng.result())


@pytest.mark.parametrize("paged", [False, True])
def test_dashboard_multistream_matches_jax(paged):
    traffic = _traffic(S, 14, 4)
    if paged:
        jeng = _jax_paged(_dashboard(mt), S, traffic)
    else:
        jeng = JaxMulti(_dashboard(mt), S, JaxConfig(buckets=BUCKETS, kernel_backend="xla", coalesce=1))
        with jeng:
            for sid, p, t in traffic:
                jeng.submit(sid, p, t)
    peng = _port_multi(_dashboard(mp, device="cpu"), S, traffic, paged)
    if paged:
        assert peng.stats.page_outs > 0 and (peng.stats.page_outs, peng.stats.page_ins) == (
            jeng.stats.page_outs, jeng.stats.page_ins)
    for sid in range(S):
        _assert_same(peng.stream_state(sid), jeng.stream_state(sid))
    _assert_same(peng.state(), jeng.state())
    _assert_same(peng.results(), jeng.results())


@pytest.mark.parametrize("num_streams", [S, 40])
@pytest.mark.parametrize("paged", [False, True])
def test_results_is_one_device_computation_for_any_s(num_streams, paged):
    traffic = _traffic(num_streams, 16, 3)
    peng = _port_multi(_dashboard(mp, device="cpu"), num_streams, traffic, paged)
    before = peng.stats.result_device_calls
    got = peng.results()
    assert peng.stats.result_device_calls == before + 1
    again = peng.results()
    assert peng.stats.result_device_calls == before + 2
    assert sorted(got) == list(range(num_streams))
    _assert_same(again, got)
    touched = {sid for sid, _, _ in traffic}
    assert len(touched) < num_streams  # never-touched streams are in the sample
    for sid in range(num_streams):
        _assert_same(got[sid], peng.result(sid))
    if paged:
        assert peng.pager.spilled_count() > 0
        jeng = _jax_paged(_dashboard(mt), num_streams, traffic)
    else:
        jeng = JaxMulti(_dashboard(mt), num_streams, JaxConfig(buckets=BUCKETS, kernel_backend="xla", coalesce=1))
        with jeng:
            for sid, p, t in traffic:
                jeng.submit(sid, p, t)
    _assert_same(got, jeng.results())


def test_paged_results_decode_q8_spills():
    """A compressing paged engine keeps spilled rows as q8 codes: the batched
    ``results()`` reads them through the row codec, as ``result()`` does."""
    traffic = _traffic(S, 16, 5)
    peng = _port_multi(_flagship_q8(mp, device="cpu"), S, traffic, paged=True, q8=True)
    spilled = peng.pager.spilled_streams(0)
    assert spilled and all(peng._row_codec.is_encoded(peng.pager.spilled_row(0, s)) for s in spilled)
    got = peng.results()
    for sid in range(S):
        _assert_same(got[sid], peng.result(sid))
    jeng = _jax_paged(_flagship_q8(mt), S, traffic, q8=True)
    _assert_same(got, jeng.results())


def test_paged_state_reassembles_every_stream():
    traffic = _traffic(S, 12, 6)
    peng = _port_multi(_dashboard(mp, device="cpu"), S, traffic, paged=True)
    stacked = peng.state()
    for sid in range(S):
        one = peng.stream_state(sid)
        _assert_same({k: {s: v[sid] for s, v in m.items()} for k, m in stacked.items()}, one)


def test_values_to_host_splits_one_transfer_by_leaf():
    values = {"f": torch.arange(12, dtype=torch.float32).reshape(4, 3), "b": torch.tensor([True, False, True, True]),
              "i": [torch.arange(4, dtype=torch.int32), torch.arange(8, dtype=torch.int64).reshape(4, 2)],
              "h": torch.ones(4, 2, 2, dtype=torch.bfloat16)}
    per_stream = _values_to_host(values, 4)
    assert len(per_stream) == 4
    for sid, got in enumerate(per_stream):
        assert torch.equal(got["f"], values["f"][sid]) and got["b"].item() == bool(values["b"][sid])
        assert got["i"][0].dtype == torch.int32 and torch.equal(got["i"][1], values["i"][1][sid])
        assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"], values["h"][sid])


def test_dashboard_arena_layout_matches_jax():
    """The dashboard's packing plan, element for element: JAX flattens dicts
    in sorted key order, and a port that did not would scramble spilled rows
    and bridged arenas."""
    from metrics_tpu.engine.megastep import flat_reductions as jax_flat_reductions
    from metrics_tpu_torch.engine import flat_reductions

    jc, pc = _dashboard(mt), _dashboard(mp, device="cpu")
    jl, pl = jc.arena_layout(), pc.arena_layout()
    spell = lambda layout: [(k, o, n, tuple(sh), str(dt).replace("torch.", ""))  # noqa: E731
                            for k, o, n, sh, dt in layout.leaf_slices()]
    assert spell(pl) == spell(jl)
    assert pl.buffer_sizes() == jl.buffer_sizes() == {"float32": 1, "int32": 3 * 4 * C + 2 + 3 * C * C + 1}
    assert flat_reductions(pc) == jax_flat_reductions(jc)
    traffic = _traffic(S, 3, 8)
    js, ps = jc.init_state(), pc.init_state()
    for _, p, t in traffic:
        js = jc.update_state(js, p, t)
        ps = pc.update_state(ps, torch.from_numpy(p), torch.from_numpy(t))
    jbuf, pbuf = jl.pack(js), pl.pack(ps)
    for k in jbuf:
        _assert_same(pbuf[k], np.asarray(jbuf[k]))
