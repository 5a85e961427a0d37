"""The engine's static plans, equal between the two packages.

For the flagship collection (Accuracy, macro F1, binned AP, confusion matrix;
binned AP under ``sync_precision="q8_block"``) the port's
``ArenaLayout.leaf_slices()``, ``column_ops()``, pack/unpack,
``flat_reductions`` and ``ArenaRowCodec`` masks and codes must be the JAX
package's, element for element: JAX flattens dicts in sorted key order, and a
port that took insertion order would scramble spilled rows and bridged
arenas. The pager, the bucketing policy and the codec are host numpy in both
packages and must agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.engine.bucketing import BucketPolicy as JaxPolicy
from metrics_tpu.engine.megastep import flat_reductions as jax_flat_reductions
from metrics_tpu.engine.paging import StreamPager as JaxPager
from metrics_tpu.engine.quantize import ArenaRowCodec as JaxCodec
from metrics_tpu.engine.traffic import zipf_stream_ids
from metrics_tpu_torch.engine import ArenaLayout, ArenaRowCodec, BucketPolicy, StreamPager, flat_reductions

C, T = 10, 100


def _flagship(m, **kw):
    return m.MetricCollection({
        "acc": m.Accuracy(**kw),
        "f1": m.F1Score(num_classes=C, average="macro", **kw),
        "binned_ap": m.BinnedAveragePrecision(num_classes=C, thresholds=T, sync_precision="q8_block", **kw),
        "confmat": m.ConfusionMatrix(num_classes=C, **kw),
    })


def _slices(layout):
    """leaf_slices with the dtype spelled by name (jnp and torch dtypes differ)."""
    return [(k, o, s, tuple(shape), str(dt).replace("torch.", "")) for k, o, s, shape, dt in layout.leaf_slices()]


@pytest.fixture(scope="module")
def pair():
    return _flagship(mt), _flagship(mp, device="cpu")


def test_leaf_slices_and_column_ops_match_jax(pair):
    jc, pc = pair
    jl, pl = jc.arena_layout(), pc.arena_layout()
    assert _slices(pl) == _slices(jl)
    assert pl.buffer_sizes() == jl.buffer_sizes() == {"float32": 3 * C * T, "int32": 6 + 4 * C + C * C}
    assert pl.dtype_keys == jl.dtype_keys
    # the order is sorted member names, then sorted state names
    assert [s[1] for s in _slices(pl)[:6]] == list(range(6))  # acc's six int32 scalars first
    assert flat_reductions(pc) == jax_flat_reductions(jc)
    leaf_ops = [("sum", "min", "max").index(f) for f in flat_reductions(pc)]
    jops, pops = jl.column_ops(leaf_ops), pl.column_ops(leaf_ops)
    assert set(jops) == set(pops) and all(np.array_equal(jops[k], pops[k]) for k in jops)
    # a mixed op row lands in the same columns in both packages
    mixed = [i % 3 for i in range(len(leaf_ops))]
    jops, pops = jl.column_ops(mixed), pl.column_ops(mixed)
    assert all(np.array_equal(jops[k], pops[k]) for k in jops)


def test_pack_and_unpack_match_jax(pair):
    jc, pc = pair
    rng = np.random.RandomState(0)
    p = rng.rand(64, C).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    t = rng.randint(0, C, 64)
    js = jc.update_state(jc.init_state(), jnp.asarray(p), jnp.asarray(t))
    ps = pc.update_state(pc.init_state(), torch.from_numpy(p), torch.from_numpy(t))
    jl, pl = jc.arena_layout(), pc.arena_layout()
    jbuf, pbuf = jl.pack(js), pl.pack(ps)
    for k in jbuf:
        assert np.array_equal(np.asarray(jbuf[k]), pbuf[k].numpy()), k
    back = pl.unpack(pbuf)
    for k, member in ps.items():
        for s, v in member.items():
            assert torch.equal(back[k][s], v)
    # the stacked form (the paged engine's slots) packs row-wise, the same way
    stacked = jax.tree.map(lambda x: jnp.stack([x, 2 * x]), js)
    jst = jl.pack_stacked(stacked)
    pst = pl.pack_stacked({k: {s: torch.stack([v, 2 * v]) for s, v in m.items()} for k, m in ps.items()})
    for k in jst:
        assert np.array_equal(np.asarray(jst[k]), pst[k].numpy())
    assert pl.fingerprint() == ArenaLayout.for_state(pc.abstract_state()).fingerprint()
    copy = ArenaLayout.clone_buffers(pbuf)
    assert all(torch.equal(copy[k], pbuf[k]) and copy[k].data_ptr() != pbuf[k].data_ptr() for k in pbuf)


def test_row_codec_matches_jax(pair):
    jc, pc = pair
    jcod, pcod = JaxCodec.for_metric(jc), ArenaRowCodec.for_metric(pc)
    assert set(pcod.q_mask) == set(jcod._q_mask) == {"float32"}
    assert np.array_equal(pcod.q_mask["float32"], jcod._q_mask["float32"])
    rng = np.random.RandomState(1)
    rows = {"float32": (rng.rand(5, 3 * C * T) * 40).astype(np.float32),
            "int32": rng.randint(0, 99, (5, 146)).astype(np.int32)}
    jenc, penc = jcod.encode_buffers(rows), pcod.encode_buffers(rows)
    assert set(jenc) == set(penc)
    for k in jenc:
        assert np.array_equal(jenc[k], penc[k]), k
    jdec, pdec = jcod.decode_buffers(jenc), pcod.decode_buffers(penc)
    for k in jdec:
        assert np.array_equal(jdec[k], pdec[k]), k
    jseed, jst = jcod.stage_buffers(jenc, ("float32",))
    pseed, pst = pcod.stage_buffers(penc, ("float32",))
    for k in jseed:
        assert np.array_equal(jseed[k], pseed[k])
    for a, b in zip(jst["float32"], pst["float32"]):
        assert np.array_equal(a, b)
    # the staged decode (K7's arithmetic) reproduces the host decode bit for bit
    codes, scales = pst["float32"]
    on = pcod.q_mask["float32"]
    assert np.array_equal((codes.astype(np.float32) * scales)[:, on], pdec["float32"][:, on])
    # a policy that quantizes nothing has no codec
    assert ArenaRowCodec.for_metric(mp.ConfusionMatrix(num_classes=C, device="cpu")) is None


def test_pager_gives_the_same_op_sequence_as_jax():
    ids = zipf_stream_ids(50, 400, alpha=1.05, seed=3)
    jpg, ppg = JaxPager(1, 8), StreamPager(1, 8)
    for lo in range(0, len(ids), 5):
        streams = [int(x) for x in ids[lo:lo + 5]]
        (jops, jh, jf), (pops, ph, pf) = jpg.plan_residency(0, streams), ppg.plan_residency(0, streams)
        assert [repr(o) for o in jops] == [repr(o) for o in pops] and (jh, jf) == (ph, pf)
        rows = {(0, o.stream): {"float32": np.full(3, o.stream, np.float32)} for o in jops if o.kind == "evict"}
        jpg.commit(jops, rows)
        ppg.commit(pops, rows)
        jpg.touch(0, streams)
        ppg.touch(0, streams)
    assert jpg.tenancy_stats() == ppg.tenancy_stats()
    assert ppg.spilled_count() > 0
    jpay, ppay = jpg.snapshot_payload(), ppg.snapshot_payload()
    assert set(jpay) == set(ppay) and all(np.array_equal(jpay[k], ppay[k]) for k in jpay)
    fresh = StreamPager(1, 8)
    fresh.load_payload(jpay)
    # (a loaded pager's LRU order is its slot order: compare the sets)
    assert set(fresh.resident_streams(0)) == set(ppg.resident_streams(0))
    assert fresh.spilled_streams(0) == ppg.spilled_streams(0)


def test_bucket_policy_matches_jax():
    jp, pp = JaxPolicy((256, 1024), pad_value=0), BucketPolicy((1024, 256), pad_value=0)
    for n in (1, 255, 256, 257, 1024, 1025, 10_000):
        assert pp.chunks(n) == jp.chunks(n)
    p = np.arange(30, dtype=np.float32).reshape(10, 3)
    t = np.arange(10)
    ja, jkw, jm = jp.pad_chunk((p, t), {}, 2, 9, 256)
    pa, pkw, pm = pp.pad_chunk((torch.from_numpy(p), t), {}, 2, 9, 256)
    assert np.array_equal(jm, pm) and pm.sum() == 7
    assert np.array_equal(np.asarray(ja[0]), pa[0].numpy()) and np.array_equal(np.asarray(ja[1]), pa[1])
    with pytest.raises(ValueError, match="ambiguous"):
        pp.pad_chunk((p, np.zeros(256)), {}, 0, 10, 256)
