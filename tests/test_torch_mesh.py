"""The port's mesh serving against the JAX package's, on the CPU.

The port's mesh is one process driving W shards (``parallel/mesh.py``); here
four shards on the CPU (the one-device layout), against JAX's engines on four
of the eight virtual CPU devices, fed the same numpy traffic:

* ``MeshConfig``/``Mesh``: JAX's names and checks, the two layouts, the
  refused mix;
* ``StreamingEngine`` under step and deferred sync (a narrow collection: 3
  classes, 10 thresholds), the port under ``"megastep"`` (K5's plain version
  on every shard) and ``"auto"``, JAX's under ``"xla"`` (JAX keeps its
  per-leaf kernels on a mesh);
* a ``q8_block`` state riding the deferred boundary merge as a whole state;
* the deferred unsharded and the stream-sharded ``MultiStreamEngine``, exact
  and q8-staged, with the same page-ins and page-outs;
* the scan strategy (``AUROC(capacity=N)``, ``AveragePrecision(capacity=N)``)
  under deferred sync, the boundary merge gathering the shards' buffers;
* the step builders of ``parallel/embedded.py``, and the mesh engine whose
  steps they are, against JAX's ``shard_map``-ped builders on one padded
  bucket;
* ``collective_counts()`` against ``fused_sync_plan``: a step-sync step
  issues the plan's collectives, a deferred step none, a boundary merge the
  plan's.

Integer states are bit-equal. The float states here are counts (BinnedAP's
TP/FP/FN) or sums of dyadic values, so they too are bit-equal, and the q8
merge, which quantizes each shard's whole state once, holds to JAX's within
rtol 1e-6 and to the exact merge within ``q8_sum_error_bound``. JAX's meshes
are built from ``jax.devices()[:4]`` directly (the ``devices`` fixture would
mark these tests slow).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import metrics_tpu as mt
import metrics_tpu.engine as je
import metrics_tpu_torch as mp
import metrics_tpu_torch.engine as pe
from metrics_tpu.engine.traffic import zipf_stream_ids
from metrics_tpu.parallel import embedded as jemb
from metrics_tpu_torch.parallel import embedded as pemb
from metrics_tpu_torch.parallel.collectives import (
    collective_counts,
    fused_sync_plan,
    q8_sum_error_bound,
    reset_collective_counts,
)
from metrics_tpu_torch.parallel.mesh import Mesh, MeshAxis, MeshConfig
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError, NotPortedError

W, C, S = 4, 3, 10
BUCKETS = (16, 64)


def _jmesh():
    return JaxMesh(np.asarray(jax.devices()[:W]), ("dp",))


def _pmesh(w=W):
    return MeshConfig(shape=(w,), devices=["cpu"] * w).make_mesh()


def _coll(m, q8=False, **kw):
    return m.MetricCollection({
        "acc": m.Accuracy(num_classes=C, average="macro", **kw),
        "f1": m.F1Score(num_classes=C, average="macro", **kw),
        "ap": m.BinnedAveragePrecision(num_classes=C, thresholds=10, sync_precision="q8_block" if q8 else None, **kw),
        "cm": m.ConfusionMatrix(num_classes=C, **kw),
    })


def _batches(n=14, seed=0, lo=3, hi=70):
    rng = np.random.RandomState(seed)
    out = []
    for k in rng.randint(lo, hi, n):
        p = rng.rand(k, C).astype(np.float32)
        out.append((p / p.sum(1, keepdims=True), rng.randint(0, C, k)))
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _same(got, want, path="", rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}", rtol)
        return
    if isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]", rtol)
        return
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if rtol and np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=path)
    else:
        assert np.array_equal(got, want), path


def _serve(eng, batches, submit=lambda e, b: e.submit(*b)):
    with eng:
        for b in batches:
            submit(eng, b)
    return eng


# ------------------------------------------------------------------------ the mesh


def test_mesh_config_and_layouts():
    cfg = MeshConfig(shape=(2, 2), axis_names=("a", "b"), sync_axis=("a", "b"), devices=["cpu"] * 4)
    mesh = cfg.make_mesh()
    assert mesh.shape == {"a": 2, "b": 2} and mesh.transport == "one_device" and mesh.size == 4
    ax = mesh.axis(("a", "b"))
    assert isinstance(ax, MeshAxis) and ax.world == 4
    assert MeshConfig.data_parallel(4, axis="x") == MeshConfig(shape=(4,), axis_names=("x",), sync_axis="x")
    assert MeshConfig.multi_slice(2, 2).axis_names == mt.parallel.mesh.MeshConfig.multi_slice(2, 2).axis_names
    with pytest.raises(ValueError, match="needs 4 devices"):
        MeshConfig(shape=(4,), devices=["cpu"] * 2).make_mesh()
    # the layout alone picks the transport: W distinct CUDA devices, or one device W times; a mix is refused
    assert Mesh(np.asarray([torch.device("cuda", i) for i in range(2)], dtype=object), ("dp",)).transport == "nccl"
    with pytest.raises(MetricsTPUUserError, match="mix layouts"):
        Mesh(np.asarray([torch.device("cuda", 0), torch.device("cuda", 0), torch.device("cuda", 1)], dtype=object),
             ("dp",))
    with pytest.raises(MetricsTPUUserError, match="sync axes"):
        mesh.axis("dp")


def test_mesh_refusals_as_jax():
    mesh = _pmesh()
    with pytest.raises(MetricsTPUUserError, match="needs a mesh"):
        pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(mesh_sync="deferred"))
    with pytest.raises(MetricsTPUUserError, match="mesh_sync must be"):
        pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(mesh=mesh, mesh_sync="sometimes"))
    with pytest.raises(MetricsTPUUserError, match="config.mesh must be a"):
        pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(mesh=_jmesh()))
    with pytest.raises(ValueError, match="not divisible"):
        pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(buckets=(6,), mesh=mesh))
    with pytest.raises(MetricsTPUUserError, match="no step-sync mesh form"):
        pe.MultiStreamEngine(_coll(mp, device="cpu"), S, pe.EngineConfig(mesh=mesh))
    # step sync refuses the scan members with JAX's reason; deferred sync serves them
    scan = lambda m, **kw: m.AUROC(num_classes=C, capacity=64, **kw)  # noqa: E731
    with pytest.raises(mt.utils.exceptions.MetricsTPUUserError) as jerr:
        je.StreamingEngine(scan(mt), je.EngineConfig(buckets=BUCKETS, mesh=_jmesh(), axis="dp"))
    with pytest.raises(MetricsTPUUserError) as perr:
        pe.StreamingEngine(scan(mp, device="cpu"), pe.EngineConfig(buckets=BUCKETS, mesh=mesh))
    assert str(perr.value) == str(jerr.value)
    pe.StreamingEngine(scan(mp, device="cpu"), pe.EngineConfig(buckets=BUCKETS, mesh=mesh, mesh_sync="deferred"))
    # a window needs deferred sync, with JAX's words; the deferred ring and the ragged engine serve
    with pytest.raises(mt.utils.exceptions.MetricsTPUUserError) as jerr:
        je.StreamingEngine(_coll(mt), je.EngineConfig(buckets=BUCKETS, mesh=_jmesh(), axis="dp",
                                                      window=je.WindowPolicy.sliding(pane_batches=2, n_panes=2)))
    with pytest.raises(MetricsTPUUserError) as perr:
        pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(
            buckets=BUCKETS, mesh=mesh, window=pe.WindowPolicy.sliding(pane_batches=2, n_panes=2)))
    assert str(perr.value) == str(jerr.value)
    pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(
        buckets=BUCKETS, mesh=mesh, mesh_sync="deferred", window=pe.WindowPolicy.sliding(pane_batches=2, n_panes=2)))
    pe.RaggedEngine(mp.RetrievalMAP(device="cpu"), 4, pe.EngineConfig(buckets=BUCKETS, mesh=mesh, mesh_sync="deferred"))
    # what waits for later slices
    with pytest.raises(NotPortedError, match="compilation_cache_dir"):
        pe.EngineConfig(compilation_cache_dir="x")


# ------------------------------------------------------------- the streaming engine


@pytest.mark.parametrize("mode", ["step", "deferred"])
def test_streaming_engine_equals_jax(mode):
    batches = _batches()
    j = _serve(je.StreamingEngine(_coll(mt), je.EngineConfig(buckets=BUCKETS, mesh=_jmesh(), axis="dp",
                                                               mesh_sync=mode, kernel_backend="xla")), batches)
    want, want_values = _np(j.state()), _np(j.result())
    single = _serve(pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(buckets=BUCKETS)), batches)
    for backend in ("megastep", None):
        p = _serve(pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(
            buckets=BUCKETS, mesh=_pmesh(), mesh_sync=mode, kernel_backend=backend)), batches)
        _same(_np(p.state()), want)
        _same(_np(p.result()), want_values, rtol=1e-6)  # the computes round apart in the last place
        _same(_np(p.state()), _np(single.state()))  # the port at world 1
        assert p.stats.summary()["mesh_sync"]["sync_payload_bytes"] == \
            j.stats.summary()["mesh_sync"]["sync_payload_bytes"]
        assert p.stats.summary()["mesh_sync"]["transport"] == "one_device"
        assert p.stats.kernel_fallbacks_by_reason() == {}


def test_q8_state_rides_the_boundary_merge_as_a_whole_state():
    batches = _batches(seed=3)
    j = _serve(je.StreamingEngine(_coll(mt, q8=True), je.EngineConfig(
        buckets=BUCKETS, mesh=_jmesh(), axis="dp", mesh_sync="deferred", kernel_backend="xla")), batches)
    p = _serve(pe.StreamingEngine(_coll(mp, q8=True, device="cpu"), pe.EngineConfig(
        buckets=BUCKETS, mesh=_pmesh(), mesh_sync="deferred", kernel_backend="megastep")), batches)
    exact = _serve(pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(
        buckets=BUCKETS, mesh=_pmesh(), mesh_sync="deferred")), batches)
    got, want = _np(p.state()), _np(j.state())
    _same(got, want, rtol=1e-6)
    split = p.stats.summary()["mesh_sync"]["sync_payload_bytes"]
    assert split == j.stats.summary()["mesh_sync"]["sync_payload_bytes"] and split["quantized"] > 0
    # the merge quantizes each shard's WHOLE state once: the bound of one quantized sum of the locals
    locals_ = p._layout.unpack_stacked(p._stacked_carried())["ap"]
    for k in ("TPs", "FPs", "FNs"):
        bound = q8_sum_error_bound(locals_[k])
        err = np.abs(got["ap"][k].astype(np.float64) - _np(exact.state())["ap"][k])
        assert np.all(err <= bound + 1e-6), k


def test_ladder_quantize_rung_forces_the_q8_policy_on_a_mesh_as_jax():
    """The ladder's ``quantize_sync`` rung: the blanket q8 policy while
    engaged (the same tag and payload split as JAX's), exact again after the
    release; a no-op without a mesh."""
    batches = _batches(n=6, seed=4)
    out = {}
    for name, e, coll, kw in (("jax", je, _coll(mt), dict(mesh=_jmesh(), axis="dp", kernel_backend="xla")),
                              ("port", pe, _coll(mp, device="cpu"), dict(mesh=_pmesh()))):
        eng = e.StreamingEngine(coll, e.EngineConfig(buckets=BUCKETS, mesh_sync="deferred", **kw))
        eng._engage_rung("quantize_sync")
        tag = eng._precision_tag
        state = _np(_serve(eng, batches).state())  # the merge rides the quantized bundle
        split = eng.stats.summary()["mesh_sync"]["sync_payload_bytes"]
        eng._release_rung("quantize_sync")
        out[name] = (tag, split, eng._precision_tag, state)
    (jt, js, jr, jstate), (pt, ps, pr, pstate) = out["jax"], out["port"]
    assert pt == jt != "exact" and pr == jr == "exact" and ps == js and ps["quantized"] > 0
    _same(pstate, jstate, rtol=1e-6)
    single = pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(buckets=BUCKETS))
    single._engage_rung("quantize_sync")
    assert single._precision_tag == "exact"


def test_collective_counts_equal_fused_sync_plan():
    batches = _batches(n=6)
    plan = fused_sync_plan(_coll(mp, device="cpu").sync_leaf_info(), W)["collectives"]
    for mode in ("step", "deferred"):
        eng = pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(buckets=BUCKETS, mesh=_pmesh(),
                                                                           mesh_sync=mode, coalesce=1))
        reset_collective_counts()
        _serve(eng, batches)
        steady = sum(collective_counts().values())
        assert steady == (plan * eng.steps if mode == "step" else 0), mode
        reset_collective_counts()
        eng.result()
        eng.state()  # the memo: one merge a state version
        assert sum(collective_counts().values()) == (plan if mode == "deferred" else 0), mode
        assert eng.stats.merges == (1 if mode == "deferred" else 0)


# -------------------------------------------------------------- multi-stream forms


def _ms_traffic(n=40, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for sid in zipf_stream_ids(S, n, alpha=1.05, seed=seed):
        k = int(rng.randint(1, 14))
        p = rng.rand(k, C).astype(np.float32)
        out.append((int(sid), p / p.sum(1, keepdims=True), rng.randint(0, C, k)))
    return out


def _ms_coll(m, q8=False, **kw):
    return m.MetricCollection({"acc": m.Accuracy(**kw), "cm": m.ConfusionMatrix(num_classes=C, **kw),
                               "ap": m.BinnedAveragePrecision(num_classes=C, thresholds=5,
                                                              sync_precision="q8_block" if q8 else None, **kw)})


@pytest.mark.parametrize("form", ["unsharded", "stream_shard", "stream_shard_q8"])
def test_multistream_equals_jax(form):
    q8 = form.endswith("q8")
    kw = {} if form == "unsharded" else dict(stream_shard=True, resident_streams=2)
    traffic = _ms_traffic()
    j = je.MultiStreamEngine(_ms_coll(mt, q8), S, je.EngineConfig(
        buckets=(8, 32), mesh=_jmesh(), axis="dp", mesh_sync="deferred", coalesce=1, kernel_backend="xla",
        compress_payloads=q8), **kw)
    with j:
        for b in traffic:
            j.submit(*b)
            j.flush()  # JAX's paged engine pages per flushed step
    want = _np(j.state())
    for backend in ("megastep", None):
        p = _serve(pe.MultiStreamEngine(_ms_coll(mp, q8, device="cpu"), S, pe.EngineConfig(
            buckets=(8, 32), mesh=_pmesh(), mesh_sync="deferred", coalesce=1, kernel_backend=backend,
            compress_payloads=q8), **kw), traffic)
        _same(_np(p.state()), want)
        assert (p.stats.page_ins, p.stats.page_outs) == (j.stats.page_ins, j.stats.page_outs)
        if form != "unsharded":
            assert {k: tuple(v.shape) for k, v in p._state.items()} == {k: tuple(v.shape) for k, v in j._state.items()}
            assert sum(x["page_outs"] for x in p.pages_by_shard()) == p.stats.page_outs > 0
        for sid in (0, 3, S - 1):
            _same(_np(p.result(sid)), _np(j.result(sid)), rtol=1e-6)


def test_scan_strategy_under_deferred_equals_jax():
    batches = _batches(n=8, seed=5)
    make = lambda m, cap=200, **kw: m.MetricCollection({  # noqa: E731
        "auroc": m.AUROC(num_classes=C, capacity=cap, **kw), "ap": m.AveragePrecision(num_classes=C, capacity=cap, **kw)})
    j = _serve(je.StreamingEngine(make(mt), je.EngineConfig(buckets=BUCKETS, mesh=_jmesh(), axis="dp",
                                                           mesh_sync="deferred", kernel_backend="xla")), batches)
    p = _serve(pe.StreamingEngine(make(mp, device="cpu"), pe.EngineConfig(buckets=BUCKETS, mesh=_pmesh(),
                                                                          mesh_sync="deferred")), batches)
    _same(_np(p.state()), _np(j.state()))  # the capacity buffers, gathered across shards
    assert p.state()["auroc"]["preds_buf"].shape[0] == W * 200
    _same(_np(p.result()), _np(j.result()), rtol=1e-6)
    eager = make(mp, cap=W * 200, device="cpu")  # the merged buffers' capacity: every row, in one metric
    for b in batches:
        eager.update(*(torch.from_numpy(x) for x in b))
    _same(_np(p.result()), _np(eager.compute()), rtol=1e-6)


# ------------------------------------------------------------------ step builders


def test_step_builders_equal_jax_shard_map():
    """One padded bucket through JAX's shard_map-ped builders, the port's,
    and the port's mesh engine, whose steps are those builders."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    (p, t), = _batches(n=1, seed=9, lo=40, hi=41)
    rows, bucket = len(t), 64
    engines = {mode: _serve(pe.StreamingEngine(_coll(mp, device="cpu"), pe.EngineConfig(
        buckets=(bucket,), mesh=_pmesh(), mesh_sync=mode, kernel_backend="megastep")), [(p, t)])
        for mode in ("step", "deferred")}
    mask = np.arange(bucket) < rows
    p = np.concatenate([p, np.zeros((bucket - rows, C), np.float32)])
    t = np.concatenate([t, np.zeros(bucket - rows, t.dtype)])
    jm, pm = _jmesh(), _pmesh()
    jc, pc = _coll(mt), _coll(mp, device="cpu")
    payload_abs = ((jax.ShapeDtypeStruct(p.shape, p.dtype), jax.ShapeDtypeStruct(t.shape, t.dtype)), {})
    mask_abs = jax.ShapeDtypeStruct(mask.shape, np.dtype(bool))
    shard = NamedSharding(jm, P("dp"))
    jpay = ((jax.device_put(p, shard), jax.device_put(t, shard)), {})
    jmask = jax.device_put(mask, shard)
    blocks = pemb.split_bucket(((torch.from_numpy(p), torch.from_numpy(t)), {}), torch.from_numpy(mask), pm, "dp")
    assert [int(m.sum()) for _, m in blocks] == [16, 16, 8, 0]  # P(axis)'s split: pad rows in the last shards
    # step sync: the replicated global state after one step, and the global token
    jstate, jtok = jax.jit(jemb.sharded_masked_step(jc, jm, "dp", payload_abs, mask_abs))(jc.init_state(), jpay, jmask)
    pstates, ptok = pemb.sharded_masked_step(pc, pm, "dp")([pc.init_state()] * W, blocks)
    _same(_np(pstates[0]), _np(jstate))
    _same(_np(engines["step"].state()), _np(jstate))
    assert int(ptok) == int(jtok) == rows
    # deferred: shard-local states, the (W,) token, then the boundary merge
    stacked_abs = jax.tree.map(lambda s: jax.ShapeDtypeStruct((W,) + tuple(s.shape), s.dtype), jc.abstract_state())
    jlocal = jax.tree.map(lambda x: np.stack([np.asarray(x)] * W), jc.init_state())
    update = lambda tree, payload, m: jc.update_state_masked(tree, *payload[0], mask=m, **payload[1])  # noqa: E731
    jnew, jtoks = jax.jit(jemb.sharded_local_step(update, jm, "dp", payload_abs, mask_abs, stacked_abs))(
        jlocal, jpay, jmask)
    pupdate = lambda tree, x, k: pc.update_state_masked(tree, *x[0][0], mask=x[1], **x[0][1])  # noqa: E731
    pnew, ptoks = pemb.sharded_local_step(pupdate, pm, "dp")([pc.init_state() for _ in range(W)], blocks)
    assert ptoks.tolist() == np.asarray(jtoks).tolist()
    eng = engines["deferred"]
    eng.flush()
    local = eng._layout.unpack_stacked(eng._stacked_carried())
    for k in range(W):
        want = _np(jax.tree.map(lambda x: x[k], jnew))
        _same(_np(pnew[k]), want)
        _same(_np(jax.tree.map(lambda x: x[k], local)), want)
    jmerged = jax.jit(jemb.sharded_state_merge(jc, jm, "dp", stacked_abs))(jnew)
    _same(_np(pemb.sharded_state_merge(pc, pm, "dp")(pnew)), _np(jmerged))
    _same(_np(eng.state()), _np(jmerged))
    err = pemb.boundary_merge_error("dp", W, RuntimeError("boom"))
    assert isinstance(err, pe.BoundaryMergeError) and "world=4" in str(err)
