"""The port's wrappers and nested child metrics against the JAX package, on
the CPU.

``MinMaxMetric`` (both semantics), ``MultioutputWrapper`` (with and without
NaN removal, numpy inputs), ``BootStrapper`` (poisson: the same seeded numpy
draws, replicas bit-equal to JAX's; multinomial: held by an oracle that
redraws the indices from a generator in the same state, its statistics held
against JAX's on the same child states) and ``MetricTracker``, eager; then
the nested-metric runtime the wrappers ride: the strategies and their
reasons, masked and segmented updates (JAX under ``"xla"``), states with a
``"_children"`` subtree crossing the state bridge, ``state_dict`` keys, the
megastep op row and the q8 precisions over child leaves, the q8 tree codec,
``.to()``/``astype`` moving the defaults, and the engines serving a wrapper
collection (the JAX engine's arena seated in the port's).

Tolerances: integer states (children included, ``draw_count`` too) bit-exact;
f32 values within ``rtol=1e-6`` plus ``atol=1e-6`` (both packages compute the
same f32 ratios of the same counts; the bootstrap mean and std add ten
values in f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.engine import EngineConfig as JaxConfig
from metrics_tpu.engine import StreamingEngine as JaxStreaming
from metrics_tpu.engine.megastep import flat_reductions as jax_flat_reductions
from metrics_tpu.engine.quantize import _flat_precisions as jax_flat_precisions
from metrics_tpu.engine.quantize import decode_state_tree as jax_decode_tree
from metrics_tpu.engine.quantize import encode_state_tree as jax_encode_tree
from metrics_tpu.ops.kernels import use_backend
from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine, flat_reductions
from metrics_tpu_torch.engine.quantize import ArenaRowCodec, _flat_precisions, decode_state_tree, encode_state_tree
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.state_bridge import engine_state_from_numpy, state_from_numpy, state_to_numpy
from metrics_tpu_torch.utils.tree import tree_leaves, tree_map

RTOL = ATOL = 1e-6
C = 4
FULL_STATE = "full_state_update"


def _rows(n, seed, heads=None):
    """``n`` rows of class probabilities (``(n, C)``, or ``(n, C, heads)``)
    and labels (``(n,)`` or ``(n, heads)``)."""
    rng = np.random.RandomState(seed)
    shape = (n, C) if heads is None else (n, C, heads)
    p = rng.rand(*shape).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    return p, rng.randint(0, C, (n,) if heads is None else (n, heads))


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree(got, want, path=""):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree(g, w, f"{path}[{i}]")
    else:
        assert got.shape == want.shape and got.dtype == want.dtype, (path, got.dtype, want.dtype, got.shape)
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=path)


def _both(build):
    """The JAX metric and the port's, built by ``build(pkg, device_kwargs)``."""
    return build(mt, {}), build(mp, {"device": "cpu"})


WRAPPERS = {
    "minmax": lambda m, kw: m.MinMaxMetric(m.F1Score(num_classes=C, average="macro", **kw)),
    "minmax_fold_on_compute": lambda m, kw: m.MinMaxMetric(m.Accuracy(**kw), fold_on_compute=True),
    "multioutput_remove_nans": lambda m, kw: m.MultioutputWrapper(m.Accuracy(num_classes=C, **kw), num_outputs=2),
    "multioutput_keep_nans": lambda m, kw: m.MultioutputWrapper(m.Accuracy(num_classes=C, **kw), num_outputs=2,
                                                                remove_nans=False),
    "boot_poisson": lambda m, kw: m.BootStrapper(m.Accuracy(num_classes=C, **kw), num_bootstraps=3, seed=1),
    "boot_multinomial": lambda m, kw: m.BootStrapper(m.Accuracy(num_classes=C, **kw), num_bootstraps=3,
                                                     sampling_strategy="multinomial", seed=1),
    "composition": lambda m, kw: (lambda p, r: 2 * p * r / (p + r))(
        m.Precision(num_classes=C, average="macro", **kw), m.Recall(num_classes=C, average="macro", **kw)),
    "minmax_of_bootstrap": lambda m, kw: m.MinMaxMetric(m.BootStrapper(m.Accuracy(**kw), num_bootstraps=2, seed=0)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_strategies_and_reasons_match_jax(name):
    jm, pm = _both(WRAPPERS[name])
    assert pm.masked_update_strategy() == jm.masked_update_strategy()
    assert pm.segmented_update_unsupported_reason() == jm.segmented_update_unsupported_reason()
    assert pm.masked_update_unsupported_reason() == jm.masked_update_unsupported_reason()
    assert pm._states_mergeable == jm._states_mergeable
    assert sorted(pm._child_metrics()) == sorted(jm._child_metrics())
    assert jax.tree_util.tree_structure(jm.abstract_state()).num_leaves == len(tree_leaves(pm.abstract_state()))


@pytest.mark.parametrize("fold_on_compute", [False, True])
def test_minmax_matches_jax(fold_on_compute):
    jm, pm = _both(lambda m, kw: m.MinMaxMetric(m.F1Score(num_classes=C, average="macro", **kw),
                                                fold_on_compute=fold_on_compute))
    for seed in range(3):
        p, t = _rows(16 + 8 * seed, seed)
        pm.update(p, t)
        jm.update(jnp.asarray(p), jnp.asarray(t))
    _assert_tree(pm.compute(), jm.compute())
    _assert_tree(pm._pack_state(), jm._pack_state())
    # forward keeps the snapshot path (full_state_update) in both
    p, t = _rows(12, 9)
    _assert_tree(pm(p, t), jm(jnp.asarray(p), jnp.asarray(t)))
    _assert_tree(pm.compute(), jm.compute())
    pm.reset()
    assert float(pm.min_val) == np.inf and int(pm._base_metric.tp.sum()) == 0


@pytest.mark.parametrize("remove_nans", [True, False])
@pytest.mark.parametrize("numpy_inputs", [True, False])
def test_multioutput_matches_jax(remove_nans, numpy_inputs):
    jm, pm = _both(lambda m, kw: m.MultioutputWrapper(m.Accuracy(num_classes=C, **kw), num_outputs=2,
                                                      remove_nans=remove_nans))
    p, t = _rows(20, 3, heads=2)
    if remove_nans:
        p[[2, 7], :, 0] = np.nan  # rows 2 and 7 of head 0, row 11 of head 1
        p[11, :, 1] = np.nan
    as_port = (lambda x: x) if numpy_inputs else torch.from_numpy
    pm.update(as_port(p), as_port(t))
    jm.update(jnp.asarray(p), jnp.asarray(t))
    _assert_tree(pm._pack_state(), jm._pack_state())
    _assert_tree(pm.compute(), jm.compute())
    if remove_nans:
        assert int(pm.metrics[0].tp + pm.metrics[0].fn) == 18 and int(pm.metrics[1].tp + pm.metrics[1].fn) == 19
    q, u = _rows(8, 4, heads=2)
    _assert_tree(pm(as_port(q), as_port(u)), jm(jnp.asarray(q), jnp.asarray(u)))
    _assert_tree(pm.compute(), jm.compute())


def test_multioutput_remove_nans_masked_update_raises_as_in_jax():
    jm, pm = _both(WRAPPERS["multioutput_remove_nans"])
    assert pm.masked_update_strategy() == jm.masked_update_strategy() == "delta"
    p, t = _rows(8, 5, heads=2)
    mask = np.arange(8) < 6
    with use_backend("xla"), pytest.raises(Exception, match="NonConcrete|[Bb]oolean"):
        jm.update_state_masked(jm.init_state(), jnp.asarray(p), jnp.asarray(t), mask=jnp.asarray(mask))
    with pytest.raises(RuntimeError, match="dynamic shape"):
        pm.update_state_masked(pm.init_state(), torch.from_numpy(p), torch.from_numpy(t), mask=torch.from_numpy(mask))


def test_poisson_bootstrapper_replicas_equal_jax():
    """Both packages draw from ``np.random.RandomState(seed)`` in the same
    order: the replicas are bit-equal."""
    jm, pm = _both(lambda m, kw: m.BootStrapper(m.Accuracy(num_classes=C, **kw), num_bootstraps=5, quantile=0.25,
                                                raw=True, seed=11))
    for seed in range(3):
        p, t = _rows(24, seed)
        pm.update(p, t)
        jm.update(jnp.asarray(p), jnp.asarray(t))
    _assert_tree(pm._pack_state(), jm._pack_state())
    _assert_tree(pm.compute(), jm.compute())
    # forward: the batch's delta (the same draws) merged into the state
    p, t = _rows(16, 5)
    _assert_tree(pm(p, t), jm(jnp.asarray(p), jnp.asarray(t)))
    _assert_tree(pm._pack_state(), jm._pack_state())


def test_multinomial_bootstrapper_matches_its_oracle_and_jax_statistics():
    """Replica ``i`` equals its base metric fed ``x[idx_i]``, with ``idx_i``
    drawn again from a generator in the same state; the statistics (mean,
    std with ddof 1, quantile, raw) equal JAX's on the same child states."""
    pm = mp.BootStrapper(mp.Accuracy(num_classes=C, device="cpu"), num_bootstraps=4, quantile=0.75, raw=True,
                         sampling_strategy="multinomial", seed=3)
    gen = torch.Generator()
    gen.set_state(pm._generator.get_state())
    refs = [mp.Accuracy(num_classes=C, device="cpu") for _ in range(4)]
    for seed in range(2):
        p, t = map(torch.from_numpy, _rows(32, seed))
        pm.update(p, t)
        for ref in refs:
            idx = torch.randint(0, 32, (32,), generator=gen)
            ref.update(p[idx], t[idx])
    for m, ref in zip(pm.metrics, refs):
        _assert_tree(m._pack_state(), ref._pack_state())
    assert pm.draw_count.dtype == torch.uint32 and int(pm.draw_count.view(torch.int32)) == 2
    jm = mt.BootStrapper(mt.Accuracy(num_classes=C), num_bootstraps=4, quantile=0.75, raw=True,
                         sampling_strategy="multinomial", seed=3)
    state = state_to_numpy(pm._pack_state())
    jm.restore_host_compute_attrs(pm.host_compute_attrs())
    _assert_tree(pm.compute(), jm.compute_from(jax.tree.map(jnp.asarray, state)))
    # a batch of one row draws nothing: the resample of one row is that row
    before = pm._generator.get_state()
    single = pm.update_state(pm.init_state(), torch.from_numpy(_rows(1, 7)[0]), torch.tensor([2]))
    assert torch.equal(pm._generator.get_state(), before)
    plain = mp.Accuracy(num_classes=C, device="cpu")
    want = plain.update_state(plain.init_state(), torch.from_numpy(_rows(1, 7)[0]), torch.tensor([2]))
    for child in single["_children"]["metrics"]:
        _assert_tree(child, want)


def test_metric_tracker_single_metric_matches_jax():
    jt = mt.MetricTracker(mt.Accuracy(num_classes=C), maximize=True)
    pt = mp.MetricTracker(mp.Accuracy(num_classes=C, device="cpu"), maximize=True)
    for epoch in range(3):
        jt.increment()
        pt.increment()
        p, t = _rows(24, 10 + epoch)
        jt.update(jnp.asarray(p), jnp.asarray(t))
        pt.update(p, t)
        _assert_tree(pt.compute(), jt.compute())
    _assert_tree(pt.compute_all(), jt.compute_all())
    assert pt.best_metric(return_step=True) == jt.best_metric(return_step=True)
    assert pt.n_steps == jt.n_steps == 3
    with pytest.raises(ValueError, match="cannot be called before"):
        mp.MetricTracker(mp.Accuracy(device="cpu")).compute()


def test_metric_tracker_collection_matches_jax():
    def coll(m, kw):
        return m.MetricCollection({"p": m.Precision(num_classes=C, average="macro", **kw),
                                   "r": m.Recall(num_classes=C, average="macro", **kw)})

    jt = mt.MetricTracker(coll(mt, {}), maximize=[True, False])
    pt = mp.MetricTracker(coll(mp, {"device": "cpu"}), maximize=[True, False])
    for epoch in range(3):
        jt.increment()
        pt.increment()
        p, t = _rows(20, 20 + epoch)
        _assert_tree(pt(p, t), jt(jnp.asarray(p), jnp.asarray(t)))
    _assert_tree(pt.compute_all(), jt.compute_all())
    assert pt.best_metric(return_step=True) == jt.best_metric(return_step=True)
    assert pt.best_metric() == jt.best_metric()


def _wrapper_collection(m, kw, heads=False):
    """A collection of wrappers over one call signature: single-head rows, or
    two-head rows (``heads=True``) for the multioutput members."""
    if heads:
        return m.MetricCollection({
            "multi_acc": m.MultioutputWrapper(m.Accuracy(num_classes=C, **kw), num_outputs=2, remove_nans=False),
            "multi_f1": m.MultioutputWrapper(m.F1Score(num_classes=C, average="macro", **kw), num_outputs=2,
                                             remove_nans=False),
        })
    return m.MetricCollection({
        "acc": m.Accuracy(**kw),
        "f1_composed": WRAPPERS["composition"](m, kw),
        "boot": m.BootStrapper(m.Accuracy(num_classes=C, **kw), num_bootstraps=3, sampling_strategy="multinomial",
                               seed=0),
        "boot_poisson": m.BootStrapper(m.Accuracy(num_classes=C, **kw), num_bootstraps=2, seed=4),
    })


@pytest.mark.parametrize("heads", [False, True], ids=["single_head", "two_heads"])
def test_wrapper_collection_masked_and_segmented_match_jax(heads):
    jc, pc = _wrapper_collection(mt, {}, heads), _wrapper_collection(mp, {"device": "cpu"}, heads)
    p, t = _rows(24, 6, heads=2 if heads else None)
    p[17:] = np.nan  # garbage in the masked rows
    t[17:] = C + 3
    mask = np.arange(24) < 17
    ids = np.random.RandomState(6).randint(0, 3, 24).astype(np.int32)
    with use_backend("xla"):
        want = jc.update_state_masked(jc.init_state(), jnp.asarray(p), jnp.asarray(t), mask=jnp.asarray(mask))
        stacked = jax.tree.map(lambda x: jnp.stack([x] * 3), jc.init_state())
        want_seg = jc.update_state_segmented(stacked, jnp.asarray(p), jnp.asarray(t), mask=jnp.asarray(mask),
                                             segment_ids=jnp.asarray(ids), num_segments=3)
    got = pc.update_state_masked(pc.init_state(), torch.from_numpy(p), torch.from_numpy(t),
                                 mask=torch.from_numpy(mask))
    _assert_tree(got, jax.tree.map(np.asarray, want))
    got_seg = pc.update_state_segmented(tree_map(lambda x: torch.stack([x] * 3), pc.init_state()),
                                        torch.from_numpy(p), torch.from_numpy(t), mask=torch.from_numpy(mask),
                                        segment_ids=torch.from_numpy(ids), num_segments=3)
    _assert_tree(got_seg, jax.tree.map(np.asarray, want_seg))
    if not heads:  # every valid row drew once; each replica saw each valid row once
        assert int(got["boot"]["draw_count"].view(torch.int32)) == 17
        for child in got["boot"]["_children"]["metrics"]:
            _assert_tree(child, got["boot"]["_children"]["metrics"][0])


@pytest.mark.parametrize("name", ["minmax", "multioutput_keep_nans", "boot_poisson", "composition"])
def test_jax_wrapper_state_seats_in_the_port(name):
    jm, pm = _both(WRAPPERS[name])
    p, t = _rows(30, 8, heads=2 if name.startswith("multi") else None)
    jm.update(jnp.asarray(p), jnp.asarray(t))
    np_state = jax.tree.map(np.asarray, jm._pack_state())
    state = state_from_numpy(pm, np_state, device="cpu", host_attrs=jm.host_compute_attrs())
    _assert_tree(state_to_numpy(state), np_state)
    _assert_tree(pm.compute_from(state), jm.compute_from(jm._pack_state()))
    missing = {k: v for k, v in np_state.items() if k != "_children"}
    with pytest.raises(KeyError, match="_children"):
        state_from_numpy(pm, missing, device="cpu")


@pytest.mark.parametrize("name", ["minmax", "multioutput_keep_nans", "boot_poisson"])
def test_state_dict_round_trip_jax_port_jax(name):
    jm, pm = _both(WRAPPERS[name])
    jm.persistent(True)
    pm.persistent(True)
    p, t = _rows(28, 12, heads=2 if name.startswith("multi") else None)
    jm.update(jnp.asarray(p), jnp.asarray(t))
    jsd = jm.state_dict()
    pm.load_state_dict(jsd)
    psd = pm.state_dict()
    assert sorted(psd) == sorted(jsd)
    back, _ = _both(WRAPPERS[name])
    back.load_state_dict({k: v.numpy() for k, v in psd.items()})
    back.restore_host_compute_attrs(jm.host_compute_attrs())
    pm.restore_host_compute_attrs(jm.host_compute_attrs())
    _assert_tree(back._pack_state(), jm._pack_state())
    _assert_tree(pm.compute(), jm.compute())


def test_op_row_and_precisions_cover_child_leaves():
    """The megastep op row and the q8 precision list recurse into children
    exactly as JAX's do, so they line up with the arena layout's leaves."""
    def coll(m, kw):
        c = _wrapper_collection(m, kw)
        c.add_metrics({"multi_ap": m.MultioutputWrapper(
            m.BinnedAveragePrecision(num_classes=C, thresholds=5, sync_precision="q8_block", **kw), num_outputs=2,
            output_dim=0, remove_nans=False)})
        return c

    jc, pc = coll(mt, {}), coll(mp, {"device": "cpu"})
    layout = pc.arena_layout()
    assert flat_reductions(pc) == jax_flat_reductions(jc)
    assert len(flat_reductions(pc)) == layout.num_leaves == len(jc.arena_layout().leaf_slices())
    assert _flat_precisions(pc) == jax_flat_precisions(jc)
    assert "q8_block" in _flat_precisions(pc)
    assert pc.state_sync_precisions() == jc.state_sync_precisions()
    codec = ArenaRowCodec.for_metric(pc)
    assert codec is not None and set(codec.q_mask) == {"float32"}
    # the tree form: each package decodes the other's compressed wrapper state
    rng = np.random.RandomState(13)
    pstate = tree_map(lambda x: torch.from_numpy(rng.rand(*x.shape).astype(np.float32) * 50).to(x.dtype)
                      if x.is_floating_point() else x, pc.init_state())
    enc = encode_state_tree(pc, pstate)
    jenc = jax_encode_tree(jc, jax.tree.map(jnp.asarray, state_to_numpy(pstate)))
    _assert_tree(decode_state_tree(enc), jax.tree.map(np.asarray, jax_decode_tree(jenc)))
    _assert_tree(decode_state_tree(jax.tree.map(np.asarray, jenc)), jax_decode_tree(_np(enc)))


def test_to_and_astype_move_defaults_and_device():
    """``.to()`` moves states, the defaults ``reset`` restores, and
    ``self.device``, through every nested metric; ``astype`` casts the float
    ones."""
    pm = mp.MinMaxMetric(mp.BootStrapper(mp.Accuracy(device="cpu"), num_bootstraps=2))
    pm.to("meta")
    pm.reset()
    for m in (pm, pm._base_metric, pm._base_metric.metrics[1]):
        assert m.device.type == "meta"
        assert all(v.device.type == "meta" for v in m._defaults.values())
        assert all(getattr(m, k).device.type == "meta" for k in m._defaults)
    cast = mp.MinMaxMetric(mp.Accuracy(device="cpu"))
    assert cast.to_device("cpu") is cast
    cast.astype(torch.float64)
    cast.reset()
    assert cast.min_val.dtype == torch.float64 and cast._base_metric.tp.dtype == torch.int32


def _traffic(n_batches, seed, heads=None):
    rng = np.random.RandomState(seed)
    return [_rows(int(rng.randint(1, 14)), seed * 100 + i, heads) for i in range(n_batches)]


def _eager_oracle(batches):
    """The served collection's state from the port's plain updates: the
    engines fold batch-of-1 rows, so every bootstrap replica sees each row
    once and ``draw_count`` counts the rows."""
    ref = _wrapper_collection(mp, {"device": "cpu"})
    state = ref.init_state()
    for p, t in batches:
        for i in range(len(t)):
            state = ref.update_state(state, torch.from_numpy(p[i:i + 1]), torch.from_numpy(t[i:i + 1]))
    return state


def test_streaming_engine_serves_wrappers_like_jax():
    """A JAX megastep engine and the port's over the wrapper collection:
    states equal, equal to the per-row oracle; the JAX engine's arena seats
    in the port's engine (the two lay out child leaves alike)."""
    batches = _traffic(6, 1)
    jeng = JaxStreaming(_wrapper_collection(mt, {}), JaxConfig(buckets=(8, 32), kernel_backend="megastep_interpret"))
    with jeng:
        for p, t in batches:
            jeng.submit(p, t)
    pc = _wrapper_collection(mp, {"device": "cpu"})
    peng = StreamingEngine(pc, EngineConfig(buckets=(8, 32), kernel_backend="megastep"))
    with peng:
        for p, t in batches:
            peng.submit(torch.from_numpy(p), torch.from_numpy(t))
    assert peng.stats.kernel_fallbacks_by_reason() == jeng.stats.kernel_fallbacks_by_reason() == {}
    # a served poisson BootStrapper replays the host draws its step was traced
    # or captured with (one per program in JAX, one per step eagerly here):
    # its states are held in the masked and segmented test, not here
    want = {k: v for k, v in jax.tree.map(np.asarray, jeng.state()).items() if k != "boot_poisson"}
    got = {k: v for k, v in peng.state().items() if k != "boot_poisson"}
    _assert_tree(got, want)
    oracle = _eager_oracle(batches)
    del oracle["boot_poisson"]
    _assert_tree(got, oracle)
    # (JAX's result() of the whole collection can fail here: a poisson replica
    # that drew no row never latched its Accuracy's input mode)
    jboot = jeng._metric["boot"]
    _assert_tree(peng.result()["boot"], jboot.compute_from(jeng.state()["boot"]))
    twin = StreamingEngine(_wrapper_collection(mp, {"device": "cpu"}),
                           EngineConfig(buckets=(8, 32), kernel_backend="megastep"))
    engine_state_from_numpy(twin, {k: np.asarray(v) for k, v in jeng._state.items()},
                            jeng.arena_layout.leaf_slices(), host_attrs=jeng._metric.host_compute_attrs())
    _assert_tree(twin.state(), jax.tree.map(np.asarray, jeng.state()))
    assert "uint32" in twin.arena_layout.dtype_keys  # draw_count keeps JAX's dtype


@pytest.mark.parametrize("paged", [False, True], ids=["unsharded", "paged"])
def test_multistream_engines_serve_wrappers(paged):
    """Each stream's state (the uint32 ``draw_count`` paged in and out with
    the rest) equals the per-row oracle over its rows."""
    rng = np.random.RandomState(2)
    batches = _traffic(10, 2)
    sids = rng.randint(0, 5, len(batches))
    kw = {"stream_shard": True, "resident_streams": 2} if paged else {}
    eng = MultiStreamEngine(_wrapper_collection(mp, {"device": "cpu"}), 5,
                            EngineConfig(buckets=(8, 32), kernel_backend="megastep", coalesce=1), **kw)
    for sid, (p, t) in zip(sids, batches):
        eng.submit(int(sid), torch.from_numpy(p), torch.from_numpy(t))
    eng.flush()
    if paged:
        assert eng.stats.page_outs > 0 and eng.stats.kernel_fallbacks_by_reason() == {}
    for sid in range(5):
        want = _eager_oracle([b for s, b in zip(sids, batches) if s == sid])
        got = eng.stream_state(sid)
        del want["boot_poisson"], got["boot_poisson"]
        _assert_tree(got, want)
    values = eng.results()
    for sid in range(5):
        _assert_tree(values[sid], eng.result(sid))


def test_engines_refuse_minmax_with_jax_reason():
    pm = mp.MetricCollection({"mm": mp.MinMaxMetric(mp.Accuracy(device="cpu"))})
    jreason = mt.MinMaxMetric(mt.Accuracy()).masked_update_unsupported_reason()
    assert jreason.startswith(FULL_STATE)
    with pytest.raises(MetricsTPUUserError, match=jreason):
        StreamingEngine(pm, EngineConfig(buckets=(8,)))
    for kw in ({}, {"stream_shard": True, "resident_streams": 2}):
        with pytest.raises(MetricsTPUUserError, match=FULL_STATE):
            MultiStreamEngine(pm, 4, EngineConfig(buckets=(8,), kernel_backend="megastep"), **kw)


def _list_wrapper(m, container):
    """A user's own wrapper that holds its inner metrics in a plain list (or
    tuple) attribute, written the same way on both packages."""

    class Pair(m.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.inner = container([m.MeanSquaredError(**kwargs), m.MeanAbsoluteError(**kwargs)])

        def update(self, preds, target):
            for metric in self.inner:
                metric.update(preds, target)

        def compute(self):
            return {"mse": self.inner[0].compute(), "mae": self.inner[1].compute()}

    return Pair


def _regression_rows(n, seed):
    rng = np.random.RandomState(seed)
    t = rng.gamma(2.0, 1.0, n).astype(np.float32)
    return (t * np.exp(rng.normal(0.0, 0.3, n))).astype(np.float32), t


@pytest.mark.parametrize("container", [list, tuple], ids=["list", "tuple"])
def test_plain_list_of_metrics_is_a_child_as_in_jax(container):
    """The state tree, eager values and ``state_dict`` keys of a wrapper
    holding a plain list or tuple equal JAX's; the port holds it as an
    ``nn.ModuleList``, so ``.to()`` and ``astype`` follow it."""
    jm, pm = _list_wrapper(mt, container)(), _list_wrapper(mp, container)(device="cpu")
    assert isinstance(pm.inner, torch.nn.ModuleList) and sorted(pm._child_metrics()) == ["inner"]
    _assert_tree(pm.init_state(), jm.init_state())
    assert len(pm.init_state()["_children"]["inner"]) == 2
    assert pm.masked_update_strategy() == jm.masked_update_strategy() == "delta"
    for seed in range(2):
        p, t = _regression_rows(12 + seed, seed)
        pm.update(p, t)
        jm.update(jnp.asarray(p), jnp.asarray(t))
    _assert_tree(pm._pack_state(), jm._pack_state())
    _assert_tree(pm.compute(), jm.compute())
    p, t = _regression_rows(5, 7)
    _assert_tree(pm(p, t), jm(jnp.asarray(p), jnp.asarray(t)))
    jm.persistent(True)
    pm.persistent(True)
    assert sorted(pm.state_dict()) == sorted(jm.state_dict()) == [
        "inner.0.sum_squared_error", "inner.0.total", "inner.1.sum_abs_error", "inner.1.total"]
    pm.astype(torch.float64)
    assert pm.inner[0].sum_squared_error.dtype == torch.float64 and pm.inner[1].total.dtype == torch.int32


@pytest.mark.parametrize("container", [list, tuple], ids=["list", "tuple"])
def test_plain_list_child_masked_fold_matches_jax(container):
    jm, pm = _list_wrapper(mt, container)(), _list_wrapper(mp, container)(device="cpu")
    p, t = _regression_rows(20, 3)
    p[14:] = np.nan  # garbage in the masked rows
    mask = np.arange(20) < 14
    with use_backend("xla"):
        want = jm.update_state_masked(jm.init_state(), jnp.asarray(p), jnp.asarray(t), mask=jnp.asarray(mask))
    got = pm.update_state_masked(pm.init_state(), torch.from_numpy(p), torch.from_numpy(t),
                                 mask=torch.from_numpy(mask))
    _assert_tree(got, jax.tree.map(np.asarray, want))
    assert int(got["_children"]["inner"][0]["total"]) == 14


@pytest.mark.parametrize("container", [list, tuple], ids=["list", "tuple"])
def test_plain_list_child_served_by_the_megastep_engine_as_in_jax(container):
    """One pass through the port's megastep ``StreamingEngine`` and JAX's
    under ``"xla"``: the two arenas lay the list's leaves out alike, and the
    port's arena, taken out through ``engine_state_to_numpy``, unpacks with
    JAX's layout to JAX's state."""
    from metrics_tpu_torch.utils.state_bridge import engine_state_to_numpy

    batches = [_regression_rows(n, 20 + i) for i, n in enumerate((3, 9, 1, 13, 6))]
    jeng = JaxStreaming(_list_wrapper(mt, container)(), JaxConfig(buckets=(8, 32), kernel_backend="xla", coalesce=1))
    with jeng:
        for p, t in batches:
            jeng.submit(p, t)
    peng = StreamingEngine(_list_wrapper(mp, container)(device="cpu"),
                           EngineConfig(buckets=(8, 32), kernel_backend="megastep"))
    with peng:
        for p, t in batches:
            peng.submit(torch.from_numpy(p), torch.from_numpy(t))
    assert peng.stats.kernel_fallbacks_by_reason() == {}
    spell = lambda layout: [(k, o, n, tuple(sh), str(dt).replace("torch.", ""))  # noqa: E731
                            for k, o, n, sh, dt in layout.leaf_slices()]
    assert spell(peng.arena_layout) == spell(jeng.arena_layout)
    arena, _ = engine_state_to_numpy(peng)
    back = jeng.arena_layout.unpack({k: jnp.asarray(v) for k, v in arena.items()})
    _assert_tree(jax.tree.map(np.asarray, back), jax.tree.map(np.asarray, jeng.state()))
    assert int(back["_children"]["inner"][1]["total"]) == sum(len(t) for _, t in batches)
    _assert_tree(peng.result(), jeng.result())
