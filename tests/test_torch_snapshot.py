"""Crash-safe snapshots of the port, and the snapshot format that crosses
between the packages, on the CPU.

* The file-level contract, one port test per JAX test of
  ``tests/engine/test_snapshot.py`` and ``tests/engine/test_faults_snapshot.py``:
  round trip and GC, an interrupted write, a same-step resave, GC by creation
  order, bit-flip and truncation fuzz raising the typed error, the sidecar
  rules, the generation-ring fallback, kill/resume, host attributes.
* The format against JAX's: the spelled treedef equals
  ``repr(jax.tree_util.tree_flatten(x)[1])`` and the payload digest equals
  ``metrics_tpu.engine.snapshot._payload_digest`` on hypothesis trees and on
  every real payload; the arena fingerprint equals JAX's
  ``ArenaLayout.fingerprint()``.
* Both directions on the same seeded traffic: JAX writes, the port restores
  and replays; the port writes, JAX loads it (``verify=True``), restores and
  replays. Each restored engine's state equals the uninterrupted run of the
  other package bit for bit (the traffic's float sums are exact: counts, and
  dyadic rows), its values within 1e-6 (the two packages' compute
  arithmetic).
* Every refusal of the restore matrix, with JAX's message, leaving the
  engine as it was.

The JAX package writes orbax directories when orbax is installed, which the
port cannot read (orbax imports JAX). Where JAX writes, the tests monkeypatch
``metrics_tpu.engine.snapshot._use_orbax`` to return False, so it writes its
pickle codec. No JAX file changes. Every engine here pins ``coalesce=1`` and
the JAX paged engines are flushed after each batch, so both packages page
the same streams at the same steps.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh

import metrics_tpu as mt
import metrics_tpu.engine.snapshot as jsnap
import metrics_tpu_torch as mp
from metrics_tpu.engine import AotCache as JaxAotCache
from metrics_tpu.engine import EngineConfig as JaxConfig
from metrics_tpu.engine import MultiStreamEngine as JaxMulti
from metrics_tpu.engine import StreamingEngine as JaxStreaming
from metrics_tpu.engine.arena import ArenaLayout as JaxLayout
from metrics_tpu.engine.traffic import zipf_stream_ids
from metrics_tpu_torch.engine import (
    EngineConfig,
    MultiStreamEngine,
    SnapshotCorruptError,
    StreamingEngine,
    generations,
    latest_snapshot,
    load_snapshot,
    save_snapshot,
)
from metrics_tpu_torch.engine.arena import ArenaLayout
from metrics_tpu_torch.engine.faults import corrupt_snapshot
from metrics_tpu_torch.engine.snapshot import _integrity_path, _payload_digest
from metrics_tpu_torch.metric import StateSpec
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.tree import spell_treedef

C, T, S = 3, 5, 6
BUCKETS = (8, 32)
#: one compiled-program cache for the file's JAX engines: equally configured
#: engines share programs, so each configuration compiles once
_JAX_AOT = JaxAotCache()


@pytest.fixture
def jax_pickle(monkeypatch):
    """The JAX package writes its pickle codec (orbax is installed here)."""
    monkeypatch.setattr(jsnap, "_use_orbax", lambda: False)


# =============================================================== the file-level contract


def _batches(seed=1, sizes=(10, 20, 9, 31, 16, 8, 40, 3)):
    rng = np.random.RandomState(seed)
    return [((rng.randint(0, 65, size=n) / 64.0).astype(np.float32), (rng.rand(n) > 0.5).astype(np.int32))
            for n in sizes]


def _pair_collection():
    return mp.MetricCollection([mp.Accuracy(device="cpu"), mp.MeanSquaredError(device="cpu")])


def _values(v):
    return {k: np.asarray(x) for k, x in v.items()}


def _save_one(d, value=1.0, step=2):
    state = {"x": np.arange(8, dtype=np.float32) * value, "n": np.asarray(3)}
    return save_snapshot(d, state, {"step": step, "batches_done": step}, keep=4)


def test_save_load_roundtrip_and_gc(tmp_path):
    d = str(tmp_path)
    state = {"correct": torch.tensor(3), "total": torch.tensor(7.5)}
    for step in (2, 4, 6):
        save_snapshot(d, state, {"step": step, "batches_done": step}, keep=2)
    snaps = sorted(n for n in os.listdir(d) if n.startswith("snap_"))
    assert [n[:17] for n in snaps] == ["snap_000000000004", "snap_000000000006"]
    loaded, meta = load_snapshot(d)
    assert meta["step"] == 6 and meta["batches_done"] == 6
    assert isinstance(loaded["correct"], np.ndarray) and int(loaded["correct"]) == 3
    assert loaded["total"].dtype == np.float32 and float(loaded["total"]) == 7.5


def test_interrupted_write_never_corrupts_recovery(tmp_path):
    d = str(tmp_path)
    save_snapshot(d, {"x": np.asarray(1.0)}, {"step": 2}, keep=2)
    good = latest_snapshot(d)
    with open(os.path.join(d, "snap_000000000099_deadbeefdeadbeef"), "wb") as f:
        f.write(b"\x80\x04half a pickle")  # a kill mid-payload-write
    with open(os.path.join(d, "LATEST.tmp"), "w") as f:  # and mid-pointer-write
        f.write("snap_000000000099_deadbeefdeadbeef")
    assert latest_snapshot(d) == good
    _, meta = load_snapshot(d)
    assert meta["step"] == 2
    _, meta = load_snapshot(d, fallback=True)
    assert meta["step"] == 2 and meta["generations_skipped"] == 0


def test_same_step_resave_never_rewrites_latest_target(tmp_path):
    d = str(tmp_path)
    save_snapshot(d, {"x": np.asarray(1.0)}, {"step": 2}, keep=2)
    first = latest_snapshot(d)
    save_snapshot(d, {"x": np.asarray(2.0)}, {"step": 2}, keep=2)
    second = latest_snapshot(d)
    assert first != second and os.path.exists(first)
    state, _ = load_snapshot(d)
    assert float(state["x"]) == 2.0


def test_gc_keeps_newest_by_creation_not_step(tmp_path):
    d = str(tmp_path)
    state = {"x": np.asarray(1.0)}
    for step in (80, 90, 10, 20, 30):  # a replayed run after 90
        save_snapshot(d, state, {"step": step}, keep=2)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d) if n.startswith("snap_"))
    assert steps == [20, 30], steps
    assert load_snapshot(d)[1]["step"] == 30


def test_no_snapshot_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_snapshot(str(tmp_path))
    with pytest.raises(MetricsTPUUserError, match="snapshot_dir"):
        StreamingEngine(mp.Accuracy(device="cpu")).restore()


def test_kill_resume_reproduces_uninterrupted_result(tmp_path):
    batches = _batches()
    snapdir = str(tmp_path / "snaps")
    ref = StreamingEngine(_pair_collection(), EngineConfig(buckets=(16, 32)))
    with ref:
        for b in batches:
            ref.submit(*b)
        want = _values(ref.result())
    eng = StreamingEngine(_pair_collection(), EngineConfig(buckets=(16, 32), snapshot_every=2, snapshot_dir=snapdir))
    with eng:
        for b in batches[:5]:
            eng.submit(*b)
        eng.flush()
    assert eng.stats.snapshots == 2
    del eng  # the kill
    resumed = StreamingEngine(_pair_collection(), EngineConfig(buckets=(16, 32), snapshot_dir=snapdir))
    meta = resumed.restore()
    assert meta["batches_done"] == 4  # cadence 2: the last complete snapshot at batch 4
    with resumed:
        for b in batches[meta["batches_done"]:]:
            resumed.submit(*b)
        got = _values(resumed.result())
    for k in want:
        assert np.array_equal(got[k], want[k]), (k, got[k], want[k])


def test_coalesced_groups_never_cross_a_snapshot_boundary(tmp_path):
    """With coalescing, the dispatcher's groups stop at the cadence: the
    snapshot at batch 3 holds exactly 3 batches, wherever the queue stood."""
    batches = _batches(sizes=(4,) * 7)
    eng = StreamingEngine(_pair_collection(), EngineConfig(buckets=(32,), coalesce=8, snapshot_every=3,
                                                           snapshot_dir=str(tmp_path), snapshot_keep=4))
    eng.start()
    with eng._state_lock:  # the whole stream queues before the dispatcher runs
        for b in batches:
            eng.submit(*b)
    eng.flush()
    assert eng.stats.megasteps > 0 and eng.stats.snapshots == 2
    cursors = sorted(load_snapshot(p)[1]["batches_done"] for p in generations(str(tmp_path)))
    assert cursors == [3, 6]
    eng.stop()


def test_explicit_snapshot_and_restore_counters(tmp_path):
    snapdir = str(tmp_path)
    eng = StreamingEngine(mp.MeanSquaredError(device="cpu"), EngineConfig(buckets=(8,), snapshot_dir=snapdir))
    with eng:
        eng.submit(np.asarray([1.0, 0.5], np.float32), np.asarray([0.5, 0.5], np.float32))
        eng.snapshot()
    assert eng.stats.snapshots == 1
    eng2 = StreamingEngine(mp.MeanSquaredError(device="cpu"), EngineConfig(buckets=(8,), snapshot_dir=snapdir))
    meta = eng2.restore()
    assert meta["batches_done"] == 1 and eng2.stats.resumes == 1 and eng2.stats.rows_in == 2
    with eng2:
        assert float(eng2.result()) == pytest.approx(0.125)


def test_host_derived_attrs_survive_snapshot_restore(tmp_path):
    snapdir = str(tmp_path)
    p = np.asarray([0.9, 0.2, 0.8, 0.1], np.float32)
    t = np.asarray([1, 0, 1, 1], np.int32)
    eng = StreamingEngine(mp.Accuracy(device="cpu"), EngineConfig(buckets=(8,), snapshot_dir=snapdir))
    with eng:
        eng.submit(p, t)
        want = float(eng.result())
        eng.snapshot()
    del eng
    fresh = mp.Accuracy(device="cpu")
    assert fresh.mode is None
    resumed = StreamingEngine(fresh, EngineConfig(buckets=(8,), snapshot_dir=snapdir))
    assert resumed.restore()["batches_done"] == 1
    from metrics_tpu_torch.utils.enums import DataType

    assert fresh.mode == DataType.BINARY and isinstance(fresh.mode, DataType)  # the real enum member
    with resumed:
        assert float(resumed.result()) == want


def test_host_attrs_persist_through_collections(tmp_path):
    snapdir = str(tmp_path)
    eng = StreamingEngine(_pair_collection(), EngineConfig(buckets=(8,), snapshot_dir=snapdir))
    with eng:
        eng.submit(np.asarray([0.75, 0.25], np.float32), np.asarray([1, 0], np.int32))
        want = _values(eng.result())
        eng.snapshot()
    del eng
    resumed = StreamingEngine(_pair_collection(), EngineConfig(buckets=(8,), snapshot_dir=snapdir))
    resumed.restore()
    with resumed:
        got = _values(resumed.result())
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_bitflip_fuzz_raises_typed_error(tmp_path):
    for seed in range(10):
        d = str(tmp_path / f"flip{seed}")
        path = _save_one(d)
        corrupt_snapshot(path, np.random.RandomState(seed), flips=4)
        with pytest.raises(SnapshotCorruptError) as ei:
            load_snapshot(d)
        assert ei.value.generation == os.path.basename(path) and ei.value.path == path
        assert ei.value.generation in str(ei.value)


def test_truncation_fuzz_raises_typed_error(tmp_path):
    for seed in range(10):
        d = str(tmp_path / f"trunc{seed}")
        path = _save_one(d)
        size = os.path.getsize(path)
        keep = int(np.random.RandomState(seed).randint(0, max(1, size - 1)))
        with open(path, "r+b") as f:
            f.truncate(keep)
        with pytest.raises(SnapshotCorruptError) as ei:
            load_snapshot(d)
        assert ei.value.generation == os.path.basename(path)


def test_corrupt_integrity_sidecar_is_corrupt_snapshot(tmp_path):
    path = _save_one(str(tmp_path))
    with open(_integrity_path(path), "w") as f:
        f.write("{not json")
    with pytest.raises(SnapshotCorruptError, match="integrity"):
        load_snapshot(str(tmp_path))


def test_missing_integrity_sidecar_is_accepted_backcompat(tmp_path):
    path = _save_one(str(tmp_path))
    os.unlink(_integrity_path(path))
    state, meta = load_snapshot(str(tmp_path))
    assert meta["step"] == 2 and int(state["n"]) == 3


def test_absent_explicit_path_is_file_not_found_not_corrupt(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_snapshot(str(tmp_path / "snap_000000000004_deadbeef"))


def test_explicit_snapshot_path_never_falls_back(tmp_path):
    d = str(tmp_path)
    path = _save_one(d)
    _save_one(d, value=2.0, step=4)
    corrupt_snapshot(path, np.random.RandomState(0))
    with pytest.raises(SnapshotCorruptError):
        load_snapshot(path, fallback=True)


def test_fallback_walks_past_corrupt_latest_to_previous_generation(tmp_path):
    d = str(tmp_path)
    _save_one(d, value=1.0, step=2)
    newest = _save_one(d, value=2.0, step=4)
    corrupt_snapshot(newest, np.random.RandomState(3))
    with pytest.raises(SnapshotCorruptError):
        load_snapshot(d)
    state, meta = load_snapshot(d, fallback=True)
    assert meta["step"] == 2 and meta["generations_skipped"] == 1
    np.testing.assert_array_equal(state["x"], np.arange(8, dtype=np.float32))


def test_fallback_with_every_generation_corrupt_raises_last_error(tmp_path):
    d = str(tmp_path)
    for i, step in enumerate((2, 4)):
        corrupt_snapshot(_save_one(d, step=step), np.random.RandomState(i))
    with pytest.raises(SnapshotCorruptError):
        load_snapshot(d, fallback=True)


def test_gc_removes_integrity_sidecars_with_their_snapshots(tmp_path):
    d = str(tmp_path)
    for step in (2, 4, 6, 8):
        save_snapshot(d, {"x": np.asarray(1.0)}, {"step": step}, keep=2)
    snaps = generations(d)
    assert len(snaps) == 2
    assert len([n for n in os.listdir(d) if n.startswith("integrity_")]) == 2
    assert all(os.path.exists(_integrity_path(p)) for p in snaps)


def test_engine_restores_past_corrupted_latest_with_exact_replay(tmp_path):
    batches = _batches(sizes=(10, 20, 9, 31, 16, 8))
    snapdir = str(tmp_path)
    ref = StreamingEngine(_pair_collection(), EngineConfig(buckets=(16, 32)))
    with ref:
        for b in batches:
            ref.submit(*b)
        want = _values(ref.result())
    eng = StreamingEngine(_pair_collection(), EngineConfig(buckets=(16, 32), coalesce=1, snapshot_every=2,
                                                           snapshot_dir=snapdir, snapshot_keep=3))
    with eng:
        for b in batches:
            eng.submit(*b)
    del eng
    corrupt_snapshot(latest_snapshot(snapdir), np.random.RandomState(1))
    resumed = StreamingEngine(_pair_collection(), EngineConfig(buckets=(16, 32), snapshot_dir=snapdir))
    meta = resumed.restore()
    assert meta["generations_skipped"] == 1 and meta["batches_done"] == 4
    assert resumed.stats.snapshot_fallbacks == 1
    with resumed:
        for b in batches[meta["batches_done"]:]:
            resumed.submit(*b)
        got = _values(resumed.result())
    for k in want:
        assert np.array_equal(got[k], want[k]), (k, got[k], want[k])


def test_integrity_sidecar_contents_are_json_sha(tmp_path):
    path = _save_one(str(tmp_path))
    with open(_integrity_path(path)) as f:
        doc = json.load(f)
    assert set(doc) == {"sha256"} and len(doc["sha256"]) == 64


def test_payload_holds_no_tensor_and_meta_ints_are_arrays(tmp_path):
    path = save_snapshot(str(tmp_path), {"a": torch.arange(3), "b": [torch.ones(2)]}, {"step": 5, "tag": "x"},
                         host_attrs={"mode": None})
    with open(path, "rb") as f:
        payload = pickle.load(f)
    leaves, _ = spell_treedef(payload)
    assert not any(isinstance(leaf, torch.Tensor) for leaf in leaves)
    assert isinstance(payload["meta"]["step"], np.ndarray) and payload["meta"]["tag"] == "x"
    assert payload["host_attrs"].dtype == np.uint8


# ===================================================== the format, against the JAX package's

_leaf = st.one_of(
    st.integers(-5, 5).map(lambda n: np.arange(abs(n), dtype=np.int32) - n),
    st.floats(-4, 4, allow_nan=False).map(lambda x: np.asarray(x, np.float32)),
    st.sampled_from([np.zeros((2, 3), np.float64), np.ones(4, np.uint8), np.asarray(True)]),
    st.text(max_size=4),
    st.integers(-10, 10),
    st.floats(-2, 2, allow_nan=False),
    st.booleans(),
)
_trees = st.recursive(
    st.one_of(_leaf, st.none()),
    lambda children: st.one_of(
        st.lists(children, max_size=3),
        st.lists(children, max_size=3).map(tuple),
        st.dictionaries(st.text(min_size=1, max_size=3), children, max_size=3),
    ),
    max_leaves=12,
)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tree=_trees)
def test_spelled_treedef_and_digest_equal_jax(tree):
    leaves, spelled = spell_treedef(tree)
    jleaves, jdef = jax.tree_util.tree_flatten(tree)
    assert spelled == repr(jdef)
    assert len(leaves) == len(jleaves) and all(a is b for a, b in zip(leaves, jleaves))
    assert _payload_digest(tree) == jsnap._payload_digest(tree)


def test_unspellable_nodes_raise_naming_the_type():
    from collections import OrderedDict, namedtuple

    with pytest.raises(TypeError, match="OrderedDict"):
        spell_treedef({"a": OrderedDict(x=1)})
    pair = namedtuple("Pair", "a b")
    with pytest.raises(TypeError, match="Pair"):
        spell_treedef([pair(1, 2)])
    layout = ArenaLayout.for_state({"a": pair(StateSpec((2,), torch.float32), StateSpec((), torch.int32))})
    with pytest.raises(TypeError, match="Pair"):
        layout.fingerprint()


def _regression(m, **kw):
    return m.MetricCollection({"mse": m.MeanSquaredError(**kw), "mae": m.MeanAbsoluteError(**kw),
                               "ev": m.ExplainedVariance(**kw), "tweedie": m.TweedieDevianceScore(power=1.5, **kw)})


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


def _coll(m, q8=False, **kw):
    return m.MetricCollection({
        "acc": m.Accuracy(**kw),
        "ap": m.BinnedAveragePrecision(num_classes=C, thresholds=T, sync_precision="q8_block" if q8 else None, **kw),
        "cm": m.ConfusionMatrix(num_classes=C, **kw),
    })


_LAYOUTS = {
    "flagship": lambda m, **kw: m.MetricCollection({
        "acc": m.Accuracy(**kw), "f1": m.F1Score(num_classes=10, average="macro", **kw),
        "binned_ap": m.BinnedAveragePrecision(num_classes=10, thresholds=100, **kw),
        "cm": m.ConfusionMatrix(num_classes=10, **kw)}),
    "dashboard": _dashboard,
    "regression": _regression,
    "minmax_wrapper": lambda m, **kw: m.MinMaxMetric(m.MeanSquaredError(**kw), **kw),
    "composition": lambda m, **kw: m.F1Score(num_classes=C, average="macro", **kw) + m.Accuracy(**kw),
}


@pytest.mark.parametrize("name", sorted(_LAYOUTS))
def test_arena_fingerprint_equals_jax(name):
    jm, pm = _LAYOUTS[name](mt), _LAYOUTS[name](mp, device="cpu")
    assert ArenaLayout.for_state(pm.abstract_state()).fingerprint() == \
        JaxLayout.for_state(jm.abstract_state()).fingerprint()
    # the stream-stacked layout of the unsharded multi-stream engine too
    stacked = {"x": pm.abstract_state()}
    jstacked = {"x": jm.abstract_state()}
    assert ArenaLayout.for_state(stacked).fingerprint() == JaxLayout.for_state(jstacked).fingerprint()


def test_arena_fingerprint_of_a_bf16_state_equals_jax():
    port = {"n": StateSpec((), torch.int32), "sum": StateSpec((4,), torch.bfloat16), "z": StateSpec((2, 2), torch.bool)}
    jax_ = {"n": jax.ShapeDtypeStruct((), jnp.int32), "sum": jax.ShapeDtypeStruct((4,), jnp.bfloat16),
            "z": jax.ShapeDtypeStruct((2, 2), jnp.bool_)}
    assert ArenaLayout.for_state(port).fingerprint() == JaxLayout.for_state(jax_).fingerprint()
    # permuted same-dtype leaves: identical buffers, different fingerprints
    swapped = {"a": StateSpec((3,), torch.float32), "b": StateSpec((2,), torch.float32)}
    other = {"a": StateSpec((2,), torch.float32), "b": StateSpec((3,), torch.float32)}
    assert ArenaLayout.for_state(swapped).buffer_sizes() == ArenaLayout.for_state(other).buffer_sizes()
    assert ArenaLayout.for_state(swapped).fingerprint() != ArenaLayout.for_state(other).fingerprint()


# --------------------------------------------------------------------- engines in both packages


def _traffic(n_batches, seed):
    """``(stream_id, preds, target)`` batches of 1-13 rows, Zipf stream ids."""
    rng = np.random.RandomState(seed)
    out = []
    for sid in zipf_stream_ids(S, n_batches, alpha=1.05, seed=seed):
        n = int(rng.randint(1, 14))
        p = rng.rand(n, C).astype(np.float32)
        out.append((int(sid), p / p.sum(1, keepdims=True), rng.randint(0, C, n)))
    return out


def _jax_mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), ("dp",))


class _Side:
    """One package's engine of a cell: how to build it and feed it."""

    def __init__(self, pkg, kind, q8=False, compress=None, resident=2, world=1, backend=None, use_arena=True,
                 coalesce=1):
        # q8: binned AP's sync_precision policy is "q8_block"; compress: compress_payloads (default: q8)
        self.pkg, self.kind, self.q8 = pkg, kind, q8
        self.compress = q8 if compress is None else compress
        self.resident, self.world, self.backend, self.use_arena = resident, world, backend, use_arena
        self.coalesce = coalesce

    def build(self, snapdir):
        jax_side = self.pkg is mt
        metric = _coll(mt, self.q8) if jax_side else _coll(mp, self.q8, device="cpu")
        kw = dict(buckets=BUCKETS, coalesce=self.coalesce, compress_payloads=self.compress, snapshot_dir=snapdir,
                  use_arena=self.use_arena)
        if jax_side:
            backend = self.backend
            if self.kind in ("paged", "deferred"):
                kw.update(mesh=_jax_mesh(self.world), axis="dp", mesh_sync="deferred")
            if self.kind == "paged":
                backend = backend or ("xla" if self.compress else "megastep_interpret")
            cfg = JaxConfig(kernel_backend=backend, **kw)
        else:
            cfg = EngineConfig(kernel_backend="megastep" if self.kind == "paged" else self.backend, **kw)
        engines = (JaxStreaming, JaxMulti) if jax_side else (StreamingEngine, MultiStreamEngine)
        aot = {"aot_cache": _JAX_AOT} if jax_side else {}
        if self.kind in ("streaming", "deferred"):
            return engines[0](metric, cfg, **aot)
        if self.kind == "unsharded":
            return engines[1](metric, S, cfg, **aot)
        return engines[1](metric, S, cfg, stream_shard=True, resident_streams=self.resident, **aot)

    def feed(self, eng, traffic):
        jax_side = self.pkg is mt
        for sid, p, t in traffic:
            p, t = (p, t) if jax_side else (torch.from_numpy(p), torch.from_numpy(t))
            if self.kind in ("streaming", "deferred"):
                eng.submit(p, t)
            else:
                eng.submit(sid, p, t)
            if jax_side:
                eng.flush()  # one step per batch, paged at the same steps as the port
        eng.flush()

    def read(self, eng):
        """The engine's logical state per stream (or whole) and its values, as numpy."""
        if self.kind in ("streaming", "deferred"):
            return {None: _np(eng.state())}, {None: _np(eng.result())}
        return ({sid: _np(eng.stream_state(sid)) for sid in range(S)},
                {sid: _np(v) for sid, v in eng.results().items()})


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return np.stack([_np(v) for v in tree])
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16 else tree).detach().numpy()
    return np.asarray(tree)


def _assert_same(got, want, exact, what):
    got_states, got_values = got
    want_states, want_values = want
    for key in want_states:
        for member, leaves in want_states[key].items():
            for s, w in leaves.items():
                g = got_states[key][member][s]
                assert g.shape == w.shape and g.dtype == w.dtype, (what, key, member, s)
                if exact or w.dtype.kind != "f":
                    assert np.array_equal(g, w), (what, key, member, s, g, w)
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f"{what} {key} {member}.{s}")
    for key in want_values:
        for member, w in want_values[key].items():
            np.testing.assert_allclose(got_values[key][member], w, rtol=0, atol=1e-6,
                                       err_msg=f"{what} {key} {member}")


def _config(side):
    return (side.kind, side.q8, side.compress, side.resident, side.world, side.use_arena)


def _cross(tmp_path, writer, reader, traffic, kill_at, exact=True):
    """``writer`` serves ``traffic[:kill_at]``, snapshots, and serves the rest
    (the uninterrupted run); a fresh ``reader`` restores the snapshot and
    replays from the returned cursor. Its state and values must equal those
    of its twin in the writer's package (the reader's configuration, the
    same snapshot, the same replay) and, where neither side compresses (a
    q8 snapshot or spill is lossy by design), the writer's uninterrupted run.
    A JAX reader loads with ``verify=True``."""
    snapdir = str(tmp_path / "snaps")
    w = writer.build(snapdir)
    writer.feed(w, traffic[:kill_at])
    path = w.snapshot()
    writer.feed(w, traffic[kill_at:])
    uninterrupted = writer.read(w)
    w.stop()
    if reader.pkg is mt:
        jsnap.load_snapshot(path, verify=True)  # the digest JAX re-derives equals the port's
    runs = []
    for side in (reader, _Side(writer.pkg, reader.kind, q8=reader.q8, compress=reader.compress,
                               resident=reader.resident, backend=writer.backend, use_arena=reader.use_arena)):
        r = side.build(snapdir)
        meta = r.restore(path)
        assert meta["batches_done"] == kill_at and meta["generations_skipped"] == 0
        side.feed(r, traffic[meta["batches_done"]:])
        runs.append((r, side.read(r)))
        r.stop()
    what = f"{writer.pkg.__name__} -> {reader.pkg.__name__}"
    _assert_same(runs[0][1], runs[1][1], exact, what + " (the twin)")
    if not (writer.compress or reader.compress):  # a compressed snapshot is lossy by design
        _assert_same(runs[0][1], uninterrupted, exact, what + " (uninterrupted)")
    return w, runs[0][0], meta


_CELLS = {
    # name: (writer kind and options, reader kind and options)
    "streaming_arena": (dict(kind="streaming"), dict(kind="streaming")),
    "streaming_no_arena": (dict(kind="streaming", use_arena=False), dict(kind="streaming", use_arena=False)),
    "streaming_megastep": (dict(kind="streaming", backend="megastep_interpret"),
                           dict(kind="streaming", backend="megastep")),
    "streaming_q8_tree": (dict(kind="streaming", q8=True), dict(kind="streaming", q8=True)),
    "unsharded": (dict(kind="unsharded"), dict(kind="unsharded")),
    "paged_same_residency": (dict(kind="paged"), dict(kind="paged")),
    "paged_other_residency": (dict(kind="paged"), dict(kind="paged", resident=4)),
    "paged_merged_into_unsharded": (dict(kind="paged"), dict(kind="unsharded")),
    "paged_compressed_into_uncompressed": (dict(kind="paged", q8=True), dict(kind="paged", q8=True, compress=False)),
    "paged_uncompressed_into_compressed": (dict(kind="paged", q8=True, compress=False), dict(kind="paged", q8=True)),
}


def _side(pkg, opts):
    opts = dict(opts)
    backend = opts.pop("backend", None)
    if pkg is mp and backend is not None:
        backend = "megastep"
    elif pkg is mt and backend == "megastep":
        backend = "megastep_interpret"
    return _Side(pkg, backend=backend, **opts)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("cell", sorted(_CELLS))
def test_snapshot_crosses_between_the_packages(tmp_path, jax_pickle, cell, direction):
    w_opts, r_opts = _CELLS[cell]
    order = (mt, mp) if direction == "jax_to_port" else (mp, mt)
    # a JAX q8 paged engine replays through "xla" (its staged megastep engine
    # is not deterministic on the CPU: ROADMAP §C)
    writer, reader = _side(order[0], w_opts), _side(order[1], r_opts)
    traffic = _traffic(12, 11)
    # the q8 cells fold decoded (non-dyadic) values: f32 within 1e-6 relative
    _cross(tmp_path, writer, reader, traffic, kill_at=7, exact=not (writer.q8 or reader.q8))


def test_jax_deferred_mesh_snapshot_at_world_2_merges_into_the_port(tmp_path, jax_pickle):
    _, _, meta = _cross(tmp_path, _Side(mt, "deferred", world=2), _Side(mp, "streaming"), _traffic(10, 12), 6)
    assert meta["mesh_sync"] == "deferred" and meta["world"] == 2


def test_jax_stream_shard_snapshot_at_world_4_rehomes_into_the_ports_paged_engine(tmp_path, jax_pickle):
    w, r, meta = _cross(tmp_path, _Side(mt, "paged", world=4), _Side(mp, "paged", resident=2), _traffic(14, 13), 8)
    assert meta["world"] == 4 and meta["stream_shard"] == 1
    assert r.stats.page_ins > 0 and r.pager.tenancy_stats()["capacity_rows"] == 2
    # the engine-free reassembly of the same piece equals JAX's
    state, meta = load_snapshot(meta["snapshot_path"])
    got = MultiStreamEngine.sshard_piece_logical(_coll(mp, device="cpu"), state, meta)
    want = JaxMulti.sshard_piece_logical(_coll(mt), state, meta)
    for k, member in want.items():
        for s, v in member.items():
            assert np.array_equal(_np(got[k][s]), np.asarray(v)), (k, s)


def test_payload_digests_and_treedefs_equal_jax_on_real_payloads(tmp_path):
    """Every payload kind the port writes: its spelled treedef is JAX's repr
    and its digest JAX's, and JAX's loader verifies it."""
    traffic = _traffic(9, 14)
    kinds = {"packed": _Side(mp, "streaming"), "no_arena": _Side(mp, "streaming", use_arena=False),
             "q8_tree": _Side(mp, "streaming", q8=True), "sshard": _Side(mp, "paged"),
             "sshard_q8": _Side(mp, "paged", q8=True)}
    for name, side in kinds.items():
        eng = side.build(str(tmp_path / name))
        side.feed(eng, traffic)
        path = eng.snapshot()
        with open(path, "rb") as f:
            payload = pickle.load(f)
        assert "host_attrs" in payload, name
        assert spell_treedef(payload)[1] == repr(jax.tree_util.tree_flatten(payload)[1]), name
        assert _payload_digest(payload) == jsnap._payload_digest(payload), name
        jsnap.load_snapshot(path, verify=True)
        if name == "sshard":
            assert payload["meta"]["stream_shard"] == 1 and "spill_coords" in payload["state"]["pager"]


def _bf16_sum(pkg, **kw):
    """A metric with a genuinely bf16 ``sum`` state (the JAX package's
    ``astype`` keeps a metric's f32 defaults)."""
    xp, bf16 = (jnp, jnp.bfloat16) if pkg is mt else (torch, torch.bfloat16)

    class Bf16Sum(pkg.Metric):
        def __init__(self):
            super().__init__(**kw)
            self.add_state("total", xp.zeros((), dtype=bf16), dist_reduce_fx="sum")
            self.add_state("n", xp.zeros((), dtype=xp.int32), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + (x.sum().astype(bf16) if pkg is mt else x.sum().to(bf16))
            self.n = self.n + x.shape[0]

        def compute(self):
            return self.total

    return Bf16Sum()


def test_bf16_paged_snapshot_crosses_both_ways(tmp_path, jax_pickle):
    """A bf16 state on the paged engine (rows spill): the port's snapshot
    holds the arena and the spilled rows as bf16, JAX verifies and restores
    it, and the JAX snapshot restores into the port, bit for bit."""
    rng = np.random.RandomState(7)
    traffic = [(int(rng.randint(5)), (rng.randint(0, 9, int(rng.randint(1, 6))) / 4.0).astype(np.float32))
               for _ in range(12)]

    def port(d):
        return MultiStreamEngine(_bf16_sum(mp, device="cpu"), 5, EngineConfig(
            buckets=(8,), kernel_backend="megastep", coalesce=1, snapshot_dir=d), stream_shard=True, resident_streams=2)

    def jax_(d):
        return JaxMulti(_bf16_sum(mt), 5, JaxConfig(buckets=(8,), mesh=_jax_mesh(1), axis="dp", mesh_sync="deferred",
                                                    kernel_backend="xla", coalesce=1, snapshot_dir=d),
                        stream_shard=True, resident_streams=2)

    def feed(eng, part, jax_side):
        for sid, x in part:
            eng.submit(sid, jnp.asarray(x, jnp.bfloat16) if jax_side else torch.from_numpy(x).bfloat16())
            eng.flush()

    def totals(eng):
        return [np.asarray(_np(eng.stream_state(s))["total"], np.float32) for s in range(5)]

    for src, dst, src_jax in ((port, jax_, False), (jax_, port, True)):
        d = str(tmp_path / f"bf16_{src_jax}")
        a = src(d)
        feed(a, traffic[:7], src_jax)
        path = a.snapshot()
        feed(a, traffic[7:], src_jax)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        assert payload["state"]["arena"]["bfloat16"].dtype.name == "bfloat16"
        assert payload["state"]["pager"]["spill_bfloat16"].dtype.name == "bfloat16"
        b = dst(d)
        b.restore()
        feed(b, traffic[7:], not src_jax)
        for g, w in zip(totals(b), totals(a)):
            assert np.array_equal(g, w)
        a.stop()
        b.stop()


def test_accuracy_latch_and_its_enum_cross_both_ways(tmp_path, jax_pickle):
    """A snapshot of Accuracy's latched input mode restores into a FRESH
    metric of the other package (mode None) as that package's real enum
    member, which computes at once, with no replay traffic."""
    from metrics_tpu.utils.enums import DataType as JaxDataType
    from metrics_tpu_torch.utils.enums import DataType as PortDataType

    p = np.asarray([[0.2, 0.7, 0.1], [0.5, 0.3, 0.2], [0.1, 0.1, 0.8]], np.float32)
    t = np.asarray([1, 2, 2])
    d = str(tmp_path / "jax")
    jeng = JaxStreaming(mt.Accuracy(), JaxConfig(buckets=(8,), snapshot_dir=d))
    with jeng:
        jeng.submit(p, t)
        want = float(jeng.result())
        jeng.snapshot()
    fresh = mp.Accuracy(device="cpu")
    peng = StreamingEngine(fresh, EngineConfig(buckets=(8,), snapshot_dir=d))
    peng.restore()
    assert isinstance(fresh.mode, PortDataType) and fresh.mode == PortDataType.MULTICLASS
    assert float(peng.result()) == want
    # and back: the port writes the JAX package's module path
    d2 = str(tmp_path / "port")
    src = StreamingEngine(mp.Accuracy(device="cpu"), EngineConfig(buckets=(8,), snapshot_dir=d2))
    with src:
        src.submit(torch.from_numpy(p), torch.from_numpy(t))
        path = src.snapshot()
    _, meta = jsnap.load_snapshot(path)
    assert type(meta["host_attrs"]["mode"]) is JaxDataType
    jfresh = mt.Accuracy()
    jeng2 = JaxStreaming(jfresh, JaxConfig(buckets=(8,), snapshot_dir=d2))
    jeng2.restore()
    assert jfresh.mode == JaxDataType.MULTICLASS
    assert float(jeng2.result()) == pytest.approx(want, abs=1e-7)


def test_restore_into_a_multiclass_latch_rekeys_the_step(tmp_path):
    """Restoring a snapshot whose latched mode differs from the live metric's
    re-derives the fingerprint: the next step is looked up under the new key
    (a new entry), never the old mode's."""
    d = str(tmp_path)
    binary = StreamingEngine(mp.Accuracy(device="cpu"), EngineConfig(buckets=(8,), snapshot_dir=d))
    with binary:
        binary.submit(np.asarray([0.9, 0.2], np.float32), np.asarray([1, 0]))
        binary.snapshot()
    live = StreamingEngine(mp.Accuracy(device="cpu"), EngineConfig(buckets=(8,)))
    with live:
        live.submit(np.asarray([[0.2, 0.8], [0.6, 0.4]], np.float32), np.asarray([1, 1]))
    misses = live.aot_cache.misses
    live.restore(d)
    assert live._program_memo == {} and live._metric.mode == "binary"
    with live:
        live.submit(np.asarray([0.3, 0.6], np.float32), np.asarray([0, 1]))
    assert live.aot_cache.misses == misses + 1
    assert float(live.result()) == 1.0


# ------------------------------------------------------------------------------- refusals


def _port_snapshot(tmp_path, side=None, traffic=None):
    side = side or _Side(mp, "streaming")
    eng = side.build(str(tmp_path / "src"))
    side.feed(eng, traffic or _traffic(5, 15))
    path = eng.snapshot()
    eng.stop()
    return path


def _rewrite(path, mutate):
    """Rewrite a snapshot's payload through ``mutate`` (its sidecar dropped,
    so only the restore matrix judges it)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    mutate(payload)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    os.unlink(_integrity_path(path))
    return path


def _untouched(eng):
    """What a failed restore must leave as it was."""
    eng.flush()
    return (_np(eng.state()), eng._batches_done, eng._step, eng.stats.resumes, eng._metric.host_compute_attrs())


def _assert_refused(eng, path, match):
    before = _untouched(eng)
    with pytest.raises(MetricsTPUUserError, match=match):
        eng.restore(path)
    after = _untouched(eng)
    assert after[1:] == before[1:]
    got, want = spell_treedef(after[0]), spell_treedef(before[0])
    assert got[1] == want[1] and all(np.array_equal(g, w) for g, w in zip(got[0], want[0]))


def _served(side):
    eng = side.build(None)
    side.feed(eng, _traffic(3, 16))
    return eng


def test_refusals_of_the_single_stream_matrix(tmp_path, jax_pickle):
    path = _port_snapshot(tmp_path)
    eng = _served(_Side(mp, "streaming"))
    _assert_refused(eng, _rewrite(path, lambda p: p["meta"].update(window="tumbling:4")),
                    "window policy 'tumbling:4' does not match this engine's 'cumulative'")
    path = _port_snapshot(tmp_path)
    _assert_refused(eng, _rewrite(path, lambda p: p["meta"].update(num_hosts=np.asarray(2),
                                                                   process_id=np.asarray(1))),
                    r"host topology \(num_hosts=2, process_id=1\)")
    path = _port_snapshot(tmp_path)
    _assert_refused(eng, _rewrite(path, lambda p: p["meta"].update(arena_fp="0123456789abcdef")),
                    "does not match this metric's layout")
    no_arena = _served(_Side(mp, "streaming", use_arena=False))
    _assert_refused(no_arena, _port_snapshot(tmp_path), "use_arena=False")
    # the permuted same-dtype leaves: identical buffers, another layout
    with pytest.raises(MetricsTPUUserError, match="does not match this metric's layout"):
        _permuted_restore(tmp_path)


def test_deferred_snapshot_whose_merge_grows_a_cat_buffer_is_refused(tmp_path):
    """A deferred mesh snapshot of a capacity AUROC (cat-reduced buffers)
    merges to buffers world times longer: a single-device engine cannot
    carry them, and refuses with JAX's message, untouched."""
    def engine(d=None):
        return StreamingEngine(mp.AUROC(capacity=16, device="cpu"), EngineConfig(buckets=(8,), snapshot_dir=d))

    src = engine(str(tmp_path / "src"))
    with src:
        src.submit(np.asarray([0.2, 0.9, 0.4], np.float32), np.asarray([0, 1, 1]))
        path = src.snapshot()

    def as_deferred(p):  # what a deferred engine at world 2 writes: the arena stacked per shard
        p["state"] = {k: np.stack([v, v]) for k, v in p["state"].items()}
        p["meta"].update(mesh_sync="deferred", world=np.asarray(2))

    _assert_refused(_served_auroc(engine), _rewrite(path, as_deferred),
                    r"deferred snapshot \(world=2\) merges to state shapes this engine cannot carry")


def _served_auroc(engine):
    eng = engine()
    with eng:
        eng.submit(np.asarray([0.7, 0.1], np.float32), np.asarray([1, 0]))
    return eng


def _permuted_restore(tmp_path):
    class TwoSums(mp.Metric):
        def __init__(self, first, second, **kw):
            super().__init__(**kw)
            self.add_state("a", torch.zeros(first), dist_reduce_fx="sum")
            self.add_state("b", torch.zeros(second), dist_reduce_fx="sum")

        def update(self, x):
            self.a = self.a + x.sum()
            self.b = self.b + x.sum()

        def compute(self):
            return self.a.sum() + self.b.sum()

    d = str(tmp_path / "perm")
    src = StreamingEngine(TwoSums(3, 2, device="cpu"), EngineConfig(buckets=(8,), snapshot_dir=d))
    with src:
        src.submit(np.ones(4, np.float32))
        path = src.snapshot()
    dst = StreamingEngine(TwoSums(2, 3, device="cpu"), EngineConfig(buckets=(8,), snapshot_dir=d))
    assert dst.arena_layout.buffer_sizes() == src.arena_layout.buffer_sizes()
    dst.restore(path)


def test_refusals_of_the_stream_shard_matrix(tmp_path, jax_pickle):
    traffic = _traffic(8, 17)
    paged = _served(_Side(mp, "paged"))
    plain = _port_snapshot(tmp_path / "plain", _Side(mp, "unsharded"), traffic)
    _assert_refused(paged, plain, "not written by a stream-sharded engine")
    sshard = _port_snapshot(tmp_path / "sshard", _Side(mp, "paged"), traffic)
    _assert_refused(paged, _rewrite(sshard, lambda p: p["meta"].update(num_streams=np.asarray(S + 1))),
                    f"snapshot serves {S + 1} streams, this engine {S}")
    q8 = _port_snapshot(tmp_path / "q8", _Side(mp, "paged", q8=True), traffic)
    _assert_refused(paged, q8, "written under sync_precision policy 'q8:[0-9a-f]+', this engine's metric "
                               "declares 'exact'")
    sshard = _port_snapshot(tmp_path / "sshard2", _Side(mp, "paged"), traffic)
    _assert_refused(paged, _rewrite(sshard, lambda p: p["state"].pop("pager")), "missing arena/pager parts")
    sshard = _port_snapshot(tmp_path / "sshard3", _Side(mp, "paged"), traffic)
    _assert_refused(paged, _rewrite(sshard, lambda p: p["meta"].update(resident=np.asarray(5))),
                    "per-stream layout")
    # JAX's own engine refuses the port's plain snapshot into its sharded engine with the same words
    jpaged = _Side(mt, "paged").build(None)
    with pytest.raises(Exception, match="not written by a stream-sharded engine"):
        jpaged.restore(_port_snapshot(tmp_path / "plain2", _Side(mp, "unsharded"), traffic))


def test_refusals_of_orbax_and_foreign_enum_modules(tmp_path):
    from metrics_tpu.engine.snapshot import save_snapshot as jax_save

    d = str(tmp_path / "orbax")
    jax_save(d, {"x": np.ones(2, np.float32)}, {"step": 1})  # orbax: a directory per snapshot
    path = latest_snapshot(d)
    assert os.path.isdir(path)
    with pytest.raises(MetricsTPUUserError, match="orbax"):
        load_snapshot(d)
    with pytest.raises(MetricsTPUUserError, match="orbax"):
        StreamingEngine(mp.Accuracy(device="cpu"), EngineConfig(snapshot_dir=d)).restore()
    # an empty directory (a kill mid-write) is a corrupt generation, not orbax
    os.makedirs(os.path.join(d, "snap_000000000000_0000000000000000"))
    with pytest.raises(SnapshotCorruptError):
        load_snapshot(os.path.join(d, "snap_000000000000_0000000000000000"))
    # a host attribute naming an enum outside both packages
    d2 = str(tmp_path / "enum")
    path = save_snapshot(d2, {"x": np.ones(1)}, {"step": 1}, host_attrs={"mode": None})
    doc = json.dumps({"mode": {"__enum__": ["os.path", "Thing"], "value": 1}}).encode()
    _rewrite(path, lambda p: p.update(host_attrs=np.frombuffer(doc, np.uint8).copy()))
    with pytest.raises(MetricsTPUUserError, match="'os.path'"):
        load_snapshot(d2)


def test_restore_clears_a_sticky_error_and_resumes(tmp_path):
    path = _port_snapshot(tmp_path)
    eng = _Side(mp, "streaming").build(None)
    eng._error = RuntimeError("dispatcher died")
    meta = eng.restore(path)
    assert eng._error is None and eng._batches_done == meta["batches_done"] == 5
