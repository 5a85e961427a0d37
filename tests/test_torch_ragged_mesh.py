"""The ragged engine's mesh forms against the JAX package's, on the CPU.

The port's mesh is four shards on the CPU (``MeshConfig(shape=(4,),
devices=["cpu"] * 4)``); JAX's engines run on ``jax.devices()[:4]``, built
directly (the ``devices`` fixture would mark these tests slow). The cases of
``tests/engine/test_ragged.py`` (deferred mesh serving, the ``group_shard``
pager, windows with ``group_shard``) and
``tests/engine/test_ragged_aggregate.py`` (the paged resident mix against
the oracle and the unsharded engine), at W = 4 in both packages:

* ``RaggedEngine(config=EngineConfig(mesh=..., mesh_sync="deferred"))``: each
  shard's grouped buffers, merged at the boundary by
  ``GroupedStateMetric.sync_states`` (one gather, the replica-major
  compaction);
* ``group_shard=True``: group ``g`` on shard ``g % 4`` in that shard's
  ``resident_groups`` slots, the paged sweep over every shard's touched rows;
* ``aggregate_path()`` word for word with JAX's;
* ``GroupedStateMetric.sync_states`` over the port's mesh axis and over two
  gloo ranks of ``tests/helpers/torch_sync_worker.py``, against JAX's under
  ``shard_map``.

Predictions are tied at one decimal. The grouped states (counts, the
capacity buffers and the ``_seq`` ranks) are bit-equal to JAX's; aggregates
hold to 1e-6 absolute of JAX's engine, of the eager metric and of the port's
own oracle and world-1 engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.engine import EngineConfig as JC
from metrics_tpu.engine import GroupedStateMetric as JGrouped
from metrics_tpu.engine import RaggedEngine as JRagged
from metrics_tpu.engine import WindowPolicy as JWindow
from metrics_tpu_torch.engine import EngineConfig, GroupedStateMetric, RaggedEngine, WindowPolicy
from metrics_tpu_torch.parallel.mesh import MeshConfig
from tests.helpers import torch_sync_worker as w

W = 4
ATOL = 1e-6


def _jmesh(n=W):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("dp",))


def _pmesh(n=W):
    return MeshConfig(shape=(n,), devices=["cpu"] * n).make_mesh()


def _batches(seed=0, n_batches=4, rows=9, groups=6):
    """JAX's ``_retrieval_batches``: tied one-decimal preds."""
    rng = np.random.RandomState(seed)
    vals = np.round(rng.rand(n_batches * rows), 1).astype(np.float32)
    out = []
    for b in range(n_batches):
        out.append((vals[b * rows:(b + 1) * rows], rng.randint(0, 2, rows), rng.randint(0, groups, rows)))
    return out


def _eager(batches):
    m = mt.RetrievalMAP()
    for p, t, g in batches:
        m.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(g))
    return float(m.compute())


def _serve(jax_side, batches, groups, capacity, buckets, mesh=True, window=None, **kw):
    """One package's ragged engine fed ``batches``: ``(device aggregate,
    oracle aggregate, aggregate_path, state as numpy, engine)``."""
    if jax_side:
        cfg = JC(buckets=buckets, window=window, **(dict(mesh=_jmesh(), axis="dp", mesh_sync="deferred")
                                                      if mesh else {}))
        eng = JRagged(mt.RetrievalMAP(), num_groups=groups, config=cfg, capacity=capacity, **kw)
    else:
        cfg = EngineConfig(buckets=buckets, window=window, **(dict(mesh=_pmesh(), mesh_sync="deferred")
                                                               if mesh else {}))
        eng = RaggedEngine(mp.RetrievalMAP(device="cpu"), num_groups=groups, config=cfg, capacity=capacity, **kw)
    with eng:
        for p, t, g in batches:
            eng.submit_update(p, t, g)
            eng.flush()  # JAX's paged engine pages per flushed step
        path = eng.aggregate_path()
        dev, orc = float(eng.aggregate()), float(eng.aggregate(oracle=True))
        state = {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in eng.state().items()}
    return dev, orc, path, state, eng


def _same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _seq_ordered(state):
    """Each group's valid rows in ``_seq`` (ingest) order, per field, and the
    counts: what a merge's shard interleaving cannot change."""
    counts = state["count"]
    cap = state["buf__seq"].shape[-1]
    valid = np.arange(cap) < np.minimum(counts, cap)[..., None]
    order = np.argsort(np.where(valid, state["buf__seq"], np.iinfo(np.int32).max), axis=-1, kind="stable")
    out = {k: np.where(valid, np.take_along_axis(v, order, axis=-1), 0) for k, v in state.items()
           if k.startswith("buf_")}
    out["count"] = counts
    return out


def test_deferred_mesh_serving_is_bit_exact():
    batches = _batches(seed=5, n_batches=4, rows=16, groups=6)
    jdev, jorc, jpath, jstate, _ = _serve(True, batches, 6, 32, (16,))
    pdev, porc, ppath, pstate, eng = _serve(False, batches, 6, 32, (16,))
    single = _serve(False, batches, 6, 32, (16,), mesh=False)
    _same_state(pstate, jstate)
    _same_state(_seq_ordered(pstate), _seq_ordered(single[3]))  # world 1 holds the rows in ingest order
    assert ppath == jpath == ("device", "batched fold over the stacked buffers")
    np.testing.assert_allclose([pdev, porc, single[0]], [_eager(batches)] * 3, atol=ATOL)
    np.testing.assert_allclose(pdev, jdev, atol=ATOL)
    assert eng.stats.merges >= 1 and eng.stats.summary()["mesh_sync"]["transport"] == "one_device"
    with eng:
        per_group = eng.results()
    np.testing.assert_allclose([float(per_group[g]) for g in range(6)],
                               [float(single[4].result(g)) for g in range(6)], atol=ATOL)


def test_group_shard_pager_serving_is_bit_exact():
    """Groups shard over the mesh and page through one slot a shard; the
    aggregate sweeps every shard's resident and spilled rows."""
    batches = _batches(seed=6, n_batches=4, rows=12, groups=8)
    jdev, jorc, jpath, jstate, j = _serve(True, batches, 8, 16, (16,), group_shard=True, resident_groups=1)
    pdev, porc, ppath, pstate, p = _serve(False, batches, 8, 16, (16,), group_shard=True, resident_groups=1)
    _same_state(pstate, jstate)
    assert ppath == jpath == ("device", "batched fold over a capacity-blocked paged sweep")
    np.testing.assert_allclose([pdev, porc, jdev], [_eager(batches)] * 3, atol=ATOL)
    assert (p.stats.page_ins, p.stats.page_outs) == (j.stats.page_ins, j.stats.page_outs)
    assert p.pager.world == W and p.stats.page_outs > 0
    assert {k: tuple(v.shape) for k, v in p._state.items()} == {k: tuple(v.shape) for k, v in j._state.items()}


@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
def test_windows_with_group_shard_compose(kind):
    """A window with ``group_shard``: tumbling reads the open pane through
    the paged sweep, sliding takes the oracle (JAX's words), both equal to
    JAX's engine and the unwindowed oracle over the live traffic."""
    batches = _batches(seed=8, n_batches=4, rows=10, groups=4)
    make = {"tumbling": lambda m: m.tumbling(pane_batches=100), "sliding": lambda m: m.sliding(n_panes=3,
                                                                                             pane_batches=2)}[kind]
    jdev, _, jpath, jstate, _ = _serve(True, batches, 4, 32, (16,), window=make(JWindow), group_shard=True,
                                       resident_groups=2)
    pdev, porc, ppath, pstate, p = _serve(False, batches, 4, 32, (16,), window=make(WindowPolicy),
                                          group_shard=True, resident_groups=2)
    _same_state(pstate, jstate)
    assert ppath == jpath
    # one tumbling pane, or a sliding ring of three two-batch panes: the live window is every batch
    np.testing.assert_allclose([pdev, porc, jdev], [_eager(batches)] * 3, atol=ATOL)
    with p:
        np.testing.assert_allclose(float(p.result(0)), float(_serve(False, batches, 4, 32, (16,), mesh=False)[4]
                                                              .result(0)), atol=ATOL)


def test_paged_resident_mix_matches_oracle_and_unsharded():
    """64 groups through eight slots a shard: the capacity-blocked sweep over
    every shard equals its own oracle, the eager metric, the unsharded
    deferred engine, world 1 and JAX's engine, in one 1024-row block."""
    rng = np.random.RandomState(11)
    batches = []
    for _ in range(6):
        g = rng.randint(0, 64, 32)
        t = rng.randint(0, 2, 32)
        for gid in set(g.tolist()):  # every touched group holds a positive
            sel = np.flatnonzero(g == gid)
            if not t[sel].any():
                t[sel[0]] = 1
        batches.append((np.round(rng.rand(32), 1).astype(np.float32), t, g))
    want = _eager(batches)
    pdev, porc, path, pstate, p = _serve(False, batches, 64, 64, (32,), group_shard=True, resident_groups=8)
    flat = _serve(False, batches, 64, 64, (32,))
    single = _serve(False, batches, 64, 64, (32,), mesh=False)
    jdev, _, _, jstate, _ = _serve(True, batches, 64, 64, (32,), group_shard=True, resident_groups=8)
    assert path == ("device", "batched fold over a capacity-blocked paged sweep")
    np.testing.assert_allclose([pdev, porc, flat[0], single[0], jdev], [want] * 5, atol=ATOL)
    assert pdev == flat[0] == single[0]
    _same_state(pstate, jstate)
    _same_state(_seq_ordered(pstate), _seq_ordered(single[3]))
    assert p.stats.page_outs > 0 and p.stats.ragged_summary()["agg_blocks"] == 1


def test_corpus_aggregate_paths_on_a_mesh_as_jax():
    """The corpus aggregate (detection's ``MAP``): the unsharded deferred
    engine runs it on the merged state; ``group_shard`` takes the oracle."""
    for kw in ({}, {"group_shard": True, "resident_groups": 2}):
        paths = []
        for jax_side in (True, False):
            m = mt if jax_side else mp
            metric = m.detection.MAP() if jax_side else m.detection.MAP(device="cpu")
            cfg = (JC(buckets=(8,), mesh=_jmesh(), axis="dp", mesh_sync="deferred") if jax_side
                   else EngineConfig(buckets=(8,), mesh=_pmesh(), mesh_sync="deferred"))
            eng = (JRagged if jax_side else RaggedEngine)(metric, num_groups=8, config=cfg, **kw)
            paths.append(eng.aggregate_path())
        assert paths[0] == paths[1], paths


def _jax_sync(objs_local, n):
    """JAX's ``GroupedStateMetric.sync_states`` (one shard_map over ``n``
    devices) of the stacked local states; shard 0's merged state."""
    grouped = JGrouped(mt.RetrievalMAP(), capacity=w.GROUPED_CAP)
    stacked = {k: jnp.asarray(np.stack([loc[k] for loc in objs_local])) for k in objs_local[0]}

    def body(state):
        return jax.tree.map(lambda x: x[None], grouped.sync_states(jax.tree.map(lambda x: x[0], state), "dp"))

    spec = jax.tree.map(lambda _: P("dp"), stacked)
    out = jax.jit(jax.shard_map(body, mesh=_jmesh(n), in_specs=(spec,), out_specs=spec))(stacked)
    return {k: np.asarray(v)[0] for k, v in out.items()}


def _local_state(rank):
    eng = RaggedEngine(mp.RetrievalMAP(device="cpu"), w.GROUPED_G, config=EngineConfig(buckets=(32,)),
                       capacity=w.GROUPED_CAP)
    with eng:
        eng.submit_update(*w.grouped_rows(rank))
        eng.flush()
        return eng.state()


def test_grouped_sync_states_over_the_mesh_equals_jax():
    locals_ = [_local_state(r) for r in range(W)]
    grouped = GroupedStateMetric(mp.RetrievalMAP(device="cpu"), capacity=w.GROUPED_CAP)
    synced = grouped.sync_states(locals_, _pmesh().axis("dp"))
    assert len(synced) == W and all(s is synced[0] for s in synced)  # one merge on a one-device mesh
    want = _jax_sync([{k: v.numpy() for k, v in loc.items()} for loc in locals_], W)
    _same_state({k: v.numpy() for k, v in synced[0].items()}, want)
    assert int(synced[0]["count"].sum()) == W * w.GROUPED_ROWS
    # outside a group of more than one rank the state comes back as it is
    assert grouped.sync_states(locals_[0]) is locals_[0]


@pytest.fixture(scope="module")
def pool():
    p = w.RankPool()
    yield p
    p.close()


def test_grouped_sync_states_over_gloo_equals_jax(pool):
    """Two gloo ranks (the ``pair`` group) each hold a world-1 engine's
    grouped state; both ranks' ``sync_states`` give JAX's merge bit for bit."""
    got = pool.run("grouped", group="pair")
    assert got[2] is None
    arrays = [{part: {k: v[2] for k, v in got[r][part].items()} for part in ("local", "synced")} for r in range(2)]
    want = _jax_sync([arrays[r]["local"] for r in range(2)], 2)
    for rank in range(2):
        _same_state(arrays[rank]["synced"], want)
    np.testing.assert_array_equal(arrays[0]["local"]["count"], _local_state(0)["count"].numpy())
