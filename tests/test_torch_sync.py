"""The port's cross-process sync on ``torch.distributed`` against numpy and
the JAX package, on the CPU over gloo.

One pool of three spawned ranks (``tests/helpers/torch_sync_worker.py``,
which imports no JAX) serves every case; a case runs on the full group
(world 3), on the group of ranks 0 and 1 (world 2) or on rank 2 alone
(world 1). The JAX reference runs in this process under ``shard_map`` on a
two-device mesh, fed the same inputs the ranks synced.

Tolerances: integer, bool, min/max, cat and None results bit-exact at any
world size; float sums bit-exact at world 2 and within the reassociation
bound ``(W-1) * 2**-24 * sum|terms|`` at world 3 (plus half an ulp of an
f16/bf16 result); ``q8_block`` sums within ``q8_sum_error_bound`` and
within one ulp of JAX's; metric values within ``rtol=1e-5`` of the
single-process port (f32 sums reassociated) and ``1e-6`` of JAX's on the
same synced states.
"""
import pickle
import re
import subprocess
import sys
from enum import Enum
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.parallel.collectives import fused_axis_sync as jax_fused_axis_sync
from metrics_tpu_torch.parallel.collectives import q8_roundtrip, q8_sum_error_bound
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.helpers import torch_sync_worker as w

WORLDS = {"world": 3, "pair": 2}


@pytest.fixture(scope="module")
def pool():
    p = w.RankPool()
    yield p
    p.close()


@pytest.fixture(scope="module")
def fused(pool):
    return {g: pool.run("fused", group=g) for g in WORLDS}


@pytest.fixture(scope="module")
def suite_runs(pool):
    return {g: pool.run("suite", group=g) for g in WORLDS}


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:2]), ("dp",))


def _arr(x):
    """A worker's ``("tensor", dtype name, array)`` as the array."""
    return x[2]


def _tree_np(x):
    if isinstance(x, tuple) and len(x) == 3 and x[0] == "tensor":
        return x[2]
    if isinstance(x, dict):
        return {k: _tree_np(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree_np(v) for v in x]
    return x


def _inputs(dt, world):
    """The ranks' inputs for ``dt`` as the workers hold them (bf16 rounded,
    widened back to f32), stacked ``(world, 2, 5)``."""
    vals = [w.leaf_values(dt, r) for r in range(world)]
    if dt == "bfloat16":
        vals = [torch.from_numpy(v).to(torch.bfloat16).float().numpy() for v in vals]
    return np.stack(vals)


def _q8_inputs(dt, world):
    tdt = getattr(torch, dt)
    return np.stack([torch.from_numpy(w.q8_values(dt, r)).to(tdt).float().numpy() for r in range(world)])


def _wrap(s, dt):
    """int64 sums wrapped into ``dt`` (two's complement)."""
    bits = np.dtype(dt).itemsize * 8
    if bits == 64:
        return s.astype(dt)
    return (s & (2**bits - 1)).astype(f"uint{bits}").view(dt) if np.dtype(dt).kind == "i" else \
        (s & (2**bits - 1)).astype(dt)


_HALF_ULP = {"float32": 0.0, "float16": 2.0**-11, "bfloat16": 2.0**-8, "float64": 0.0}
_ACC_EPS = {"float32": 2.0**-24, "float16": 2.0**-24, "bfloat16": 2.0**-24, "float64": 2.0**-53}
_FLOATS = ("float32", "float16", "bfloat16", "float64")


def _expected(dt, fx, X):
    """numpy's result of ``fx`` over the stacked ``X`` and its dtype name."""
    world = X.shape[0]
    if fx == "sum":
        if dt in _FLOATS:
            return X.astype(np.float64).sum(0), dt
        if dt == "bool":
            return X.astype(np.int32).sum(0).astype(np.int32), "int32"
        return _wrap(X.astype(np.int64).sum(0), dt), dt
    if fx == "mean":
        if dt in _FLOATS:
            return X.astype(np.float64).sum(0) / world, dt
        summed = X.astype(np.int32).sum(0) if dt == "bool" else _wrap(X.astype(np.int64).sum(0), dt)
        return summed.astype(np.float32) / np.float32(world), "float32"
    if fx == "min":
        return X.min(0), dt
    if fx in ("max", "max_fn"):
        return X.max(0), dt
    if fx == "cat":
        return X.reshape((-1,) + X.shape[2:]), dt
    return X, dt  # None: stacked


@pytest.mark.parametrize("dt", w.DTYPES)
@pytest.mark.parametrize("group", list(WORLDS))
def test_fused_bundle_matches_numpy(fused, group, dt):
    """Every reduction of ``dt`` in one bundle: every member rank holds the
    numpy result, in JAX's result dtype."""
    world = WORLDS[group]
    X = _inputs(dt, world)
    ranks = [r for r in fused[group] if r is not None]
    assert len(ranks) == world
    for fx in w.FXS:
        i = w.DTYPES.index(dt) * len(w.FXS) + w.FXS.index(fx)
        want, want_dt = _expected(dt, fx, X)
        for res in ranks:
            _, got_dt, got = res["out"][i]
            assert got_dt == want_dt, (fx, got_dt, want_dt)
            assert got.shape == want.shape, (fx, got.shape, want.shape)
            if fx in ("sum", "mean") and dt in _FLOATS:
                terms = np.abs(X.astype(np.float64)).sum(0) / (world if fx == "mean" else 1)
                bound = (world - 1) * _ACC_EPS[dt] * terms + _HALF_ULP[dt] * np.abs(want)
                if fx == "mean" and dt in ("float16", "bfloat16"):
                    bound += world * _HALF_ULP[dt] * terms  # the sum and the division round in dt
                assert np.all(np.abs(got.astype(np.float64) - want) <= bound), (fx, got, want)
                if world == 2 and dt == "float32":
                    np.testing.assert_array_equal(got, (X[0] + X[1]) / (2 if fx == "mean" else 1))
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{dt} {fx}")


def test_fused_bundle_single_state_helper(fused):
    """``sync_axis_state`` is the bundle of one leaf."""
    for group, world in WORLDS.items():
        X = _inputs("float32", world)
        for res in fused[group]:
            if res is not None:
                np.testing.assert_allclose(_arr(res["one"]), X.sum(0), rtol=0, atol=(world - 1) * 2.0**-24 * np.abs(X).sum(0).max())


@pytest.mark.parametrize("group", list(WORLDS))
def test_collectives_per_call_equal_the_plan(fused, group):
    """One call issues the collectives ``fused_sync_plan`` names and no more:
    one f32 all-reduce, one per (reduction, dtype) of the rest, one gather."""
    for res in fused[group]:
        if res is None:
            continue
        plan, counts = res["plan"], res["counts"]
        assert counts["all_gather"] == 1
        assert counts["all_reduce"] + counts["all_gather"] == plan["collectives"]
        # sum bucket: f32/f16/bf16 + the six <=32-bit ints; reduce buckets:
        # sum of f64/int64/bool, and mean/min/max of all 11 dtypes
        assert plan["collectives"] == 1 + 3 + 3 * len(w.DTYPES) + 1
        assert plan["quantized"] == list(range(len(w.DTYPES) * len(w.FXS), len(w.DTYPES) * len(w.FXS) + 3))
        assert plan["q8_words"] == 3 * (7 * 8 + 7)  # 200 elements: 7 blocks of 32
        assert res["q8_bytes"] < res["exact_bytes"]


@pytest.mark.parametrize("dt", w.Q8_DTYPES)
@pytest.mark.parametrize("group", list(WORLDS))
def test_q8_sum_within_its_bound(fused, group, dt):
    world = WORLDS[group]
    X = _q8_inputs(dt, world)
    exact = X.astype(np.float64).sum(0)
    bound = q8_sum_error_bound(X).astype(np.float64) + _HALF_ULP[dt] * np.abs(exact) + 2.0**-24 * np.abs(X).sum(0)
    i = len(w.DTYPES) * len(w.FXS) + w.Q8_DTYPES.index(dt)
    for res in fused[group]:
        if res is not None:
            _, got_dt, got = res["out"][i]
            assert got_dt == dt
            assert np.all(np.abs(got.astype(np.float64) - exact) <= bound)


# ---------------------------------------------------------------- JAX, world 2

_JAX_DTYPES = tuple(d for d in w.DTYPES if d not in ("float64", "int64"))  # x64 is off in JAX


def _jax_max_fn(a, b):
    return jnp.logical_or(a, b) if a.dtype == jnp.bool_ else jnp.maximum(a, b)


@pytest.fixture(scope="module")
def jax_fused(mesh):
    """JAX's ``fused_axis_sync`` over the pair's inputs: {(dtype, fx): value},
    and the q8 leaves under ``("q8", dtype)``."""
    keys, leaves, precs = [], [], []
    for dt in _JAX_DTYPES:
        X = _inputs(dt, 2)
        for fx in w.FXS:
            keys.append((dt, fx))
            leaves.append((_jax_max_fn if fx == "max_fn" else fx, jnp.asarray(X, getattr(jnp, dt))))
            precs.append("exact")
    for dt in w.Q8_DTYPES:
        keys.append(("q8", dt))
        leaves.append(("sum", jnp.asarray(_q8_inputs(dt, 2), getattr(jnp, dt))))
        precs.append("q8_block")
    fxs = [fx for fx, _ in leaves]

    def body(*vals):
        out = jax_fused_axis_sync([(fx, v[0]) for fx, v in zip(fxs, vals)], "dp", precisions=precs)
        return tuple(o[None] for o in out)

    spec = tuple(P("dp") for _ in leaves)
    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec))(*[v for _, v in leaves])
    return {k: np.asarray(o)[0] for k, o in zip(keys, out)}


@pytest.mark.parametrize("dt", _JAX_DTYPES)
def test_fused_bundle_equals_jax_at_world_2(fused, jax_fused, dt):
    for fx in w.FXS:
        i = w.DTYPES.index(dt) * len(w.FXS) + w.FXS.index(fx)
        want = jax_fused[(dt, fx)]
        for res in fused["pair"][:2]:
            _, got_dt, got = res["out"][i]
            assert got_dt == want.dtype.name, (fx, got_dt, want.dtype)
            np.testing.assert_array_equal(got, want.astype(np.float32) if want.dtype.name == "bfloat16" else want,
                                          err_msg=f"{dt} {fx}")


@pytest.mark.parametrize("dt", w.Q8_DTYPES)
def test_q8_sum_equals_jax_to_one_ulp(fused, jax_fused, dt):
    """One ulp of the f32 sum's terms (the ranks' decoded contributions: XLA
    may contract a decode's multiply and add into one FMA), plus one ulp of
    an f16/bf16 result."""
    want = jax_fused[("q8", dt)].astype(np.float64)
    terms = sum(np.abs(q8_roundtrip(x)) for x in _q8_inputs(dt, 2)).astype(np.float32)
    tol = np.spacing(terms).astype(np.float64)
    if dt != "float32":
        tol += np.abs(want) * (2.0**-10 if dt == "float16" else 2.0**-7)
    i = len(w.DTYPES) * len(w.FXS) + w.Q8_DTYPES.index(dt)
    for res in fused["pair"][:2]:
        got = _arr(res["out"][i]).astype(np.float64)
        assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want) / tol)


# ------------------------------------------------------------------ metric level

_SUITE = list(w.suite(mp, device="cpu"))


def _single_process(name):
    """The port's value on all rows in one process (capacity for all rows)."""
    metric, kind = w.suite(mp, capacity=w.N_ROWS, device="cpu")[name]
    w._update(metric, kind, 0, w.N_ROWS)
    return _tree_np(w.to_np(metric.compute()))


def _close(got, want, rtol=1e-5, atol=1e-6, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], rtol, atol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, x) in enumerate(zip(got, want)):
            _close(g, x, rtol, atol, f"{path}[{i}]")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("name", _SUITE + ["tracker"])
@pytest.mark.parametrize("group", list(WORLDS))
def test_compute_gives_the_global_value(suite_runs, group, name):
    """Each rank updates on its shard; ``compute()`` syncs and gives the
    single-process value on all rows, on every rank. MinMax's extremes and
    the bootstrap's replicas follow each rank's own draws and prefixes, so
    they are held to ``compute_synced`` (the same function of the synced
    states) and the raw value to the single-process one."""
    ranks = [r[name] for r in suite_runs[group] if r is not None]
    values = [_tree_np(r["compute"]) for r in ranks]
    for v in values[1:]:
        _close(v, values[0], rtol=0, atol=0)
    if name == "tracker":
        want = _single_process("minmax")["raw"]
    elif name == "bootstrap":
        want = _tree_np(ranks[0]["compute_synced"])
    elif name == "minmax":
        _close(values[0], _tree_np(ranks[0]["compute_synced"]), rtol=0, atol=0)
        want = {**values[0], "raw": _single_process(name)["raw"]}
    elif name == "mse_q8":
        want = _single_process(name)
        local = np.stack([_tree_np(r["local"])["sum_squared_error"] for r in ranks])
        n = sum(int(_tree_np(r["local"])["total"]) for r in ranks)
        assert abs(float(values[0]) - float(want)) <= float(q8_sum_error_bound(local)) / n + 1e-6
        return
    else:
        want = _single_process(name)
    _close(values[0], want)
    if name not in ("tracker", "bootstrap"):
        _close(values[0], _tree_np(ranks[0]["compute_synced"]), rtol=1e-6)


@pytest.mark.parametrize("group", list(WORLDS))
def test_capacity_buffers_gather_to_world_times_capacity(suite_runs, group):
    world = WORLDS[group]
    synced = _tree_np(suite_runs[group][0]["capacity"]["synced"])
    for member in ("auroc", "ap"):
        s = synced[member]
        assert s["preds_buf"].shape == (world * 64, w.C) and s["preds_buf"].dtype == np.float32
        assert s["target_buf"].shape == (world * 64, w.C) and s["target_buf"].dtype == np.int32
        assert s["valid_buf"].shape == (world * 64,) and s["valid_buf"].dtype == np.bool_
        assert int(s["count"]) == w.N_ROWS and int(s["valid_buf"].sum()) == w.N_ROWS


@pytest.mark.parametrize("group", list(WORLDS))
def test_pearson_moments_arrive_stacked_and_fold(suite_runs, group):
    synced = _tree_np(suite_runs[group][0]["pearson"]["synced"])
    assert all(v.shape == (WORLDS[group],) for v in synced.values())
    assert float(synced["n_total"].sum()) == w.N_ROWS


def _jax_host(attrs):
    from metrics_tpu.utils import enums as jenums

    return {k: getattr(jenums, type(v).__name__)(v.value) if isinstance(v, Enum) else v for k, v in attrs.items()}


@pytest.fixture(scope="module")
def jax_suite(suite_runs, mesh):
    """JAX's ``sync_states`` (one shard_map) over the pair's local states, and
    ``compute_from`` of them: {name: (synced, value)}."""
    objs = {k: v for k, (v, _) in w.suite(mt).items()}
    ranks = suite_runs["pair"][:2]
    stacked = {k: jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *[_tree_np(r[k]["local"]) for r in ranks])
               for k in objs}

    def body(states):
        return {k: jax.tree.map(lambda x: x[None], objs[k].sync_states(jax.tree.map(lambda x: x[0], s), "dp"))
                for k, s in states.items()}

    spec = jax.tree.map(lambda _: P("dp"), stacked)
    synced = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec))(stacked)
    out = {}
    for k, obj in objs.items():
        one = jax.tree.map(lambda x: np.asarray(x)[0], synced[k])
        obj.restore_host_compute_attrs(_jax_host(port_host_attrs(k)))
        out[k] = (one, obj.compute_from(jax.tree.map(jnp.asarray, one)))
    return out


def port_host_attrs(name):
    """The host attributes a port metric latches on rank 0's shard."""
    metric, kind = w.suite(mp, device="cpu")[name]
    w._update(metric, kind, *w.shard(2, 0))
    return metric.host_compute_attrs()


def _same(got, want, path=""):
    """Bit-equal trees (the port's numpy against JAX's)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, x) in enumerate(zip(got, want)):
            _same(g, x, f"{path}[{i}]")
    else:
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype.name == want.dtype.name, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("name", _SUITE)
def test_sync_states_and_compute_synced_equal_jax_at_world_2(suite_runs, jax_suite, name):
    """The same local states through both packages' ``sync_states``: every
    synced leaf bit-equal (the q8 leaf within its bound), and
    ``compute_synced`` within 1e-6 of JAX's ``compute_from`` of them."""
    want_states, want_value = jax_suite[name]
    for res in suite_runs["pair"][:2]:
        got = _tree_np(res[name]["synced"])
        if name == "mse_q8":
            local = np.stack([_tree_np(r[name]["local"])["sum_squared_error"] for r in suite_runs["pair"][:2]])
            bound = float(q8_sum_error_bound(local))
            assert abs(float(got["sum_squared_error"]) - float(want_states["sum_squared_error"])) <= bound
            _same(got["total"], want_states["total"])
        else:
            _same(got, want_states)
        _close(_tree_np(res[name]["compute_synced"]), jax.tree.map(np.asarray, want_value), rtol=1e-6)


# ------------------------------------------------------------- eager behaviour


@pytest.fixture(scope="module")
def errors(pool):
    return pool.run("errors")


@pytest.mark.parametrize("case, pattern", [
    ("sync_twice", "already been synced"),
    ("update_synced", "already been synced. HINT"),
    ("forward_synced", "shouldn't be synced"),
    ("unsync_twice", "already been un-synced"),
    ("list_lengths_compute", r"AUROC\.preds \(rows per rank: \[8, 12, 16\]\)"),
    ("list_lengths_sync_states", r"AUROC\.preds \(rows per rank: \[8, 12, 16\]\)"),
])
def test_refusals(errors, case, pattern):
    for res in errors:
        assert res["msgs"][case] is not None and re.search(pattern, res["msgs"][case]), res["msgs"][case]
        assert res["synced_flag"] is False


def test_equal_length_list_states_gather_as_one_element_list(errors):
    want = np.concatenate([np.r_[np.arange(3) + 10 * r, -1.0 - r] for r in range(w.WORLD)]).astype(np.float32)
    for rank, res in enumerate(errors):
        assert len(res["cat"]) == 1
        np.testing.assert_array_equal(_arr(res["cat"][0]), want)
        local = [_arr(x) for x in res["local_cat"]]
        np.testing.assert_array_equal(np.concatenate([np.atleast_1d(x) for x in local]),
                                      np.r_[np.arange(3) + 10 * rank, -1.0 - rank].astype(np.float32))


@pytest.fixture(scope="module")
def on_step(pool):
    return {g: pool.run("forward_on_step", group=g) for g in WORLDS}


def _batch_value(make, kind, world, step):
    """The single-process value of the step's rows of every rank."""
    metric = make()
    rows = [w.rows_for(kind, *w.shard(world * 2, 2 * pos + step)) for pos in range(world)]
    p = np.concatenate([r[0] for r in rows])
    t = np.concatenate([r[1] for r in rows])
    return metric(torch.from_numpy(p), torch.from_numpy(t)).numpy()


@pytest.mark.parametrize("group", list(WORLDS))
def test_dist_sync_on_step_forward_values(on_step, group):
    """``forward`` under ``dist_sync_on_step`` returns the batch value over
    every rank's batch (the delta path and Pearson's snapshot path); the
    accumulated state stays rank-local, so ``compute()`` still syncs once."""
    world = WORLDS[group]
    for res in [r for r in on_step[group] if r is not None]:
        for step in range(2):
            np.testing.assert_allclose(_arr(res["acc"][step]),
                                       _batch_value(lambda: mp.Accuracy(device="cpu"), "cls", world, step), rtol=1e-6)
            np.testing.assert_allclose(_arr(res["mse"][step]),
                                       _batch_value(lambda: mp.MeanSquaredError(device="cpu"), "reg", world, step),
                                       rtol=1e-5)
            np.testing.assert_allclose(_arr(res["pearson"][step]),
                                       _batch_value(lambda: mp.PearsonCorrCoef(device="cpu"), "reg", world, step),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_arr(res["acc_compute"]), _single_process("minmax")["raw"], rtol=1e-6)
        _same(_tree_np(res["acc_local_state"]), _tree_np(res["local_state"]))


@pytest.fixture(scope="module")
def group_handling(pool):
    return pool.run("group_handling")


def test_a_group_travels_with_clone_and_not_with_pickle(group_handling):
    for res in group_handling[:2]:
        assert res["clone_shares_group"] is True and res["unpickled_group"] is None
        assert res["state_dict"] == []  # states are not persistent by default; the group is no state
        _close(_tree_np(res["clone_compute"]), _tree_np(res["compute"]), rtol=0, atol=0)
    assert all("ProcessGroup" in res["string_group"] for res in group_handling)


def test_world_1_group_runs_the_bundle_unchanged(group_handling):
    solo = group_handling[2]
    assert solo["solo_equal"] is True
    # every count rides the sum rider; no hand-off (the `ppermute` kind counts the pipeline's)
    assert solo["solo_counts"] == {"all_reduce": 1, "all_gather": 0, "ppermute": 0}


def test_constructor_takes_the_sync_keywords():
    m = mp.Accuracy(device="cpu", dist_sync_on_step=True, sync_axis=None, dist_sync_fn=None, process_group=None)
    assert m.dist_sync_on_step is True and m.sync_axis is None and m.dist_sync_fn is None
    # without a process group the sync is a no-op: compute is the local value
    m.update(torch.tensor([0, 1, 1]), torch.tensor([0, 1, 0]))
    assert abs(float(m.compute()) - 2 / 3) < 1e-7 and m._is_synced is False
    state = m._pack_state()
    assert m.sync_states(state) is state
    assert pickle.loads(pickle.dumps(m)).sync_axis is None


def test_compositional_metric_sync_is_a_no_op():
    c = mp.Accuracy(device="cpu") + mp.Accuracy(device="cpu")
    c.sync()
    c.unsync()
    assert c._is_synced is False


# ------------------------------------------------------------ stacked merges

_C = w.C


def _cls(n, seed):
    return w.cls_rows(n, seed)


def _binary(n, seed):
    p, t = w.cls_rows(n, seed)
    return p[:, 1], (t == 1).astype(np.int64)


def _reg(n, seed):
    return w.reg_rows(n, seed)


def _values(n, seed):
    return (w.reg_rows(n, seed)[0],)


def _two_col(n, seed):
    return w.reg_rows(n, seed, cols=2)


def _dists(n, seed):
    p, _ = w.cls_rows(n, seed)
    q, _ = w.cls_rows(n, seed + 100)
    return p, q


def _hinge(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n).astype(np.float32), rng.randint(0, 2, n)


def _auc(n, seed):
    x = np.sort(np.random.RandomState(seed).rand(n).astype(np.float32))
    return x, np.random.RandomState(seed + 1).rand(n).astype(np.float32)


def _retrieval(n, seed):
    rng = np.random.RandomState(seed)
    return np.round(rng.rand(n), 1).astype(np.float32), rng.randint(0, 2, n), rng.randint(0, 4, n)


def _detection(n, seed):
    """``n`` images of ``MAP.update``'s per-image dicts: a few boxes, scores
    and labels each."""
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for _ in range(n):
        xy = rng.uniform(0, 50, (3, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + 10], axis=1)
        preds.append({"boxes": boxes, "scores": rng.rand(3).astype(np.float32), "labels": rng.randint(0, 2, 3)})
        target.append({"boxes": boxes[:2], "labels": rng.randint(0, 2, 2)})
    return preds, target


_TEXT_WORDS = ("the", "cat", "sat", "on", "a", "mat", "dog", "ran")


def _text(n, seed):
    rng = np.random.RandomState(seed)
    refs = [" ".join(_TEXT_WORDS[i] for i in rng.randint(0, 8, int(rng.randint(1, 9)))) for _ in range(n)]
    return [" ".join(x for x in r.split() if rng.rand() > 0.3) for r in refs], refs


def _text_lists(n, seed):
    hyps, refs = _text(n, seed)
    return hyps, [[r] for r in refs]


def _squad(n, seed):
    hyps, refs = _text(n, seed)
    return ([{"prediction_text": h, "id": str(i)} for i, h in enumerate(hyps)],
            [{"answers": {"text": [r]}, "id": str(i)} for i, r in enumerate(refs)])


def _bert_encoder(m):
    """A sin encoder in the package's own array library."""
    if m is mp:
        return lambda ids, mask: torch.sin(ids[..., None].float() * torch.arange(1, 5))
    return lambda ids, mask: jnp.sin(ids[..., None].astype(jnp.float32) * jnp.arange(1, 5))


def _audio(n, seed):
    rng = np.random.RandomState(seed)
    t = rng.randn(n, 2, 3000).astype(np.float32)
    return (t + 0.3 * rng.randn(*t.shape)).astype(np.float32), t


def _images(n, seed):
    rng = np.random.RandomState(seed)
    t = rng.rand(max(1, n // 4), 3, 16, 16).astype(np.float32)
    return (t + 0.1 * rng.randn(*t.shape)).astype(np.float32), t


_FEAT = np.random.RandomState(90).randn(5, 4).astype(np.float32)


def _feature(m):
    """A linear feature extractor in package ``m``'s array type."""
    if m is mp:
        return lambda x: torch.as_tensor(x) @ torch.from_numpy(_FEAT)
    return lambda x: jnp.asarray(x) @ jnp.asarray(_FEAT)


def _feature_rows(n, seed):
    return (np.random.RandomState(seed).randn(n, 5).astype(np.float32) + 2.0, seed % 2 == 0)


def _feature_rows_only(n, seed):
    return _feature_rows(n, seed)[:1]


def _lpips_pairs(n, seed):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, (n, 3, 6, 6)).astype(np.float32)
    return a, np.clip(a + 0.1 * rng.randn(*a.shape), -1, 1).astype(np.float32)


#: every ported metric: name -> (builder over a package, data)
_ALL = {
    "FID": (lambda m, kw: m.FID(feature=_feature(m), feature_dim=4, **kw), _feature_rows),
    "FID-list": (lambda m, kw: m.FID(feature=_feature(m), streaming=False, **kw), _feature_rows),
    "KID": (lambda m, kw: m.KID(feature=_feature(m), **kw), _feature_rows),
    "IS": (lambda m, kw: m.IS(feature=_feature(m), splits=2, seed=0, **kw), _feature_rows_only),
    "IS-streaming": (lambda m, kw: m.IS(feature=_feature(m), feature_dim=4, splits=2, seed=0, streaming=True, **kw),
                     _feature_rows_only),
    "LPIPS": (lambda m, kw: m.LPIPS(net=lambda x: [torch.as_tensor(x)] if m is mp else [x], **kw), _lpips_pairs),
    "SignalNoiseRatio": (lambda m, kw: m.SignalNoiseRatio(**kw), _audio),
    "ScaleInvariantSignalNoiseRatio": (lambda m, kw: m.ScaleInvariantSignalNoiseRatio(**kw), _audio),
    "ScaleInvariantSignalDistortionRatio": (lambda m, kw: m.ScaleInvariantSignalDistortionRatio(**kw), _audio),
    "SignalDistortionRatio": (lambda m, kw: m.SignalDistortionRatio(filter_length=16, **kw), _audio),
    "PermutationInvariantTraining": (
        lambda m, kw: m.PermutationInvariantTraining(m.functional.scale_invariant_signal_noise_ratio, **kw), _audio),
    "STOI": (lambda m, kw: m.STOI(10000, **kw), _audio),
    "PSNR": (lambda m, kw: m.PSNR(**kw), _images),
    "PSNR-data_range": (lambda m, kw: m.PSNR(data_range=1.0, **kw), _images),
    "PSNR-dim": (lambda m, kw: m.PSNR(data_range=1.0, dim=(1, 2, 3), **kw), _images),
    "SSIM": (lambda m, kw: m.SSIM(kernel_size=(5, 5), **kw), _images),
    "MultiScaleStructuralSimilarityIndexMeasure": (
        lambda m, kw: m.MultiScaleStructuralSimilarityIndexMeasure(kernel_size=(3, 3), betas=(0.3, 0.3, 0.4), **kw),
        _images),
    "Accuracy": (lambda m, kw: m.Accuracy(**kw), _cls),
    "AUC": (lambda m, kw: m.AUC(**kw), _auc),
    "AUROC": (lambda m, kw: m.AUROC(**kw), _binary),
    "AUROC-capacity": (lambda m, kw: m.AUROC(num_classes=_C, capacity=32, **kw), _cls),
    "AveragePrecision": (lambda m, kw: m.AveragePrecision(**kw), _binary),
    "AveragePrecision-capacity": (lambda m, kw: m.AveragePrecision(num_classes=_C, capacity=32, **kw), _cls),
    "BinnedAveragePrecision": (lambda m, kw: m.BinnedAveragePrecision(num_classes=_C, thresholds=5, **kw), _cls),
    "BinnedPrecisionRecallCurve": (lambda m, kw: m.BinnedPrecisionRecallCurve(num_classes=_C, thresholds=5, **kw),
                                   _cls),
    "BinnedRecallAtFixedPrecision": (lambda m, kw: m.BinnedRecallAtFixedPrecision(
        num_classes=_C, min_precision=0.3, thresholds=5, **kw), _cls),
    "BootStrapper": (lambda m, kw: m.BootStrapper(m.Accuracy(num_classes=_C, **kw), num_bootstraps=2, seed=0), _cls),
    "CalibrationError": (lambda m, kw: m.CalibrationError(**kw), _binary),
    "CatMetric": (lambda m, kw: m.CatMetric(**kw), _values),
    "CohenKappa": (lambda m, kw: m.CohenKappa(num_classes=_C, **kw), _cls),
    "CompositionalMetric": (lambda m, kw: m.Precision(num_classes=_C, average="macro", **kw)
                            + m.Recall(num_classes=_C, average="macro", **kw), _cls),
    "ConfusionMatrix": (lambda m, kw: m.ConfusionMatrix(num_classes=_C, **kw), _cls),
    "CosineSimilarity": (lambda m, kw: m.CosineSimilarity(**kw), _two_col),
    "ExplainedVariance": (lambda m, kw: m.ExplainedVariance(**kw), _reg),
    "F1Score": (lambda m, kw: m.F1Score(num_classes=_C, average="macro", **kw), _cls),
    "FBeta": (lambda m, kw: m.FBeta(num_classes=_C, beta=0.5, **kw), _cls),
    "HammingDistance": (lambda m, kw: m.HammingDistance(**kw), _cls),
    "HingeLoss": (lambda m, kw: m.HingeLoss(**kw), _hinge),
    "JaccardIndex": (lambda m, kw: m.JaccardIndex(num_classes=_C, **kw), _cls),
    "KLDivergence": (lambda m, kw: m.KLDivergence(**kw), _dists),
    "MatthewsCorrCoef": (lambda m, kw: m.MatthewsCorrCoef(num_classes=_C, **kw), _cls),
    "MaxMetric": (lambda m, kw: m.MaxMetric(**kw), _values),
    "MeanAbsoluteError": (lambda m, kw: m.MeanAbsoluteError(**kw), _reg),
    "MeanAbsolutePercentageError": (lambda m, kw: m.MeanAbsolutePercentageError(**kw), _reg),
    "MeanMetric": (lambda m, kw: m.MeanMetric(**kw), _values),
    "MeanSquaredError": (lambda m, kw: m.MeanSquaredError(**kw), _reg),
    "MeanSquaredLogError": (lambda m, kw: m.MeanSquaredLogError(**kw), _reg),
    "MinMaxMetric": (lambda m, kw: m.MinMaxMetric(m.Accuracy(**kw)), _cls),
    "MinMetric": (lambda m, kw: m.MinMetric(**kw), _values),
    "MultioutputWrapper": (lambda m, kw: m.MultioutputWrapper(m.MeanSquaredError(**kw), num_outputs=2), _two_col),
    "PearsonCorrCoef": (lambda m, kw: m.PearsonCorrCoef(**kw), _reg),
    "Precision": (lambda m, kw: m.Precision(num_classes=_C, average="macro", **kw), _cls),
    "PrecisionRecallCurve": (lambda m, kw: m.PrecisionRecallCurve(**kw), _binary),
    "PrecisionRecallCurve-capacity": (lambda m, kw: m.PrecisionRecallCurve(num_classes=_C, capacity=32, **kw), _cls),
    "R2Score": (lambda m, kw: m.R2Score(**kw), _reg),
    "Recall": (lambda m, kw: m.Recall(num_classes=_C, average="macro", **kw), _cls),
    "RetrievalFallOut": (lambda m, kw: m.RetrievalFallOut(**kw), _retrieval),
    "RetrievalHitRate": (lambda m, kw: m.RetrievalHitRate(**kw), _retrieval),
    "RetrievalMAP": (lambda m, kw: m.RetrievalMAP(**kw), _retrieval),
    "RetrievalMRR": (lambda m, kw: m.RetrievalMRR(**kw), _retrieval),
    "RetrievalNormalizedDCG": (lambda m, kw: m.RetrievalNormalizedDCG(**kw), _retrieval),
    "RetrievalPrecision": (lambda m, kw: m.RetrievalPrecision(k=2, **kw), _retrieval),
    "RetrievalRecall": (lambda m, kw: m.RetrievalRecall(**kw), _retrieval),
    "RetrievalRPrecision": (lambda m, kw: m.RetrievalRPrecision(**kw), _retrieval),
    "ROC": (lambda m, kw: m.ROC(**kw), _binary),
    "ROC-capacity": (lambda m, kw: m.ROC(num_classes=_C, capacity=32, **kw), _cls),
    "SpearmanCorrCoef": (lambda m, kw: m.SpearmanCorrCoef(**kw), _reg),
    "Specificity": (lambda m, kw: m.Specificity(num_classes=_C, average="macro", **kw), _cls),
    "StatScores": (lambda m, kw: m.StatScores(num_classes=_C, reduce="macro", **kw), _cls),
    "SumMetric": (lambda m, kw: m.SumMetric(**kw), _values),
    "SymmetricMeanAbsolutePercentageError": (lambda m, kw: m.SymmetricMeanAbsolutePercentageError(**kw), _reg),
    "TweedieDevianceScore": (lambda m, kw: m.TweedieDevianceScore(power=1.5, **kw), _reg),
    "BERTScore": (lambda m, kw: m.BERTScore(user_forward_fn=_bert_encoder(m), **kw), _text),
    "BLEUScore": (lambda m, kw: m.BLEUScore(**kw), _text_lists),
    "CharErrorRate": (lambda m, kw: m.CharErrorRate(**kw), _text),
    "CHRFScore": (lambda m, kw: m.CHRFScore(**kw), _text),
    "CHRFScore-sentences": (lambda m, kw: m.CHRFScore(return_sentence_level_score=True, **kw), _text),
    "MatchErrorRate": (lambda m, kw: m.MatchErrorRate(**kw), _text),
    "ROUGEScore": (lambda m, kw: m.ROUGEScore(**kw), _text),
    "SacreBLEUScore": (lambda m, kw: m.SacreBLEUScore(**kw), _text_lists),
    "SQuAD": (lambda m, kw: m.SQuAD(**kw), _squad),
    "TranslationEditRate": (lambda m, kw: m.TranslationEditRate(**kw), _text),
    "WordErrorRate": (lambda m, kw: m.WordErrorRate(**kw), _text),
    "WordInfoLost": (lambda m, kw: m.WordInfoLost(**kw), _text),
    "WordInfoPreserved": (lambda m, kw: m.WordInfoPreserved(**kw), _text),
    "MAP": (lambda m, kw: m.MAP(**kw), _detection),
}


def test_every_exported_metric_is_in_the_merge_table():
    exported = {n for n in mp.__all__ if isinstance(getattr(mp, n), type) and issubclass(getattr(mp, n), mp.Metric)}
    aliases = {"Metric", "BaseAggregator", "RetrievalMetric", "Hinge", "IoU", "MatthewsCorrcoef", "PearsonCorrcoef",
               "SpearmanCorrcoef", "WER", "SNR", "SDR", "PIT", "SI_SDR", "SI_SNR", "FrechetInceptionDistance",
               "KernelInceptionDistance", "InceptionScore", "MeanAveragePrecision"}
    # PESQ cannot be built without the native pesq package; its states (a float sum, an int32 count) are
    # SignalNoiseRatio's, and tests/test_torch_audio.py holds it to JAX under a fake package
    aliases.add("PESQ")
    assert exported - aliases <= {k.split("-")[0] for k in _ALL}


@pytest.mark.parametrize("name", list(_ALL))
def test_merge_stacked_states_equals_jax(name):
    """``stacked_merge_unsupported_reason`` says what JAX's says; where the
    merge applies, the port's fold of three ranks' stacked states equals
    JAX's on the same numpy stack, leaf for leaf, bit for bit."""
    build, data = _ALL[name]
    pm, jm = build(mp, {"device": "cpu"}), build(mt, {})
    reason = pm.stacked_merge_unsupported_reason()
    assert reason == jm.stacked_merge_unsupported_reason()
    if reason is not None:
        with pytest.raises(MetricsTPUUserError, match="no stacked state merge"):
            pm.merge_stacked_states(pm.init_state())
        return
    states = [pm.update_state(pm.init_state(), *(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                                                 for x in data(12, 30 + r))) for r in range(3)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *[_tree_np(w.to_np(s)) for s in states])
    got = _tree_np(w.to_np(pm.merge_stacked_states(jax.tree.map(torch.from_numpy, stacked))))
    want = jax.tree.map(np.asarray, jm.merge_stacked_states(jax.tree.map(jnp.asarray, stacked)))
    _same(got, want)


def test_collection_stacked_merge_and_leaf_info_equal_jax():
    def coll(m, **kw):
        return m.MetricCollection({
            "acc": m.Accuracy(**kw),
            "mse": m.MeanSquaredError(sync_precision="q8_block", **kw),
            "boot": m.BootStrapper(m.Accuracy(num_classes=_C, **kw), num_bootstraps=2, seed=0),
        })

    pc, jc = coll(mp, device="cpu"), coll(mt)
    assert pc.stacked_merge_unsupported_reason() == jc.stacked_merge_unsupported_reason() is None
    got = [(fx, tuple(s.shape), str(s.dtype).replace("torch.", ""), p) for fx, s, p in pc.sync_leaf_info()]
    want = [(fx, tuple(s.shape), np.dtype(s.dtype).name, p) for fx, s, p in jc.sync_leaf_info()]
    assert got == want
    stacked = {"acc": {k: np.arange(3, dtype=np.int32) for k in ("tp", "fp", "tn", "fn")},
               "mse": {"sum_squared_error": np.array([1.5, 1e-3, 250.0], np.float32),
                       "total": np.arange(3, dtype=np.int32)}}
    bounds = pc["mse"].sync_error_bounds(stacked["mse"])
    jbounds = jc["mse"].sync_error_bounds(stacked["mse"])
    assert sorted(bounds) == sorted(jbounds) == ["sum_squared_error"]
    np.testing.assert_array_equal(bounds["sum_squared_error"], jbounds["sum_squared_error"])
    assert sorted(pc.sync_error_bounds({"acc": {}, "mse": stacked["mse"], "boot": {}})) == ["mse.sum_squared_error"]
    with pytest.raises(MetricsTPUUserError):
        mp.MetricCollection({"p": mp.PearsonCorrCoef(device="cpu")}).merge_stacked_states({"p": {}})


def test_port_and_sync_worker_import_no_jax():
    """The port and its parallel package, and the ranks' module, load without
    JAX or the JAX package."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import metrics_tpu_torch, metrics_tpu_torch.parallel, tests.helpers.torch_sync_worker;"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu'));"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(Path(__file__).resolve().parents[1]))
