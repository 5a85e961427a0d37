"""The port's metric runtime and collection, on the CPU.

``Metric`` (an ``nn.Module`` with the JAX package's pure API kept under its
names) and ``MetricCollection`` are held against ``metrics_tpu`` on the
flagship four-metric collection (Accuracy, macro F1, binned AP, confusion
matrix): ``update``/``compute`` and the masked bucket step
``update_state_masked``, with the JAX kernels under
``use_backend("pallas_interpret")``. Integer states bit-exact, f32 values
within ``atol=1e-6``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.ops.kernels import use_backend
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

C, T = 5, 11


def _collection(m, **kw):
    return m.MetricCollection({
        "acc": m.Accuracy(**kw),
        "f1": m.F1Score(num_classes=C, average="macro", **kw),
        "ap": m.BinnedAveragePrecision(num_classes=C, thresholds=T, **kw),
        "cm": m.ConfusionMatrix(num_classes=C, **kw),
    })


def _data(n, seed):
    rng = np.random.RandomState(seed)
    p = rng.rand(n, C).astype(np.float32)
    return p / p.sum(1, keepdims=True), rng.randint(0, C, n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_states(got, want):
    assert set(got) == set(want)
    for k in want:
        assert set(got[k]) == set(want[k]), k
        for s, w in want[k].items():
            g, w = _np(got[k][s]), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (k, s)
            np.testing.assert_array_equal(g, w)


def _assert_values(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k]
        g = np.stack([_np(v) for v in g]) if isinstance(g, list) else _np(g)
        w = want[k]
        w = np.stack([np.asarray(v) for v in w]) if isinstance(w, list) else np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_collection_update_compute_matches_jax():
    jc, pc = _collection(mt), _collection(mp, device="cpu")
    for seed in (0, 1, 2):
        preds, target = _data(80, seed)
        with use_backend("pallas_interpret"):
            jc.update(jnp.asarray(preds), jnp.asarray(target))
        pc.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_values(pc.compute(), jc.compute())
    _assert_states({k: {s: getattr(m, s) for s in m._defaults} for k, m in pc.items(keep_base=True)},
                   {k: {s: getattr(m, s) for s in m._defaults} for k, m in jc.items(keep_base=True)})


def test_collection_pure_api_matches_jax():
    jc, pc = _collection(mt), _collection(mp, device="cpu")
    preds, target = _data(64, 4)
    with use_backend("pallas_interpret"):
        js = jc.update_state(jc.init_state(), jnp.asarray(preds), jnp.asarray(target))
        jv = jc.compute_from(js)
    ps = pc.update_state(pc.init_state(), torch.from_numpy(preds), torch.from_numpy(target))
    _assert_states(ps, js)
    _assert_values(pc.compute_from(ps), jv)


def test_collection_masked_bucket_step_matches_jax():
    """The bucketed engine step: garbage pad rows contribute nothing."""
    jc, pc = _collection(mt), _collection(mp, device="cpu")
    preds, target = _data(32, 5)
    mask = np.arange(32) < 21
    preds[21:] = np.nan
    target[21:] = C + 3
    with use_backend("pallas_interpret"):
        js = jc.update_state_masked(jc.init_state(), jnp.asarray(preds), jnp.asarray(target), mask=jnp.asarray(mask))
    ps = pc.update_state_masked(pc.init_state(), torch.from_numpy(preds), torch.from_numpy(target),
                                mask=torch.from_numpy(mask))
    _assert_states(ps, js)
    ref = pc.update_state(pc.init_state(), torch.from_numpy(preds[:21]), torch.from_numpy(target[:21]))
    _assert_states(ps, {k: {s: _np(v) for s, v in m.items()} for k, m in ref.items()})
    _assert_values(pc.compute_from(ps), pc.compute_from(ref))


def test_masked_buckets_equal_one_shot_update():
    pc = _collection(mp, device="cpu")
    preds, target = _data(100, 6)
    state = pc.init_state()
    for lo in range(0, 100, 24):  # ragged buckets padded to 32 rows
        valid = min(24, 100 - lo)
        p = np.full((32, C), 7.0, np.float32)
        t = np.full(32, -4)
        p[:valid], t[:valid] = preds[lo:lo + valid], target[lo:lo + valid]
        state = pc.update_state_masked(state, torch.from_numpy(p), torch.from_numpy(t),
                                       mask=torch.from_numpy(np.arange(32) < valid))
    ref = pc.update_state(pc.init_state(), torch.from_numpy(preds), torch.from_numpy(target))
    _assert_states(state, {k: {s: _np(v) for s, v in m.items()} for k, m in ref.items()})


def test_forward_returns_batch_value_and_accumulates():
    jm, pm = mt.F1Score(num_classes=C, average="macro"), mp.F1Score(num_classes=C, average="macro", device="cpu")
    for seed in (7, 8):
        preds, target = _data(40, seed)
        jb = jm(jnp.asarray(preds), jnp.asarray(target))
        pb = pm(torch.from_numpy(preds), torch.from_numpy(target))
        np.testing.assert_allclose(_np(pb), np.asarray(jb), atol=1e-6)
    np.testing.assert_allclose(_np(pm.compute()), np.asarray(jm.compute()), atol=1e-6)


def test_stateful_facade_and_state_dict():
    m = mp.ConfusionMatrix(num_classes=C, device="cpu")
    assert isinstance(m, torch.nn.Module)
    preds, target = _data(30, 9)
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert int(m.confmat.sum()) == 30 and m.confmat.dtype == torch.int32
    assert "confmat" not in m.state_dict()
    m.persistent(True)
    assert torch.equal(m.state_dict()["confmat"], m.confmat)
    value = m.compute()
    assert m.compute() is value  # cached until the next update
    m.reset()
    assert int(m.confmat.sum()) == 0


def test_pure_api_leaves_the_module_state_alone():
    m = mp.Accuracy(device="cpu")
    preds, target = _data(20, 10)
    state = m.update_state(m.init_state(), torch.from_numpy(preds), torch.from_numpy(target))
    assert int(state["tp"]) + int(state["fn"]) == 20
    assert int(m.tp) == 0 and int(m.fn) == 0


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert mp.Accuracy().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mp.Accuracy()
    with pytest.raises(RuntimeError):
        mp.MetricCollection([mp.ConfusionMatrix(num_classes=C)])


def test_add_state_validates():
    m = mp.ConfusionMatrix(num_classes=2, device="cpu")
    with pytest.raises(ValueError):
        m.add_state("bad", default=3)
    with pytest.raises(ValueError):
        m.add_state("bad", default=torch.zeros(1), dist_reduce_fx="median")


def test_list_state_metric_has_no_masked_update():
    m = mp.StatScores(reduce="samples", device="cpu")
    assert m.masked_update_strategy() is None
    with pytest.raises(MetricsTPUUserError, match="list"):
        m.update_state_masked(m.init_state(), torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64),
                              mask=torch.ones(4, dtype=torch.bool))


def test_value_checks_are_skipped_under_vmap_only():
    """Under ``torch.func.vmap`` a value-dependent ``if`` cannot run, so the
    checks skip there, as the JAX package skips them on tracers."""
    from metrics_tpu_torch.utils.checks import _compute_value_stats

    preds, target = torch.tensor([0, 1, 2]), torch.tensor([0, 1, 2])
    assert _compute_value_stats(preds, target) is not None
    seen = []
    torch.func.vmap(lambda p, t: seen.append(_compute_value_stats(p, t)) or p)(preds, target)
    assert seen == [None]


def test_sync_precision_policy_matches_jax():
    """The quantization policy the engine's codec reads: which states a
    blanket ``q8_block`` marks, and the tag, as in the JAX package."""
    jc, pc = _collection(mt), _collection(mp, device="cpu")
    for c in (jc, pc):
        c.set_sync_precision({"ap": "q8_block"})
    assert pc.state_sync_precisions() == jc.state_sync_precisions()
    assert pc.sync_precision_tag() == jc.sync_precision_tag() != "exact"
    assert {k for k, v in pc.state_sync_precisions().items() if v == "q8_block"} == {"ap.TPs", "ap.FPs", "ap.FNs"}
    # counts never quantize: a dict naming one raises, a blanket string skips it
    with pytest.raises(MetricsTPUUserError, match="exact"):
        mp.ConfusionMatrix(num_classes=C, device="cpu", sync_precision={"confmat": "q8_block"})
    assert mp.ConfusionMatrix(num_classes=C, device="cpu", sync_precision="q8_block").sync_precision_tag() == "exact"
    with pytest.raises(MetricsTPUUserError, match="never registered"):
        mp.Accuracy(device="cpu", sync_precision={"nope": "q8_block"}).state_sync_precisions()
    with pytest.raises(ValueError, match="sync_precision"):
        mp.Accuracy(device="cpu", sync_precision="q4")
