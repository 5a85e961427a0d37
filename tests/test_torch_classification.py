"""The port's slice metrics against the JAX package's, on the CPU.

Each metric of ``metrics_tpu_torch`` (StatScores, Accuracy, FBeta/F1Score,
BinnedPrecisionRecallCurve, BinnedAveragePrecision, ConfusionMatrix) and its
functional form take the same numpy inputs, made from a seed, as its
``metrics_tpu`` twin (kernels under ``use_backend("pallas_interpret")``).
Integer states must be bit-exact, f32 values within ``atol=1e-6``. The masked
update (the bucketed engine step) is compared the same way, with garbage in the
masked rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.functional as mtf
import metrics_tpu_torch as mp
import metrics_tpu_torch.functional as mpf
from metrics_tpu.ops.kernels import use_backend

ATOL = 1e-6
C, T = 4, 11


def _inputs(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "multiclass_probs":
        p = rng.rand(n, C).astype(np.float32)
        return p / p.sum(1, keepdims=True), rng.randint(0, C, n)
    if kind == "multiclass_labels":
        return rng.randint(0, C, n), rng.randint(0, C, n)
    if kind == "binary_probs":
        return rng.rand(n).astype(np.float32), rng.randint(0, 2, n)
    if kind == "multilabel_probs":
        return rng.rand(n, C).astype(np.float32), rng.randint(0, 2, (n, C))
    raise ValueError(kind)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, equal_nan=True)


def _assert_states(port_state, jax_state):
    assert set(port_state) == set(jax_state)
    for k, v in jax_state.items():
        _assert_same(port_state[k], v)


METRICS = {
    "stat_scores_micro": (lambda m, **kw: m.StatScores(**kw), {}),
    "stat_scores_macro": (lambda m, **kw: m.StatScores(**kw), {"reduce": "macro", "num_classes": C}),
    "accuracy": (lambda m, **kw: m.Accuracy(**kw), {}),
    "accuracy_macro": (lambda m, **kw: m.Accuracy(**kw), {"average": "macro", "num_classes": C}),
    "accuracy_top2": (lambda m, **kw: m.Accuracy(**kw), {"top_k": 2}),
    "f1_macro": (lambda m, **kw: m.F1Score(**kw), {"num_classes": C, "average": "macro"}),
    "f1_micro": (lambda m, **kw: m.F1Score(**kw), {"num_classes": C}),
    "fbeta_weighted": (lambda m, **kw: m.FBeta(**kw), {"num_classes": C, "beta": 0.5, "average": "weighted"}),
    "binned_pr_curve": (lambda m, **kw: m.BinnedPrecisionRecallCurve(**kw), {"num_classes": C, "thresholds": T}),
    "binned_ap": (lambda m, **kw: m.BinnedAveragePrecision(**kw), {"num_classes": C, "thresholds": T}),
    "confmat": (lambda m, **kw: m.ConfusionMatrix(**kw), {"num_classes": C}),
    "confmat_true": (lambda m, **kw: m.ConfusionMatrix(**kw), {"num_classes": C, "normalize": "true"}),
}
KINDS = {
    "stat_scores_micro": "multiclass_probs",
    "stat_scores_macro": "multiclass_labels",
    "accuracy": "multiclass_probs",
    "accuracy_macro": "multiclass_probs",
    "accuracy_top2": "multiclass_probs",
    "f1_macro": "multiclass_probs",
    "f1_micro": "multiclass_labels",
    "fbeta_weighted": "multiclass_probs",
    "binned_pr_curve": "multiclass_probs",
    "binned_ap": "multilabel_probs",
    "confmat": "multiclass_probs",
    "confmat_true": "multiclass_labels",
}


def _pair(name):
    make, kw = METRICS[name]
    return make(mt, **kw), make(mp, device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_update_compute_matches_jax(name):
    jm, pm = _pair(name)
    for seed in (0, 1):
        preds, target = _inputs(KINDS[name], 96, seed)
        with use_backend("pallas_interpret"):
            jm.update(jnp.asarray(preds), jnp.asarray(target))
        pm.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_states({k: getattr(pm, k) for k in pm._defaults}, {k: getattr(jm, k) for k in jm._defaults})
    _assert_same(pm.compute(), jm.compute())
    pm.reset()
    for k, v in pm._defaults.items():
        assert torch.equal(getattr(pm, k), v)


@pytest.mark.parametrize("name", ["accuracy", "f1_macro", "binned_ap", "confmat", "stat_scores_macro"])
def test_update_state_masked_matches_jax(name):
    jm, pm = _pair(name)
    preds, target = _inputs(KINDS[name], 24, 3)
    mask = np.arange(24) < 17
    # garbage in the masked rows: out-of-range labels, huge and NaN scores
    target = target.copy()
    if target.ndim == 1 and KINDS[name] != "binary_probs":
        target[17:] = C + 2
    if preds.dtype == np.float32:
        preds = preds.copy()
        preds[17:] = 1e6
        preds[20:] = np.nan
    with use_backend("pallas_interpret"):
        want = jm.update_state_masked(jm.init_state(), jnp.asarray(preds), jnp.asarray(target), mask=jnp.asarray(mask))
    got = pm.update_state_masked(pm.init_state(), torch.from_numpy(preds), torch.from_numpy(target),
                                 mask=torch.from_numpy(mask))
    _assert_states(got, want)
    # the masked update of the valid rows equals the plain update of those rows
    ref = pm.update_state(pm.init_state(), torch.from_numpy(preds[:17]), torch.from_numpy(target[:17]))
    _assert_states(got, ref)


def test_binary_inputs_match_jax():
    preds, target = _inputs("binary_probs", 64, 4)
    for make in (lambda m, **kw: m.Accuracy(**kw), lambda m, **kw: m.StatScores(**kw),
                 lambda m, **kw: m.F1Score(**kw)):
        jm, pm = make(mt), make(mp, device="cpu")
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        pm.update(torch.from_numpy(preds), torch.from_numpy(target))
        _assert_same(pm.compute(), jm.compute())


def test_multilabel_confusion_matrix_matches_jax():
    preds, target = _inputs("multilabel_probs", 64, 5)
    jm = mt.ConfusionMatrix(num_classes=C, multilabel=True)
    pm = mp.ConfusionMatrix(num_classes=C, multilabel=True, device="cpu")
    with use_backend("pallas_interpret"):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
    pm.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_same(pm.compute(), jm.compute())
    assert pm.confmat.dtype == torch.int32


@pytest.mark.parametrize(
    "fn,kwargs,kind",
    [
        ("accuracy", {}, "multiclass_probs"),
        ("accuracy", {"average": "macro", "num_classes": C}, "multiclass_labels"),
        ("stat_scores", {"reduce": "macro", "num_classes": C}, "multiclass_probs"),
        ("f1_score", {"num_classes": C, "average": "macro"}, "multiclass_probs"),
        ("fbeta", {"num_classes": C, "beta": 2.0}, "multiclass_probs"),
        ("confusion_matrix", {"num_classes": C, "normalize": "all"}, "multiclass_probs"),
        ("precision_recall_curve", {"num_classes": C}, "multiclass_probs"),
        ("average_precision", {"num_classes": C}, "multiclass_probs"),
    ],
)
def test_functional_matches_jax(fn, kwargs, kind):
    preds, target = _inputs(kind, 80, 6)
    with use_backend("pallas_interpret"):
        want = getattr(mtf, fn)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(mpf, fn)(torch.from_numpy(preds), torch.from_numpy(target), device="cpu", **kwargs)
    _assert_same(got, want)


def test_states_keep_jax_dtypes():
    for name in METRICS:
        jm, pm = _pair(name)
        for k, v in jm._defaults.items():
            assert str(getattr(pm, k).dtype).replace("torch.", "") == str(jnp.asarray(v).dtype), (name, k)


def test_value_checks_run_eagerly():
    pm = mp.Accuracy(device="cpu")
    with pytest.raises(ValueError):
        pm.update(torch.tensor([0, 1, 2]), torch.tensor([0, -1, 2]))
    with pytest.raises(ValueError):
        mp.StatScores(multiclass=False, device="cpu").update(torch.tensor([0, 1]), torch.tensor([0, 2]))
