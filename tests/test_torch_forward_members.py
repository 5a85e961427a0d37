"""The port's compiled forward, metric by metric, against the JAX package's
compiled (``jit``) forward on the CPU.

Each metric takes four seeded numpy batches of one signature through JAX
``m(x)`` and the port's ``m(x)``: the first runs eagerly in both, the second
builds the step, the rest reuse it. Covered: the flagship's four members, the
classification dashboard's counting metrics, the regression members (R2Score
stays eager-only: its compute reads ``n_obs`` on the host, which JAX cannot
trace and the port's traced body refuses) and ``MeanMetric``.

Held: every per-batch value and the final states against JAX (integers
bit-exact, floats within 1e-6) and against the port's eager twin (the same
metric with the compiled path off: bit-exact, values too), the final
``compute()`` against JAX's, and each signature's entry kind equal to JAX's
``_FORWARD_JIT_CACHE``.
"""
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.metric as jax_metric
import metrics_tpu_torch as mp
from metrics_tpu_torch.metric import forward_entry_kinds, keep_forward_eager
from metrics_tpu_torch.utils.state_bridge import state_to_numpy

RTOL = ATOL = 1e-6
C = 5
N = 48
BATCHES = 4


def jax_entry_kinds(owner):
    """Each signature's entry of ``owner`` in the JAX package's forward
    cache: compiled, eager_only or pending (the port's counterpart is
    ``metrics_tpu_torch.metric.forward_entry_kinds``)."""
    cache = jax_metric._FORWARD_JIT_CACHE.get(owner) or {}
    return ["eager_only" if v is jax_metric._EAGER_ONLY else "pending" if v is jax_metric._PENDING else "compiled"
            for v in cache.values()]


def _class_batches(seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(BATCHES):
        p = rng.rand(N, C).astype(np.float32)
        out.append((p / p.sum(1, keepdims=True), rng.randint(0, C, N)))
    return out


def _reg_batches(seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(BATCHES):
        t = rng.gamma(2.0, 1.0, N).astype(np.float32)
        out.append(((t * np.exp(rng.normal(0.0, 0.3, N))).astype(np.float32), t))
    return out


def _mean_batches(seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(N).astype(np.float32),) for _ in range(BATCHES)]


# name -> (class name, constructor kwargs, batches, JAX's entry kinds after the run)
CASES = {
    "accuracy": ("Accuracy", {}, _class_batches, ["compiled"]),
    "f1_macro": ("F1Score", {"num_classes": C, "average": "macro"}, _class_batches, ["compiled"]),
    "binned_ap": ("BinnedAveragePrecision", {"num_classes": C, "thresholds": 10}, _class_batches, ["compiled"]),
    "confmat": ("ConfusionMatrix", {"num_classes": C}, _class_batches, ["compiled"]),
    "precision": ("Precision", {"num_classes": C, "average": "macro"}, _class_batches, ["compiled"]),
    "recall": ("Recall", {"num_classes": C, "average": "macro"}, _class_batches, ["compiled"]),
    "specificity": ("Specificity", {"num_classes": C, "average": "macro"}, _class_batches, ["compiled"]),
    "hamming": ("HammingDistance", {}, _class_batches, ["compiled"]),
    "jaccard": ("JaccardIndex", {"num_classes": C}, _class_batches, ["compiled"]),
    "kappa": ("CohenKappa", {"num_classes": C}, _class_batches, ["compiled"]),
    "mcc": ("MatthewsCorrCoef", {"num_classes": C}, _class_batches, ["compiled"]),
    "hinge": ("HingeLoss", {}, _class_batches, ["compiled"]),
    "mse": ("MeanSquaredError", {}, _reg_batches, ["compiled"]),
    "rmse": ("MeanSquaredError", {"squared": False}, _reg_batches, ["compiled"]),
    "mae": ("MeanAbsoluteError", {}, _reg_batches, ["compiled"]),
    "msle": ("MeanSquaredLogError", {}, _reg_batches, ["compiled"]),
    "mape": ("MeanAbsolutePercentageError", {}, _reg_batches, ["compiled"]),
    "smape": ("SymmetricMeanAbsolutePercentageError", {}, _reg_batches, ["compiled"]),
    "explained_variance": ("ExplainedVariance", {}, _reg_batches, ["compiled"]),
    "tweedie": ("TweedieDevianceScore", {"power": 1.5}, _reg_batches, ["compiled"]),
    "r2": ("R2Score", {}, _reg_batches, ["eager_only"]),
    "mean": ("MeanMetric", {"nan_strategy": "ignore"}, _mean_batches, ["compiled"]),
}


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tree(got, want, exact=False, path=""):
    """``got`` against ``want``: integers bit-exact, floats within 1e-6 (or
    bit-exact with ``exact``), shapes equal."""
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_tree(got[k], want[k], exact, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree(g, w, exact, f"{path}[{i}]")
    else:
        assert got.shape == want.shape, (path, got.shape, want.shape)
        if exact or want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_compiled_forward_matches_jax_and_the_eager_twin(name):
    cls, kwargs, make_batches, jax_kinds = CASES[name]
    batches = make_batches(sum(map(ord, name)))
    jm = getattr(mt, cls)(**kwargs)
    pm = getattr(mp, cls)(device="cpu", **kwargs)
    twin = keep_forward_eager(getattr(mp, cls)(device="cpu", **kwargs))  # the eager forward, every call
    for i, batch in enumerate(batches):
        jv = jm(*batch)
        pv = pm(*(torch.from_numpy(x) for x in batch))
        tv = twin(*(torch.from_numpy(x) for x in batch))
        assert_tree(pv, jv, path=f"{name} batch {i} vs JAX")
        assert_tree(pv, tv, exact=True, path=f"{name} batch {i} vs eager twin")
    assert jax_entry_kinds(jm) == jax_kinds
    assert forward_entry_kinds(pm) == jax_kinds
    assert_tree(state_to_numpy(pm._pack_state()), {k: np.asarray(v) for k, v in jm._pack_state().items()},
                path=f"{name} state vs JAX")
    assert_tree(pm._pack_state(), twin._pack_state(), exact=True, path=f"{name} state vs eager twin")
    assert_tree(pm.compute(), jm.compute(), path=f"{name} compute")
