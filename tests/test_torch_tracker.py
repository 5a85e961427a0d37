"""The port's ``DriftDetector`` against the JAX package's, on the CPU.

The detector is pure in the value sequence, so the same scripted series,
recorded into both packages' detectors, must give the same transitions (each
``DriftAlarm`` field equal), the same ``history()`` of every series, the same
``alarmed_series()`` and the same ``summary()``. The series are
``tests/engine/test_tracker.py``'s, plus seeded random walks over every
baseline with several stream keys and collection results. Float values pass
through unchanged (``==``): the detector does Python float arithmetic on
both sides. The port's detector also reads tensors (f32, bf16, 0-d and not),
which must record as the numpy values they hold.
"""
import dataclasses

import numpy as np
import pytest
import torch

from metrics_tpu.engine import tracker as jtracker
from metrics_tpu_torch.engine import tracker as ptracker

PACKAGES = (jtracker, ptracker)


def _scripted():
    """``name -> (detector kwargs, [(value, key, pane), ...])``."""
    rng = np.random.RandomState(3)
    walk = [(float(v), None, p) for p, v in enumerate(rng.rand(30))]
    return {
        "hysteresis": (dict(threshold=0.1, up_after=2, down_after=2, baseline="first"),
                       [(v, None, p) for p, v in enumerate([0.5, 0.5, 0.8, 0.8, 0.5, 0.5, 0.5])]),
        "single_noisy_pane": (dict(threshold=0.1, up_after=2, down_after=1),
                              [(v, None, p) for p, v in enumerate([0.5, 0.9, 0.5, 0.9, 0.5])]),
        "prev_jump": (dict(threshold=0.1, up_after=1, baseline="prev"), [(0.5, None, None), (0.55, None, None),
                                                                          (0.8, None, None)]),
        "prev_slow_walk": (dict(threshold=0.1, up_after=1, baseline="prev"),
                           [(float(v), None, None) for v in np.arange(0.5, 2.0, 0.05)]),
        "mean": (dict(threshold=0.25, up_after=1, baseline="mean"), [(0.4, None, 0), (0.6, None, 1), (1.0, None, 2)]),
        "collection": (dict(threshold=0.1, up_after=1),
                       [({"Accuracy": 0.9, "MeanSquaredError": 0.1}, None, 0),
                        ({"Accuracy": 0.9, "MeanSquaredError": 0.5}, None, 1)]),
        "per_key": (dict(threshold=0.1, up_after=1), [(0.5, 0, None), (0.5, 1, None), (0.9, 1, None),
                                                      (0.5, 0, None)]),
        "min_panes": (dict(threshold=0.1, up_after=1, min_panes=3), [(v, None, None) for v in (0.5, 0.9, 0.9, 0.9)]),
        "seeded_walk": (dict(threshold=0.1, up_after=2, down_after=1), walk),
        "non_scalar_members": (dict(threshold=0.1, up_after=1),
                               [({"curve": np.zeros((3,)), "acc": 0.5}, None, 0),
                                ({"curve": np.ones((3,)), "acc": 0.9}, None, 1)]),
        "bounded_history": (dict(threshold=10.0, max_history=4, baseline="mean"),
                            [(float(v), None, v) for v in range(10)]),
    }


def _random_series(baseline, seed):
    """Three stream keys, collection results of two members whose level
    shifts halfway: raises, clears and quiet series in one run."""
    rng = np.random.RandomState(seed)
    out = []
    for pane in range(40):
        shift = 0.3 if 15 <= pane < 28 else 0.0
        for key in (0, 1, 2):
            acc = float(np.float32(0.6 + (shift if key == 1 else 0.0) + 0.08 * rng.randn()))
            out.append(({"acc": acc, "mse": float(np.float32(0.2 + 0.05 * rng.rand()))}, key, pane))
    return dict(threshold=0.15, up_after=2, down_after=3, baseline=baseline, max_history=16), out


def _run(pkg, kwargs, records):
    det = pkg.DriftDetector(**kwargs)
    transitions = [[dataclasses.astuple(a) for a in det.record(v, key=k, pane=p)] for v, k, p in records]
    return det, transitions


def _series_keys(records):
    keys = []
    for v, k, _ in records:
        names = [n for n, x in v.items() if np.ndim(x) == 0] if isinstance(v, dict) else [""]
        keys += [(k, n) for n in names if (k, n) not in keys]
    return keys


def _assert_same(jdet, pdet, jtrans, ptrans, records):
    assert ptrans == jtrans
    assert [dataclasses.astuple(a) for a in pdet.alarms()] == [dataclasses.astuple(a) for a in jdet.alarms()]
    for kind in ("raise", "clear"):
        assert len(pdet.alarms(kind)) == len(jdet.alarms(kind))
    assert [a.describe() for a in pdet.alarms()] == [a.describe() for a in jdet.alarms()]
    for key, name in _series_keys(records):
        assert pdet.history(key=key, name=name) == jdet.history(key=key, name=name), (key, name)
    assert pdet.alarmed_series() == jdet.alarmed_series()
    assert pdet.summary() == jdet.summary()
    assert pdet.evals == jdet.evals


@pytest.mark.parametrize("name", sorted(_scripted()))
def test_scripted_series_give_the_same_alarms_histories_and_summary(name):
    kwargs, records = _scripted()[name]
    (jdet, jtrans), (pdet, ptrans) = (_run(pkg, kwargs, records) for pkg in PACKAGES)
    _assert_same(jdet, pdet, jtrans, ptrans, records)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("baseline", ["first", "prev", "mean"])
def test_seeded_keyed_collections_give_the_same_alarms(baseline, seed):
    kwargs, records = _random_series(baseline, seed)
    (jdet, jtrans), (pdet, ptrans) = (_run(pkg, kwargs, records) for pkg in PACKAGES)
    _assert_same(jdet, pdet, jtrans, ptrans, records)
    if baseline == "first":  # the shifted stream raises and clears
        assert any(a.kind == "raise" and a.key == 1 for a in pdet.alarms())


def test_tensor_values_record_as_the_values_they_hold():
    """The engine hands its detector computed tensors: a 0-d f32 or bf16
    tensor, a collection of them, a non-scalar member (skipped)."""
    _, records = _random_series("first", 5)
    as_tensors = []
    for i, (v, k, p) in enumerate(records):
        dtype = torch.bfloat16 if i % 7 == 0 else torch.float32
        tv = {n: torch.tensor(x, dtype=dtype) for n, x in v.items()}
        tv["curve"] = torch.zeros(3)
        as_tensors.append((tv, k, p))
    widened = [({n: float(torch.tensor(x, dtype=torch.bfloat16 if i % 7 == 0 else torch.float32).float())
                 for n, x in v.items()}, k, p) for i, (v, k, p) in enumerate(records)]
    kwargs = dict(threshold=0.15, up_after=2, down_after=3)
    jdet, jtrans = _run(jtracker, kwargs, widened)
    pdet, ptrans = _run(ptracker, kwargs, as_tensors)
    _assert_same(jdet, pdet, jtrans, ptrans, widened)


@pytest.mark.parametrize("kwargs", [
    dict(threshold=0.0), dict(threshold=-1.0), dict(threshold=0.1, up_after=0), dict(threshold=0.1, down_after=0),
    dict(threshold=0.1, baseline="median"), dict(threshold=0.1, min_panes=0), dict(threshold=0.1, max_history=0),
])
def test_validation_gives_the_same_messages(kwargs):
    msgs = []
    for pkg in PACKAGES:
        with pytest.raises(ValueError) as ei:
            pkg.DriftDetector(**kwargs)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_raise_on_alarm_raises_the_typed_error_with_the_same_message():
    msgs = []
    for pkg in PACKAGES:
        det = pkg.DriftDetector(threshold=0.1, up_after=1, raise_on_alarm=True)
        det.record(0.5, pane=0)
        with pytest.raises(pkg.DriftAlarmError) as ei:
            det.record(0.9, pane=1)
        assert isinstance(ei.value.alarm, pkg.DriftAlarm)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "delta=+0.4" in msgs[1]


def test_reset_forgets_every_series_in_both():
    for pkg in PACKAGES:
        det = pkg.DriftDetector(threshold=0.1, up_after=1)
        det.record(0.5)
        det.record(0.9)
        det.reset()
        assert det.alarms() == [] and det.history() == [] and det.summary()["evals"] == 0
