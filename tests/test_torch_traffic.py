"""The port's seeded traffic generator (``metrics_tpu_torch/engine/traffic.py``)
against the JAX package's: plain, hot-spot-shifted and drifted draws, bit for
bit, for the same arguments."""
import numpy as np
import pytest

import metrics_tpu.engine.traffic as jt
import metrics_tpu_torch.engine.traffic as pt

ID_CASES = {
    "plain": dict(num_streams=16, n=500, alpha=1.1, seed=3),
    "steep": dict(num_streams=10_000, n=1840, alpha=1.05, seed=0),
    "shift_default_rotation": dict(num_streams=16, n=100, alpha=1.4, seed=7, shift_at=60),
    "shift_rotation": dict(num_streams=24, n=200, alpha=1.2, seed=5, shift_at=120, shift_rotation=12),
    "shift_alpha": dict(num_streams=16, n=400, alpha=2.5, seed=1, shift_at=200, shift_alpha=0.2),
    "shift_at_zero": dict(num_streams=8, n=50, seed=2, shift_at=0),
    "shift_past_end": dict(num_streams=8, n=50, seed=2, shift_at=50),
}

TRAFFIC_CASES = {
    "plain": dict(num_streams=32, n_batches=40, alpha=1.3, seed=9, max_rows=7),
    "shifted": dict(num_streams=16, n_batches=56, alpha=1.6, seed=31, max_rows=6, shift_at=24, shift_rotation=8),
    "score_drift": dict(num_streams=8, n_batches=30, seed=4, drift_at=10, drift_ramp=5, drift_score=0.25),
    "label_drift": dict(num_streams=8, n_batches=30, seed=4, drift_at=10, drift_ramp=5, drift_flip=0.4,
                        label_acc=0.9),
    "both_drifts_and_shift": dict(num_streams=12, n_batches=48, alpha=1.2, seed=6, max_rows=9, shift_at=20,
                                  shift_alpha=0.7, drift_at=12, drift_ramp=8, drift_score=0.3, drift_flip=0.2,
                                  label_acc=0.8),
    "paged_tenancy": dict(num_streams=10_000, n_batches=200, alpha=1.05, seed=0, max_rows=64, shift_at=100,
                          shift_rotation=5000),
}


@pytest.mark.parametrize("case", sorted(ID_CASES))
def test_stream_ids_equal_jax_bit_for_bit(case):
    kw = ID_CASES[case]
    got, want = pt.zipf_stream_ids(**kw), jt.zipf_stream_ids(**kw)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", sorted(TRAFFIC_CASES))
def test_batches_equal_jax_bit_for_bit(case):
    kw = TRAFFIC_CASES[case]
    got, want = pt.zipf_traffic(**kw), jt.zipf_traffic(**kw)
    assert len(got) == len(want) == kw["n_batches"]
    for (gs, gp, gt), (ws, wp, wt) in zip(got, want):
        assert gs == ws and type(gs) is int
        assert gp.dtype == wp.dtype == np.float32 and gp.tobytes() == wp.tobytes()
        assert gt.dtype == wt.dtype == np.int32 and np.array_equal(gt, wt)


def test_shift_prefix_is_the_unshifted_draw_and_the_head_moves():
    base = pt.zipf_stream_ids(16, 100, alpha=1.4, seed=7)
    shifted = pt.zipf_stream_ids(16, 100, alpha=1.4, seed=7, shift_at=60)
    assert np.array_equal(shifted[:60], base[:60])
    assert not np.array_equal(shifted[60:], base[60:])


def test_drift_prefix_is_undrifted_and_values_stay_dyadic():
    base = pt.zipf_traffic(8, 30, seed=4)
    drifted = pt.zipf_traffic(8, 30, seed=4, drift_at=10, drift_score=0.5, drift_flip=0.5)
    for (bs, bp, bt), (ds, dp, dt) in zip(base[:10], drifted[:10]):
        assert bs == ds and np.array_equal(bp, dp) and np.array_equal(bt, dt)
    for _, p, _ in drifted:
        assert np.array_equal(p * 64, np.round(p * 64)) and p.min() >= 0 and p.max() <= 1


@pytest.mark.parametrize("kw", [dict(num_streams=0, n=3), dict(num_streams=3, n=-1),
                                dict(num_streams=3, n=3, shift_at=-1)])
def test_bad_arguments_raise_as_jax(kw):
    with pytest.raises(ValueError):
        jt.zipf_stream_ids(**kw)
    with pytest.raises(ValueError):
        pt.zipf_stream_ids(**kw)
