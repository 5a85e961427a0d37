"""The port's two-process fleet harness, held against the JAX package.

One run of ``metrics_tpu_torch.engine.fleet.harness`` (three rounds of two
spawned workers over gloo, ~15 s) for the module: its own claims hold, and
both hosts' ``results()`` equal the JAX package's single-process
``MultiStreamEngine`` serving the harness's plan in this process (S = 16,
120 batches, cuts every 30, host 1 killed at 75), counts bit-equal and
floats within 1e-6, for the plain hosts, the restored ones, and the
tenancy hosts against JAX's windowed engine. The workers import nothing of
JAX.
"""
import numpy as np
import pytest

import metrics_tpu as mt
import metrics_tpu.engine as je
from metrics_tpu.engine.traffic import zipf_traffic as jax_zipf_traffic
from metrics_tpu_torch.engine.fleet import harness

RTOL = 1e-6


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    return harness.run(str(tmp_path_factory.mktemp("fleet_harness")))


@pytest.fixture(scope="module")
def jax_oracle():
    plan = jax_zipf_traffic(harness.S, harness.N_BATCHES, alpha=1.1, seed=harness.SEED)
    for (sid, p, t), (psid, pp, pt) in zip(plan, harness.traffic()):
        assert sid == psid and np.array_equal(p, pp) and np.array_equal(t, pt)
    out = {}
    window = je.WindowPolicy.tumbling(pane_batches=harness.PANE_BATCHES, n_panes=harness.N_PANES)
    for form, w in (("plain", None), ("tenancy", window)):
        eng = je.MultiStreamEngine(mt.MetricCollection([mt.Accuracy(), mt.MeanSquaredError()]), harness.S,
                                   je.EngineConfig(buckets=harness.BUCKETS, window=w))
        with eng:
            for sid, p, t in plan:
                eng.submit(sid, p, t)
            out[form] = {str(sid): {k: np.asarray(v) for k, v in r.items()} for sid, r in eng.results().items()}
    return out


def _same(got, want, what):
    assert set(got) == set(want), what
    for sid in want:
        for k, w in want[sid].items():
            g = np.asarray(got[sid][k], dtype=w.dtype)
            if np.issubdtype(w.dtype, np.integer):
                assert np.array_equal(g, w), (what, sid, k)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, equal_nan=True, err_msg=f"{what} {sid} {k}")


def test_harness_claims_hold(report):
    assert report["failures"] == []
    assert all(not o.get("imported_jax", True) for rnd in ("serve", "restore") for o in report[rnd])


@pytest.mark.parametrize("form", ["plain", "tenancy"])
def test_both_hosts_equal_the_jax_single_process_engine(report, jax_oracle, form):
    for p, o in enumerate(report["serve"]):
        for run_ix, r in enumerate(o[form]):
            _same(r["results"], jax_oracle[form], f"{form} host {p} run {run_ix}")


@pytest.mark.parametrize("form", ["plain", "tenancy"])
def test_same_seed_rerun_is_identical(report, form):
    for o in report["serve"]:
        a, b = o[form]
        assert harness.results_equal(a["results"], b["results"])
        assert a["spans"] == b["spans"] and a["spans"]
        assert a["steady_compiles"] == b["steady_compiles"] == 0
        assert not any(a["steady_collectives"].values()) and sum(a["fold_collectives"].values()) >= 1


@pytest.mark.parametrize("form", ["plain", "tenancy"])
def test_kill_restore_replay_equals_the_jax_engine(report, jax_oracle, form):
    assert [o[form]["restored_cut"] for o in report["restore"]] == [harness.KILL_AT // harness.CUT_EVERY - 1] * 2
    for p, o in enumerate(report["restore"]):
        _same(o[form]["results"], jax_oracle[form], f"restored {form} host {p}")
    if form == "tenancy":
        assert report["kill"][0]["tenancy"]["spilled_rows"] > 0
        assert all(o["tenancy"]["spilled_rows"] > 0 for o in report["restore"])
