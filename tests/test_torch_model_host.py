"""The port's model host at world 1 against the JAX package's, on the CPU.

The same demo model (``tanh(x @ w + b)``) is served by both packages' hosts:
the f32 path bit-equal to the direct forward at the bucket shape, padded
requests against the unpadded forward, zero steady-state captures over
varied traffic, coalescing, the closed host and a serving error, the bf16
and int8 paths within JAX's bounds, precision in the program key, the
registry's dedup; then the InceptionV3 host (75 x 75, the seeded fill):
features bit-equal to the direct extractor at the same padded shape, FID
and KID sharing one host, BERTScore through a hosted encoder, the
OpenMetrics text and the engine's telemetry section, and the refusals
(``mesh=``, ``cache_dir=``, parameter shardings, pipeline stages).
Counters are held equal to JAX's host over the same requests.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metrics_tpu.engine import model_host as jmh
from metrics_tpu_torch.engine import model_host as pmh
from metrics_tpu_torch.utils.exceptions import NotPortedError

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

CPU = torch.device("cpu")
SIZE = 75


@pytest.fixture(autouse=True)
def _fresh_registry():
    pmh.reset_host_registry()
    jmh.reset_host_registry()
    yield
    pmh.reset_host_registry()
    jmh.reset_host_registry()


def _params(seed=0, din=6, dout=4):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(din, dout).astype(np.float32), "b": rng.randn(dout).astype(np.float32)}


def p_forward(params, x):
    # a bf16 input promotes to the f32 weights, as jnp's does
    return torch.tanh(x.to(params["w"].dtype) @ params["w"] + params["b"])


def j_forward(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def p_host(precision="f32", seed=0, aot=None, **cfg):
    cfg.setdefault("buckets", (8,))
    cfg.setdefault("coalesce_window_ms", 0.0)
    params = {k: torch.from_numpy(v) for k, v in _params(seed).items()}
    return pmh.ModelHost("demo", p_forward, params, config=pmh.ModelHostConfig(precision=precision, **cfg),
                         fingerprint=f"test-demo-{seed}", aot=aot, device="cpu")


def j_host(precision="f32", seed=0, **cfg):
    cfg.setdefault("buckets", (8,))
    cfg.setdefault("coalesce_window_ms", 0.0)
    return jmh.ModelHost("demo", j_forward, _params(seed), config=jmh.ModelHostConfig(precision=precision, **cfg),
                         fingerprint=f"test-demo-{seed}")


def direct(x, seed=0):
    params = {k: torch.from_numpy(v) for k, v in _params(seed).items()}
    with torch.no_grad():
        return p_forward(params, torch.as_tensor(x))


def test_f32_host_is_bit_exact_vs_the_direct_forward_and_close_to_jax():
    """At the bucket shape the f32 host's rows are bitwise the direct
    forward's; JAX's host gives the same rows within 1e-6."""
    x = np.random.RandomState(1).randn(8, 6).astype(np.float32)
    host, jhost = p_host(), j_host()
    got = host.infer(x)
    assert got.dtype == torch.float32 and got.device == CPU
    assert torch.equal(got, direct(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jhost.infer(x)), rtol=1e-6, atol=1e-6)
    host.close()
    jhost.close()


def test_padded_request_rows_match_the_unpadded_forward():
    """A 5-row request served through the 8-row bucket: its rows bit-equal to
    the direct forward at the padded shape, and to the unpadded forward
    within 1e-6 (a matmul of another row count may take another kernel)."""
    x = np.random.RandomState(2).randn(5, 6).astype(np.float32)
    host = p_host()
    got = host.infer(x)
    host.close()
    padded = np.zeros((8, 6), np.float32)
    padded[:5] = x
    assert got.shape == (5, 4)
    assert torch.equal(got, direct(padded)[:5])
    np.testing.assert_allclose(got.numpy(), direct(x).numpy(), rtol=1e-6, atol=1e-6)


def test_zero_steady_captures_over_varied_traffic_as_jax():
    """Warm bucket entries serve every in-bucket size with no new capture;
    the counters equal JAX's host's over the same requests."""
    host, jhost = p_host(buckets=(4, 8)), j_host(buckets=(4, 8))
    rng = np.random.RandomState(3)
    for n in (3, 7, 4, 8, 1, 2, 5, 6, 3, 8, 7, 4, 11):
        x = rng.randn(n, 6).astype(np.float32)
        np.testing.assert_allclose(host.infer(x).numpy(), np.asarray(jhost.infer(x)), rtol=1e-6, atol=1e-6)
        if n == 8:
            warm = host.aot.misses
    assert host.aot.misses == warm == 2 and host.aot.hits > 0
    got, want = host.counters(), jhost.counters()
    assert got == want, (got, want)
    host.close()
    jhost.close()


def test_coalescing_merges_compatible_requests_into_one_batch():
    host = p_host(coalesce=3, coalesce_window_ms=500.0)
    rng = np.random.RandomState(4)
    xs = [rng.randn(2, 6).astype(np.float32) for _ in range(3)]
    handles = [host.submit(x) for x in xs]
    outs = [h.get(timeout=30) for h in handles]
    for x, o in zip(xs, outs):
        assert not isinstance(o, BaseException), o
        assert o.shape == (2, 4)
        np.testing.assert_allclose(o.numpy(), direct(x).numpy(), rtol=1e-6, atol=1e-6)
    c = host.counters()
    host.close()
    assert c["requests"] == 3 and c["batches"] == 1 and c["coalesced_batches"] == 1
    assert c["items"] == 6 and c["padded_items"] == 2


def test_incompatible_requests_and_oversized_ones_serve_apart():
    """A request of another signature is carried to its own batch; one past
    the largest bucket splits into chunks, its rows in order."""
    host = p_host(coalesce=4, coalesce_window_ms=300.0, buckets=(4, 8))
    rng = np.random.RandomState(5)
    a, b = rng.randn(3, 6).astype(np.float32), rng.randn(3, 6)
    big = rng.randn(19, 6).astype(np.float32)
    ha, hb = host.submit(a), host.submit(b)  # float32 then float64: two signatures
    assert ha.get(timeout=30).shape == (3, 4) and hb.get(timeout=30).shape == (3, 4)
    got = host.infer(big)
    np.testing.assert_allclose(got.numpy(), direct(big).numpy(), rtol=1e-6, atol=1e-6)
    c = host.counters()
    host.close()
    assert c["batches"] == 3 and c["requests"] == 3 and c["items"] == 25


def test_closed_host_refuses_and_serving_errors_propagate():
    host = p_host()
    with pytest.raises(Exception):
        host.infer(np.zeros((3, 5), np.float32))  # wrong trailing dim: fails in the forward
    assert host.infer(np.zeros((3, 6), np.float32)).shape == (3, 4)
    with pytest.raises(ValueError, match="batch-carried"):
        host.submit(np.float32(1.0))
    with pytest.raises(ValueError, match="inconsistent"):
        host.submit(np.zeros((2, 6), np.float32), np.zeros((3, 6), np.float32))
    host.close()
    with pytest.raises(RuntimeError, match="closed"):
        host.submit(np.zeros((3, 6), np.float32))


def test_bf16_and_int8_paths_hold_jax_bounds():
    """bf16 within 5e-2 (JAX's bound) and really reduced; int8 within
    ``q8_sum_error_bound`` at W = 1 and equal to the port's numpy
    ``q8_roundtrip`` of the f32 rows."""
    from metrics_tpu_torch.parallel.collectives import q8_roundtrip, q8_sum_error_bound

    x = np.random.RandomState(5).randn(8, 6).astype(np.float32)
    want = p_host("f32").infer(x).numpy()
    got_bf16 = p_host("bf16").infer(x)
    assert got_bf16.dtype == torch.float32
    np.testing.assert_allclose(got_bf16.numpy(), want, rtol=5e-2, atol=5e-2)
    assert not np.array_equal(got_bf16.numpy(), want)
    got_int8 = p_host("int8").infer(x).numpy()
    assert np.all(np.abs(got_int8 - want) <= q8_sum_error_bound(want[None]) + 1e-7)
    np.testing.assert_array_equal(got_int8, q8_roundtrip(want))
    jint8 = np.asarray(j_host("int8").infer(x))
    np.testing.assert_allclose(got_int8, jint8, rtol=1e-5, atol=1e-5)


def test_precision_is_part_of_the_program_key():
    from metrics_tpu_torch.engine.aot import AotCache

    aot = AotCache()
    for prec in ("f32", "bf16", "int8"):
        host = p_host(prec, aot=aot)
        host.infer(np.zeros((8, 6), np.float32))
        host.close()
    assert aot.misses == 3 and len(aot) == 3


def test_shared_host_dedupes_by_key_and_bumps_shared_by():
    made = []

    def factory():
        made.append(p_host())
        return made[-1]

    a = pmh.shared_host(("demo", "fp", None, "single"), factory)
    b = pmh.shared_host(("demo", "fp", None, "single"), factory)
    c = pmh.shared_host(("demo", "OTHER", None, "single"), factory)
    assert a is b and a is not c and len(made) == 2
    assert a.shared_by == 2 and c.shared_by == 1
    a.close()
    d = pmh.shared_host(("demo", "fp", None, "single"), factory)
    assert d is not a and len(made) == 3  # a closed host is rebuilt


def test_refusals_name_what_is_not_ported():
    # the mesh layouts are ported (tests/test_torch_model_mesh.py): a mesh must
    # be the port's, param_shardings is the placement applied once, and the
    # pipeline stages need a mesh, with JAX's message
    with pytest.raises(ValueError, match="parallel.mesh.Mesh"):
        pmh.ModelHostConfig(mesh=object())
    with pytest.raises(NotPortedError, match="cache_dir"):
        pmh.ModelHostConfig(cache_dir="/nonexistent")
    with pytest.raises(ValueError, match="precision"):
        pmh.ModelHostConfig(precision="fp8")
    placed = pmh.ModelHost("demo", p_forward, {"w": torch.ones(2)}, param_shardings=lambda p: {"w": p["w"] * 2},
                           device="cpu")
    assert torch.equal(placed.params["w"], torch.full((2,), 2.0))
    placed.close()
    with pytest.raises(ValueError, match="needs config.mesh") as perr:
        pmh.encoder_host(stage_fn=lambda p, x: x, stage_params={}, device="cpu")
    with pytest.raises(ValueError) as jerr:
        jmh.encoder_host(stage_fn=lambda p, x: x, stage_params={})
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="exactly one"):
        pmh.encoder_host(device="cpu")
    with pytest.raises(ValueError, match="feature"):
        pmh.inception_host("1000", device="cpu")


def test_q8_roundtrip_traced_equals_the_numpy_roundtrip():
    from metrics_tpu_torch.parallel.collectives import q8_roundtrip

    x = np.random.RandomState(6).randn(5, 37).astype(np.float32) * np.logspace(-3, 3, 37).astype(np.float32)
    got = pmh.q8_roundtrip_traced(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), q8_roundtrip(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmh.q8_roundtrip_traced(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------- InceptionV3


@pytest.fixture(scope="module")
def seeded_params():
    from metrics_tpu_torch.models.inception import random_inception_params

    return random_inception_params(input_size=SIZE, seed=0), random_inception_params(input_size=SIZE, seed=7)


def test_inception_host_f32_features_are_the_direct_forward(seeded_params):
    """5 images through the 8-image bucket: bit-equal to the direct
    extractor on the padded batch, within 1e-5 of the scale unpadded; a warm
    pass captures nothing; bf16 within JAX's bound."""
    from metrics_tpu_torch.models.inception import InceptionFeatureExtractor

    params, _ = seeded_params
    imgs = np.random.RandomState(8).randint(0, 256, (5, 3, SIZE, SIZE)).astype(np.uint8)
    padded = np.zeros((8, 3, SIZE, SIZE), np.uint8)
    padded[:5] = imgs
    host = pmh.inception_host("2048", params, config=pmh.ModelHostConfig(buckets=(8,), coalesce_window_ms=0.0),
                              device="cpu")
    ext = InceptionFeatureExtractor("2048", params=params, device="cpu")
    got = host.infer(imgs)
    assert torch.equal(got, ext(padded)[:5])
    want = ext(imgs).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert torch.equal(host.infer(imgs.transpose(0, 2, 3, 1)), got)  # NHWC in, as JAX's host takes NCHW
    assert host.aot.misses == 2  # the NCHW and NHWC signatures
    host.infer(imgs)
    assert host.aot.misses == 2
    bf16 = pmh.inception_host("2048", params, config=pmh.ModelHostConfig(buckets=(8,), precision="bf16"),
                              device="cpu")
    np.testing.assert_allclose(bf16.infer(imgs).numpy(), want, rtol=5e-2, atol=5e-2)


def test_fid_and_kid_share_one_resident_model(seeded_params):
    """FID and KID over the same weights and config resolve ONE host
    (``shared_by`` 2, the same tensors); other weights another host; the
    hosted FID's value equals the direct one's."""
    import metrics_tpu_torch as mp

    params, other = seeded_params
    cfg = pmh.ModelHostConfig(buckets=(8,), coalesce_window_ms=0.0)
    fid = mp.FID(feature=2048, params=params, model_host=cfg, device="cpu")
    kid = mp.KID(feature=2048, params=params, subsets=2, subset_size=4, model_host=cfg, device="cpu")
    assert fid.model_host is not None and fid.model_host is kid.model_host
    assert fid.model_host.counters()["shared_by"] == 2
    assert all(a is b for a, b in zip(fid.model_host.params.values(), kid.model_host.params.values()))
    fid2 = mp.FID(feature=2048, params=other, model_host=cfg, device="cpu")
    assert fid2.model_host is not fid.model_host
    assert mp.FID(feature=2048, params=params, model_host=True, device="cpu").model_host is not fid.model_host
    plain = mp.FID(feature=2048, params=params, device="cpu")
    rng = np.random.RandomState(9)
    for real in (True, False):
        x = rng.randint(0, 256, (8, 3, SIZE, SIZE)).astype(np.uint8)
        fid.update(x, real=real)
        plain.update(x, real=real)
    torch.testing.assert_close(fid.compute(), plain.compute(), rtol=0, atol=0)
    host = fid.model_host
    assert mp.KID(feature=2048, params=params, model_host=host, device="cpu").model_host is host


def test_bertscore_host_bounds_the_captures_and_matches_the_direct_path():
    """Varied-length traffic through a hosted BERTScore takes at most one
    entry per length bucket (one batch bucket), a replay takes none, and the
    scores equal the direct path's, as JAX's test holds them."""
    import metrics_tpu_torch as mp

    rng = np.random.RandomState(11)
    emb = torch.from_numpy(rng.randn(512, 16).astype(np.float32) * 0.1)
    wt = torch.from_numpy(rng.randn(16, 16).astype(np.float32) * 0.1)

    def enc(ids, mask):
        x = emb[ids.long() % emb.shape[0]] * mask[..., None]
        return torch.tanh(x @ wt) * mask[..., None]

    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta"]
    traffic = []
    for _ in range(6):
        n = int(rng.randint(2, 5))
        traffic.append(([" ".join(rng.choice(words, size=int(rng.randint(2, 24)))) for _ in range(n)],
                        [" ".join(rng.choice(words, size=int(rng.randint(2, 24)))) for _ in range(n)]))
    direct_m = mp.BERTScore(user_forward_fn=enc, max_length=32, device="cpu")
    hosted = mp.BERTScore(user_forward_fn=enc, max_length=32, device="cpu",
                          model_host=pmh.ModelHostConfig(buckets=(8,), coalesce_window_ms=0.0))
    for preds, targets in traffic:
        direct_m.update(preds, targets)
        hosted.update(preds, targets)
    assert hosted.compute()["f1"] == direct_m.compute()["f1"]
    host = hosted.model_host
    warm = host.aot.misses
    assert 0 < warm <= len(hosted.length_buckets)
    hosted.reset()
    for preds, targets in traffic:
        hosted.update(preds, targets)
    hosted.compute()
    assert host.aot.misses == warm


def test_openmetrics_and_engine_telemetry_sections(tmp_path):
    """The ``model_host_*`` families parse strictly and equal JAX's host's
    over the same request; an engine with a host attached carries its
    section in its telemetry and export."""
    import json

    import trace_export

    import metrics_tpu_torch as mp
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    host, jhost = p_host(), j_host()
    x = np.zeros((3, 6), np.float32)
    host.infer(x)
    jhost.infer(x)
    fams = trace_export.parse_openmetrics(host.metrics_text())
    jfams = trace_export.parse_openmetrics(jhost.metrics_text())
    jhost.close()
    assert sorted(fams) == sorted(jfams)
    for fam in fams:
        if fam.endswith("_per_s"):
            assert fams[fam]["type"] == "gauge"
            continue
        assert fams[fam] == jfams[fam], fam
    req = fams["metrics_tpu_model_host_requests"]
    assert {s["labels"].get("precision") for s in req["samples"]} == {"f32"} and req["samples"][0]["value"] == 1.0
    eng = StreamingEngine(mp.MeanSquaredError(device="cpu"), EngineConfig(buckets=(8,)))
    eng.model_host = host
    rng = np.random.RandomState(6)
    with eng:
        for n in (5, 3):
            feats = host.infer(rng.randn(n, 6).astype(np.float32))
            eng.submit(feats.mean(dim=1), torch.from_numpy(rng.rand(n).astype(np.float32)))
        eng.result()
        (sec,) = eng.telemetry()["model_host"]
        path = str(tmp_path / "telemetry.json")
        eng.export_telemetry(path)
    host.close()
    assert sec["kind"] == "demo" and sec["precision"] == "f32" and sec["counters"]["requests"] == 3
    with open(path) as f:
        assert json.load(f)["model_host"][0]["counters"]["requests"] == 3
