"""The sharded embedded-model forwards against the JAX package's, on the CPU.

The port's mesh is four shards on the CPU (``MeshConfig(shape=(4,),
devices=["cpu"] * 4)``, or ``(2, 2)`` for the multi-axis ``out_axis`` forms);
JAX's runs on ``jax.devices()[:4]``, built directly (the ``devices`` fixture
would mark these tests slow). The same numpy inputs and parameters feed both:

* the three builders of ``parallel/embedded.py``: ``shard_batch_forward``
  (replicated parameters, the zero pad rows cut, the ``out_axis`` forms, the
  non-prefix refusal), ``stem_tensor_batch_forward`` (a channel-split stem,
  the non-divisible batch refused) and ``pipeline_stage_forward`` (GPipe
  stages, its hand-off count);
* the cases of ``tests/parallel/test_sharded_embedded.py``: InceptionV3 at
  75 x 75 batch-sharded and stem-sharded, FID, KID, IS and BERTScore with
  ``mesh=``, each against the port's own world-1 result and JAX's sharded
  one, and a callable feature with ``mesh=`` refused;
* the model host's two mesh layouts against JAX's host: values, ``sharding``,
  ``allowed_collectives``, the bucket divisor, one model shared by FID and
  KID.

Tolerances: on the CPU the port's sharded forwards run the world-1 ops on
row blocks (and the stem on channel slices), so they equal its world-1
results bit for bit; against JAX, Inception taps within 1e-4 of the largest
tap (94 f32 convolutions summed in another order, as
``tests/test_torch_image_models.py`` holds them), FID, KID and IS within 1e-4
relative, BERTScore within 1e-5 relative and 1e-6 absolute, the small
builders' outputs within 1e-6.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.engine import model_host as jmh
from metrics_tpu.functional import bert_score as j_bert_score
from metrics_tpu.parallel import embedded as jemb
from metrics_tpu_torch.engine import model_host as pmh
from metrics_tpu_torch.functional import bert_score as p_bert_score
from metrics_tpu_torch.parallel import embedded as pemb
from metrics_tpu_torch.parallel.collectives import collective_counts, reset_collective_counts
from metrics_tpu_torch.parallel.mesh import MeshConfig

j_inc = importlib.import_module("metrics_tpu.models.inception")
p_inc = importlib.import_module("metrics_tpu_torch.models.inception")

W, SIZE = 4, 75
TAPS = ("64", "192", "768", "2048", "logits_unbiased")


def _jmesh(shape=(W,), names=("dp",)):
    return JaxMesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


def _pmesh(shape=(W,), names=("dp",)):
    return MeshConfig(shape=shape, axis_names=names, sync_axis=names if len(names) > 1 else names[0],
                      devices=["cpu"] * int(np.prod(shape))).make_mesh()


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _taps_close(got, want, what):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=what)


def _images(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n, 3, SIZE, SIZE)).astype(np.uint8)


@pytest.fixture(scope="module")
def params():
    """One seeded Inception: the port's state dict and JAX's Flax variables
    (the same numpy draws, ``random_inception_params(fast=True)``)."""
    return (p_inc.random_inception_params(input_size=SIZE, seed=3),
            j_inc.random_inception_params(input_size=SIZE, seed=3, fast=True))


@pytest.fixture(scope="module")
def jax_sharded(params):
    """JAX's references, each compiled once: its batch-sharded extractor's
    ``'64'``, ``'2048'`` and ``'logits_unbiased'`` taps of the real and fake images
    (10 a side: the pad path), and its model host in the hybrid stem-tensor
    layout with its features of the real images."""
    _, jvars = params
    real, fake = _images(6, 10), _images(7, 10)
    taps = {}
    for tap in ("64", "2048", "logits_unbiased"):
        ext = j_inc.InceptionFeatureExtractor(tap, params=jvars, input_size=SIZE, mesh=_jmesh())
        taps[tap] = (np.asarray(ext(real)), np.asarray(ext(fake)))
    host = jmh.inception_host("2048", jvars, config=jmh.ModelHostConfig(
        buckets=(8,), coalesce_window_ms=0.0, mesh=_jmesh(), mesh_axis="dp"), shared=False)
    hosted = np.asarray(host.infer(real[:8]))
    tel = host.telemetry()
    divisor = host._policy.divisor
    host.close()
    return {"real": real, "fake": fake, "taps": taps, "host": (hosted, tel, divisor)}


@pytest.fixture(autouse=True)
def _fresh_hosts():
    yield
    pmh.reset_host_registry()
    jmh.reset_host_registry()


# ------------------------------------------------------------------ the builders


def test_shard_batch_forward_pads_replicates_and_gathers_as_jax():
    rng = np.random.RandomState(0)
    wts, x = rng.randn(4, 3).astype(np.float32), rng.randn(11, 4).astype(np.float32)  # 11 rows: the pad path
    jf = jemb.shard_batch_forward(lambda p, v: jnp.tanh(v @ p), _jmesh(), "dp", replicated_argnums=(0,))
    want = np.asarray(jf(jnp.asarray(wts), jnp.asarray(x)))
    pf = pemb.shard_batch_forward(lambda p, v: torch.tanh(v @ p), _pmesh(), "dp", replicated_argnums=(0,))
    blocks = pf(torch.from_numpy(wts), torch.from_numpy(x))  # the default: sharded, one block a shard
    assert [b.shape[0] for b in blocks] == [3, 3, 3, 2]
    np.testing.assert_allclose(torch.cat(blocks).numpy(), want, rtol=1e-6, atol=1e-6)
    placed = pf.place(torch.from_numpy(wts))  # one copy a device: the four shards share it
    assert len({id(p) for p in placed.shards}) == 1
    np.testing.assert_array_equal(torch.cat(pf(placed, x)).numpy(), torch.cat(blocks).numpy())
    reset_collective_counts()
    gathered = pemb.shard_batch_forward(lambda v: torch.tanh(v) * 2.0, _pmesh(), "dp", out_axis=None)(x)
    want = np.asarray(jemb.shard_batch_forward(lambda v: jnp.tanh(v) * 2.0, _jmesh(), "dp", out_axis=None)(x))
    np.testing.assert_allclose(gathered.numpy(), want, rtol=1e-6, atol=1e-6)
    assert collective_counts()["all_gather"] == 1
    with pytest.raises(ValueError, match="batch argument"):
        pemb.shard_batch_forward(lambda p: p, _pmesh(), "dp", replicated_argnums=(0,))(wts)


def test_shard_batch_forward_out_axis_prefix_and_refusal_as_jax():
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    jf = jemb.shard_batch_forward(lambda v: v * 2.0, _jmesh((2, 2), ("dp", "grp")), ("dp", "grp"), out_axis="dp")
    pf = pemb.shard_batch_forward(lambda v: v * 2.0, _pmesh((2, 2), ("dp", "grp")), ("dp", "grp"), out_axis="dp")
    blocks = pf(x)  # sharded over the prefix "dp": two blocks, the "grp" shards gathered in each
    assert len(blocks) == 2 and [b.shape[0] for b in blocks] == [6, 4]
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), np.asarray(jf(x)))
    with pytest.raises(ValueError) as jerr:
        jemb.shard_batch_forward(lambda v: v, _jmesh((2, 2), ("dp", "grp")), ("dp", "grp"), out_axis="grp")(x)
    with pytest.raises(ValueError) as perr:
        pemb.shard_batch_forward(lambda v: v, _pmesh((2, 2), ("dp", "grp")), ("dp", "grp"), out_axis="grp")
    assert str(perr.value) == str(jerr.value)


def test_pipeline_stage_forward_equals_jax_with_its_hand_offs():
    rng = np.random.RandomState(1)
    stages, x = (rng.randn(W, 6, 6) * 0.3).astype(np.float32), rng.randn(8, 6).astype(np.float32)
    want = np.asarray(jax.jit(jemb.pipeline_stage_forward(lambda w_, v: jnp.tanh(v @ w_) + v, _jmesh()))(
        jnp.asarray(stages), jnp.asarray(x)))
    pf = pemb.pipeline_stage_forward(lambda w_, v: torch.tanh(v @ w_) + v, _pmesh())
    reset_collective_counts()
    got = pf(torch.from_numpy(stages), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert collective_counts() == {"all_reduce": 0, "all_gather": 0, "ppermute": (W + W - 1) + (W - 1)}
    placed = pf.place(torch.from_numpy(stages))
    assert [torch.equal(p, torch.from_numpy(stages[s])) for s, p in enumerate(placed)] == [True] * W
    np.testing.assert_array_equal(pf(placed, x).numpy(), got.numpy())
    with pytest.raises(ValueError) as jerr:
        jemb.pipeline_stage_forward(lambda w_, v: v, _jmesh(), microbatches=3)(jnp.asarray(stages), jnp.asarray(x))
    with pytest.raises(ValueError) as perr:
        pemb.pipeline_stage_forward(lambda w_, v: v, _pmesh(), microbatches=3)(stages, x)
    assert str(perr.value) == str(jerr.value)


def test_stem_tensor_forward_equals_the_module_and_jax(params, jax_sharded):
    """The hybrid forward on the 128-lane padded stem: every tap equal to
    the port's world-1 module bit for bit, and JAX's hybrid (its host's
    layout) within the tap bound; five stem gathers plus one a trunk output;
    a batch that does not divide by the axis refused with JAX's message."""
    pstate, _ = params
    imgs = _images(4, 8)
    padded = p_inc.pad_stem_params(pstate, 128)
    stem, trunk = p_inc.split_stem_variables(padded)
    assert sorted({k.split(".")[0] + "." + k.split(".")[1] for k in stem}) == list(p_inc.STEM_LAYERS)
    module = p_inc.InceptionV3(stem_lanes=128)
    module.load_state_dict(padded)
    module.eval()
    fwd = pemb.stem_tensor_batch_forward(
        lambda sv, xs, ax: p_inc.stem_apply(sv, xs, stem_lanes=128, gather_axis=ax),
        lambda m, v: m.trunk(v), _pmesh())
    from metrics_tpu_torch.utils.precision import full_f32

    with torch.no_grad(), full_f32():
        want = module(torch.from_numpy(imgs))
        x_stem, taps = p_inc.stem_apply(stem, torch.from_numpy(imgs), stem_lanes=128)
        assert torch.equal(taps["192"], want["192"]) and x_stem.shape[1] == 192
        reset_collective_counts()
        got = fwd(stem, pemb.PlacedParams([module] * W), imgs)
    assert collective_counts()["all_gather"] == 5 + 3
    for tap in TAPS:
        assert torch.equal(got[tap], want[tap]), tap
    hosted, _, _ = jax_sharded["host"]  # JAX's stem-tensor hybrid (its host's layout) on the real images
    with torch.no_grad(), full_f32():
        got_real = fwd(stem, pemb.PlacedParams([module] * W), jax_sharded["real"][:8])
    _taps_close(got_real["2048"], hosted, "2048")
    jfwd = jemb.stem_tensor_batch_forward(lambda sv, v, ax: (v, {}), lambda tv, v: {"x": v}, _jmesh())
    with pytest.raises(ValueError) as jerr:  # refused before any program is built
        jfwd({}, {}, jnp.asarray(imgs[:6].transpose(0, 2, 3, 1)))
    with pytest.raises(ValueError) as perr:
        fwd(stem, trunk, imgs[:6])
    assert str(perr.value) == str(jerr.value)


# ------------------------------------------------------------- the metrics


def test_inception_extractor_batch_sharded_equals_world_1_and_jax(params, jax_sharded):
    pstate, _ = params
    imgs = jax_sharded["real"]  # 10 images over 4 shards: the pad rows
    single = p_inc.InceptionFeatureExtractor("logits_unbiased", params=pstate, input_size=SIZE, device="cpu")
    sharded = p_inc.InceptionFeatureExtractor("logits_unbiased", params=pstate, input_size=SIZE, mesh=_pmesh())
    got = sharded(imgs)  # the last tap: every layer of the trunk on each shard's block
    assert torch.equal(got, single(imgs)) and got.shape == (10, 1008)
    _taps_close(got, jax_sharded["taps"]["logits_unbiased"][0], "logits_unbiased")


def test_fid_kid_is_sharded_equal_world_1_and_jax(params, jax_sharded):
    """FID (on the ``'64'`` tap: a 64-wide covariance keeps its float64
    square root cheap), KID and IS with ``mesh=`` equal the port's
    world-1 values bit for bit, and JAX's metrics over JAX's batch-sharded
    features within 1e-4."""
    pstate, _ = params
    real, fake = jax_sharded["real"], jax_sharded["fake"]
    ident = lambda x: x  # noqa: E731
    for name, pcls, jcls, kw in (("fid", mp.FID, mt.FID, {}),
                                 ("kid", mp.KID, mt.KID, {"subsets": 2, "subset_size": 4, "seed": 0}),
                                 ("is", mp.IS, mt.IS, {"splits": 2, "seed": 0})):
        feature = {"fid": 64, "kid": 2048, "is": "logits_unbiased"}[name]
        vals = []
        for mesh in (None, _pmesh()):
            m = pcls(feature=feature, params=pstate, mesh=mesh, device="cpu", **kw)
            if name == "is":
                m.update(torch.from_numpy(real))
            else:
                m.update(torch.from_numpy(real), real=True)
                m.update(torch.from_numpy(fake), real=False)
            vals.append(_np(m.compute()))
        jr, jf = jax_sharded["taps"][str(feature)]
        dim = {} if name == "kid" else {"feature_dim": jr.shape[1]}
        j = jcls(feature=ident, **dim, **kw)
        if name == "is":
            j.update(jnp.asarray(jr))
        else:
            j.update(jnp.asarray(jr), real=True)
            j.update(jnp.asarray(jf), real=False)
        want = _np(j.compute())
        np.testing.assert_array_equal(np.asarray(vals[1]), np.asarray(vals[0]), err_msg=name)
        np.testing.assert_allclose(np.asarray(vals[1], np.float64), np.asarray(want, np.float64), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_mesh_with_callable_feature_raises_as_jax():
    feat = lambda x: x  # noqa: E731
    for pcls, jcls, kw in ((mp.FID, mt.FID, {"feature_dim": 8}), (mp.IS, mt.IS, {"feature_dim": 8}),
                           (mp.KID, mt.KID, {})):
        with pytest.raises(ValueError) as jerr:
            jcls(feature=feat, mesh=_jmesh(), **kw)
        with pytest.raises(ValueError) as perr:
            pcls(feature=feat, mesh=_pmesh(), device="cpu", **kw)
        assert str(perr.value) == str(jerr.value).replace("metrics_tpu.", "metrics_tpu_torch.")


def _toy_jax(ids, mask):  # the ids folded small: an f32 sine of a large argument differs across libraries
    freqs = jnp.arange(1, 17, dtype=jnp.float32) / 7.0
    return jnp.sin((ids[..., None] % 97).astype(jnp.float32) * freqs) * mask[..., None].astype(jnp.float32)


def _toy_torch(ids, mask):
    freqs = torch.arange(1, 17, dtype=torch.float32) / 7.0
    return torch.sin((ids[..., None].long() % 97).to(torch.float32) * freqs) * mask[..., None].to(torch.float32)


def test_bert_score_sharded_equals_world_1_and_jax():
    preds = [f"the cat tok{i} sat on the mat" for i in range(23)]
    refs = [f"a dog tok{i + 1} ran in the park" for i in range(23)]
    base = p_bert_score(preds, refs, user_forward_fn=_toy_torch, max_length=16, device="cpu")
    shard = p_bert_score(preds, refs, user_forward_fn=_toy_torch, max_length=16, device="cpu", mesh=_pmesh())
    want = j_bert_score(preds, refs, user_forward_fn=_toy_jax, max_length=16, mesh=_jmesh())
    for k in ("precision", "recall", "f1"):
        assert shard[k] == base[k], k
        np.testing.assert_allclose(shard[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # the class, its encoder a module replicated over the mesh's devices
    enc = torch.nn.Embedding(30001, 16)
    with torch.no_grad():
        enc.weight.copy_(torch.from_numpy(np.random.RandomState(2).randn(30001, 16).astype(np.float32)))
    model = lambda: type("Enc", (torch.nn.Module,), {  # noqa: E731
        "__init__": lambda self: (torch.nn.Module.__init__(self), setattr(self, "emb", enc))[0],
        "forward": lambda self, ids, mask: self.emb(ids.long()) * mask[..., None]})()
    m_base, m_shard = mp.BERTScore(model=model(), max_length=8, device="cpu"), \
        mp.BERTScore(model=model(), max_length=8, device="cpu", mesh=_pmesh())
    for m in (m_base, m_shard):
        m.update([f"tok{i} cat sat" for i in range(16)], [f"tok{i} dog ran" for i in range(16)])
    a, b = m_base.compute(), m_shard.compute()
    for k in ("precision", "recall", "f1"):
        assert a[k] == b[k], k


# ---------------------------------------------------------------- the model host


def test_inception_host_hybrid_layout_equals_jax_host(params, jax_sharded):
    pstate, _ = params
    imgs = jax_sharded["real"][:6]  # padded to the bucket of 8, a multiple of the axis
    hosted, jtel, jdivisor = jax_sharded["host"]
    cfg = pmh.ModelHostConfig(buckets=(8,), coalesce_window_ms=0.0, mesh=_pmesh())
    host = pmh.inception_host("2048", pstate, config=cfg)
    single = pmh.inception_host("2048", pstate, config=pmh.ModelHostConfig(buckets=(8,), coalesce_window_ms=0.0),
                                device="cpu")
    got = host.infer(imgs)
    assert torch.equal(got, single.infer(imgs))
    _taps_close(got, hosted[:6], "host 2048")
    tel = host.telemetry()
    for key in ("sharding", "allowed_collectives", "buckets", "unit", "precision"):
        assert tel[key] == jtel[key], key
    assert tel["sharding"] == "mesh" and tel["allowed_collectives"] == ["all_gather"]
    assert host._policy.divisor == jdivisor == W
    with pytest.raises(ValueError, match="divisible"):
        pmh.inception_host("2048", pstate, config=pmh.ModelHostConfig(buckets=(6,), mesh=_pmesh()), shared=False)
    # FID and KID over the same (tap, weights, mesh, precision) share ONE model
    fid = mp.FID(feature=2048, params=pstate, model_host=cfg, device="cpu")
    kid = mp.KID(feature=2048, params=pstate, subsets=2, subset_size=4, model_host=cfg, device="cpu")
    assert fid.model_host is kid.model_host is host and host.counters()["shared_by"] == 3
    mesh_fid = mp.FID(feature=2048, params=pstate, mesh=_pmesh(), model_host=True, device="cpu")
    assert mesh_fid.model_host.telemetry()["sharding"] == "mesh"


def test_encoder_host_pipeline_layout_equals_jax_host():
    rng = np.random.RandomState(3)
    stages = (rng.randn(W, 4, 4) * 0.5).astype(np.float32)
    ids = rng.randn(5, 4).astype(np.float32)
    mask = np.ones_like(ids)
    cfg = dict(buckets=(8,), coalesce_window_ms=0.0)
    host = pmh.encoder_host(stage_fn=lambda w_, v: torch.tanh(v @ w_), stage_params=torch.from_numpy(stages),
                            embed_fn=lambda i, m: i * m, config=pmh.ModelHostConfig(mesh=_pmesh(), **cfg),
                            fingerprint="pipe", shared=False)
    jhost = jmh.encoder_host(stage_fn=lambda w_, v: jnp.tanh(v @ w_), stage_params=stages,
                             embed_fn=lambda i, m: i * m, config=jmh.ModelHostConfig(mesh=_jmesh(), **cfg),
                             fingerprint="pipe", shared=False)
    got = host.infer(ids, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(jhost.infer(ids, mask)), rtol=1e-6, atol=1e-6)
    assert host.telemetry()["allowed_collectives"] == jhost.telemetry()["allowed_collectives"] == ["ppermute"]
    assert host.telemetry()["sharding"] == jhost.telemetry()["sharding"] == "mesh"
    assert [s.shape for s in host.params] == [(4, 4)] * W  # stage s's parameters, on shard s
    host.close()
    jhost.close()
    for bad, match in ((dict(config=pmh.ModelHostConfig(**cfg)), "needs config.mesh"),
                       (dict(config=pmh.ModelHostConfig(mesh=_pmesh(), **cfg), stage_params=None), "stage_params")):
        with pytest.raises(ValueError, match=match):
            pmh.encoder_host(**{"stage_fn": lambda w_, v: v, "stage_params": stages, **bad})
