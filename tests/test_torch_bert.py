"""The port's BERTScore against the JAX package's, on the CPU.

Two encoders are built from the same numpy weights in ``jnp`` and in torch:
``tests/text/test_text.py``'s sin encoder and a tanh-MLP like
``metrics_tpu/engine/model_bench.py``'s. Through both: the functional with
and without idf, the dedup path, the per-side path (the two sides at other
padded lengths), baseline rescaling from a temporary csv, the module over
three uneven updates with length buckets (its ``cat`` states int32 as
JAX's), pairs with an empty side, and the refusals. With ``transformers``
importable: a tiny torch ``BertModel`` checkpoint converted by
``tools/convert_weights.py bert`` scores the same in JAX (Flax) and the
port (torch, ``model_name_or_path``), and ``bert_state_dict_from_flax``
gives back the torch model's tensors exactly. Tolerance 1e-5 absolute.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metrics_tpu as mt
import metrics_tpu.functional as jf
import metrics_tpu_torch as mp
import metrics_tpu_torch.functional as pf
from metrics_tpu.functional.text import bert as jbert
from metrics_tpu_torch.functional.text import bert as pbert
from metrics_tpu_torch.utils.imports import _TRANSFORMERS_AVAILABLE

ATOL = 1e-5
CPU = torch.device("cpu")
DIM, VOCAB = 32, 30001  # the whitespace tokenizer's ids run 1..30000

_W = np.random.RandomState(20260807)
EMB = (_W.randn(VOCAB, DIM) * 0.1).astype(np.float32)
W1 = (_W.randn(DIM, 4 * DIM) * 0.1).astype(np.float32)
W2 = (_W.randn(4 * DIM, DIM) * 0.1).astype(np.float32)


def sin_jax(ids, mask):
    base = (ids[..., None] * jnp.arange(1, 9)) % 97
    return jnp.sin(base.astype(jnp.float32) + 0.5)


def sin_torch(ids, mask):
    base = (ids[..., None].long() * torch.arange(1, 9, device=ids.device)) % 97
    return torch.sin(base.float() + 0.5)


def mlp_jax(ids, mask):
    x = jnp.asarray(EMB)[ids] * mask[..., None]
    x = jnp.tanh(x @ jnp.asarray(W1)) @ jnp.asarray(W2)
    return x * mask[..., None]


class MLP(torch.nn.Module):
    """The tanh-MLP encoder as a torch module, called as ``model(ids, mask)``."""

    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Parameter(torch.from_numpy(EMB))
        self.w1 = torch.nn.Parameter(torch.from_numpy(W1))
        self.w2 = torch.nn.Parameter(torch.from_numpy(W2))

    def forward(self, ids, mask):
        m = mask[..., None].to(torch.float32)
        x = self.emb[ids.long()] * m
        return (torch.tanh(x @ self.w1) @ self.w2) * m


ENCODERS = {
    "sin": ({"user_forward_fn": sin_jax}, lambda: {"user_forward_fn": sin_torch}),
    "mlp": ({"user_forward_fn": mlp_jax}, lambda: {"model": MLP()}),
}

WORDS = ("the", "cat", "sat", "on", "mat", "a", "dog", "ran", "in", "park", "hello", "world", "there", "general")


def corpus(seed, n=14):
    rng = np.random.RandomState(seed)
    refs = [" ".join(WORDS[i] for i in rng.randint(0, len(WORDS), int(rng.randint(1, 12)))) for _ in range(n)]
    hyps = [" ".join(w for w in r.split() if rng.rand() > 0.2) or "park" for r in refs]
    hyps[3] = refs[3]  # an identical pair
    hyps[4] = refs[5] = ""  # one empty side each (JAX: P or R -inf, F1 NaN)
    hyps[6] = refs[6] = ""  # both sides empty: 0
    return hyps, refs


def same_scores(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for k in ("precision", "recall", "f1"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=f"{what} {k}")


# --------------------------------------------------------------------- pieces

def test_whitespace_tokenizer_ids_are_bit_identical_to_jax():
    texts = ["the cat sat", "", "Über naïve 東京 3.5 (hi)", " ".join(["x"] * 40)]
    for max_length in (1, 8, 32):
        got = pbert._simple_whitespace_tokenizer(texts, max_length)
        want = jbert._simple_whitespace_tokenizer(texts, max_length)
        for k in ("input_ids", "attention_mask"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_strip_special_positions_and_idf_equal_jax():
    rng = np.random.RandomState(3)
    lengths = rng.randint(0, 10, 12)
    mask = (np.arange(10)[None] < lengths[:, None]).astype(np.int64)
    ids = rng.randint(1, 50, (12, 10)) * mask
    np.testing.assert_array_equal(pbert._strip_special_positions(mask), jbert._strip_special_positions(mask))
    assert pbert._strip_special_positions(np.zeros((3, 0), np.int64)).shape == (3, 0)
    got, want = pbert._get_tokens_idf(ids, mask), jbert._get_tokens_idf(ids, mask)
    assert got == want
    w = pbert._idf_weights(ids, mask, got)
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w, jbert._idf_weights(ids, mask, want))
    np.testing.assert_array_equal(pbert._idf_weights(ids[:1] + 1000, mask[:1], got)[mask[:1] > 0],
                                  np.float32(np.log(2.0)))  # an unseen token


def test_matching_equals_jax_on_random_embeddings():
    rng = np.random.RandomState(5)
    pe, te = rng.randn(6, 9, 16).astype(np.float32), rng.randn(6, 7, 16).astype(np.float32)
    pm, tm = (rng.rand(6, 9) > 0.3).astype(np.int32), (rng.rand(6, 7) > 0.3).astype(np.int32)
    pm[0], tm[0] = 0, 0
    pw, tw = rng.rand(6, 9).astype(np.float32), rng.rand(6, 7).astype(np.float32)
    for w_ in ((None, None), (pw, tw)):
        got = pbert._bert_score_from_embeddings(
            torch.from_numpy(pe), torch.from_numpy(pm), torch.from_numpy(te), torch.from_numpy(tm),
            *(None if x is None else torch.from_numpy(x) for x in w_))
        want = jbert._bert_score_from_embeddings(
            jnp.asarray(pe), jnp.asarray(pm), jnp.asarray(te), jnp.asarray(tm),
            *(None if x is None else jnp.asarray(x) for x in w_))
        for g, v in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(v), atol=ATOL)
        assert float(got[2][0]) == 0.0  # both sides masked: 0, not NaN


# -------------------------------------------------------------------- functional

@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("encoder", sorted(ENCODERS))
@pytest.mark.parametrize("seed", range(2))
def test_functional_matches_jax(seed, encoder, idf):
    hyps, refs = corpus(seed)
    jkw, pkw = ENCODERS[encoder]
    for max_length, batch_size in ((16, 4), (8, 64)):
        want = jf.bert_score(hyps, refs, idf=idf, max_length=max_length, batch_size=batch_size, **jkw)
        got = pf.bert_score(hyps, refs, idf=idf, max_length=max_length, batch_size=batch_size, device="cpu",
                            **pkw())
        same_scores(got, want, f"{encoder} idf={idf} L={max_length}")
        assert np.isnan(got["f1"][4]) and got["f1"][6] == 0.0  # JAX's: one empty side NaN, both empty 0


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_dedup_encodes_each_distinct_row_once_and_matches_jax(encoder):
    """K systems against one reference set: at most half the rows are
    distinct, so the encoder takes the distinct rows padded to whole batches."""
    hyps, refs = corpus(2, n=7)
    hyps, refs = hyps * 4, refs * 4
    jkw, pkw = ENCODERS[encoder]
    calls = []
    inner = pkw()
    fn = inner.get("user_forward_fn") or (lambda ids, mask, m=inner["model"]: m(ids, mask))
    counted = lambda ids, mask: (calls.append(tuple(ids.shape)), fn(ids, mask))[1]  # noqa: E731
    got = pf.bert_score(hyps, refs, batch_size=4, max_length=16, device="cpu", user_forward_fn=counted)
    same_scores(got, jf.bert_score(hyps, refs, batch_size=4, max_length=16, **jkw), encoder)
    distinct = len(set(hyps + refs))
    assert distinct <= len(hyps)  # at most half of the 2N rows
    assert calls == [(4, 16)] * (-(-distinct // 4))


@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("strip", [False, True])
def test_per_side_path_matches_jax(idf, strip):
    """Pred and reference rows padded to other lengths: each side is encoded
    alone and matched at (L_pred, L_ref)."""
    hyps, refs = corpus(4)
    p = pbert._simple_whitespace_tokenizer(hyps, 12)
    t = pbert._simple_whitespace_tokenizer(refs, 20)
    args = (p["input_ids"], p["attention_mask"], t["input_ids"], t["attention_mask"])
    want = jbert._score_tokenized(jbert._resolve_forward(mlp_jax, None, None), *args, idf=idf, batch_size=5,
                                  strip_special=strip)
    got = pbert._score_tokenized(pbert._resolve_forward(None, MLP(), None, CPU), *args, idf=idf, batch_size=5,
                                 device=CPU, strip_special=strip)
    assert got.shape == (3, len(hyps))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def write_baseline(tmp_path):
    path = tmp_path / "baseline.csv"
    path.write_text("LAYER,P,R,F\n0,0.81,0.80,0.805\n1,0.83,0.82,0.825\n2,0.85,0.86,0.855\n")
    return str(path)


@pytest.mark.parametrize("num_layers", [None, 0, 1])
def test_baseline_rescaling_from_a_local_csv_matches_jax(tmp_path, num_layers):
    hyps, refs = corpus(6)
    path = write_baseline(tmp_path)
    for kw in ({"baseline_path": path}, {"baseline_url": "file://" + path}):
        want = jf.bert_score(hyps, refs, user_forward_fn=mlp_jax, rescale_with_baseline=True,
                             num_layers=num_layers, **kw)
        got = pf.bert_score(hyps, refs, model=MLP(), rescale_with_baseline=True, num_layers=num_layers,
                            device="cpu", **kw)
        same_scores(got, want, f"baseline {num_layers} {sorted(kw)}")


def test_baseline_errors_match_jax(tmp_path):
    path = write_baseline(tmp_path)
    bad = [
        {"rescale_with_baseline": True},
        {"rescale_with_baseline": True, "baseline_path": str(tmp_path / "missing.csv")},
        {"rescale_with_baseline": True, "baseline_url": "https://example.invalid/base.csv"},
        {"rescale_with_baseline": True, "baseline_path": path, "num_layers": 7},
    ]
    for kw in bad:
        msgs = []
        for make in (lambda: mt.BERTScore(user_forward_fn=mlp_jax, **kw),
                     lambda: mp.BERTScore(model=MLP(), device="cpu", **kw)):
            with pytest.raises(ValueError) as e:
                make()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_encoder_resolution_order_and_refusals():
    hyps, refs = corpus(7, n=8)
    # user_forward_fn wins over model
    got = pf.bert_score(hyps, refs, user_forward_fn=sin_torch, model=MLP(), device="cpu")
    same_scores(got, jf.bert_score(hyps, refs, user_forward_fn=sin_jax), "order")
    # an encoder answering in numpy becomes a tensor on the device
    np_enc = lambda ids, mask: sin_torch(ids, mask).numpy()  # noqa: E731
    same_scores(pf.bert_score(hyps, refs, user_forward_fn=np_enc, device="cpu"), got, "numpy output")
    msgs = []
    for f, kw in ((pf.bert_score, {"device": "cpu"}), (jf.bert_score, {})):
        with pytest.raises(ValueError) as e:
            f(hyps, refs, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="Number of predicted and reference"):
        pf.bert_score(hyps, refs[:2], user_forward_fn=sin_torch, device="cpu")


def test_the_encoder_runs_under_inference_mode_on_the_device():
    seen = []

    def enc(ids, mask):
        seen.append((torch.is_inference_mode_enabled(), ids.device, mask.device, ids.dtype))
        return sin_torch(ids, mask)

    pf.bert_score(["a b"], ["a c"], user_forward_fn=enc, device="cpu")
    assert seen == [(True, CPU, CPU, torch.int32)]


@pytest.mark.parametrize("kw", [{"mesh": "four cpu shards"}, {"model_host": True}])
def test_mesh_and_model_host_are_not_ported(kw):
    """Both were refused until ported: ``mesh=`` now runs the encoder
    batch-sharded over four CPU shards in the class and the functional, the
    scores equal to the direct path's, and a host built with it serves on
    the mesh; ``model_host=`` serves the encoder from a host, with the direct
    path's scores."""
    from metrics_tpu_torch.engine.model_host import reset_host_registry
    from metrics_tpu_torch.parallel.mesh import MeshConfig

    if "mesh" in kw:
        kw = {"mesh": MeshConfig(shape=(4,), devices=["cpu"] * 4).make_mesh()}
        preds, refs = ["a b c", "d e", "f g h i", "j", "k l"], ["a c", "d e f", "g h", "j k", "l"]
        want = pf.bert_score(preds, refs, user_forward_fn=sin_torch, device="cpu")
        assert pf.bert_score(preds, refs, user_forward_fn=sin_torch, device="cpu", **kw) == want
    try:
        hosted, direct = mp.BERTScore(user_forward_fn=sin_torch, device="cpu", **{**kw, "model_host": True}), \
            mp.BERTScore(user_forward_fn=sin_torch, device="cpu")
        assert hosted.model_host is not None and hosted.model_host.device == CPU
        assert hosted.model_host.telemetry()["sharding"] == ("mesh" if "mesh" in kw else "none")
        for m in (hosted, direct):
            m.update(["a b c", "d e"], ["a c", "d e f"])
        assert hosted.compute() == direct.compute()
    finally:
        reset_host_registry()


# ------------------------------------------------------------------------ module

def longest_tokenizer(texts, max_length):
    """Pads each call to its own longest row (whitespace ids with [CLS]=1,
    [SEP]=2 around them), so updates land on other length buckets."""
    enc = pbert._simple_whitespace_tokenizer(texts, max_length - 2)
    n = enc["attention_mask"].sum(1)
    width = int(n.max()) + 2 if len(texts) else 2
    ids = np.zeros((len(texts), width), np.int64)
    mask = np.zeros((len(texts), width), np.int64)
    for i, k in enumerate(n):
        ids[i, 0], ids[i, 1:k + 1], ids[i, k + 1] = 1, enc["input_ids"][i, :k] + 2, 2
        mask[i, :k + 2] = 1
    return {"input_ids": ids, "attention_mask": mask}


@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("tokenizer", [None, longest_tokenizer])
@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_module_over_uneven_updates_matches_jax(encoder, tokenizer, idf):
    hyps, refs = corpus(8, n=13)
    jkw, pkw = ENCODERS[encoder]
    common = {"idf": idf, "max_length": 32, "batch_size": 4, "user_tokenizer": tokenizer}
    jm, pm = mt.BERTScore(**jkw, **common), mp.BERTScore(device="cpu", **pkw(), **common)
    for lo, hi in ((0, 5), (5, 6), (6, 13)):
        jm.update(hyps[lo:hi], refs[lo:hi])
        pm.update(hyps[lo:hi], refs[lo:hi])
    js, ps = jm._pack_state(), pm._pack_state()
    assert sorted(js) == sorted(ps)
    for k in js:
        assert len(ps[k]) == len(js[k]) == 3
        for a, b in zip(ps[k], js[k]):
            b = np.asarray(b)
            assert a.dtype == torch.int32 and b.dtype == np.int32 and a.device == CPU
            np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
    same_scores(pm.compute(), jm.compute(), f"{encoder} tok={tokenizer is not None} idf={idf}")


def test_module_rescales_with_baseline_and_buckets_as_jax(tmp_path):
    from metrics_tpu.text.bert import _bucket_pad_tokens as jpad, _derive_length_buckets as jbuckets
    from metrics_tpu_torch.text.bert import _bucket_pad_tokens as ppad, _derive_length_buckets as pbuckets

    for n in (1, 8, 9, 100, 128, 512):
        assert pbuckets(n) == jbuckets(n)
    enc = longest_tokenizer(["a b c", "d"], 32)
    for got, want in zip(ppad(enc, (8, 16, 32)).values(), jpad(enc, (8, 16, 32)).values()):
        np.testing.assert_array_equal(got, want)
    hyps, refs = corpus(9, n=8)
    path = write_baseline(tmp_path)
    jm = mt.BERTScore(user_forward_fn=mlp_jax, rescale_with_baseline=True, baseline_path=path, num_layers=2)
    pm = mp.BERTScore(model=MLP(), rescale_with_baseline=True, baseline_path=path, num_layers=2, device="cpu")
    jm.update(hyps, refs)
    pm.update(hyps, refs)
    same_scores(pm.compute(), jm.compute(), "module baseline")


# -------------------------------------------------------- HF checkpoints (transformers)

VOCAB_WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat", "sat", "on", "mat", "a", "dog", "ran",
               "in", "park", "hello", "world", "general", "kenobi", "there"]


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    """A tiny torch BERT and its tokenizer saved locally, converted to Flax by
    the shipped tool (no network)."""
    if not _TRANSFORMERS_AVAILABLE:
        pytest.skip("needs transformers")
    from transformers import BertConfig, BertModel, BertTokenizerFast

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from convert_weights import convert_bert

    root = tmp_path_factory.mktemp("bert")
    (root / "vocab.txt").write_text("\n".join(VOCAB_WORDS))
    tokenizer = BertTokenizerFast(vocab_file=str(root / "vocab.txt"), do_lower_case=True)
    cfg = BertConfig(vocab_size=len(VOCAB_WORDS), hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=64, max_position_embeddings=64)
    torch.manual_seed(0)
    model = BertModel(cfg).eval()
    pt_dir, flax_dir = root / "pt", root / "flax"
    model.save_pretrained(pt_dir)
    tokenizer.save_pretrained(pt_dir)
    convert_bert(str(pt_dir), str(flax_dir))
    return str(pt_dir), str(flax_dir), tokenizer, model, cfg


def hf_tokenizer(tokenizer):
    def tok(texts, max_length):
        return tokenizer(texts, padding="max_length", truncation=True, max_length=max_length, return_tensors="np")

    return tok


def test_tiny_bert_checkpoint_scores_the_same_in_both_packages(tiny_bert):
    pt_dir, flax_dir, tokenizer, model, _ = tiny_bert
    hyps = ["the cat sat on the mat", "hello there general kenobi", "a dog ran in the park", "the cat"]
    refs = ["the cat sat on the mat", "a dog ran in the park", "the dog ran in a park", "cat the"]
    for idf in (False, True):
        want = jf.bert_score(hyps, refs, model_name_or_path=flax_dir, user_tokenizer=hf_tokenizer(tokenizer),
                             max_length=16, idf=idf)
        got = pf.bert_score(hyps, refs, model_name_or_path=pt_dir, user_tokenizer=hf_tokenizer(tokenizer),
                            max_length=16, idf=idf, device="cpu")
        same_scores(got, want, f"tiny bert idf={idf}")
        # the HF model object itself, passed as `model`
        same_scores(pf.bert_score(hyps, refs, model=model, user_tokenizer=hf_tokenizer(tokenizer), max_length=16,
                                  idf=idf, device="cpu"), want, "model object")
    jm = mt.BERTScore(model_name_or_path=flax_dir, user_tokenizer=hf_tokenizer(tokenizer), max_length=16)
    pm = mp.BERTScore(model_name_or_path=pt_dir, user_tokenizer=hf_tokenizer(tokenizer), max_length=16,
                      device="cpu")
    for m in (jm, pm):
        m.update(hyps[:1], refs[:1])
        m.update(hyps[1:], refs[1:])
    for k, v in jm._pack_state().items():  # HF's int64 ids narrow to int32, as jnp.asarray narrows them
        assert all(a.dtype == torch.int32 for a in pm._pack_state()[k]) and np.asarray(v[0]).dtype == np.int32
    same_scores(pm.compute(), jm.compute(), "tiny bert module")


def test_bert_state_dict_from_flax_gives_back_the_torch_tensors_exactly(tiny_bert):
    from transformers import BertModel, FlaxAutoModel

    _, flax_dir, _, model, cfg = tiny_bert
    flax_params = jax.tree.map(np.asarray, FlaxAutoModel.from_pretrained(flax_dir).params)
    sd = pbert.bert_state_dict_from_flax(flax_params)
    fresh = BertModel(cfg).eval()
    fresh.load_state_dict(sd, strict=True)
    want = model.state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
    # the tree wrapped in a top-level "params" key reads the same
    sd2 = pbert.bert_state_dict_from_flax({"params": flax_params})
    assert sorted(sd2) == sorted(sd) and all(torch.equal(sd2[k], sd[k]) for k in sd)


def test_bert_state_dict_from_flax_needs_no_transformers_and_refuses_foreign_names():
    params = {"embeddings": {"word_embeddings": {"embedding": np.arange(6, dtype=np.float32).reshape(3, 2)},
                             "LayerNorm": {"scale": np.ones(2, np.float32), "bias": np.zeros(2, np.float32)}},
              "encoder": {"layer": {"0": {"intermediate": {"dense": {
                  "kernel": np.arange(6, dtype=np.float32).reshape(2, 3), "bias": np.zeros(3, np.float32)}}}}}}
    sd = pbert.bert_state_dict_from_flax(params)
    assert sorted(sd) == ["embeddings.LayerNorm.bias", "embeddings.LayerNorm.weight",
                          "embeddings.word_embeddings.weight", "encoder.layer.0.intermediate.dense.bias",
                          "encoder.layer.0.intermediate.dense.weight"]
    assert torch.equal(sd["encoder.layer.0.intermediate.dense.weight"],
                       torch.arange(6, dtype=torch.float32).reshape(2, 3).T)
    with pytest.raises(ValueError, match="not a Flax BERT parameter"):
        pbert.bert_state_dict_from_flax({"dense": {"weights": np.zeros(2)}})
