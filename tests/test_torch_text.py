"""The port's text metrics and functionals against the JAX package, on the CPU.

The same seeded corpora go to both packages: every functional, every module
class over three uneven updates (its states bit-equal and dtype-equal to
JAX's, its value within 1e-6 relative), the keyword and deprecated aliases,
the tokenizers and options, a ``MetricCollection`` of the edit-distance
family through ``forward`` (strings take the eager path: nothing is
captured), the state bridge both ways mid-corpus, the cross-process sync
of text states over the three-rank gloo pool, and the port's native
edit-distance library (built from ``metrics_tpu_torch/native/levenshtein.cpp``
into ``build/kernels/``) against its plain Python DPs and JAX's library.

Corpora carry empty strings, empty reference sets, a flat reference list
with one hypothesis, CJK text, punctuation, numbers and multi-references.
"""
import ctypes
import doctest
import importlib
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metrics_tpu as mt
import metrics_tpu.functional as jf
import metrics_tpu_torch as mp
import metrics_tpu_torch.functional as pf
from metrics_tpu_torch.functional.text import helper as ph
from metrics_tpu_torch.metric import compiled_forward_steps, forward_entry_kinds
from metrics_tpu_torch.ops.kernels import build
from metrics_tpu_torch.utils.state_bridge import state_from_numpy, state_to_numpy
from tests.helpers import torch_sync_worker as w

RTOL = 1e-6
CPU = torch.device("cpu")

WORDS = ("the", "cat", "sat", "on", "mat", "a", "dog", "ran", "in", "park", "hello", "world", "there",
         "general", "kenobi", "Über", "naïve", "3.5", "U.S.", "don't", "e-mail", "(hi)", "!", ",", "quot;&amp;",
         "running", "ran", "runs", "it's", "10-20", "<b>")
CJK = ("我", "爱", "北京", "天安门", "東京", "カタカナ", "ひらがな", "。", "、", "！", "ｔｅｓｔ")


def sentence(rng, lo=0, hi=12, cjk=False):
    n = int(rng.randint(lo, hi))
    pool = WORDS + CJK if cjk else WORDS
    return " ".join(pool[i] for i in rng.randint(0, len(pool), n))


def edited(rng, s):
    """``s`` with about a third of its words substituted, dropped or doubled."""
    out = []
    for tok in s.split():
        r = rng.rand()
        if r < 0.12:
            out.append(WORDS[rng.randint(len(WORDS))])
        elif r < 0.22:
            continue
        elif r < 0.3:
            out += [tok, tok]
        else:
            out.append(tok)
    return " ".join(out)


def corpus(seed, n=15, cjk=False):
    """``(hyps, refs)`` of ``n`` pairs: references drawn, hypotheses edited
    from them; pair 0 has an empty hypothesis, pair 1 an empty reference."""
    rng = np.random.RandomState(seed)
    refs = [sentence(rng, 1, 14, cjk) for _ in range(n)]
    hyps = [edited(rng, r) for r in refs]
    hyps[0], refs[1] = "", ""
    return hyps, refs


def multi_refs(seed, refs):
    """Two to three references per pair, the first ``refs``; one empty set."""
    rng = np.random.RandomState(seed + 100)
    out = [[r] + [edited(rng, r) for _ in range(int(rng.randint(1, 3)))] for r in refs]
    out[2] = []
    return out


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_np(v) for v in x)
    if isinstance(x, jax.Array):
        return np.asarray(x)
    return x


def close(got, want, what=""):
    got, want = to_np(got), to_np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            close(got[k], want[k], f"{what}[{k}]")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w_) in enumerate(zip(got, want)):
            close(g, w_, f"{what}[{i}]")
        return
    g, w_ = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w_.shape, f"{what}: shape {g.shape} != {w_.shape}"
    np.testing.assert_allclose(g, w_, rtol=RTOL, atol=1e-7, err_msg=what)


def same_state(pstate, jstate, what=""):
    """Every leaf bit-equal and of JAX's dtype; list states element by element."""
    assert sorted(pstate) == sorted(jstate), what
    for k, jv in jstate.items():
        pv = pstate[k]
        if isinstance(jv, list):
            assert isinstance(pv, list) and len(pv) == len(jv), f"{what}.{k}: {len(pv)} != {len(jv)}"
            pairs = list(zip(pv, jv))
        else:
            pairs = [(pv, jv)]
        for p_, j_ in pairs:
            p_, j_ = p_.detach().cpu().numpy(), np.asarray(j_)
            assert p_.dtype == j_.dtype, f"{what}.{k}: dtype {p_.dtype} != {j_.dtype}"
            assert p_.shape == j_.shape, f"{what}.{k}: shape {p_.shape} != {j_.shape}"
            np.testing.assert_array_equal(p_, j_, err_msg=f"{what}.{k}")


# --------------------------------------------------------------------- functionals

EDIT_FUNCTIONALS = ("word_error_rate", "char_error_rate", "match_error_rate", "word_information_lost",
                    "word_information_preserved")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", EDIT_FUNCTIONALS)
def test_edit_distance_functionals_match_jax(name, seed):
    hyps, refs = corpus(seed, cjk=seed % 2 == 1)
    hyps[0] = "x"  # a corpus of only empty hypotheses would divide by zero in WIL/WIP alike
    got = getattr(pf, name)(hyps, refs, device="cpu")
    assert got.dtype == torch.float32 and got.device == CPU
    close(got, getattr(jf, name)(hyps, refs), name)
    # one string each
    close(getattr(pf, name)(hyps[3], refs[3], device="cpu"), getattr(jf, name)(hyps[3], refs[3]), f"{name} str")


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("n_gram", [1, 2, 4])
@pytest.mark.parametrize("seed", range(3))
def test_bleu_matches_jax(seed, n_gram, smooth):
    hyps, refs = corpus(seed)
    refs_m = multi_refs(seed, refs)
    refs_m[2] = [refs[2]]  # BLEU takes no empty reference set (JAX and the reference index an empty list)
    for r in (refs_m, [[x] for x in refs]):
        close(pf.bleu_score(hyps, r, n_gram=n_gram, smooth=smooth, device="cpu"),
              jf.bleu_score(hyps, r, n_gram=n_gram, smooth=smooth), "bleu")
    # all-zero numerator: 0.0
    close(pf.bleu_score(["a b"], [["c d"]], device="cpu"), jf.bleu_score(["a b"], [["c d"]]))


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("tokenize", ["13a", "zh", "char", "intl", "none"])
def test_sacre_bleu_matches_jax_per_tokenizer(tokenize, lowercase):
    hyps, refs = corpus(7, n=20, cjk=True)
    refs_m = [[r, edited(np.random.RandomState(i), r)] for i, r in enumerate(refs)]
    for smooth in (False, True):
        close(pf.sacre_bleu_score(hyps, refs_m, tokenize=tokenize, lowercase=lowercase, smooth=smooth, device="cpu"),
              jf.sacre_bleu_score(hyps, refs_m, tokenize=tokenize, lowercase=lowercase, smooth=smooth), tokenize)


def test_sacre_bleu_tokenizers_split_as_jax():
    """Token by token, every tokenizer, over the zh charset's edges (the
    string-compare quirk: U+2001..U+2A6D counts, CJK Ext B does not) and the
    13a/intl punctuation, digits and entities."""
    from metrics_tpu.functional.text.sacre_bleu import _SacreBLEUTokenizer as J
    from metrics_tpu_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer as P

    points = [0x2000, 0x2001, 0x2A6D, 0x2A6E, 0x2E80, 0x3000, 0x3100, 0x31A0, 0x4DB5, 0x4DB6, 0x4E00, 0x9FBB,
              0x9FBC, 0xF900, 0xFA2E, 0xFE10, 0xFF00, 0xFFEF, 0x20000, 0x2A6D6]
    lines = ["".join(chr(c) + "x" for c in points), "Hello, world. 3.5 10-20 &amp; &quot;hi&quot; <skipped>",
             "U.S.-made $5.00 (approx.) e.g. don't", "我爱北京天安门。東京は、カタカナ！ｔｅｓｔ 1,000.5",
             "line-\nbreak\nhere", ".5 leading dot", ""]
    for tok in ("13a", "zh", "char", "intl", "none"):
        for lower in (False, True):
            for line in lines:
                assert P(tok, lower)(line) == J(tok, lower)(line), (tok, line)
    with pytest.raises(ValueError, match="tokenize"):
        P("ja-mecab")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("opts", [{}, {"n_word_order": 0}, {"n_char_order": 3, "beta": 1.0},
                                  {"lowercase": True, "whitespace": True}])
def test_chrf_matches_jax(opts, seed):
    hyps, refs = corpus(seed, cjk=seed == 2)
    for r in (refs, multi_refs(seed, refs)):
        got = pf.chrf_score(hyps, r, return_sentence_level_score=True, device="cpu", **opts)
        want = jf.chrf_score(hyps, r, return_sentence_level_score=True, **opts)
        close(got, want, f"chrf {opts}")
        assert got[1].dtype == torch.float32
        close(pf.chrf_score(hyps, r, device="cpu", **opts), jf.chrf_score(hyps, r, **opts))
    # a flat reference list with ONE hypothesis: several references for it
    close(pf.chrf_score(hyps[3], refs[:4], device="cpu"), jf.chrf_score(hyps[3], refs[:4]), "flat refs")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("opts", [{}, {"normalize": True}, {"no_punctuation": True, "lowercase": False},
                                  {"normalize": True, "no_punctuation": True, "asian_support": True}])
def test_ter_matches_jax(opts, seed):
    hyps, refs = corpus(seed, cjk=bool(opts.get("asian_support")))
    for r in (refs, multi_refs(seed, refs)):
        close(pf.translation_edit_rate(hyps, r, return_sentence_level_score=True, device="cpu", **opts),
              jf.translation_edit_rate(hyps, r, return_sentence_level_score=True, **opts), f"ter {opts}")
    close(pf.translation_edit_rate(hyps[4], refs[:3], device="cpu", **opts),
          jf.translation_edit_rate(hyps[4], refs[:3], **opts), "flat refs")


def test_ter_shift_search_matches_jax_on_long_shuffled_pairs():
    """Long sentences with blocks moved: the shift search, its 1000-candidate
    cap and the beam-limited distance all bind."""
    rng = np.random.RandomState(11)
    hyps, refs = [], []
    for n in (30, 60, 90):
        ref = [WORDS[i] for i in rng.randint(0, len(WORDS), n)]
        hyp = list(ref)
        for _ in range(4):
            a = int(rng.randint(0, n - 6))
            block = hyp[a:a + 5]
            del hyp[a:a + 5]
            b = int(rng.randint(0, len(hyp)))
            hyp[b:b] = block
        hyps.append(" ".join(hyp))
        refs.append(" ".join(ref))
    hyps.append(" ".join(WORDS[:3] * 40))  # the length ratio widens the beam
    refs.append(" ".join(WORDS[:2]))
    close(pf.translation_edit_rate(hyps, refs, return_sentence_level_score=True, device="cpu"),
          jf.translation_edit_rate(hyps, refs, return_sentence_level_score=True), "long ter")


@pytest.mark.parametrize("accumulate", ["best", "avg"])
@pytest.mark.parametrize("use_stemmer", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_rouge_matches_jax(seed, use_stemmer, accumulate):
    hyps, refs = corpus(seed)
    hyps[5] = hyps[5].replace(" ", "\n", 2)  # rougeLsum's sentences
    keys = ("rouge1", "rouge2", "rouge3", "rougeL", "rougeLsum")
    for r in (refs, [x for x in multi_refs(seed, refs)]):
        r = [x if x else [""] for x in r] if isinstance(r[0], list) else r
        close(pf.rouge_score(hyps, r, use_stemmer=use_stemmer, accumulate=accumulate, rouge_keys=keys, device="cpu"),
              jf.rouge_score(hyps, r, use_stemmer=use_stemmer, accumulate=accumulate, rouge_keys=keys), "rouge")
    close(pf.rouge_score(hyps[3], refs[3], rouge_keys="rougeL", device="cpu"),
          jf.rouge_score(hyps[3], refs[3], rouge_keys="rougeL"), "one key")


def squad_corpus(seed, n=12):
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for i in range(n):
        ans = [sentence(rng, 1, 5) for _ in range(int(rng.randint(1, 4)))]
        pred = ans[0] if rng.rand() < 0.4 else edited(rng, ans[-1])
        preds.append({"prediction_text": pred, "id": f"q{i}"})
        targets.append({"answers": {"text": ans, "answer_start": [0] * len(ans)}, "id": f"q{i}"})
    preds[1]["prediction_text"] = ""
    preds.pop(3)  # a question with no prediction counts in the total only
    return preds, targets


@pytest.mark.parametrize("seed", range(3))
def test_squad_matches_jax(seed):
    preds, targets = squad_corpus(seed)
    got, want = pf.squad(preds, targets, device="cpu"), jf.squad(preds, targets)
    close(got, want, "squad")
    assert all(v.dtype == torch.float32 for v in got.values())
    close(pf.squad(preds[0], targets[0], device="cpu"), jf.squad(preds[0], targets[0]), "one dict")


@pytest.mark.parametrize("bad", ["pred_key", "target_key", "answers_key"])
def test_squad_input_errors_match_jax(bad):
    preds, targets = [{"prediction_text": "x", "id": "1"}], [{"answers": {"text": ["x"]}, "id": "1"}]
    if bad == "pred_key":
        preds = [{"text": "x", "id": "1"}]
    elif bad == "target_key":
        targets = [{"answer": {"text": ["x"]}, "id": "1"}]
    else:
        targets = [{"answers": {"txt": ["x"]}, "id": "1"}]
    msgs = []
    for fn, kw in ((pf.squad, {"device": "cpu"}), (jf.squad, {})):
        with pytest.raises(KeyError) as e:
            fn(preds, targets, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_corpus_size_and_argument_errors_match_jax():
    cases = [
        lambda f, kw: f.chrf_score(["a", "b"], [["a"], ["b"], ["c"]], **kw),
        lambda f, kw: f.translation_edit_rate(["a", "b"], [["a"]], **kw),
        lambda f, kw: f.bleu_score(["a"], [["a"], ["b"]], **kw),
        lambda f, kw: f.sacre_bleu_score(["a"], [["a"], ["b"]], **kw),
        lambda f, kw: f.chrf_score(["a"], ["a"], n_char_order=0, **kw),
        lambda f, kw: f.chrf_score(["a"], ["a"], n_word_order=-1, **kw),
        lambda f, kw: f.chrf_score(["a"], ["a"], beta=-1.0, **kw),
        lambda f, kw: f.rouge_score(["a"], ["a"], rouge_keys=("rougeX",), **kw),
        lambda f, kw: f.sacre_bleu_score(["a"], [["a"]], tokenize="nope", **kw),
    ]
    for case in cases:
        msgs = []
        for f, kw in ((pf, {"device": "cpu"}), (jf, {})):
            with pytest.raises(ValueError) as e:
                case(f, kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("fn", ["chrf_score", "translation_edit_rate"])
def test_reference_keyword_aliases_match_jax(fn):
    hyps, refs = corpus(3)
    want = getattr(jf, fn)(hypothesis_corpus=hyps, reference_corpus=refs)
    close(getattr(pf, fn)(hypothesis_corpus=hyps, reference_corpus=refs, device="cpu"), want, fn)
    close(getattr(pf, fn)(hyps, reference_corpus=refs, device="cpu"), want, fn)
    for f, kw in ((getattr(pf, fn), {"device": "cpu"}), (getattr(jf, fn), {})):
        with pytest.raises(TypeError, match="multiple values"):
            f(hyps, refs, hypothesis_corpus=hyps, **kw)
        with pytest.raises(TypeError, match="multiple values"):
            f(hyps, refs, reference_corpus=refs, **kw)
        with pytest.raises(ValueError, match="requires both"):
            f(hyps, **kw)
    # the module's update takes the reference's argument names
    cls = {"chrf_score": "CHRFScore", "translation_edit_rate": "TranslationEditRate"}[fn]
    pm, jm = getattr(mp, cls)(device="cpu"), getattr(mt, cls)()
    pm.update(hypothesis_corpus=hyps, reference_corpus=refs)
    jm.update(hypothesis_corpus=hyps, reference_corpus=refs)
    close(pm.compute(), jm.compute(), cls)


def test_deprecated_wer_aliases_warn_and_match_jax():
    hyps, refs = corpus(5)
    for pkg, kw in ((pf, {"device": "cpu"}), (jf, {})):
        with pytest.warns(DeprecationWarning, match="`wer` was renamed to `word_error_rate`"):
            pkg.wer(hyps, refs, **kw)
    close(pf.wer(hyps, refs, device="cpu"), jf.wer(hyps, refs), "wer")
    with pytest.warns(DeprecationWarning, match="`WER` was renamed to `WordErrorRate`"):
        pm = mp.WER(device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jm = mt.WER()
    assert isinstance(pm, mp.WordErrorRate)
    pm.update(hyps, refs)
    jm.update(hyps, refs)
    same_state(pm._pack_state(), jm._pack_state(), "WER")
    close(pm.compute(), jm.compute(), "WER")


def test_optional_packages_raise_at_construction_not_import():
    from metrics_tpu_torch.utils import imports

    assert imports._module_available("torch") and not imports._module_available("no_such_package.sub")
    assert imports._NLTK_AVAILABLE == mt.utils.imports._NLTK_AVAILABLE
    assert imports._REGEX_AVAILABLE == mt.utils.imports._REGEX_AVAILABLE
    assert imports._TRANSFORMERS_AVAILABLE == mt.utils.imports._TRANSFORMERS_AVAILABLE


@pytest.mark.parametrize("flag, build_it", [
    ("_NLTK_AVAILABLE", lambda: mp.ROUGEScore(use_stemmer=True, device="cpu")),
    ("_NLTK_AVAILABLE", lambda: pf.rouge_score(["a"], ["a"], use_stemmer=True, device="cpu")),
    ("_REGEX_AVAILABLE", lambda: mp.SacreBLEUScore(tokenize="intl", device="cpu")),
])
def test_missing_optional_package_raises_when_constructed(monkeypatch, flag, build_it):
    import metrics_tpu_torch.functional.text.rouge as rouge_mod
    import metrics_tpu_torch.functional.text.sacre_bleu as sacre_mod

    for mod in (rouge_mod, sacre_mod):
        if hasattr(mod, flag):
            monkeypatch.setattr(mod, flag, False)
    with pytest.raises(ModuleNotFoundError):
        build_it()


# ------------------------------------------------------------------------ modules

def module_cases():
    hyps, refs = corpus(21, n=17, cjk=True)
    hyps[0] = "only one"
    refs_m = multi_refs(21, refs)
    refs_nonempty = [x if x else [refs[2] or "x"] for x in refs_m]
    squad_p, squad_t = squad_corpus(4, n=17)
    ids_t = {t["id"] for t in squad_t}
    return {
        "WordErrorRate": ({}, hyps, refs),
        "CharErrorRate": ({}, hyps, refs),
        "MatchErrorRate": ({}, hyps, refs),
        "WordInfoLost": ({}, hyps, refs),
        "WordInfoPreserved": ({}, hyps, refs),
        "BLEUScore": ({"n_gram": 3, "smooth": True}, hyps, refs_nonempty),
        "SacreBLEUScore": ({"tokenize": "zh"}, hyps, refs_nonempty),
        "CHRFScore": ({"return_sentence_level_score": True}, hyps, refs_m),
        "CHRFScore_plain": ({"n_word_order": 0}, hyps, refs),
        "TranslationEditRate": ({"return_sentence_level_score": True, "normalize": True}, hyps, refs_m),
        "TranslationEditRate_asian": ({"asian_support": True, "normalize": True}, hyps, refs),
        "ROUGEScore": ({"rouge_keys": ("rouge1", "rouge2", "rougeL", "rougeLsum")}, hyps, refs),
        "ROUGEScore_avg": ({"accumulate": "avg", "use_stemmer": True}, hyps,
                           [x if x else [""] for x in refs_m]),
        "SQuAD": ({}, squad_p, [t for t in squad_t if t["id"] in ids_t]),
    }


MODULE_CASES = module_cases()


def run_modules(case, splits=(5, 1)):
    kw, a, b = MODULE_CASES[case]
    name = case.split("_")[0]
    pm, jm = getattr(mp, name)(device="cpu", **kw), getattr(mt, name)(**kw)
    if name == "SQuAD":  # split by question: targets follow the predictions' ids
        cuts = [0, splits[0], splits[0] + splits[1], len(b)]
        parts = [([p for p in a if p["id"] in {t["id"] for t in b[lo:hi]}], b[lo:hi])
                 for lo, hi in zip(cuts, cuts[1:])]
    else:
        cuts = [0, splits[0], splits[0] + splits[1], len(a)]
        parts = [(a[lo:hi], b[lo:hi]) for lo, hi in zip(cuts, cuts[1:])]
    for x, y in parts:
        pm.update(x, y)
        jm.update(x, y)
    return pm, jm, parts


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_module_states_and_values_match_jax_over_uneven_updates(case):
    pm, jm, _ = run_modules(case)
    same_state(pm._pack_state(), jm._pack_state(), case)
    close(pm.compute(), jm.compute(), case)
    pm.reset()
    jm.reset()
    same_state(pm._pack_state(), jm._pack_state(), f"{case} reset")


@pytest.mark.parametrize("case", ["WordErrorRate", "BLEUScore", "CHRFScore", "ROUGEScore", "SQuAD"])
def test_module_forward_gives_the_batch_value_and_captures_nothing(case):
    kw, a, b = MODULE_CASES[case]
    name = case.split("_")[0]
    pm, jm = getattr(mp, name)(device="cpu", **kw), getattr(mt, name)(**kw)
    for lo, hi in ((0, 6), (6, 9), (9, len(b))):
        x, y = (a[lo:hi], b[lo:hi]) if name != "SQuAD" else (a, b[lo:hi])
        close(pm(x, y), jm(x, y), f"{case} forward")
    close(pm.compute(), jm.compute(), case)
    assert forward_entry_kinds(pm) == [] and compiled_forward_steps(pm) == []


def test_squad_total_is_int32_as_jax():
    pm, jm, _ = run_modules("SQuAD")
    assert pm.total.dtype == torch.int32 and np.asarray(jm.total).dtype == np.int32
    assert int(pm.total) == int(jm.total) == len(MODULE_CASES["SQuAD"][2])


def edit_collection(pkg, **kw):
    return pkg.MetricCollection({"wer": pkg.WordErrorRate(**kw), "cer": pkg.CharErrorRate(**kw),
                                 "mer": pkg.MatchErrorRate(**kw), "wil": pkg.WordInfoLost(**kw),
                                 "wip": pkg.WordInfoPreserved(**kw)})


def test_edit_family_collection_forward_is_eager_and_matches_jax():
    hyps, refs = corpus(8, n=20)
    pc, jc = edit_collection(mp, device="cpu"), edit_collection(mt)
    for lo, hi in ((0, 7), (7, 8), (8, 20)):
        close(pc(hyps[lo:hi], refs[lo:hi]), jc(hyps[lo:hi], refs[lo:hi]), "forward")
    close(pc.compute(), jc.compute(), "compute")
    for k, m in pc.items(keep_base=True):
        same_state(m._pack_state(), jc[k]._pack_state(), k)
        assert forward_entry_kinds(m) == []
    assert forward_entry_kinds(pc) == [] and compiled_forward_steps(pc) == []


def test_mixed_text_collection_matches_jax():
    """The corpus collection of ``chip_smoke.py`` phase 21 at a small size:
    flat string references feed every member."""
    hyps, refs = corpus(9, n=24)

    def coll(pkg, **kw):
        return pkg.MetricCollection({
            "wer": pkg.WordErrorRate(**kw), "bleu": pkg.BLEUScore(**kw), "sacre": pkg.SacreBLEUScore(**kw),
            "chrf": pkg.CHRFScore(n_word_order=2, **kw), "rouge": pkg.ROUGEScore(**kw),
        })

    pc, jc = coll(mp, device="cpu"), coll(mt)
    for lo in range(0, 24, 8):
        pc.update(hyps[lo:lo + 8], refs[lo:lo + 8])
        jc.update(hyps[lo:lo + 8], refs[lo:lo + 8])
    for k, m in pc.items(keep_base=True):
        same_state(m._pack_state(), jc[k]._pack_state(), k)
    close(pc.compute(), jc.compute(), "collection")


def test_chrf_sentence_scores_state_is_a_cat_list_of_f32_rows():
    pm, jm, parts = run_modules("CHRFScore")
    assert [tuple(x.shape) for x in pm.sentence_chrf] == [(len(p[0]),) for p in parts]
    assert pm._reductions["sentence_chrf"] == "cat" and all(x.dtype == torch.float32 for x in pm.sentence_chrf)


def test_rouge_states_hold_one_row_per_pair():
    pm, jm, _ = run_modules("ROUGEScore")
    n = len(MODULE_CASES["ROUGEScore"][1])
    for key in ("rouge1", "rouge2", "rougeL", "rougeLsum"):
        for t in ("fmeasure", "precision", "recall"):
            vals = getattr(pm, f"{key}_{t}")
            assert len(vals) == n and all(tuple(v.shape) == (1,) for v in vals)


def test_module_argument_checks_match_jax():
    cases = [
        ("CHRFScore", {"n_char_order": 0}), ("CHRFScore", {"n_word_order": -2}), ("CHRFScore", {"beta": -0.5}),
        ("ROUGEScore", {"rouge_keys": ("rouge0",)}), ("ROUGEScore", {"accumulate": "max"}),
        ("SacreBLEUScore", {"tokenize": "nope"}),
    ]
    for name, kw in cases:
        msgs = []
        for make in (lambda: getattr(mp, name)(device="cpu", **kw), lambda: getattr(mt, name)(**kw)):
            with pytest.raises(ValueError) as e:
                make()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], name


# -------------------------------------------------------------------- state bridge

BRIDGED = {
    "WordErrorRate": {},
    "BLEUScore": {"n_gram": 4},
    "CHRFScore": {"return_sentence_level_score": True},
    "SQuAD": {},
}


def bridged_batches(name):
    hyps, refs = corpus(30, n=18)
    if name == "SQuAD":
        p, t = squad_corpus(30, n=18)
        ids = [[q["id"] for q in t[lo:lo + 6]] for lo in (0, 6, 12)]
        return [([x for x in p if x["id"] in set(i)], [x for x in t if x["id"] in set(i)]) for i in ids]
    if name == "BLEUScore":
        refs = [[r or "x"] for r in refs]
    return [(hyps[lo:lo + 6], refs[lo:lo + 6]) for lo in (0, 6, 12)]


@pytest.mark.parametrize("name", sorted(BRIDGED))
def test_state_crosses_from_jax_mid_corpus_and_back(name):
    """JAX takes the first two batches, the port the last, from JAX's state;
    and the other way: the port's state finishes in JAX. Both end on JAX's
    whole-corpus state and value."""
    kw = BRIDGED[name]
    batches = bridged_batches(name)
    whole = getattr(mt, name)(**kw)
    for x, y in batches:
        whole.update(x, y)

    jm, pm = getattr(mt, name)(**kw), getattr(mp, name)(device="cpu", **kw)
    for x, y in batches[:2]:
        jm.update(x, y)
    pm._load_state(state_from_numpy(pm, jax.tree.map(np.asarray, jm._pack_state()), device="cpu"))
    pm.update(*batches[2])
    same_state(pm._pack_state(), whole._pack_state(), f"{name} JAX -> port")
    close(pm.compute(), whole.compute(), name)

    pm2, jm2 = getattr(mp, name)(device="cpu", **kw), getattr(mt, name)(**kw)
    for x, y in batches[:2]:
        pm2.update(x, y)
    back = state_to_numpy(pm2._pack_state())
    jm2._load_state(jax.tree.map(jnp.asarray, back))
    jm2.update(*batches[2])
    same_state(pm._pack_state(), jm2._pack_state(), f"{name} port -> JAX")
    close(jm2.compute(), whole.compute(), name)


# ----------------------------------------------------- three gloo ranks (no JAX in them)

@pytest.fixture(scope="module")
def pool():
    p = w.RankPool()
    yield p
    p.close()


def test_text_states_gathered_over_three_ranks_equal_jax_on_the_whole_corpus(pool):
    """Each rank updates the text suite on its third of the corpus; every
    rank's ``sync_states`` and synced ``compute()`` equal JAX's single
    process over the whole corpus: counts bit-equal, float sums within 1e-6
    relative (three ranks add in another order), ``cat`` lists in rank order."""
    got = pool.run("text", group="world")
    for name, kw in w.TEXT_SUITE.items():
        ref = getattr(mt, name)(**kw)
        for rank in range(w.WORLD):
            ref.update(*w.text_rows(name, rank))
        want_state = jax.tree.map(np.asarray, ref._pack_state())
        want_value = to_np(ref.compute())
        for rank in range(w.WORLD):
            res = got[rank][name]
            for k, jv in want_state.items():
                tag, dtype, pv = res["synced"][k]
                if isinstance(jv, list):
                    jv = np.concatenate([np.atleast_1d(x) for x in jv])
                jv = np.asarray(jv)
                assert dtype == str(jv.dtype), f"{name}.{k}"
                if np.array_equal(jv, np.round(jv)):  # counts: bit-equal
                    np.testing.assert_array_equal(pv, jv, err_msg=f"{name}.{k} rank {rank}")
                else:  # float sums (SQuAD's f1) reassociate across ranks
                    np.testing.assert_allclose(pv, jv, rtol=RTOL, err_msg=f"{name}.{k} rank {rank}")
            close(w_value(res["compute"]), want_value, f"{name} rank {rank}")


def w_value(x):
    """The worker's ``to_np`` tree back to numpy values."""
    if isinstance(x, tuple) and len(x) == 3 and x[0] == "tensor":
        return x[2]
    if isinstance(x, list) and len(x) == 3 and x[0] == "tensor":
        return x[2]
    if isinstance(x, dict):
        return {k: w_value(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(w_value(v) for v in x)
    return x


# ------------------------------------------------------------- the native library

def pairs(seed, n=500):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = list(rng.randint(0, 6, int(rng.randint(0, 40))))
        b = list(a)
        for _ in range(int(rng.randint(0, 8))):
            op = rng.randint(3)
            pos = int(rng.randint(0, len(b) + 1))
            if op == 0:
                b.insert(pos, int(rng.randint(0, 6)))
            elif b:
                del b[min(pos, len(b) - 1)]
        if rng.rand() < 0.1:  # far-offset pairs, where the beam binds
            b = b + list(rng.randint(0, 6, int(rng.randint(40, 90))))
        out.append((a, b))
    return out


def test_native_batch_matches_its_plain_dp_and_jax():
    from metrics_tpu.functional.text import helper as jh

    ps = pairs(0)
    a, b = [p for p, _ in ps], [q for _, q in ps]
    got = ph._edit_distance_batch(a, b)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, [ph._edit_distance_py(p, q) for p, q in ps])
    np.testing.assert_array_equal(got, jh._edit_distance_batch(a, b))
    # word tokens, one pair at a time
    words = [(s.split(), t.split()) for s, t in zip(*corpus(1, n=40))]
    for p, q in words:
        assert ph._edit_distance(p, q) == ph._edit_distance_py(p, q) == jh._edit_distance(p, q)


@pytest.mark.parametrize("beam", [1, 3, 25])
def test_native_beam_matches_its_plain_beam_dp_and_jax(beam):
    from metrics_tpu.functional.text import helper as jh

    for p, q in pairs(1):
        a, b = np.asarray(p, np.int32), np.asarray(q, np.int32)
        want = ph._edit_distance_beam_py(p, q, beam)
        assert ph._edit_distance_ids(a, b, beam=beam) == want == jh._edit_distance_ids(a, b, beam=beam)
        # asymmetric: the beam follows the hypothesis, so no operand swap
        assert ph._edit_distance_ids(b, a, beam=beam) == ph._edit_distance_beam_py(q, p, beam)
        assert ph._edit_distance_ids(a, b) == ph._edit_distance_py(p, q)


def test_tokens_to_ids_packs_offsets_as_jax():
    from metrics_tpu.functional.text import helper as jh

    a, b = [["x", "y"], [], ["y", 3]], [["z"], ["x", "x"], []]
    for g, w_ in zip(ph._tokens_to_ids(a, b), jh._tokens_to_ids(a, b)):
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_)


def test_native_library_is_built_from_the_port_into_build_kernels():
    path = ph.native_library_path()
    assert path.parent == build.BUILD_DIR and path.parent.parts[-2:] == ("build", "kernels")
    assert path.name.startswith("liblevenshtein-") and path.is_file()
    assert ph.SOURCE == Path(mp.__file__).resolve().parent / "native" / "levenshtein.cpp"
    assert path == build.host_library_path(ph.SOURCE)


def test_port_never_opens_the_jax_packages_native_directory(monkeypatch, tmp_path):
    """A fresh load builds from the port's source into its own build directory;
    no file under ``metrics_tpu/native/`` is read, compiled or loaded."""
    jax_native = (Path(mt.__file__).resolve().parent / "native").as_posix()
    seen = []
    real_cdll, real_build = ctypes.CDLL, build.build_host_library
    monkeypatch.setattr(ctypes, "CDLL", lambda p, *a, **k: (seen.append(str(p)), real_cdll(p, *a, **k))[1])
    monkeypatch.setattr(build, "build_host_library",
                        lambda src, *a, **k: (seen.append(str(src)), real_build(src, tmp_path, *a, **k))[1])
    monkeypatch.setattr(ph, "_lib", None)
    monkeypatch.setattr(ph, "_lib_path", None)
    assert ph._edit_distance(["a", "b"], ["a"]) == 1
    assert seen and not any(s.startswith(jax_native) for s in seen)
    assert ph._lib_path.parent == tmp_path
    for src in Path(mp.__file__).resolve().parent.rglob("*.py"):
        assert "metrics_tpu/native" not in src.read_text(), src


def test_host_library_rebuilds_when_the_source_hash_changes(tmp_path):
    src = tmp_path / "levenshtein.cpp"
    src.write_text(ph.SOURCE.read_text())
    first = build.build_host_library(src, tmp_path / "out")
    assert first.is_file() and build.build_host_library(src, tmp_path / "out") == first  # reused
    mtime = first.stat().st_mtime_ns
    src.write_text(ph.SOURCE.read_text() + "\n// edited\n")
    second = build.build_host_library(src, tmp_path / "out")
    assert second != first and second.is_file() and first.stat().st_mtime_ns == mtime
    lib = ctypes.CDLL(str(second))
    lib.edit_distance_i32.restype = ctypes.c_int64
    a = np.asarray([1, 2, 3], np.int32)
    b = np.asarray([1, 3], np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    assert lib.edit_distance_i32(a.ctypes.data_as(i32p), ctypes.c_int64(3), b.ctypes.data_as(i32p),
                                 ctypes.c_int64(2)) == 1


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_a_broken_compiler_raises_and_nothing_falls_back(monkeypatch, tmp_path, compiler):
    if compiler == "missing":
        cxx = str(tmp_path / "no-such-g++")
    else:
        cxx = tmp_path / "bad-g++"
        cxx.write_text("#!/bin/sh\necho 'error: this compiler is broken' >&2\nexit 1\n")
        cxx.chmod(0o755)
        cxx = str(cxx)
    real_build = build.build_host_library
    monkeypatch.setattr(build, "build_host_library", lambda src, *a, **k: real_build(src, tmp_path, cxx=cxx))
    monkeypatch.setattr(ph, "_lib", None)
    monkeypatch.setattr(ph, "_lib_path", None)
    match = "this compiler is broken" if compiler == "failing" else "host library build failed"
    with pytest.raises(RuntimeError, match=match):
        pf.word_error_rate(["a b"], ["a c"], device="cpu")
    with pytest.raises(RuntimeError, match=match):
        mp.TranslationEditRate(device="cpu").update(["a b"], ["b a"])
    assert ph._lib is None


# ------------------------------------------------------------------------ doctests

TEXT_MODULES = ("wer", "cer", "mer", "wil", "wip", "bleu", "sacre_bleu", "chrf", "ter", "rouge", "squad")


@pytest.mark.parametrize("name", TEXT_MODULES)
def test_module_docstring_examples_run(name):
    for mod_name in (f"metrics_tpu_torch.text.{name}", f"metrics_tpu_torch.functional.text.{name}"):
        mod = importlib.import_module(mod_name)
        result = doctest.testmod(mod, optionflags=doctest.ELLIPSIS)
        assert result.failed == 0, mod_name
