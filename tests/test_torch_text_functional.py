"""The port's functional text metrics against the JAX package's, on the CPU.

Inputs are seeded numpy draws from one small vocabulary (punctuation,
digits, capitals, CJK and kana among the words). Tolerances:

- edit distances and their lengths, n-gram, chrF and TER counts, ROUGE,
  SQuAD and the HashTextEncoder's embeddings and IDF weights: bit-equal
  (the same host Python and the same float32 rounding);
- sentence-level EED, chrF and TER scores: bit-equal on these inputs;
- corpus scores computed as tensor math (BLEU's and chrF's formulas, EED's
  mean): within 1e-6 relative (a float32 sum in another order);
- BERTScore: within 1e-6 absolute (a float32 norm, product and sum in
  another order; measured up to 2.4e-7).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu.functional.text as JT  # noqa: E402
import metrics_tpu_torch.functional.text as TT  # noqa: E402
from metrics_tpu.functional.text import bert as jbert  # noqa: E402
from metrics_tpu.functional.text import bleu as jbleu  # noqa: E402
from metrics_tpu.functional.text import chrf as jchrf  # noqa: E402
from metrics_tpu.functional.text import eed as jeed  # noqa: E402
from metrics_tpu.functional.text import helper as jhelper  # noqa: E402
from metrics_tpu.functional.text import ter as jter  # noqa: E402
from metrics_tpu_torch.functional.text import bert as tbert  # noqa: E402
from metrics_tpu_torch.functional.text import bleu as tbleu  # noqa: E402
from metrics_tpu_torch.functional.text import chrf as tchrf  # noqa: E402
from metrics_tpu_torch.functional.text import eed as teed  # noqa: E402
from metrics_tpu_torch.functional.text import helper as thelper  # noqa: E402
from metrics_tpu_torch.functional.text import ter as tter  # noqa: E402

CPU = torch.device("cpu")
RTOL = 1e-6
BERT_ATOL = 1e-6

WORDS = (
    "the a an cat dog sat on mat mat. hello, world! is it 3.5 ok? The Cat \"quoted\" don't "
    "e.g. U.S. Dr. 12,000 state-of-the-art 猫 ねこ ネコ 東京 (paren) semi; colon: &amp; x-ray"
).split()


def _sentences(n, seed, lo=0, hi=20):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(lo, hi))) for _ in range(n)]


def _references(preds, seed, max_refs=3):
    """Each prediction's references: seeded edits of it (deletions,
    substitutions, insertions), or an unrelated sentence."""
    rng = np.random.default_rng(seed)
    out = []
    for p in preds:
        refs = []
        for _ in range(rng.integers(1, max_refs + 1)):
            words = p.split()
            if not words or rng.random() < 0.2:
                refs.append(" ".join(rng.choice(WORDS, rng.integers(1, 15))))
                continue
            edited = []
            for w in words:
                r = rng.random()
                if r < 0.1:
                    continue
                edited.append(rng.choice(WORDS) if r < 0.2 else w)
                if rng.random() < 0.1:
                    edited.append(rng.choice(WORDS))
            refs.append(" ".join(edited))
        out.append(refs)
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _levenshtein(a, b):
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


# ----------------------------------------------------------------------
# the wavefront and the edit-distance family
# ----------------------------------------------------------------------


@pytest.mark.parametrize("lengths", [(0, 0), (0, 1), (1, 0), (1, 1), (7, 8), (8, 8), (8, 9), (9, 8), (15, 16), (16, 17), (17, 16), (31, 33)])
def test_edit_distances_at_bucket_edges(lengths):
    """Empty and one-token rows and lengths on both sides of each bucket
    edge (8, 16, 32): the distances bit-equal to JAX's and to a plain
    Python Levenshtein."""
    la, lb = lengths
    rng = np.random.default_rng(la * 100 + lb)
    vocab = list("abcdef")
    preds = [" ".join(rng.choice(vocab, la)) for _ in range(5)]
    target = [" ".join(rng.choice(vocab, lb)) for _ in range(5)]
    got, got_pl, got_tl = thelper._edit_distances(preds, target, thelper._tokenize_words, CPU)
    want, want_pl, want_tl = jhelper._edit_distances(preds, target, jhelper._tokenize_words)
    assert got.dtype == torch.int32
    _same(got, want)
    _same(got_pl, want_pl)
    _same(got_tl, want_tl)
    assert got.tolist() == [_levenshtein(p.split(), t.split()) for p, t in zip(preds, target)]


def test_edit_distances_of_a_mixed_batch():
    preds = _sentences(40, 1, 0, 40)
    target = [refs[0] for refs in _references(preds, 2)]
    for tokenize in ("_tokenize_words", "_tokenize_chars"):
        got = thelper._edit_distances(preds, target, getattr(thelper, tokenize), CPU)[0]
        want = jhelper._edit_distances(preds, target, getattr(jhelper, tokenize))[0]
        _same(got, want)
        split = str.split if tokenize == "_tokenize_words" else list
        assert got.tolist() == [_levenshtein(split(p), split(t)) for p, t in zip(preds, target)]


@pytest.mark.parametrize("name", ["wer", "cer", "mer", "wil", "wip"])
def test_edit_rate_counts_and_values(name):
    import importlib

    jmod = importlib.import_module(f"metrics_tpu.functional.text.{name}")
    tmod = importlib.import_module(f"metrics_tpu_torch.functional.text.{name}")
    preds = _sentences(30, 3, 0, 25) + ["", "one"]
    target = [refs[0] for refs in _references(preds[:30], 4)] + ["x y", "one"]
    got = getattr(tmod, f"_{name}_update")(preds, target, CPU)
    want = getattr(jmod, f"_{name}_update")(preds, target)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _same(g, w)
    public = {"wer": "word_error_rate", "cer": "char_error_rate", "mer": "match_error_rate",
              "wil": "word_information_lost", "wip": "word_information_preserved"}[name]
    _same(getattr(TT, public)(preds, target, device="cpu"), getattr(JT, public)(preds, target))
    # a single string is one pair
    _same(getattr(TT, public)(preds[0], target[0], device="cpu"), getattr(JT, public)(preds[0], target[0]))


# ----------------------------------------------------------------------
# EED
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [{}, {"alpha": 1.0, "rho": 0.5, "deletion": 0.5, "insertion": 0.5}, {"language": "ja"}])
def test_eed_against_jax(kwargs):
    preds = _sentences(40, 5, 0, 15)
    target = _references(preds, 6)
    got, got_s = TT.extended_edit_distance(preds, target, return_sentence_level_score=True, device="cpu", **kwargs)
    want, want_s = JT.extended_edit_distance(preds, target, return_sentence_level_score=True, **kwargs)
    assert len(got_s) == len(want_s)
    _same(torch.stack(got_s), np.stack([np.asarray(s) for s in want_s]))
    _close(got, want)


def test_eed_ties_in_the_row_minimum():
    """Rows whose minimum several positions share (repeated characters,
    equal costs): the first index counts, as ``jnp.argmin`` takes it, so
    the coverage and the scores are bit-equal."""
    preds = ["aaaa bbbb", "ab ab ab", "a", "", "xyz xyz", "aa"]
    target = [["aaaa"], ["ba ba"], ["a a a a"], ["b"], ["xyz"], ["aaaaaa aaaaaa"]]
    got = teed._eed_update(preds, target, CPU)
    want = jeed._eed_update(preds, target)
    _same(got, np.stack([np.asarray(s) for s in want]))
    # XLA flushes denormals in the compare: the three zeros of the second
    # row tie, and the first wins; torch sees -1e-40 as the least unless
    # the row is flushed first
    row = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0], [1e-40, 0.0, -1e-40, 5.0, 0.0]])
    assert jnp.argmin(jnp.asarray(row.numpy()), axis=1).tolist() == [1, 0]
    assert torch.argmin(teed.flush_denormals(row), dim=1).tolist() == [1, 0]
    assert torch.argmin(row, dim=1).tolist() == [1, 2]


def test_eed_empty_and_refusals():
    assert float(TT.extended_edit_distance([], [], device="cpu")) == float(JT.extended_edit_distance([], [])) == 0.0
    with pytest.raises(ValueError, match="language"):
        TT.extended_edit_distance(["a"], ["a"], language="de", device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        TT.extended_edit_distance(["a"], ["a"], alpha=-1.0, device="cpu")
    with pytest.raises(ValueError, match="different size"):
        TT.extended_edit_distance(["a", "b"], ["a"], device="cpu")


# ----------------------------------------------------------------------
# TER, BLEU, SacreBLEU, chrF
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"normalize": True}, {"no_punctuation": True}, {"lowercase": False}, {"normalize": True, "asian_support": True, "no_punctuation": True}],
)
def test_ter_against_jax(kwargs):
    preds = _sentences(25, 7, 0, 14)
    target = _references(preds, 8)
    tok_t = tter._TercomTokenizer(**{"normalize": False, "no_punctuation": False, "lowercase": True, "asian_support": False, **kwargs})
    tok_j = jter._TercomTokenizer(**{"normalize": False, "no_punctuation": False, "lowercase": True, "asian_support": False, **kwargs})
    got = tter._ter_update(preds, target, tok_t, CPU, collect_sentence_scores=True)
    want = jter._ter_update(preds, target, tok_j, collect_sentence_scores=True)
    _same(got[0], want[0])
    _same(got[1], want[1])
    _same(torch.cat(got[2]), np.concatenate([np.asarray(s) for s in want[2]]))
    _same(TT.translation_edit_rate(preds, target, device="cpu", **kwargs), JT.translation_edit_rate(preds, target, **kwargs))
    with pytest.raises(ValueError, match="boolean"):
        TT.translation_edit_rate(preds, target, normalize="yes", device="cpu")


@pytest.mark.parametrize("kwargs", [{}, {"smooth": True}, {"n_gram": 2}, {"n_gram": 3, "weights": [0.5, 0.3, 0.2]}])
def test_bleu_against_jax(kwargs):
    preds = _sentences(40, 9, 1, 20)
    target = _references(preds, 10)
    n = kwargs.get("n_gram", 4)
    got = tbleu._bleu_score_update(preds, target, CPU, n)
    want = jbleu._bleu_score_update(preds, target, n)
    for g, w in zip(got, want):
        _same(g, w)
    value = TT.bleu_score(preds, target, device="cpu", **kwargs)
    assert float(value) > 0
    _close(value, JT.bleu_score(preds, target, **kwargs))
    _close(TT.bleu_score(preds[0], [target[0]], device="cpu", **kwargs), JT.bleu_score(preds[0], [target[0]], **kwargs))
    with pytest.raises(ValueError, match="weights"):
        TT.bleu_score(preds, target, n_gram=2, weights=[1.0], device="cpu")


@pytest.mark.parametrize("tokenize", ["none", "13a", "zh", "intl", "char", "ja-mecab"])
@pytest.mark.parametrize("lowercase", [False, True])
def test_sacre_bleu_tokenizers_against_jax(tokenize, lowercase):
    """The six tokenizers; ``ja-mecab`` runs MeCab where it is importable
    and the script-boundary fallback elsewhere, in both packages."""
    preds = _sentences(30, 11, 1, 20)
    target = _references(preds, 12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = TT.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase, smooth=True, device="cpu")
        want = JT.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase, smooth=True)
    _close(got, want)
    line = preds[3]
    from metrics_tpu.functional.text import sacre_bleu as jsb
    from metrics_tpu_torch.functional.text import sacre_bleu as tsb

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tsb._SacreBLEUTokenizer(tokenize, lowercase)(line) == jsb._SacreBLEUTokenizer(tokenize, lowercase)(line)


def test_sacre_bleu_mecab_where_importable():
    pytest.importorskip("MeCab")
    from metrics_tpu.functional.text import sacre_bleu as jsb
    from metrics_tpu_torch.functional.text import sacre_bleu as tsb

    line = "東京は日本の首都です。"
    assert tsb._tokenize_ja_mecab(line) == jsb._tokenize_ja_mecab(line)


def test_sacre_bleu_refuses_an_unknown_tokenizer():
    with pytest.raises(ValueError, match="tokenize"):
        TT.sacre_bleu_score(["a"], [["a"]], tokenize="moses", device="cpu")


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"n_word_order": 0}, {"n_char_order": 4, "n_word_order": 1, "beta": 1.0}, {"lowercase": True, "whitespace": True}],
)
def test_chrf_against_jax(kwargs):
    preds = _sentences(40, 13, 0, 15)
    target = _references(preds, 14)
    c, w = kwargs.get("n_char_order", 6), kwargs.get("n_word_order", 2)
    beta, lower, ws = kwargs.get("beta", 2.0), kwargs.get("lowercase", False), kwargs.get("whitespace", False)
    got = tchrf._chrf_score_update(preds, target, c, w, beta, lower, ws, CPU, collect_sentence_scores=True)
    want = jchrf._chrf_score_update(preds, target, c, w, beta, lower, ws, collect_sentence_scores=True)
    for g, x in zip(got[:6], want[:6]):
        _same(g, x)
    _same(torch.cat(got[6]), np.concatenate([np.asarray(s) for s in want[6]]))
    score, sentences = TT.chrf_score(preds, target, return_sentence_level_score=True, device="cpu", **kwargs)
    j_score, j_sentences = JT.chrf_score(preds, target, return_sentence_level_score=True, **kwargs)
    _close(score, j_score)
    _same(sentences, j_sentences)


def test_chrf_refusals():
    with pytest.raises(ValueError, match="n_char_order"):
        TT.chrf_score(["a"], [["a"]], n_char_order=0, device="cpu")
    with pytest.raises(ValueError, match="n_word_order"):
        TT.chrf_score(["a"], [["a"]], n_word_order=-1, device="cpu")
    with pytest.raises(ValueError, match="beta"):
        TT.chrf_score(["a"], [["a"]], beta=-1.0, device="cpu")


# ----------------------------------------------------------------------
# SQuAD and ROUGE
# ----------------------------------------------------------------------


def _squad_data(n, seed):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for i in range(n):
        answers = [" ".join(rng.choice(WORDS, rng.integers(1, 6))) for _ in range(rng.integers(1, 4))]
        pick = rng.random()
        pred = answers[0] if pick < 0.3 else (" ".join(rng.choice(WORDS, rng.integers(0, 6))) if pick < 0.9 else "")
        preds.append({"prediction_text": pred, "id": str(i)})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": str(i)})
    return preds, target


def test_squad_against_jax():
    import importlib

    # the packages export the function under its module's name
    jsq = importlib.import_module("metrics_tpu.functional.text.squad")
    tsq = importlib.import_module("metrics_tpu_torch.functional.text.squad")

    preds, target = _squad_data(60, 15)
    # one question left unanswered
    preds = preds[:-1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tsq._squad_update(*tsq._squad_input_check(preds, target), CPU)
        want = jsq._squad_update(*jsq._squad_input_check(preds, target))
        for g, w in zip(got, want):
            _same(g, w)
        assert got[2].dtype == torch.int32
        tv, jv = TT.squad(preds, target, device="cpu"), JT.squad(preds, target)
    assert tv.keys() == jv.keys()
    for k in tv:
        _same(tv[k], jv[k])
    with pytest.raises(KeyError, match="prediction_text"):
        TT.squad([{"id": "1"}], target[:1], device="cpu")


@pytest.mark.parametrize("accumulate", ["best", "avg"])
@pytest.mark.parametrize("newlines", [False, True])
def test_rouge_against_jax(accumulate, newlines):
    """rougeLsum with newline-split summaries and without (then nltk's punkt
    where its data is present, else the regex split, in both packages)."""
    preds = _sentences(30, 16, 1, 25)
    target = _references(preds, 17)
    if newlines:
        preds = [p.replace(". ", ".\n") for p in preds]
        target = [[r.replace(". ", ".\n") for r in refs] for refs in target]
    keys = ("rouge1", "rouge2", "rouge3", "rougeL", "rougeLsum")
    got = TT.rouge_score(preds, target, accumulate=accumulate, rouge_keys=keys, device="cpu")
    want = JT.rouge_score(preds, target, accumulate=accumulate, rouge_keys=keys)
    assert got.keys() == want.keys()
    for k in got:
        _same(got[k], want[k])


def test_rouge_with_a_custom_normalizer_tokenizer_and_stemmer():
    pytest.importorskip("nltk")
    preds = _sentences(20, 18, 1, 20)
    target = _references(preds, 19)

    def normalizer(text):
        return text.upper()

    def tokenizer(text):
        return text.replace(".", " ").split()

    for kw in ({"normalizer": normalizer, "tokenizer": tokenizer}, {"use_stemmer": True}):
        got = TT.rouge_score(preds, target, device="cpu", **kw)
        want = JT.rouge_score(preds, target, **kw)
        for k in got:
            _same(got[k], want[k])
    with pytest.raises(ValueError, match="rouge key"):
        TT.rouge_score(preds, target, rouge_keys="rouge10", device="cpu")
    with pytest.raises(ValueError, match="accumulate"):
        TT.rouge_score(preds, target, accumulate="max", device="cpu")


# ----------------------------------------------------------------------
# BERTScore
# ----------------------------------------------------------------------


def test_hash_text_encoder_and_idf_weights_are_bit_equal():
    sentences = _sentences(30, 20, 0, 30)
    got = tbert.HashTextEncoder(dim=32, seed=3)(sentences)
    want = jbert.HashTextEncoder(dim=32, seed=3)(sentences)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    _, mask, ids = got
    table = tbert._idf_weights(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    weights = jbert._idf_weights(ids, mask)
    assert set(np.nonzero(table)[0]) <= set(weights)
    for token, w in weights.items():
        assert table[token] == np.float32(w)


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"idf": True}, {"rescale_with_baseline": True, "baseline": [0.1, 0.2, 0.3]}, {"max_length": 7},
     {"idf": True, "rescale_with_baseline": True, "baseline": [0.25, 0.5, 0.75]}],
)
def test_bert_score_with_the_default_encoder(kwargs):
    preds = _sentences(24, 21, 0, 25)
    target = [refs[0] for refs in _references(preds, 22)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = TT.bert_score(preds, target, device="cpu", **kwargs)
        want = JT.bert_score(preds, target, **kwargs)
    for k in ("precision", "recall", "f1"):
        assert got[k].shape == (24,)
        _close(got[k], want[k], rtol=0.0, atol=BERT_ATOL)


def test_bert_score_with_precomputed_dicts():
    rng = np.random.default_rng(23)

    def side(n, length, seed):
        r = np.random.default_rng(seed)
        lens = r.integers(2, length + 1, n)
        mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.int64)
        return {"embeddings": r.normal(size=(n, length, 16)).astype(np.float32), "attention_mask": mask,
                "input_ids": r.integers(0, 50, (n, length)) * mask}

    preds, target = side(9, 11, 1), side(9, 6, 2)
    for kwargs in ({}, {"idf": True}):
        got = TT.bert_score(preds, target, device="cpu", **kwargs)
        want = JT.bert_score(preds, target, **kwargs)
        for k in got:
            _close(got[k], want[k], rtol=0.0, atol=BERT_ATOL)
    del rng
    # without input_ids, and torch tensors as they are
    bare = {k: v for k, v in preds.items() if k != "input_ids"}
    got = TT.bert_score({k: torch.from_numpy(v) for k, v in bare.items()}, target, device="cpu")
    want = JT.bert_score(bare, target)
    for k in got:
        _close(got[k], want[k], rtol=0.0, atol=BERT_ATOL)


def test_bert_score_empty_and_refusals():
    empty = {"embeddings": np.zeros((0, 0, 4), np.float32), "attention_mask": np.zeros((0, 0), np.int64)}
    got = TT.bert_score(empty, empty, device="cpu")
    assert all(v.shape == (0,) for v in got.values())
    one = {"embeddings": np.ones((1, 3, 4), np.float32), "attention_mask": np.ones((1, 3), np.int64)}
    two = {"embeddings": np.ones((2, 3, 4), np.float32), "attention_mask": np.ones((2, 3), np.int64)}
    with pytest.raises(ValueError, match="same number"):
        TT.bert_score(one, two, device="cpu")
    with pytest.raises(ValueError, match="baseline"):
        TT.bert_score(one, one, rescale_with_baseline=True, device="cpu")


def test_bert_score_matching_in_blocks_is_the_matching_at_once(monkeypatch):
    """The matching runs in blocks of pairs; the pairs are independent, so
    blocks of 5 give the values of one block."""
    preds = _sentences(23, 24, 1, 20)
    target = [refs[0] for refs in _references(preds, 25)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        whole = TT.bert_score(preds, target, device="cpu")
        monkeypatch.setattr(tbert, "MATCH_BLOCK_ROWS", 5)
        blocked = TT.bert_score(preds, target, device="cpu")
    for k in whole:
        _close(blocked[k], whole[k], rtol=0.0, atol=1e-7)


def test_chip_smoke_host_levenshtein_is_the_dp():
    """``chip_smoke.py`` checks the card's edit counts against its
    bit-parallel Levenshtein; it is the cell-by-cell DP on words, characters
    and empty sequences."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_levenshtein", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(26)
    for _ in range(400):
        a = list(rng.integers(0, 5, rng.integers(0, 40)))
        b = list(rng.integers(0, 5, rng.integers(0, 40)))
        assert smoke._levenshtein(a, b) == _levenshtein(a, b)
    for p, t in zip(_sentences(40, 27, 0, 30), _sentences(40, 28, 0, 30)):
        assert smoke._levenshtein(p.split(), t.split()) == _levenshtein(p.split(), t.split())
        assert smoke._levenshtein(p, t) == _levenshtein(p, t)
