"""The port's text metric classes against the JAX package's, on the CPU:
each class through a forward and several updates (states compared after
every step), ``compute``, ``state_dict``, ``reset`` and a JAX state loaded
through ``interop``; then BERTScore's sync over ranks and batches of
different token lengths (ROADMAP F10, D50) in a two-rank Gloo world and in
a fake twin world, beside the JAX package's failure on the same states.

Tolerances: states bit-equal, but EED's float32 ``score_sum`` (1e-6
relative: the batch's sum in another order); values bit-equal where the
JAX package computes them on the host or as one division (the edit rates,
TER, SQuAD, ROUGE), 1e-6 relative where they are a float32 formula (BLEU,
chrF, EED), 1e-6 absolute for BERTScore.
"""
import multiprocessing as mp
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import tests.helpers.torch_text_ranks as R  # noqa: E402
from metrics_tpu.parallel import sync as jsync  # noqa: E402
from metrics_tpu_torch.interop import load_jax_state  # noqa: E402
from tests.helpers.torch_twin_world import TwinWorld  # noqa: E402
from tests.helpers.torch_twins import assert_states_close, leaves  # noqa: E402

WORDS = "the a cat dog sat on mat. hello, world! is it 3.5 ok? The Cat don't e.g. 猫 ねこ (x) y; &amp;".split()


def _sentences(n, seed, lo=1, hi=16):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(lo, hi))) for _ in range(n)]


def _edits(preds, seed):
    rng = np.random.default_rng(seed)
    out = []
    for p in preds:
        words = [w for w in p.split() if rng.random() > 0.15]
        words = [rng.choice(WORDS) if rng.random() < 0.15 else w for w in words]
        out.append(" ".join(words + list(rng.choice(WORDS, rng.integers(0, 3)))))
    return out


def _pairs(seed, n=12):
    preds = _sentences(n, seed)
    return preds, _edits(preds, seed + 1)


def _multi(seed, n=12):
    preds = _sentences(n, seed)
    return preds, [[_edits([p], seed + i)[0] for i in range(1 + i % 3)] for i, p in enumerate(preds)]


def _squad(seed, n=12):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for i in range(n):
        answers = [" ".join(rng.choice(WORDS, rng.integers(1, 5))) for _ in range(rng.integers(1, 4))]
        pred = answers[0] if rng.random() < 0.4 else " ".join(rng.choice(WORDS, rng.integers(0, 5)))
        preds.append({"prediction_text": pred, "id": f"{seed}-{i}"})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"{seed}-{i}"})
    return preds, target


EXACT, FORMULA, BERT = {"rtol": 0.0, "atol": 0.0}, {"rtol": 1e-6, "atol": 0.0}, {"rtol": 0.0, "atol": 1e-6}

# name: (constructor kwargs, batch maker, state tolerance, value tolerance)
SPECS = {
    "WordErrorRate": ({}, _pairs, EXACT, EXACT),
    "CharErrorRate": ({}, _pairs, EXACT, EXACT),
    "MatchErrorRate": ({}, _pairs, EXACT, EXACT),
    "WordInfoLost": ({}, _pairs, EXACT, EXACT),
    "WordInfoPreserved": ({}, _pairs, EXACT, EXACT),
    "ExtendedEditDistance": ({"return_sentence_level_score": True}, _multi, FORMULA, FORMULA),
    "TranslationEditRate": ({"return_sentence_level_score": True, "normalize": True}, _multi, EXACT, EXACT),
    "BLEUScore": ({"smooth": True}, _multi, EXACT, FORMULA),
    "SacreBLEUScore": ({"tokenize": "intl", "lowercase": True}, _multi, EXACT, FORMULA),
    "CHRFScore": ({"return_sentence_level_score": True}, _multi, EXACT, FORMULA),
    "SQuAD": ({}, _squad, EXACT, EXACT),
    "ROUGEScore": ({"accumulate": "avg"}, _multi, EXACT, EXACT),
    "BERTScore": ({"idf": True}, _pairs, EXACT, BERT),
}


def _jax_state(jm):
    """A JAX metric's state as numpy (lists as lists of arrays)."""
    return {k: [np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v) for k, v in jm.metric_state.items()}


def _value_leaves(value):
    if isinstance(value, tuple):
        value = {f"v{i}": v for i, v in enumerate(value)}
    return leaves(value)


def _values_close(got, want, tol):
    a, b = _value_leaves(got), _value_leaves(want)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_class_against_jax_through_updates_reset_and_state_dict(name):
    kwargs, make, state_tol, value_tol = SPECS[name]
    tm = getattr(mtt, name)(device="cpu", **kwargs)
    jm = getattr(mt, name)(**kwargs)
    assert tm.jittable_update is False
    batches = [make(seed) for seed in (10, 20, 30)]
    # a forward first: its batch value, then updates
    _values_close(_quiet(tm, *batches[0]), _quiet(jm, *batches[0]), value_tol)
    assert_states_close(tm.metric_state, _jax_state(jm), **state_tol)
    for batch in batches[1:]:
        _quiet(tm.update, *batch)
        _quiet(jm.update, *batch)
        assert_states_close(tm.metric_state, _jax_state(jm), **state_tol)
    _values_close(_quiet(tm.compute), _quiet(jm.compute), value_tol)

    # the state dict round trip, and a JAX state carried into the port
    twin = getattr(mtt, name)(device="cpu", **kwargs)
    twin.persistent(True)
    tm.persistent(True)
    twin.load_state_dict(tm.state_dict())
    assert_states_close(twin.metric_state, tm.metric_state)
    carried = getattr(mtt, name)(device="cpu", **kwargs)
    load_jax_state(carried, _jax_state(jm))
    _values_close(_quiet(carried.compute), _quiet(jm.compute), value_tol)
    # and on from there, in both
    more = make(40)
    _quiet(carried.update, *more)
    _quiet(jm.update, *more)
    _values_close(_quiet(carried.compute), _quiet(jm.compute), value_tol)

    tm.reset()
    fresh = getattr(mtt, name)(device="cpu", **kwargs)
    assert_states_close(tm.metric_state, fresh.metric_state)


def test_edit_rate_states_are_float32_counts():
    """W3: the error and length states are float32, so counts stay exact
    below 2^24."""
    m = mtt.WordErrorRate(device="cpu")
    m.update(["a b c"] * 3, ["a x c d"] * 3)
    assert m.errors.dtype == m.total.dtype == torch.float32
    assert (float(m.errors), float(m.total)) == (6.0, 12.0)
    assert mtt.SQuAD(device="cpu").total.dtype == torch.int32


def test_rouge_lsum_and_stemmer_modules():
    pytest.importorskip("nltk")
    preds, target = _multi(50)
    preds = [p.replace(". ", ".\n") for p in preds]
    for kw in ({"use_stemmer": True, "rouge_keys": "rougeLsum"}, {"rouge_keys": ("rouge2", "rougeL"), "accumulate": "best"}):
        tm, jm = mtt.ROUGEScore(device="cpu", **kw), mt.ROUGEScore(**kw)
        tm.update(preds, target)
        jm.update(preds, target)
        _values_close(tm.compute(), jm.compute(), EXACT)
    with pytest.raises(ValueError, match="rouge key"):
        mtt.ROUGEScore(rouge_keys="rougeX", device="cpu")


def test_bert_score_module_with_a_precomputed_encoder_output():
    rng = np.random.default_rng(60)

    def encoder(texts):
        n, length = len(texts), 3 + len(texts[0].split())
        mask = np.ones((n, length), np.int64)
        mask[0, -1] = 0
        return rng.normal(size=(n, length, 8)).astype(np.float32), mask, rng.integers(0, 30, (n, length))

    tm = mtt.BERTScore(encoder=encoder, rescale_with_baseline=True, baseline=[0.2, 0.2, 0.2], device="cpu")
    tm.update(["a b", "c d"], ["e f", "g h"])
    tm.update(["a b c d e", "x"], ["q", "r s"])
    assert [t.shape[1] for t in tm.pred_embeddings] == [5, 8]
    jm = mt.BERTScore(rescale_with_baseline=True, baseline=[0.2, 0.2, 0.2])
    for k in ("pred", "target"):
        for part in ("embeddings", "masks", "ids"):
            for item in getattr(tm, f"{k}_{part}"):
                getattr(jm, f"{k}_{part}").append(jnp.asarray(item.numpy()))
    _values_close(tm.compute(), _quiet(jm.compute), BERT)
    with pytest.raises(ValueError, match="baseline"):
        mtt.BERTScore(rescale_with_baseline=True, device="cpu")


# ----------------------------------------------------------------------
# F10: BERTScore's sync over batches and ranks of different token lengths
# ----------------------------------------------------------------------


def _one_process(idf):
    m = mtt.BERTScore(idf=idf, device="cpu")
    for rank_batches in R.BATCHES:
        for preds, target in rank_batches:
            if preds:
                _quiet(m.update, preds, target)
    return _quiet(m.compute)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    n = 2
    out = {}
    for idf in (False, True):
        store = tmp_path_factory.mktemp(f"text2-{idf}") / "store"
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        procs = [ctx.Process(target=R.rank_main, args=(r, n, str(store), queue, idf)) for r in range(n)]
        for proc in procs:
            proc.start()
        try:
            results = dict(queue.get(timeout=240) for _ in procs)
        finally:
            for proc in procs:
                proc.join(timeout=60)
                if proc.is_alive():
                    proc.kill()
        for r, res in sorted(results.items()):
            if "error" in res:
                pytest.fail(f"rank {r} of {n} failed:\n{res['error']}")
        assert [proc.exitcode for proc in procs] == [0] * n
        out[idf] = [results[r] for r in range(n)]
    return out


@pytest.mark.parametrize("idf", [False, True])
def test_two_ranks_with_mixed_token_lengths_give_the_one_process_values(world2, idf):
    """D50: each rank's batches (and the ranks) differ in token length; the
    synced compute equals one process over every batch in rank order, with
    the collectives of six list states (a header and a payload gather each)
    and no other."""
    ranks = world2[idf]
    want = _one_process(idf)
    lengths = [set(r["local_lengths"]) for r in ranks]
    assert len(lengths[0]) > 1 and len(lengths[1]) > 1 and lengths[0] != lengths[1]
    for r in ranks:
        assert r["jax_loaded"] == []
        assert r["calls"] == [("all_gather",)] * 12
        for k in ("precision", "recall", "f1"):
            np.testing.assert_array_equal(r["value"][k], want[k].numpy())
    # the local state is kept as it was (the sync pads copies)
    assert [r["local_after"] for r in ranks] == [r["local_lengths"][: len(r["local_after"])] for r in ranks]


def _mixed_lengths(pkg, **kw):
    m = pkg.BERTScore(**kw)
    _quiet(m.update, ["a b c"], ["a b"])
    _quiet(m.update, ["a b c d e f g h i j"], ["k l m n o p q r s t"])
    return m


def test_twin_world_sync_with_mixed_token_lengths():
    """The same repair in a fake two-rank world: the synced state is each
    list's items padded to the longest and gathered twice, and compute gives
    every pair twice."""
    tm = _mixed_lengths(mtt, device="cpu")
    alone = _quiet(tm.compute)
    world = TwinWorld()
    tm.sync(dist_sync_fn=world, distributed_available_fn=lambda: True)
    assert [tuple(t.shape) for t in tm.pred_embeddings] == [(2, 12, 128), (2, 12, 128)]
    synced = _quiet(tm._original_compute)
    tm.unsync()
    assert [t.shape[1] for t in tm.pred_embeddings] == [5, 12]
    for k in alone:
        np.testing.assert_array_equal(synced[k].numpy(), np.concatenate([alone[k].numpy()] * 2))
    assert [c[0] for c in world.calls] == ["all_gather"] * 12


def test_other_list_states_still_refuse_mixed_trailing_shapes():
    """Only BERTScore pads before a sync: another list state whose items
    differ in a trailing dimension still raises, as in the JAX package."""

    class Rows(mtt.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("rows", default=[], dist_reduce_fx="cat")

        def update(self, x):
            self.rows.append(x)

        def compute(self):
            return torch.cat(self.rows)

    m = Rows(device="cpu")
    m.update(torch.zeros(2, 3))
    m.update(torch.zeros(2, 4))
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        m.sync(dist_sync_fn=TwinWorld(), distributed_available_fn=lambda: True)


@pytest.mark.reference_fault
def test_jax_bert_score_sync_fails_on_mixed_token_lengths():
    """ROADMAP F10 (reference-side): the JAX package's sync concatenates a
    list state's items before it gathers, so a 5-token and a 12-token batch
    cannot sync under ``jax.vmap(axis_name=...)``."""
    jm = _mixed_lengths(mt)
    state = jm.metric_state
    stacked = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), state)

    def sync(s):
        return jsync.sync_state(s, jm._reductions, "x")

    with pytest.raises(TypeError, match="Cannot concatenate arrays with shapes that differ"):
        jax.vmap(sync, axis_name="x")(stacked)
