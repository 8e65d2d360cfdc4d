"""The retrieval metrics of the port (``metrics_tpu_torch/retrieval``,
``functional/retrieval``) against the JAX package's, on the same seeded
numpy inputs.

About 40 ragged queries of 1-70 documents, with tied scores, ``-0.0``, a
denormal and a ``-inf`` score, queries without a relevant document and
queries with only relevant ones. Both modes (lists, and ``capacity=`` rings
with negative and out-of-range ids), every class and every functional.
Tolerances: the per-query values of MRR, precision, recall, hit rate,
fall-out, R-precision and the precision/recall curve bit-equal (sums of 0/1
in any order); AP and nDCG per query, and every mean over the queries,
within ``atol=1e-6`` (float32 sums in another order). The grouped capacity
layout is bit-equal. A four-rank Gloo world syncs both modes and matches
one process, its collectives counted.
"""
import multiprocessing as mp
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu.functional as jf  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import metrics_tpu_torch.functional as tf  # noqa: E402
from metrics_tpu_torch.interop import load_jax_state  # noqa: E402
from metrics_tpu_torch.retrieval import base as tbase  # noqa: E402
from tests.helpers import torch_retrieval_ranks as R  # noqa: E402

ATOL = 1e-6
EXACT = ("RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalHitRate", "RetrievalFallOut", "RetrievalRPrecision")


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _batches(rows, n=3):
    idx, p, t = rows
    bounds = np.linspace(0, idx.shape[0], n + 1).astype(int)
    return [(p[a:b], t[a:b], idx[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def _twins(name, **kw):
    return getattr(mt, name)(**kw), getattr(mtt, name)(device="cpu", **kw)


def _feed(jm, tm, batches):
    for p, t, i in batches:
        jm.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(i))
        tm.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))


def _close(ours, ref, exact=False):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    if exact:
        assert ours.astype(ref.dtype).tobytes() == ref.tobytes(), (ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


CLASSES = [
    ("RetrievalMAP", {}),
    ("RetrievalMRR", {}),
    ("RetrievalPrecision", {}),
    ("RetrievalPrecision", {"k": 3}),
    ("RetrievalPrecision", {"k": 30, "adaptive_k": True}),
    ("RetrievalRecall", {"k": 5}),
    ("RetrievalRecall", {}),
    ("RetrievalHitRate", {"k": 2}),
    ("RetrievalFallOut", {"k": 4}),
    ("RetrievalRPrecision", {}),
    ("RetrievalNormalizedDCG", {}),
    ("RetrievalNormalizedDCG", {"k": 6}),
]


# The JAX reference's jitted row kernels, shared by the three empty-target
# actions of one class: a row kernel reads only ``k`` and ``adaptive_k``
# (the action is applied on the host, after it), so each class compiles
# its kernels once instead of once an action.
_JAX_BUCKET_KERNELS: dict = {}


@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("name,kw", CLASSES, ids=[f"{n}-{sorted(k.items())}" for n, k in CLASSES])
def test_list_mode_matches_jax(name, kw, action):
    graded = name == "RetrievalNormalizedDCG"
    rows = R.queries(seed=3, graded=graded)
    jm, tm = _twins(name, empty_target_action=action, **kw)
    jm.__dict__["_bucket_kernels"] = _JAX_BUCKET_KERNELS.setdefault((name, tuple(sorted(kw.items()))), {})
    _feed(jm, tm, _batches(rows))
    _close(tm.compute(), jm.compute())
    # per query: the exact metrics bit-equal
    idx, p, t = (np.concatenate([np.asarray(x) for x in getattr(jm, s)]) for s in ("indexes", "preds", "target"))
    ref = jm._per_query_values(idx, p, t)
    ours = tm._per_query_values(*(torch.from_numpy(x) for x in (idx, p, t)))
    _close(ours, ref, exact=name in EXACT)


@pytest.mark.parametrize("name,kw", CLASSES, ids=[f"{n}-{sorted(k.items())}" for n, k in CLASSES])
def test_capacity_mode_matches_jax(name, kw):
    graded = name == "RetrievalNormalizedDCG"
    idx, p, t = R.queries(seed=4, graded=graded)
    idx = idx.copy()
    idx[5], idx[17], idx[40] = -3, R.NUM_QUERIES, R.NUM_QUERIES + 9  # dropped, never wrapped
    cap = dict(capacity=idx.shape[0] + 8, num_queries=R.NUM_QUERIES, max_docs_per_query=32)
    jm, tm = _twins(name, **cap, **kw)
    _feed(jm, tm, _batches((idx, p, t)))
    for a, b in zip(tm._grouped_capacity_matrices(), jm._grouped_capacity_matrices()):
        _close(a, b, exact=True)
    pmat, tmat, mask = jm._grouped_capacity_matrices()
    ref_rows = jax.vmap(jm._row_metric)(pmat, tmat, mask)
    ours_rows = tm._row_metric(*(torch.from_numpy(np.asarray(x)) for x in (pmat, tmat, mask)))
    _close(ours_rows, ref_rows, exact=name in EXACT)
    _close(tm.compute(), jm.compute())


def test_capacity_default_max_docs_and_a_cut_below_a_query():
    idx, p, t = R.queries(seed=5)
    longest = int(np.bincount(idx).max())
    for max_docs in (None, 7):
        kw = dict(capacity=idx.shape[0], num_queries=R.NUM_QUERIES)
        if max_docs is not None:
            kw["max_docs_per_query"] = max_docs
        jm, tm = _twins("RetrievalMAP", **kw)
        assert tm.max_docs_per_query == jm.max_docs_per_query == (max_docs or idx.shape[0])
        assert (max_docs or idx.shape[0]) != longest
        _feed(jm, tm, _batches((idx, p, t)))
        for a, b in zip(tm._grouped_capacity_matrices(), jm._grouped_capacity_matrices()):
            _close(a, b, exact=True)
        _close(tm.compute(), jm.compute())


@pytest.mark.parametrize("mode", ["list", "capacity"])
@pytest.mark.parametrize("kw", [{"max_k": 12}, {"max_k": 80, "adaptive_k": True}, {}])
def test_curves_match_jax(mode, kw):
    rows = R.queries(seed=6)
    extra = dict(capacity=rows[0].shape[0], num_queries=R.NUM_QUERIES, max_docs_per_query=64) if mode == "capacity" else {}
    for name, more in (("RetrievalPrecisionRecallCurve", {}), ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.3})):
        jm, tm = _twins(name, **extra, **kw, **more)
        _feed(jm, tm, _batches(rows))
        ours, ref = tm.compute(), jm.compute()
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _close(a, b, exact=_np(b).dtype.kind == "i")
            _close(a, b)


def test_empty_target_action_error_both_modes():
    rows = R.queries(seed=7)
    jm, tm = _twins("RetrievalMRR", empty_target_action="error")
    _feed(jm, tm, _batches(rows))
    with pytest.raises(ValueError, match="no positive target"):
        jm.compute()
    with pytest.raises(ValueError, match="no positive target"):
        tm.compute()
    for pkg, kw in ((mt, {}), (mtt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="not supported in capacity"):
            pkg.RetrievalMAP(empty_target_action="error", capacity=8, num_queries=2, **kw)
    jm, tm = _twins("RetrievalFallOut", empty_target_action="error")
    _feed(jm, tm, _batches(rows))
    for m in (jm, tm):
        with pytest.raises(ValueError, match="no negative target"):
            m.compute()


@pytest.mark.parametrize("mode", ["list", "capacity"])
def test_ignore_index(mode):
    idx, p, t = R.queries(seed=8)
    t = t.copy()
    t[::7] = -100
    extra = dict(capacity=idx.shape[0], num_queries=R.NUM_QUERIES, max_docs_per_query=70) if mode == "capacity" else {}
    for name in ("RetrievalMAP", "RetrievalRecall", "RetrievalMRR"):
        jm, tm = _twins(name, ignore_index=-100, **extra)
        _feed(jm, tm, _batches((idx, p, t)))
        _close(tm.compute(), jm.compute())


FUNCTIONALS = [
    ("retrieval_average_precision", {}),
    ("retrieval_reciprocal_rank", {}),
    ("retrieval_precision", {"k": 3}),
    ("retrieval_precision", {"k": 90, "adaptive_k": True}),
    ("retrieval_recall", {"k": 4}),
    ("retrieval_fall_out", {"k": 4}),
    ("retrieval_hit_rate", {"k": 2}),
    ("retrieval_r_precision", {}),
    ("retrieval_normalized_dcg", {"k": 5}),
    ("retrieval_precision_recall_curve", {"max_k": 9}),
    ("retrieval_precision_recall_curve", {"max_k": 90, "adaptive_k": True}),
]


@pytest.mark.parametrize("name,kw", FUNCTIONALS, ids=[f"{n}-{sorted(k.items())}" for n, k in FUNCTIONALS])
def test_functionals_per_query(name, kw):
    idx, p, t = R.queries(seed=9, graded=name == "retrieval_normalized_dcg")
    exact = name not in ("retrieval_average_precision", "retrieval_normalized_dcg")
    for q in (0, 3, 7, 11, 19, 28):  # 3 holds no relevant document, 7 only relevant ones
        sel = idx == q
        ref = getattr(jf, name)(jnp.asarray(p[sel]), jnp.asarray(t[sel]), **kw)
        ours = getattr(tf, name)(torch.from_numpy(p[sel]), torch.from_numpy(t[sel]), **kw)
        for a, b in zip(ours if isinstance(ours, tuple) else (ours,), ref if isinstance(ref, tuple) else (ref,)):
            _close(a, b, exact=exact)


def test_functional_refusals_match():
    for pkg, arr in ((jf, jnp.asarray), (tf, torch.tensor)):
        with pytest.raises(ValueError, match="same shape"):
            pkg.retrieval_recall(arr([0.1, 0.2]), arr([1]))
        with pytest.raises(ValueError, match="non-empty"):
            pkg.retrieval_recall(arr([]), arr([]))
        with pytest.raises(ValueError, match="binary"):
            pkg.retrieval_recall(arr([0.1, 0.2]), arr([2, 0]))
        with pytest.raises(ValueError, match="floats"):
            pkg.retrieval_recall(arr([1, 2]), arr([1, 0]))
        with pytest.raises(ValueError, match="positive integer"):
            pkg.retrieval_recall(arr([0.1, 0.2]), arr([1, 0]), k=0)


def test_ties_signed_zero_denormal_and_minus_inf_order_as_jax():
    # one query: a real -inf document must rank before the padding of its block
    p = np.array([0.5, -0.0, 0.0, 1e-40, -1e-40, -np.inf, 0.5, 0.5], np.float32)
    t = np.array([0, 1, 0, 1, 0, 1, 1, 0])
    idx = np.zeros(8, np.int64)
    for name in ("RetrievalMRR", "RetrievalMAP", "RetrievalPrecision", "RetrievalRPrecision"):
        jm, tm = _twins(name)
        _feed(jm, tm, [(p[:5], t[:5], idx[:5]), (p[5:], t[5:], idx[5:])])
        _close(tm.compute(), jm.compute(), exact=True)
    from metrics_tpu.ops import descending_order as jorder

    from metrics_tpu_torch.ops.bucketed_rank import descending_order_rows

    block = np.stack([p, p[::-1].copy()])
    ours = descending_order_rows(torch.from_numpy(block))
    ref = jax.vmap(jorder)(jnp.asarray(block))
    _close(ours, ref, exact=True)


@pytest.mark.parametrize("mode", ["list", "capacity"])
def test_collection_groups_metrics_with_float_and_integer_targets_as_jax(mode):
    """F6: nDCG keeps float targets, the other metrics integer ones; JAX's
    group check compares them with ``np.allclose`` (the dtypes promote) and
    groups them, where the port's ``torch.allclose`` raised."""
    rows = R.queries(seed=13)
    extra = dict(capacity=rows[0].shape[0], num_queries=R.NUM_QUERIES, max_docs_per_query=70) if mode == "capacity" else {}

    def coll(pkg, **kw):
        return pkg.MetricCollection({"mrr": pkg.RetrievalMRR(**kw, **extra), "ndcg": pkg.RetrievalNormalizedDCG(k=5, **kw, **extra),
                                     "p": pkg.RetrievalPrecision(k=3, **kw, **extra)})

    ours, ref = coll(mtt, device="cpu"), coll(mt)
    for p, t, i in _batches(rows):
        ours.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
        ref.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(i))
    assert ours.compute_groups == ref.compute_groups
    got, want = ours.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


def test_list_mode_warns_once_per_class_above_the_env_threshold(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_EAGER_WARN_ROWS", "10")
    tbase._host_grouped_warned.discard("RetrievalHitRate")
    m = mtt.RetrievalHitRate(device="cpu")
    idx, p, t = R.queries(seed=10)
    m.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(idx))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        m.compute()
        m.compute()
    assert sum("list mode" in str(w.message) for w in rec) == 1
    monkeypatch.setenv("METRICS_TPU_EAGER_WARN_ROWS", "many")
    tbase._env_warn_once.reset()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert tbase._eager_warn_rows() == 50_000
        assert tbase._eager_warn_rows() == 50_000
    assert sum("not a non-negative integer" in str(w.message) for w in rec) == 1


@pytest.mark.parametrize("mode", ["list", "capacity"])
def test_jax_state_carries_over(mode):
    rows = R.queries(seed=11)
    extra = dict(capacity=rows[0].shape[0], num_queries=R.NUM_QUERIES, max_docs_per_query=70) if mode == "capacity" else {}
    jm, tm = _twins("RetrievalMAP", **extra)
    first, *rest = _batches(rows)
    jm.update(*(jnp.asarray(x) for x in first[:2]), indexes=jnp.asarray(first[2]))
    load_jax_state(tm, {k: v for k, v in jm.metric_state.items()})
    _feed(jm, tm, rest)
    _close(tm.compute(), jm.compute())


class ScalarReads(TorchDispatchMode):
    """Counts the reads of a tensor's value to the host (the
    ``aten._local_scalar_dense`` behind ``item()``, ``int()``, ``bool()``
    and indexing by a 0-d tensor), which block the host on the card."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def test_capacity_update_reads_nothing_back():
    idx, p, t = R.queries(seed=12)
    m = mtt.RetrievalMRR(capacity=idx.shape[0] + 5, num_queries=R.NUM_QUERIES, device="cpu")
    batches = _batches((idx, p, t))
    with ScalarReads() as rec:
        for pb, tb, ib in batches:
            m.update(torch.from_numpy(pb), torch.from_numpy(tb), indexes=torch.from_numpy(ib))
    assert rec.reads == 0


@pytest.mark.parametrize("valid", [None, [True, False, True, True, False, True, True]])
def test_ring_append_reads_nothing_back(valid):
    """F5: an append indexed its rows by a 0-d tensor, two reads back each."""
    from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_append

    buf = CatBuffer.zeros(9, (2,), torch.float32)
    rows = torch.arange(14, dtype=torch.float32).reshape(7, 2)
    mask = None if valid is None else torch.tensor(valid)
    with ScalarReads() as rec:
        out = cat_append(buf, rows, mask)
        out = cat_append(out, rows, mask)
    assert rec.reads == 0
    kept = rows if mask is None else rows[mask]
    want = torch.cat([kept, kept])[:9]
    assert torch.equal(out.data[: want.shape[0]], want) and int(out.mask.sum()) == want.shape[0]
    assert int(out.dropped) == 2 * kept.shape[0] - want.shape[0]


# ----------------------------------------------------------------------
# four ranks
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    n = 4
    store = tmp_path_factory.mktemp("retrieval4") / "store"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=R.rank_main, args=(r, n, str(store), queue)) for r in range(n)]
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
    return n, [results[r] for r in range(n)]


@pytest.mark.parametrize("mode", ["list", "capacity"])
def test_four_rank_retrieval_matches_one_process(world4, mode):
    n, results = world4
    rows = R.queries(seed=R.WORLD_SEED)
    # one process over the union in the order the sync gathers it (rank
    # order): tied scores keep that order within a query
    union = tuple(np.concatenate(parts) for parts in zip(*(R.shard(rows, r, n) for r in range(n))))
    for name, kw in R.WORLD_METRICS:
        extra = R.capacity_kw(rows) if mode == "capacity" else {}
        jm = getattr(mt, name)(**kw, **extra)
        jm.update(jnp.asarray(union[1]), jnp.asarray(union[2]), indexes=jnp.asarray(union[0]))
        want = np.asarray(jm.compute())
        for res in results:
            np.testing.assert_allclose(res[mode]["values"][name], want, rtol=0, atol=ATOL)
            assert res["jax_loaded"] == []
        for res in results[1:]:
            assert res[mode]["values"][name].tobytes() == results[0][mode]["values"][name].tobytes()
    for res in results:
        calls = res[mode]["calls"]
        gathers = [c for c in calls if c[0] != "all_reduce"]
        reduces = [c[:2] + (c[2].split(".")[-1],) for c in calls if c[0] == "all_reduce"]
        if mode == "list":
            # three list states, each a ragged gather (a header, then the rows)
            assert gathers == [("all_gather",)] * 6 * len(R.WORLD_METRICS), calls
            assert reduces == [], calls
        else:
            # three rings, each its data and its mask (ragged gathers); the rings' dropped
            # counts in one int32 bucket
            assert gathers == [("all_gather",)] * R.RING_GATHERS * len(R.WORLD_METRICS), calls
            assert reduces == [("all_reduce", "int32", "SUM")] * len(R.WORLD_METRICS), calls
