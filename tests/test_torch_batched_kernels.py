"""The kernels' lane route under ``torch.func.vmap`` (``ops/_build.py::
lane_route``) against the JAX package's kernels under ``jax.vmap``, on the
same seeded numpy inputs.

On the CPU a vmap-batched tensor reaches each kernel's ``torch.library`` op,
whose vmap rule runs the plain version with the lane axis written out: the
form a batched CUDA tensor reaches on the card, with the kernel's batched
form in place of the plain one. JAX's side is its own Pallas kernel, run in
interpret mode, through ``pallas_call``'s batching rule: K1 is
``jax.vmap(binned_counter_update(..., backend="pallas-interpret"))``, K2
``jax.vmap(histogram_pallas(..., interpret=True))``, K3 the insert and
merge cascades and the single fold (``fold_level``) under
``kernel_override(compactor_fold="pallas-interpret")``.

Tolerance: none. Every output is bit-equal (integer counts, float32 counts
of 0/1 rows, sketch items that are input values moved, never computed).

Also held: lanes of one row and of many, NaN and denormal scores, repeated
thresholds, out-of-range and int64 ids, a lane axis that is not axis 0,
nested vmaps folded into one lane axis, the split of a large K2 call into
launches below 2^31 bins, the refusal of a batched threshold set, and K3's
edges in one batch: empty, full and pass-through lanes, c == k and k + 1,
odd leftovers, heavy ties, an insert at the top level.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from metrics_tpu.ops import binned_counters as jax_k1  # noqa: E402
from metrics_tpu.ops import compactor as jax_compactor  # noqa: E402
from metrics_tpu.ops import dispatch as kdispatch  # noqa: E402
from metrics_tpu.ops.pallas_kernels import histogram_pallas  # noqa: E402
from metrics_tpu.streaming.sketches import QuantileSketchState as JaxState  # noqa: E402
from metrics_tpu_torch.ops import _build, binned_counters, compactor, histogram  # noqa: E402
from metrics_tpu_torch.streaming.sketches import QuantileSketchState  # noqa: E402

DENORMAL = np.float32(1e-40)
_INF = float("inf")


def _bits(ours, ref):
    o, r = np.ascontiguousarray(ours.numpy()), np.ascontiguousarray(np.asarray(ref))
    assert o.shape == r.shape and o.dtype == r.dtype, (o.shape, r.shape, o.dtype, r.dtype)
    np.testing.assert_array_equal(o.reshape(-1).view(np.uint8), r.reshape(-1).view(np.uint8))


class Count:
    """Counts the calls of a module's function while the test runs."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        inner = getattr(module, name)

        def counted(*args, **kwargs):
            self.n += 1
            return inner(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)


# --------------------------------------------------------------------------
# K1: binned counters
# --------------------------------------------------------------------------


def _k1_inputs(lanes, rows, classes, seed, nan=False, denormal=False):
    rng = np.random.default_rng(seed)
    p = rng.random((lanes, rows, classes)).astype(np.float32)
    t = (rng.random((lanes, rows, classes)) < 0.4).astype(np.float32)
    if nan:
        p[rng.random(p.shape) < 0.2] = np.nan
    if denormal:
        p[rng.random(p.shape) < 0.3] = DENORMAL
        p[rng.random(p.shape) < 0.1] = -DENORMAL
    return p, t


THRESHOLDS = {
    "linspace": np.linspace(0, 1, 6).astype(np.float32),
    "repeated": np.array([0.5, 0.2, 0.5, 0.0, 0.9, 0.2], np.float32),
    "denormal": np.array([0.0, DENORMAL, -DENORMAL, 0.5, -0.0, 1.0], np.float32),
    # 7,000 thresholds (one class a tile in the many-row kernel's plan), in no order, with a repeat and a NaN
    "many": np.concatenate([np.random.default_rng(7).random(6998), [0.5, np.nan]]).astype(np.float32),
}

K1_CASES = {
    # name: (lanes, rows, classes, thresholds, nan, denormal)
    "one_row_lanes": (8, 1, 5, "linspace", False, False),
    "many_row_lanes": (4, 11, 3, "linspace", False, False),
    "nan_scores_repeated_thresholds": (6, 1, 4, "repeated", True, False),
    "denormal_scores_and_thresholds": (5, 7, 2, "denormal", False, True),
    # the splits of the many-row kernel's plan: class tiles of 32, groups of
    # rows, more lanes than classes, one class a tile at many thresholds
    "classes_not_a_multiple_of_32": (2, 5, 37, "repeated", True, False),
    "rows_not_a_multiple_of_a_stage": (3, 37, 4, "linspace", False, True),
    "more_lanes_than_classes": (12, 6, 2, "denormal", True, True),
    "7000_thresholds_few_rows": (2, 3, 2, "many", True, False),
}


def _jax_k1(p, t, thr):
    f = lambda pp, tt: jax_k1.binned_counter_update(pp, tt, jnp.asarray(thr), backend="pallas-interpret")  # noqa: E731
    return jax.vmap(f)(jnp.asarray(p), jnp.asarray(t))


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_lanes_match_jax_vmap_of_the_pallas_kernel(case, monkeypatch):
    lanes, rows, classes, thr_name, nan, denormal = K1_CASES[case]
    p, t = _k1_inputs(lanes, rows, classes, seed=len(case), nan=nan, denormal=denormal)
    thr = THRESHOLDS[thr_name]
    calls = Count(monkeypatch, binned_counters, "binned_counter_update_lanes_plain")
    thr_t = torch.from_numpy(thr)
    order = binned_counters.threshold_order(thr_t)
    ours = torch.func.vmap(lambda a, b: binned_counters.binned_counter_update(a, b, thr_t, order))(
        torch.from_numpy(p), torch.from_numpy(t)
    )
    assert calls.n == 1  # one lane-batched call, not one per lane
    for o, r in zip(ours, _jax_k1(p, t, thr)):
        _bits(o, r)


def test_k1_lane_axis_not_first_and_nested_vmap():
    """A lane axis at position 1 is moved to 0; a vmap inside a vmap is
    folded into one lane axis of outer x inner lanes. Both equal the
    unbatched call lane by lane, and the first JAX's vmap."""
    p, t = _k1_inputs(3, 4, 2, seed=9)
    thr = THRESHOLDS["linspace"]
    thr_t = torch.from_numpy(thr)
    f = lambda a, b: binned_counters.binned_counter_update(a, b, thr_t)  # noqa: E731
    moved = torch.func.vmap(f, in_dims=(1, 1))(torch.from_numpy(p).movedim(0, 1), torch.from_numpy(t).movedim(0, 1))
    for o, r in zip(moved, _jax_k1(p, t, thr)):
        _bits(o, r)
    nested = torch.func.vmap(torch.func.vmap(f))(torch.from_numpy(p)[:, :, None], torch.from_numpy(t)[:, :, None])
    for lane in range(3):
        for row in range(4):
            want = f(torch.from_numpy(p[lane, row:row + 1]), torch.from_numpy(t[lane, row:row + 1]))
            for o, w in zip(nested, want):
                assert torch.equal(o[lane, row], w)


def test_k1_batched_thresholds_refused():
    """The thresholds are one set for every lane: batched ones raise, with
    the argument named, before any device is asked."""
    p, t = _k1_inputs(3, 2, 2, seed=3)
    thr = torch.from_numpy(np.stack([THRESHOLDS["linspace"]] * 3))
    with pytest.raises(ValueError, match="`thresholds` is one set shared by every lane"):
        torch.func.vmap(binned_counters.binned_counter_update)(torch.from_numpy(p), torch.from_numpy(t), thr)


def test_unbatched_calls_do_not_take_the_route(monkeypatch):
    """An unbatched call runs the kernel's entry directly, not the op."""
    for module in (binned_counters, histogram):
        monkeypatch.setattr(module, "_ROUTE", None)
    monkeypatch.setattr(compactor, "_INSERT_ROUTE", None)
    monkeypatch.setattr(compactor, "_FOLD_ROUTE", None)
    compactor.fold_level(torch.tensor([1.0, 2.0, _INF]), torch.tensor(2), torch.tensor([0.5]), torch.tensor(1))
    p, t = _k1_inputs(1, 5, 3, seed=4)
    binned_counters.binned_counter_update(torch.from_numpy(p[0]), torch.from_numpy(t[0]), torch.linspace(0, 1, 4))
    histogram.histogram(torch.arange(6), 4)
    s = QuantileSketchState.create(k=16, levels=5, device="cpu")
    s.insert(torch.arange(40, dtype=torch.float32))


# --------------------------------------------------------------------------
# K2: histogram
# --------------------------------------------------------------------------


def _jax_k2(ids, nb):
    return jax.vmap(lambda x: histogram_pallas(x, nb, interpret=True))(jnp.asarray(ids))


K2_CASES = {
    # name: (lanes, ids per lane, num_buckets)
    "one_id_lanes": (8, 1, 9),
    "many_id_lanes_out_of_range": (5, 33, 7),
}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_lanes_match_jax_vmap_of_the_pallas_kernel(case, monkeypatch):
    lanes, n, nb = K2_CASES[case]
    ids = np.random.default_rng(lanes * n).integers(-3, nb + 3, (lanes, n)).astype(np.int32)
    calls = Count(monkeypatch, histogram, "histogram_lanes_plain")
    ours = torch.func.vmap(lambda x: histogram.histogram(x, nb))(torch.from_numpy(ids))
    assert calls.n == 1
    _bits(ours, _jax_k2(ids, nb))


def test_k2_int64_ids_lane_axis_not_first_and_nested_vmap():
    """Wide ids through ``_bincount`` (out-of-range ones sent to -1 before
    the narrowing, so none wraps into range), a lane axis at position 1,
    and a nested vmap: each lane equals its own count."""
    from metrics_tpu_torch.utilities.data import _bincount

    rng = np.random.default_rng(21)
    ids = rng.integers(-2, 8, (4, 3, 5)).astype(np.int64)
    ids[0, 0, 0] = 2**32 + 3  # narrows to 3 if it were cast first
    ids[1, 2, 4] = -(2**40)
    x = torch.from_numpy(ids)
    want = np.zeros((4, 3, 6), np.int32)
    for i in range(4):
        for j in range(3):
            v = ids[i, j]
            want[i, j] = np.bincount(v[(v >= 0) & (v < 6)], minlength=6)
    nested = torch.func.vmap(torch.func.vmap(lambda r: _bincount(r, 6)))(x)
    np.testing.assert_array_equal(nested.numpy(), want)
    moved = torch.func.vmap(lambda r: _bincount(r, 6), in_dims=1)(x[:, 0])  # lane j: ids[:, 0, j]
    cols = [ids[:, 0, j] for j in range(5)]
    np.testing.assert_array_equal(moved.numpy(), np.stack([np.bincount(v[(v >= 0) & (v < 6)], minlength=6) for v in cols]))
    narrow = ids[:, 0].clip(-1, 7).astype(np.int32)
    _bits(torch.func.vmap(lambda r: histogram.histogram(r, 6))(torch.from_numpy(narrow)), _jax_k2(narrow, 6))


def test_k2_lanes_split_below_two_to_the_31_bins():
    """A lane-batched K2 launch counts into lane * num_buckets + id, kept
    below 2^31: the wrapper's runs of lanes (stubbed: no large allocation)
    cover every lane once, in order, each run under the limit."""
    limit = histogram._LANE_BINS_LIMIT
    for lanes, nb in ((1024, 10**6), (3000, 10**6), (5, (1 << 31) - 1), (2148, 10**6), (7, 3)):
        runs = _build.lane_groups(lanes, nb, limit)
        assert [lo for lo, _ in runs] == [0] + [hi for _, hi in runs[:-1]] and runs[-1][1] == lanes
        assert all((hi - lo) * nb <= limit or hi - lo == 1 for lo, hi in runs)
        assert len(runs) == -(-lanes // max(1, limit // nb))
    assert len(_build.lane_groups(1024, 10**6, limit)) == 1
    assert len(_build.lane_groups(3000, 10**6, limit)) == 2


# --------------------------------------------------------------------------
# K3: the compactor cascade
# --------------------------------------------------------------------------

L3, K3 = 5, 16


def _sketches(lanes, seed, ties=False, kinds=False):
    """``lanes`` sketches after a few inserts each (the JAX package's own
    insert), as numpy ``(lanes, L, k)`` items and ``(lanes, L)`` counts.
    ``ties``: the values are drawn from {0, 1, 2, 3}; ``kinds``: lane i % 3
    == 0 stays empty, lane i % 3 == 1 takes one insert of 64 rows and lane
    i % 3 == 2 six, which reach the top level."""
    rng = np.random.default_rng(seed)
    items, counts = [], []
    for lane in range(lanes):
        s = JaxState.create(k=K3, levels=L3)
        inserts, n = 1 + lane % 3, 24 + 8 * lane
        if kinds:
            inserts, n = (0, 1, 6)[lane % 3], 64
        for _ in range(inserts):
            vals = rng.integers(0, 4, n) if ties else rng.lognormal(0, 1, n)
            s = s.insert(jnp.asarray(vals.astype(np.float32)))
        items.append(np.asarray(s.items))
        counts.append(np.asarray(s.counts))
    return np.stack(items), np.stack(counts)


def _runs(lanes, m, seed, ties=False):
    rng = np.random.default_rng(seed)
    count = rng.integers(0, m + 1, lanes).astype(np.int32)
    count[0] = m
    if ties:
        count[1::3] = 0  # empty runs beside full ones
    vals = rng.integers(0, 4, (lanes, m)) if ties else rng.random((lanes, m))
    run = np.sort(vals.astype(np.float32), axis=1)
    return np.where(np.arange(m) < count[:, None], run, np.inf).astype(np.float32), count


# (start level, heavy ties with empty and full lanes); the start level L3 - 1
# runs the top level's absorb alone
@pytest.mark.parametrize(
    "start_level,ties",
    [pytest.param(0, False, id="0"), pytest.param(2, False, id="2"), pytest.param(L3 - 1, False, id="top_level"),
     pytest.param(1, True, id="heavy_ties_empty_and_full_lanes")],
)
def test_k3_insert_lanes_match_jax_vmap_of_the_pallas_fold(start_level, ties, monkeypatch):
    items, counts = _sketches(6, seed=1, ties=ties, kinds=ties)
    inc, inc_count = _runs(6, K3, seed=2 + start_level, ties=ties)
    calls = Count(monkeypatch, compactor, "fold_cascade_lanes_plain")
    ours = torch.func.vmap(lambda i, c, x, xc: compactor.fold_cascade(i, c, x, xc, start_level))(
        torch.from_numpy(items), torch.from_numpy(counts), torch.from_numpy(inc), torch.from_numpy(inc_count)
    )
    assert calls.n == 1
    with kdispatch.kernel_override(compactor_fold="pallas-interpret"):
        ref = jax.vmap(lambda i, c, x, xc: jax_compactor.fold_cascade(i, c, x, xc, start_level))(
            jnp.asarray(items), jnp.asarray(counts), jnp.asarray(inc), jnp.asarray(inc_count)
        )
    for o, r in zip(ours, ref):
        _bits(o, r)


def test_k3_merge_lanes_match_jax_vmap_of_the_pallas_fold(monkeypatch):
    _check_merge_lanes(*_sketches(5, seed=3), *_sketches(5, seed=4), monkeypatch)


def test_k3_merge_lanes_with_ties_and_empty_and_full_lanes_match_jax_vmap(monkeypatch):
    """Merges where lanes of one batch are empty, hold one insert or reach
    the top level, over values with heavy ties."""
    _check_merge_lanes(*_sketches(6, seed=3, ties=True, kinds=True), *_sketches(6, seed=4, ties=True, kinds=True), monkeypatch)


def _check_merge_lanes(items, counts, other, other_counts, monkeypatch):
    calls = Count(monkeypatch, compactor, "merge_cascade_lanes_plain")
    ours = torch.func.vmap(compactor.merge_cascade)(
        torch.from_numpy(items), torch.from_numpy(counts), torch.from_numpy(other), torch.from_numpy(other_counts)
    )
    assert calls.n == 1

    def merge(i, c, o, oc):
        zero = jnp.zeros((), jnp.int32)
        s = JaxState(items=i, counts=c, n_seen=zero).sketch_merge(JaxState(items=o, counts=oc, n_seen=zero))
        return s.items, s.counts

    with kdispatch.kernel_override(compactor_fold="pallas-interpret"):
        ref = jax.vmap(merge)(jnp.asarray(items), jnp.asarray(counts), jnp.asarray(other), jnp.asarray(other_counts))
    for o, r in zip(ours, ref):
        _bits(o, r)


def test_k3_fold_of_gathered_stacked_sketches_is_each_replicas_plain_fold(monkeypatch):
    """A bootstrap's quantile sketches synced over a group
    (``parallel/sync.py::_fold_packed``): every rank's stacked payload
    unpacked and folded in rank order under ``torch.func.vmap``, one
    lane-batched merge per rank folded, equals each replica's own fold by
    ``merge_cascade_plain``, bit for bit."""
    from metrics_tpu_torch.parallel.sync import _fold_packed

    world, lanes = 4, 6
    rng = np.random.default_rng(40)
    ranks = []
    for r in range(world):
        states = []
        for lane in range(lanes):  # empty lanes, one insert, and inserts that reach the top level
            s = QuantileSketchState.create(k=K3, levels=L3, device="cpu")
            for _ in range((0, 1, 6)[(lane + r) % 3]):
                s = s.insert(torch.from_numpy(rng.lognormal(0, 1, 64).astype(np.float32)))
            states.append(s)
        ranks.append(QuantileSketchState(*(torch.stack(f) for f in zip(*states))))
    gathered = [torch.func.vmap(QuantileSketchState.pack)(s) for s in ranks]  # each rank's (lanes, packed) payload
    calls = Count(monkeypatch, compactor, "merge_cascade_lanes_plain")
    ours = _fold_packed(ranks[0], gathered, lanes)
    assert calls.n == world - 1
    for b in range(lanes):
        items, counts = ranks[0].items[b], ranks[0].counts[b]
        for s in ranks[1:]:
            items, counts = compactor.merge_cascade_plain(items, counts, s.items[b], s.counts[b])
        _bits(ours.items[b], items)
        _bits(ours.counts[b], counts)
        assert int(ours.n_seen[b]) == sum(int(s.n_seen[b]) for s in ranks)


def _level_runs(lanes, n, counts, seed, ties=False):
    """``lanes`` ascending float32 runs of length ``n``, ``+inf`` past each
    lane's count; ``ties``: values drawn from {0, 1, 2}."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 3, (lanes, n)) if ties else rng.lognormal(0, 1, (lanes, n))
    run = np.sort(vals.astype(np.float32), axis=1)
    return np.where(np.arange(n) < np.asarray(counts)[:, None], run, np.inf).astype(np.float32), np.asarray(counts, np.int32)


# k, then the lanes' level and run counts (runs of 10), heavy ties
FOLD_LANE_CASES = {
    "8": (8, [0, 4, 8, 7, 3, 8], [10, 2, 0, 10, 9, 7], False),
    "24": (24, [0, 12, 24, 23, 3, 24], [10, 2, 0, 10, 9, 7], False),
    # c == k, c == k + 1 (an odd leftover), c == k + 2, empty lanes and a
    # pass-through lane (nothing incoming) in one batch
    "c_eq_k_and_k_plus_1": (16, [6, 7, 8, 0, 0, 16, 9], [10, 10, 10, 0, 10, 0, 10], False),
    "heavy_ties": (16, [16, 15, 5, 0, 11], [10, 10, 10, 4, 5], True),
}


@pytest.mark.parametrize("case", list(FOLD_LANE_CASES))
def test_k3_single_fold_lanes_match_jax_vmap_of_the_pallas_fold(case, monkeypatch):
    """``fold_level`` under ``torch.func.vmap`` takes the single fold's lane
    route (one call of its plain lanes version on the CPU), bit-equal to
    JAX's ``fold_level`` under ``jax.vmap`` through its Pallas fold: lanes
    whose counts stay within ``k`` (absorbed) and lanes that overflow it
    (compacted, an odd leftover kept), an empty run and an empty level, in
    one batch; c == k and k + 1; heavy ties."""
    k, level_counts, run_counts, ties = FOLD_LANE_CASES[case]
    m, lanes = 10, len(level_counts)
    items, counts = _level_runs(lanes, k, level_counts, seed=k, ties=ties)
    inc, inc_count = _level_runs(lanes, m, run_counts, seed=k + 1, ties=ties)
    c = np.asarray(level_counts) + np.asarray(run_counts)
    assert (c <= k).any() and (c > k).any() and ((c > k) & (c % 2 == 1)).any()
    calls = Count(monkeypatch, compactor, "compactor_fold_lanes_plain")
    ours = torch.func.vmap(compactor.fold_level)(
        torch.from_numpy(items), torch.from_numpy(counts), torch.from_numpy(inc), torch.from_numpy(inc_count)
    )
    assert calls.n == 1  # one lane-batched call, not one per lane
    with kdispatch.kernel_override(compactor_fold="pallas-interpret"):
        ref = jax.vmap(jax_compactor.fold_level)(jnp.asarray(items), jnp.asarray(counts), jnp.asarray(inc), jnp.asarray(inc_count))
    for o, r in zip(ours, ref):
        _bits(o, r)


def test_k3_shared_sketch_with_batched_runs_and_the_single_fold():
    """An unbatched sketch is expanded over the lanes of a batched run, each
    lane equal to its own insert; the single fold, its level unbatched and
    its runs batched, takes its lane route with the level expanded, each
    lane equal to its own fold."""
    items, counts = _sketches(1, seed=5)
    inc, inc_count = _runs(4, 8, seed=6)
    it, ct = torch.from_numpy(items[0]), torch.from_numpy(counts[0])
    got = torch.func.vmap(lambda x, xc: compactor.fold_cascade(it, ct, x, xc, 1))(
        torch.from_numpy(inc), torch.from_numpy(inc_count)
    )
    for lane in range(4):
        want = compactor.fold_cascade(it, ct, torch.from_numpy(inc[lane]), torch.tensor(inc_count[lane]), 1)
        assert torch.equal(got[0][lane], want[0]) and torch.equal(got[1][lane], want[1])
    folded = torch.func.vmap(lambda x, xc: compactor.fold_level(it[0], ct[0], x, xc))(
        torch.from_numpy(inc), torch.from_numpy(inc_count)
    )
    for lane in range(4):
        want = compactor.fold_level(it[0], ct[0], torch.from_numpy(inc[lane]), torch.tensor(inc_count[lane]))
        for o, w in zip(folded, want):
            assert torch.equal(o[lane], w)
