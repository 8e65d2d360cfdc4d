"""The port's compactor layer (the module that holds kernel K3's wrapper)
against the JAX package, on the same seeded numpy inputs.

On the CPU the wrapper runs K3's plain version (``torch.sort`` of the
concatenation, then the port of ``_compactor_fold_xla``). It must be
bit-equal to JAX's ``fold_level`` under the XLA fold and under the Pallas
kernel run in interpret mode. The binned precompaction and the cascade are
bit-equal too; quantiles and ranks are exact (the weights are powers of two
and their sums stay below 2^24); the CDF holds to ``atol=1e-6``, since it
adds float32 weights over ``L * k`` slots in another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from metrics_tpu.ops import binning as jax_binning  # noqa: E402
from metrics_tpu.ops import compactor as jax_compactor  # noqa: E402
from metrics_tpu.ops import dispatch as kdispatch  # noqa: E402
from metrics_tpu.streaming.sketches import QuantileSketchState as JaxState  # noqa: E402
from metrics_tpu_torch.ops import binning, compactor  # noqa: E402

CDF_ATOL = 1e-6  # float32 sums over L * k slots, added in another order
FOLD_IMPLS = ["xla", "pallas-interpret"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_bit_equal(ours, ref):
    o, r = ours.numpy(), np.asarray(ref)
    assert o.shape == r.shape and o.dtype == r.dtype, (o.shape, r.shape, o.dtype, r.dtype)
    np.testing.assert_array_equal(o.reshape(-1).view(np.uint8), r.reshape(-1).view(np.uint8))


def _level_buffer(k, count, rng):
    vals = np.sort(rng.random(k).astype(np.float32))
    return np.where(np.arange(k) < count, vals, np.inf).astype(np.float32)


# the JAX package's own fold cases (tests/ops/test_pallas_kernels.py), plus
# c == k and c == k + 1
FOLD_CASES = [
    (64, 40, 32, 30),  # overflow, even combined
    (64, 40, 31, 31),  # overflow, odd leftover
    (64, 10, 64, 10),  # absorb (no overflow)
    (64, 0, 32, 0),  # empty fold
    (64, 64, 64, 64),  # full-on-full
    (8, 5, 4, 3),  # tiny shapes
    (200, 137, 100, 93),  # k not a multiple of 128
    (64, 40, 32, 24),  # c == k
    (64, 40, 32, 25),  # c == k + 1
    (64, 33, 64, 0),  # nothing incoming, level partly full
]


@pytest.mark.parametrize("impl", FOLD_IMPLS)
@pytest.mark.parametrize("k,count,m,inc_count", FOLD_CASES)
def test_fold_level_matches_jax(impl, k, count, m, inc_count):
    rng = np.random.default_rng(k * 1000 + count * 10 + m)
    items = _level_buffer(k, count, rng)
    inc = _level_buffer(m, inc_count, rng)
    with kdispatch.kernel_override(compactor_fold=impl):
        ref = jax_compactor.fold_level(jnp.asarray(items), jnp.int32(count), jnp.asarray(inc), jnp.int32(inc_count))
    ours = compactor.fold_level(_t(items), torch.tensor(count, dtype=torch.int32), _t(inc), torch.tensor(inc_count, dtype=torch.int32))
    for o, r in zip(ours, ref):
        _assert_bit_equal(o, r)


@pytest.mark.parametrize("k,count,m,inc_count", FOLD_CASES)
def test_select_stage_matches_xla_stage(k, count, m, inc_count):
    rng = np.random.default_rng(count + 7 * m)
    combined = np.sort(np.concatenate([_level_buffer(k, count, rng), _level_buffer(m, inc_count, rng)]))
    c = count + inc_count
    ref = jax_compactor._compactor_fold_xla(jnp.asarray(combined), jnp.int32(c), k)
    ours = compactor._compactor_fold_select(_t(combined), torch.tensor(c, dtype=torch.int32), k)
    for o, r in zip(ours, ref):
        _assert_bit_equal(o, r)


def test_fold_with_ties_and_all_inf():
    """Heavy ties and all-+inf buffers: the fold depends on the sorted values
    alone."""
    k = 16
    items = np.array([1.0] * 10 + [np.inf] * 6, np.float32)
    inc = np.array([1.0] * 5 + [2.0] * 5 + [np.inf] * 2, np.float32)
    for a, ca, b, cb in [(items, 10, inc, 10), (np.full(k, np.inf, np.float32), 0, np.full(12, np.inf, np.float32), 0)]:
        ref = jax_compactor.fold_level(jnp.asarray(a), jnp.int32(ca), jnp.asarray(b), jnp.int32(cb))
        ours = compactor.fold_level(_t(a), torch.tensor(ca, dtype=torch.int32), _t(b), torch.tensor(cb, dtype=torch.int32))
        for o, r in zip(ours, ref):
            _assert_bit_equal(o, r)


def test_merge_mode_is_the_sorted_merge():
    """With ``k`` set to the total the fold compacts nothing: the items are
    the ascending merge of both runs (``sketch_merge`` merges a level and
    the carry this way)."""
    rng = np.random.default_rng(5)
    a, b = _level_buffer(32, 20, rng), _level_buffer(64, 37, rng)
    items, count, promoted, pcount = compactor.compactor_fold(
        _t(a), torch.tensor(20, dtype=torch.int32), _t(b), torch.tensor(37, dtype=torch.int32), 96
    )
    np.testing.assert_array_equal(items.numpy(), np.sort(np.concatenate([a, b])))
    assert int(count) == 57 and int(pcount) == 0 and bool(torch.isinf(promoted).all())


def test_wrapper_checks_its_inputs():
    a, c = torch.full((8,), float("inf")), torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="one device"):
        compactor.compactor_fold(a, c, torch.full((8,), float("inf"), device="meta"), c, 8)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        m = torch.full((8,), float("inf"), device="meta")
        compactor.compactor_fold(m, c.to("meta"), m, c.to("meta"), 8)
    with pytest.raises(TypeError, match="float32"):
        compactor.compactor_fold(a.double(), c, a, c, 8)
    with pytest.raises(ValueError, match="k <= na"):
        compactor.compactor_fold(a, c, a, c, 17)


# --------------------------------------------------------------------------
# binned precompaction
# --------------------------------------------------------------------------


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.lognormal(size=n).astype(np.float32)
    pick = rng.random(n)
    x[pick < 0.05] = np.nan
    x[(pick >= 0.05) & (pick < 0.08)] = -0.0
    x[(pick >= 0.08) & (pick < 0.11)] = np.float32(1e-40)
    x[(pick >= 0.11) & (pick < 0.13)] = np.inf
    x[(pick >= 0.13) & (pick < 0.15)] = -np.inf
    x[(pick >= 0.15) & (pick < 0.3)] = np.round(x[(pick >= 0.15) & (pick < 0.3)], 1)  # ties
    valid = rng.random(n) < 0.9
    return x, valid


@pytest.mark.parametrize("n", [0, 1, 7, 64, 65, 5000])
def test_precompaction_matches_jax(n):
    k = 64
    x, valid = _batch(n, n)
    ref = jax_binning._precompact_binned(jnp.asarray(x), jnp.asarray(valid), k)
    ours = binning.precompact_binned(_t(x), _t(valid), k)
    _assert_bit_equal(ours[0], ref[0])
    _assert_bit_equal(ours[1], ref[1])
    assert ours[2] == ref[2]


@pytest.mark.parametrize("n,k", [(0, 8), (5, 8), (9, 8), (1000, 64), (50000, 256)])
def test_halving_map_and_key_inverse(n, k):
    ours, level = binning.halving_map(n, k)
    ref, ref_level = jax_binning.halving_map(n, k)
    np.testing.assert_array_equal(ours, ref)
    assert level == ref_level == binning.halving_level(n, k)
    keys = np.random.default_rng(n).integers(0, 1 << 32, 2000, dtype=np.uint64)
    _assert_bit_equal(binning.key_to_float32(_t(keys.astype(np.int64))), jax_binning.key_to_float32(jnp.asarray(keys.astype(np.uint32))))


# --------------------------------------------------------------------------
# cascade and queries
# --------------------------------------------------------------------------


def _jax_sketch(batches, k=64, levels=6):
    st = JaxState.create(k=k, levels=levels)
    for x in batches:
        st = st.insert(jnp.asarray(x))
    return st


@pytest.mark.parametrize("n_inc", [10, 64, 300, 4000])
def test_fold_cascade_matches_jax(n_inc):
    rng = np.random.default_rng(n_inc)
    st = _jax_sketch([rng.normal(size=n).astype(np.float32) for n in (700, 130, 2000)])
    x = rng.normal(size=n_inc).astype(np.float32)
    k = st.items.shape[1]
    inc, inc_count, level = jax_compactor.precompact_batch(jnp.asarray(x), jnp.ones(x.shape, bool), k)
    ref = jax_compactor.fold_cascade(st.items, st.counts, inc, inc_count, level)
    ours = compactor.fold_cascade(_t(st.items), _t(st.counts), _t(inc), _t(inc_count), level)
    for o, r in zip(ours, ref):
        _assert_bit_equal(o, r)


def test_queries_match_jax():
    rng = np.random.default_rng(3)
    st = _jax_sketch([rng.lognormal(size=n).astype(np.float32) for n in (5000, 333, 20000, 1)], k=128, levels=8)
    items, counts = _t(st.items), _t(st.counts)
    _assert_bit_equal(compactor.level_weights(items, counts), jax_compactor.level_weights(st.items, st.counts))
    qs = np.array([0.0, 0.001, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0], np.float32)
    _assert_bit_equal(
        compactor.weighted_quantiles(items, counts, _t(qs)), jax_compactor.weighted_quantiles(st.items, st.counts, jnp.asarray(qs))
    )
    for v in (0.0, 0.5, 1.0, 3.0, 100.0, float("inf")):
        _assert_bit_equal(compactor.weighted_rank(items, counts, v), jax_compactor.weighted_rank(st.items, st.counts, v))
    pts = np.array([-1.0, 0.1, 0.7, 1.0, 2.5, 10.0, np.inf], np.float32)
    ours = compactor.weighted_cdf(items, counts, _t(pts)).numpy()
    ref = np.asarray(jax_compactor.weighted_cdf(st.items, st.counts, jnp.asarray(pts)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=CDF_ATOL)


def test_empty_sketch_queries_are_nan():
    items = torch.full((4, 8), float("inf"))
    counts = torch.zeros(4, dtype=torch.int32)
    assert bool(torch.isnan(compactor.weighted_quantiles(items, counts, torch.tensor([0.5]))).all())
    assert bool(torch.isnan(compactor.weighted_cdf(items, counts, [0.0, 1.0])).all())


# --------------------------------------------------------------------------
# the cascade's plain versions (what the cascade kernel is held against)
# --------------------------------------------------------------------------


def _per_level_insert(items, counts, inc, inc_count, start_level):
    """The per-level composition the cascade replaced: one ``compactor_fold``
    call per level, then the top level's absorb."""
    return compactor.fold_cascade_plain(items, counts, inc, inc_count, start_level, fold=compactor.compactor_fold)


def _state_with(levels, k, fill, seed):
    """A (levels, k) state whose level l holds ``fill[l]`` ascending items."""
    rng = np.random.default_rng(seed)
    items = np.stack([_level_buffer(k, c, rng) for c in fill]).astype(np.float32)
    return items, np.array(fill, np.int32)


# name, (levels, k), per-level fill, inc size, inc count, start level
INSERT_CASES = [
    ("empty_state", (6, 64), [0] * 6, 64, 50, 0),
    ("empty_state_empty_run", (6, 64), [0] * 6, 32, 0, 2),
    ("promotes_to_the_top", (5, 16), [16, 16, 15, 16, 3], 16, 16, 0),
    ("saturated_top", (4, 16), [15, 16, 16, 16], 16, 13, 0),
    ("start_at_the_top", (4, 16), [3, 9, 2, 12], 8, 8, 3),
    ("start_mid_odd_leftover", (7, 64), [10, 64, 63, 64, 1, 0, 0], 40, 37, 1),
    ("run_longer_than_k", (5, 16), [16, 16, 16, 2, 0], 40, 33, 0),
]


@pytest.mark.parametrize(("name", "shape", "fill", "m", "mc", "start"), INSERT_CASES, ids=[c[0] for c in INSERT_CASES])
def test_fold_cascade_plain_matches_the_per_level_folds_and_jax(name, shape, fill, m, mc, start):
    levels, k = shape
    items, counts = _state_with(levels, k, fill, seed=len(name))
    inc = _level_buffer(m, mc, np.random.default_rng(m + mc))
    args = (_t(items), _t(counts), _t(inc), torch.tensor(mc, dtype=torch.int32))
    ours = compactor.fold_cascade_plain(*args, start)
    for o, r in zip(ours, _per_level_insert(*args, start)):
        _assert_bit_equal(o, r.numpy())
    for o, r in zip(ours, jax_compactor.fold_cascade(jnp.asarray(items), jnp.asarray(counts), jnp.asarray(inc), jnp.int32(mc), start)):
        _assert_bit_equal(o, r)
    for o, r in zip(compactor.fold_cascade(*args, start), ours):  # the CPU wrapper is the plain version
        _assert_bit_equal(o, r.numpy())


# name, (levels, k), fill of a, fill of b
MERGE_CASES = [
    ("both_empty", (5, 16), [0] * 5, [0] * 5),
    ("with_an_empty_sketch", (5, 16), [7, 16, 3, 0, 0], [0] * 5),
    ("full_levels_carry_up", (6, 16), [16, 16, 16, 16, 16, 4], [16, 15, 16, 16, 16, 1]),
    ("saturated_top", (4, 16), [16, 16, 16, 15], [16, 16, 16, 16]),
    ("sparse", (7, 64), [5, 0, 64, 0, 33, 0, 0], [0, 64, 64, 1, 0, 0, 2]),
]


@pytest.mark.parametrize(("name", "shape", "fill_a", "fill_b"), MERGE_CASES, ids=[c[0] for c in MERGE_CASES])
def test_merge_cascade_plain_matches_jax_and_commutes(name, shape, fill_a, fill_b):
    levels, k = shape
    a_items, a_counts = _state_with(levels, k, fill_a, seed=1)
    b_items, b_counts = _state_with(levels, k, fill_b, seed=2)
    ab = compactor.merge_cascade_plain(_t(a_items), _t(a_counts), _t(b_items), _t(b_counts))
    ba = compactor.merge_cascade_plain(_t(b_items), _t(b_counts), _t(a_items), _t(a_counts))
    ja = JaxState(items=jnp.asarray(a_items), counts=jnp.asarray(a_counts), n_seen=jnp.int32(0))
    jb = JaxState(items=jnp.asarray(b_items), counts=jnp.asarray(b_counts), n_seen=jnp.int32(0))
    ref = ja.sketch_merge(jb)
    for o, o2, r in zip(ab, ba, (ref.items, ref.counts)):
        _assert_bit_equal(o, r)
        _assert_bit_equal(o2, r)
    for o, r in zip(compactor.merge_cascade(_t(a_items), _t(a_counts), _t(b_items), _t(b_counts)), ab):
        _assert_bit_equal(o, r.numpy())


def test_cascade_wrappers_check_their_inputs():
    items, counts = torch.full((4, 8), float("inf")), torch.zeros(4, dtype=torch.int32)
    run, c = torch.full((8,), float("inf")), torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(L, k\) items"):
        compactor.fold_cascade(items[0], counts, run, c, 0)
    with pytest.raises(TypeError, match="float32"):
        compactor.fold_cascade(items.double(), counts, run, c, 0)
    with pytest.raises(ValueError, match="one shape"):
        compactor.merge_cascade(items, counts, items[:3], counts[:3])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        compactor.merge_cascade(items.to("meta"), counts.to("meta"), items.to("meta"), counts.to("meta"))
    with pytest.raises(ValueError, match="start_level"):
        compactor.fold_cascade(items, counts, run, c, -1)


def test_cuda_paths_raise_instead_of_falling_back():
    """The kernels' launch paths build their library first; without a CUDA
    toolkit that raises, and nothing answers with the plain version."""
    import shutil

    from metrics_tpu_torch.ops import binned_counters, histogram

    if torch.cuda.is_available() or shutil.which("nvcc"):
        pytest.skip("a CUDA toolkit is present: the launch paths build and run there (chip_smoke.py)")
    items, counts = torch.full((4, 8), float("inf")), torch.zeros(4, dtype=torch.int32)
    run, c = torch.full((8,), float("inf")), torch.tensor(0, dtype=torch.int32)
    calls = [
        lambda: compactor._cascade_cuda(items, counts, run, c, 0, None, None),
        lambda: compactor._cascade_cuda(items, counts, None, None, 0, items, counts),
        lambda: compactor._compactor_fold_cuda(run, c, run, c, 8),
        lambda: binned_counters._binned_counter_update_cuda(torch.rand(4, 3), torch.zeros(4, 3, dtype=torch.bool), torch.rand(5)),
        lambda: histogram._histogram_cuda(torch.zeros(4, dtype=torch.int32), 8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
