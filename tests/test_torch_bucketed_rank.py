"""The port's orderable keys and orders against the JAX package: the
float32 key equal by value to ``_float32_ascending_word``; ``ascending_order``,
``descending_order``, ``partition_order``, ``stable_key_order``,
``inverse_permutation`` and ``ascending_ranks`` bitwise equal to JAX's on
adversarial inputs (±0.0, denormals, NaNs of either sign, ±inf, ties,
int32 ``INT_MIN``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from metrics_tpu.ops.bucketed_rank import _float32_ascending_word as jax_word  # noqa: E402
from metrics_tpu.ops import bucketed_rank as jax_br  # noqa: E402
from metrics_tpu.ops.bucketed_rank import _key_words_ascending as jax_key_words  # noqa: E402
from metrics_tpu_torch.ops.bucketed_rank import (  # noqa: E402
    _float32_ascending_word,
    _key_words_ascending,
    ascending_order,
    ascending_ranks,
    descending_order,
    inverse_permutation,
    partition_order,
    stable_key_order,
)

SPECIALS = np.array(
    [0.0, -0.0, 1e-40, -1e-40, 1.4e-45, -1.4e-45, np.inf, -np.inf, np.nan, -np.nan, 1.0, -1.0, 3.4e38, -3.4e38],
    np.float32,
)


def _adversarial(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    pick = rng.random(n)
    x = np.where(pick < 0.2, np.round(x, 1), x).astype(np.float32)  # ties
    x = np.where(pick >= 0.65, rng.choice(SPECIALS, size=n), x).astype(np.float32)
    # negative NaN bit patterns, which np.nan never is
    neg_nan = np.array([0xFFC00001], np.uint32).view(np.float32)[0]
    x[rng.random(n) < 0.02] = neg_nan
    return x


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 17), (2, 256), (3, 5000)])
def test_float32_word_matches_jax(seed, n):
    x = _adversarial(seed, n)
    ours = _float32_ascending_word(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_word(jnp.asarray(x))).astype(np.int64)
    assert ours.dtype == np.int64
    np.testing.assert_array_equal(ours, ref)


def test_specials_word_matches_jax():
    ours = _float32_ascending_word(torch.from_numpy(SPECIALS)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_word(jnp.asarray(SPECIALS))).astype(np.int64))
    # -0.0 and denormals share +0.0's key; NaNs of either sign take the largest
    assert len(set(ours[:6].tolist())) == 1 and ours[8] == ours[9] == 0xFFFFFFFF


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 2), (3, 33), (4, 1000), (5, 20000)])
def test_ascending_order_matches_argsort(seed, n):
    x = _adversarial(seed, n)
    ours = ascending_order(torch.from_numpy(x)).numpy()
    ref = np.asarray(jnp.argsort(jnp.asarray(x), stable=True))
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize(
    "dtype",
    [np.int32, np.int16, np.int8, np.uint8, np.bool_, np.float16],
)
def test_key_words_and_order_other_dtypes(dtype):
    rng = np.random.default_rng(7)
    if dtype == np.bool_:
        x = rng.random(300) < 0.5
    elif np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        x = rng.integers(info.min, int(info.max) + 1, 300).astype(dtype)
    else:
        x = rng.normal(size=300).astype(dtype)
        x[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
    words, bits = _key_words_ascending(torch.from_numpy(x))
    ref_words, ref_bits = jax_key_words(jnp.asarray(x))
    assert bits == ref_bits and len(words) == len(ref_words)
    for w, r in zip(words, ref_words):
        np.testing.assert_array_equal(w.numpy(), np.asarray(r).astype(np.int64))
    np.testing.assert_array_equal(
        ascending_order(torch.from_numpy(x)).numpy(), np.asarray(jnp.argsort(jnp.asarray(x), stable=True))
    )


def test_int64_and_float64_orders():
    """64-bit keys (two words): the order equals numpy's stable argsort, with
    XLA's comparator semantics for float64 (±0.0 tie, NaNs last)."""
    rng = np.random.default_rng(11)
    ints = rng.integers(-(1 << 62), 1 << 62, 500).astype(np.int64)
    ints[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1]
    np.testing.assert_array_equal(ascending_order(torch.from_numpy(ints)).numpy(), np.argsort(ints, kind="stable"))
    f = rng.normal(size=500)
    f[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    canon = np.where(f == 0.0, 0.0, f)
    np.testing.assert_array_equal(ascending_order(torch.from_numpy(f)).numpy(), np.argsort(canon, kind="stable"))


def _ties_heavy_ints(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, n).astype(np.int32)
    x[rng.random(n) < 0.1] = np.iinfo(np.int32).min  # -INT_MIN wraps onto itself
    x[rng.random(n) < 0.05] = np.iinfo(np.int32).max
    return x


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 40), (3, 3000)])
@pytest.mark.parametrize("kind", ["float32", "int32"])
def test_descending_order_matches_jax(seed, n, kind):
    x = _adversarial(seed, n) if kind == "float32" else _ties_heavy_ints(seed, n)
    ours = descending_order(torch.from_numpy(x)).numpy()
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, np.asarray(jax_br.descending_order(jnp.asarray(x))))
    np.testing.assert_array_equal(ours, np.asarray(jnp.argsort(-jnp.asarray(x))))


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 77), (3, 4000)])
def test_partition_order_matches_jax(seed, n):
    first = np.random.default_rng(seed).random(n) < 0.3
    ours = partition_order(torch.from_numpy(first)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_br.partition_order(jnp.asarray(first))))


@pytest.mark.parametrize("num_buckets,n", [(1, 10), (7, 500), (1000, 3000), (70000, 2000)])
def test_stable_key_order_matches_jax(num_buckets, n):
    keys = np.random.default_rng(num_buckets).integers(0, num_buckets, n).astype(np.int32)
    ours = stable_key_order(torch.from_numpy(keys), num_buckets).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_br.stable_key_order(jnp.asarray(keys), num_buckets)))


@pytest.mark.parametrize("bad", [-1, 8])
def test_stable_key_order_checks_its_range(bad):
    keys = torch.tensor([0, 3, bad, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"must be in \[0, 8\)"):
        stable_key_order(keys, 8)
    with pytest.raises(ValueError, match=r"must be in \[0, 8\)"):
        jax_br.stable_key_order(jnp.asarray(keys.numpy()), 8)


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 33), (3, 5000)])
def test_inverse_permutation_and_ranks_match_jax(seed, n):
    x = _adversarial(seed, n)
    perm = np.random.default_rng(seed).permutation(n).astype(np.int32)
    inv = inverse_permutation(torch.from_numpy(perm)).numpy()
    assert inv.dtype == np.int32
    np.testing.assert_array_equal(inv, np.asarray(jax_br.inverse_permutation(jnp.asarray(perm))))
    ranks = ascending_ranks(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ranks, np.asarray(jax_br.ascending_ranks(jnp.asarray(x))))
    np.testing.assert_array_equal(ranks, np.asarray(jnp.argsort(jnp.argsort(jnp.asarray(x), stable=True), stable=True)))
