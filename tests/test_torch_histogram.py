"""The port's histogram (K2's plain version and its wrapper on the CPU) and
``bucket_counts`` against the JAX package: the Pallas kernel run in
interpret mode and the XLA scatter-add, on seeded ids and scores, with
out-of-range ids, no ids, one bucket, all-equal, sorted, run-length and
Zipf-skewed ids, a misaligned view, ±inf, NaN, ``valid`` masks and no
finite score. Counts and bucket ids are bit-equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from metrics_tpu.ops.bucketed_rank import _histogram_xla  # noqa: E402
from metrics_tpu.ops.bucketed_rank import bucket_counts as jax_bucket_counts  # noqa: E402
from metrics_tpu.ops.pallas_kernels import histogram_pallas  # noqa: E402
from metrics_tpu_torch.ops import histogram as k2  # noqa: E402
from metrics_tpu_torch.ops.bucketed_rank import bucket_counts  # noqa: E402


def _id_pattern(pattern, rng, n, num_buckets):
    """The id patterns the card's parity cases cover, at a small size: the
    ids, and the tensor the port is given (for ``misaligned`` a view one
    element into its buffer, so its data pointer is off the 16-byte
    boundary that the kernel's vector loads need)."""
    i = np.arange(n)
    if pattern == "uniform":
        ids = rng.integers(0, num_buckets, n)
    elif pattern == "sorted":
        ids = np.sort(rng.integers(0, num_buckets, n))
    elif pattern == "pairs":
        ids = (i // 2) % num_buckets
    elif pattern == "runs_16":
        ids = (i // 16) % num_buckets
    elif pattern == "zipf":
        ids = np.minimum(rng.zipf(1.1, n) - 1, num_buckets - 1)
    else:
        base = torch.from_numpy(rng.integers(0, num_buckets, n + 1).astype(np.int32))
        view = base[1:]
        assert n == 0 or view.data_ptr() % 16 != 0
        return view.numpy(), view
    ids = ids.astype(np.int32)
    return ids, torch.from_numpy(ids)


@pytest.mark.parametrize("pattern", ["uniform", "sorted", "pairs", "runs_16", "zipf", "misaligned"])
@pytest.mark.parametrize("num_buckets", [1, 7, 130, 515])
@pytest.mark.parametrize("n", [0, 1, 127, 513, 3000])
def test_plain_matches_pallas_interpret_and_xla(num_buckets, n, pattern):
    rng = np.random.default_rng(num_buckets * 1000 + n)
    ids, port_ids = _id_pattern(pattern, rng, n, num_buckets)
    ours = k2.histogram_plain(port_ids, num_buckets).numpy()
    assert ours.dtype == np.int32 and ours.shape == (num_buckets,)
    np.testing.assert_array_equal(ours, np.asarray(histogram_pallas(jnp.asarray(ids), num_buckets, interpret=True)))
    np.testing.assert_array_equal(ours, np.asarray(_histogram_xla(jnp.asarray(ids), num_buckets)))
    assert int(ours.sum()) == n


@pytest.mark.parametrize("num_buckets", [1, 64, 257])
def test_out_of_range_ids_are_not_counted(num_buckets):
    """Negative ids and ids >= num_buckets count nowhere, as in the Pallas
    kernel (XLA's scatter would wrap a negative id onto the last bucket)."""
    rng = np.random.default_rng(num_buckets)
    ids = rng.integers(-2 * num_buckets - 3, 3 * num_buckets + 3, 2000).astype(np.int32)
    ids[:3] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, -1]
    ours = k2.histogram(torch.from_numpy(ids), num_buckets).numpy()
    np.testing.assert_array_equal(ours, np.asarray(histogram_pallas(jnp.asarray(ids), num_buckets, interpret=True)))
    in_range = (ids >= 0) & (ids < num_buckets)
    np.testing.assert_array_equal(ours, np.bincount(ids[in_range], minlength=num_buckets))


def test_all_equal_and_int64_ids():
    ids = np.full(1000, 3, np.int64)
    ours = k2.histogram(torch.from_numpy(ids), 5).numpy()
    np.testing.assert_array_equal(ours, [0, 0, 0, 1000, 0])
    np.testing.assert_array_equal(ours, np.asarray(histogram_pallas(jnp.asarray(ids, jnp.int32), 5, interpret=True)))


def test_wrapper_on_cpu_launches_nothing_and_checks_its_inputs():
    k2.reset_launch_count()
    ids = torch.arange(10, dtype=torch.int32) % 4
    assert torch.equal(k2.histogram(ids, 4), k2.histogram_plain(ids, 4))
    assert k2.launch_count == 0
    with pytest.raises(TypeError, match="integer ids"):
        k2.histogram(torch.zeros(3), 4)
    with pytest.raises(ValueError, match="num_buckets"):
        k2.histogram(ids, 0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k2.histogram(ids.to("meta"), 4)


def _scores(seed, n):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=n).astype(np.float32)
    pick = rng.random(n)
    s[pick < 0.05] = np.inf
    s[(pick >= 0.05) & (pick < 0.08)] = -np.inf
    s[(pick >= 0.08) & (pick < 0.1)] = np.nan
    s[(pick >= 0.1) & (pick < 0.3)] = np.round(s[(pick >= 0.1) & (pick < 0.3)], 1)  # ties
    s[(pick >= 0.3) & (pick < 0.32)] = 3.0e38  # huge finite: the clamp keeps the grid finite
    return s, rng.random(n) < 0.8


def _bounds(s, v):
    vf = v & np.isfinite(s)
    lo = np.float32(s[vf].min()) if vf.any() else np.float32(np.inf)
    hi = np.float32(s[vf].max()) if vf.any() else np.float32(-np.inf)
    return lo, hi


@pytest.mark.parametrize("seed,n,num_buckets", [(0, 1, 8), (1, 100, 16), (2, 3000, 64), (3, 5000, 2048)])
@pytest.mark.parametrize("masked", [False, True])
def test_bucket_counts_matches_jax(seed, n, num_buckets, masked):
    s, v = _scores(seed, n)
    if not masked:
        v = np.ones(n, bool)
    lo, hi = _bounds(s, v)
    valid = v if masked else None
    counts, ids = bucket_counts(
        torch.from_numpy(s), torch.tensor(lo), torch.tensor(hi), num_buckets,
        valid=None if valid is None else torch.from_numpy(valid),
    )
    ref_counts, ref_ids = jax_bucket_counts(
        jnp.asarray(s), jnp.asarray(lo), jnp.asarray(hi), num_buckets, valid=None if valid is None else jnp.asarray(valid)
    )
    assert counts.dtype == torch.int32 and ids.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert int(counts.sum()) == n
    # the edge buckets: +inf, -inf, and NaN with the rows left out
    assert int(counts[0]) == int((v & (s == np.inf)).sum())
    assert int(counts[num_buckets + 1]) == int((v & (s == -np.inf)).sum())
    assert int(counts[num_buckets + 2]) == int((~v | np.isnan(s)).sum())


def test_bucket_counts_without_finite_scores():
    s = np.array([np.inf, -np.inf, np.nan, np.inf], np.float32)
    lo, hi = np.float32(np.inf), np.float32(-np.inf)
    counts, ids = bucket_counts(torch.from_numpy(s), torch.tensor(lo), torch.tensor(hi), 8)
    ref_counts, ref_ids = jax_bucket_counts(jnp.asarray(s), jnp.asarray(lo), jnp.asarray(hi), 8)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(ids.numpy(), [0, 9, 10, 0])
