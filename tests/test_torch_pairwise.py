"""The pairwise functions of the port (``metrics_tpu_torch/functional/pairwise/``)
against the JAX package's, on the same seeded numpy inputs.

Tolerance ``atol=1e-5`` plus ``rtol=1e-5``: each entry is a float32 sum
over ``d`` products or differences, which the two packages take in
another order (a matrix product's blocking, ``cdist``'s own sum), and the
euclidean distance subtracts two such sums. The manhattan distance is also
held against a float64 sum on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu.functional.pairwise as jP  # noqa: E402
import metrics_tpu_torch.functional.pairwise as tP  # noqa: E402

RTOL = ATOL = 1e-5
FUNCTIONS = ["pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity", "pairwise_manhattan_distance"]


def _xy(n=13, m=7, d=9, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(m, d)).astype(np.float32)


def _both(name, x, y=None, **kw):
    ours = getattr(tP, name)(torch.from_numpy(x), None if y is None else torch.from_numpy(y), **kw)
    ref = getattr(jP, name)(jnp.asarray(x), None if y is None else jnp.asarray(y), **kw)
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("reduction", [None, "mean", "sum"])
def test_pairwise_matches_jax(name, with_y, reduction):
    x, y = _xy()
    ours, ref = _both(name, x, y if with_y else None, reduction=reduction)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("zero_diagonal", [True, False])
def test_zero_diagonal_matches_jax(name, zero_diagonal):
    x, y = _xy(n=6, m=6)
    ours, ref = _both(name, x, y, zero_diagonal=zero_diagonal)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    if zero_diagonal:
        assert not np.diag(ours).any()


def test_manhattan_against_float64_and_integer_inputs():
    x, y = _xy(n=31, m=17, d=64, seed=2)
    want = np.abs(x.astype(np.float64)[:, None] - y.astype(np.float64)[None]).sum(-1)
    np.testing.assert_allclose(tP.pairwise_manhattan_distance(torch.from_numpy(x), torch.from_numpy(y)).numpy(), want, rtol=1e-6, atol=1e-5)
    xi, yi = (x * 10).astype(np.int32), (y * 10).astype(np.int32)
    ours, ref = _both("pairwise_manhattan_distance", xi, yi)
    assert ours.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize(
    ("x", "y", "reduction"),
    [
        (np.zeros((3,), np.float32), None, None),
        (np.zeros((3, 2), np.float32), np.zeros((3, 4), np.float32), None),
        (np.zeros((3, 2), np.float32), None, "max"),
    ],
)
def test_refusals_match_jax(x, y, reduction):
    with pytest.raises(ValueError):
        jP.pairwise_linear_similarity(jnp.asarray(x), None if y is None else jnp.asarray(y), reduction=reduction)
    with pytest.raises(ValueError):
        tP.pairwise_linear_similarity(torch.from_numpy(x), None if y is None else torch.from_numpy(y), reduction=reduction)
