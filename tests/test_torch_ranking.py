"""The multilabel ranking metrics of the port (``CoverageError``,
``LabelRankingAveragePrecision``, ``LabelRankingLoss``) against their JAX
twins, and the port's batched row ranks against ``jax.vmap(ascending_ranks)``.

Ranks are exact (bitwise, ties, signed zeros, denormals and NaNs included);
the int32 row counts are exact; the float32 score and weight sums and the
values are held to ``SUM_ATOL`` plus ``FLOAT_RTOL`` (sums over rows in
another order). Rows with no relevant label, or only relevant labels, are
in every batch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu.functional as jF  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import metrics_tpu_torch.functional.classification as tF  # noqa: E402
from metrics_tpu.ops import ascending_ranks as jax_ascending_ranks  # noqa: E402
from metrics_tpu_torch.ops.bucketed_rank import ascending_ranks_rows  # noqa: E402
from tests.test_torch_classification import _np  # noqa: E402

SUM_ATOL = 1e-6  # float32 values near or below 1, summed over rows in another order
FLOAT_RTOL = 1e-6  # float32 sums of many rows

N = 40
L = 7


def _data(kind, seed, n=N, labels=L):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        preds = (rng.integers(0, 4, (n, labels)) / 4).astype(np.float32)
    elif kind == "specials":
        preds = rng.random((n, labels)).astype(np.float32)
        specials = np.array([0.0, -0.0, 1e-40, -1e-40, 2e-40, 0.5], np.float32)
        pick = rng.random((n, labels)) < 0.4
        preds[pick] = rng.choice(specials, pick.sum())
    else:
        preds = rng.normal(size=(n, labels)).astype(np.float32)
    target = rng.integers(0, 2, (n, labels))
    target[0] = 0  # no relevant label
    target[1] = 1  # every label relevant
    return preds, target


def _close(ours, ref):
    o, r = _np(ours), np.asarray(ref)
    assert o.dtype == r.dtype and o.shape == r.shape
    if np.issubdtype(r.dtype, np.floating):
        np.testing.assert_allclose(o, r, rtol=FLOAT_RTOL, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(o, r)


NAMES = ["CoverageError", "LabelRankingAveragePrecision", "LabelRankingLoss"]
KINDS = ["normal", "ties", "specials"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_ranking_module_matches_jax(name, kind, weighted):
    ours, ref = getattr(mtt, name)(device="cpu"), getattr(mt, name)()
    for i, op in enumerate(("forward", "update", "update")):
        preds, target = _data(kind, i, n=N - 3 * i)
        kw_o, kw_r = {}, {}
        if weighted:
            w = np.random.default_rng(50 + i).random(preds.shape[0]).astype(np.float32)
            kw_o, kw_r = {"sample_weight": torch.from_numpy(w)}, {"sample_weight": jnp.asarray(w)}
        if op == "update":
            ours.update(torch.from_numpy(preds), torch.from_numpy(target), **kw_o)
            ref.update(jnp.asarray(preds), jnp.asarray(target), **kw_r)
        else:
            _close(ours(torch.from_numpy(preds), torch.from_numpy(target), **kw_o), ref(jnp.asarray(preds), jnp.asarray(target), **kw_r))
        so, sr = ours.metric_state, ref.metric_state
        assert set(so) == set(sr)
        for k in sr:
            _close(so[k], sr[k])
    _close(ours.compute(), ref.compute())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["coverage_error", "label_ranking_average_precision", "label_ranking_loss"])
def test_ranking_functional_matches_jax(name, kind):
    preds, target = _data(kind, 11)
    _close(getattr(tF, name)(torch.from_numpy(preds), torch.from_numpy(target)), getattr(jF, name)(jnp.asarray(preds), jnp.asarray(target)))


def test_zero_weight_total_falls_back_to_the_row_count_as_jax():
    preds, target = _data("normal", 3)
    w = np.zeros(preds.shape[0], np.float32)
    for name in ("coverage_error", "label_ranking_average_precision", "label_ranking_loss"):
        _close(getattr(tF, name)(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(w)),
               getattr(jF, name)(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(w)))


@pytest.mark.parametrize(
    "rows",
    [
        np.array([[0.5, 0.5, 0.5, 0.1], [0.0, -0.0, 1e-40, -1e-40], [np.nan, 1.0, -np.nan, 0.0], [np.inf, -np.inf, 3.0, 3.0]], np.float32),
        np.random.default_rng(0).integers(-3, 3, (9, 12)).astype(np.int32),
        (np.random.default_rng(1).integers(0, 5, (6, 33)) / 5).astype(np.float32),
    ],
    ids=["float-specials", "int32-ties", "float-ties"],
)
def test_row_ranks_bitwise_equal_to_vmapped_jax(rows):
    ours = ascending_ranks_rows(torch.from_numpy(rows))
    ref = jax.vmap(jax_ascending_ranks)(jnp.asarray(rows))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(_np(ours), np.asarray(ref))


def test_ranking_input_errors_match_jax():
    for args in ((np.zeros((3, 2), np.float32), np.zeros((3, 3), np.int64)), (np.zeros(3, np.float32), np.zeros(3, np.int64))):
        with pytest.raises(ValueError) as ours:
            tF.coverage_error(*(torch.from_numpy(a) for a in args))
        with pytest.raises(ValueError) as ref:
            jF.coverage_error(*(jnp.asarray(a) for a in args))
        assert str(ours.value) == str(ref.value)
