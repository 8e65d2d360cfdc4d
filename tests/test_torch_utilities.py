"""The port's utilities (``metrics_tpu_torch/utilities/``) against their JAX
counterparts on the same seeded numpy inputs. Elementwise arithmetic is
exact. ``atol=1e-6`` where float32 results are summed in another order
(``_auc_compute``, matmul, sum and mean) or come from another ``log``
implementation (``_safe_xlogy``)."""
import doctest
import importlib
import pkgutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu_torch  # noqa: E402
from metrics_tpu.utilities import checks as jchecks  # noqa: E402
from metrics_tpu.utilities import compute as jcompute  # noqa: E402
from metrics_tpu.utilities import data as jdata  # noqa: E402
from metrics_tpu.utilities import enums as jenums  # noqa: E402
from metrics_tpu_torch.utilities import checks, compute, data, enums  # noqa: E402

SUM_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same(ours, ref, atol=0.0):
    o, r = ours.numpy(), np.asarray(ref)
    assert o.shape == r.shape and o.dtype == r.dtype, (o.shape, r.shape, o.dtype, r.dtype)
    if atol:
        np.testing.assert_allclose(o, r, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(o, r)


RNG = np.random.default_rng(2024)
X = RNG.normal(size=(6, 4)).astype(np.float32)
Y = RNG.normal(size=(6, 4)).astype(np.float32)
COUNTS = RNG.integers(0, 3, size=(6, 4)).astype(np.int32)


@pytest.mark.parametrize(
    ("name", "args"),
    [
        ("_safe_divide", (X, np.where(RNG.random((6, 4)) < 0.3, 0.0, Y).astype(np.float32))),
        ("_safe_divide", (COUNTS, COUNTS[::-1].copy())),
        ("_safe_xlogy", (np.where(RNG.random((6, 4)) < 0.3, 0.0, np.abs(X)).astype(np.float32), np.abs(Y))),
        ("_safe_matmul", (X, Y.T.copy())),
        ("_to_float", (COUNTS,)),
        ("_to_float", (X,)),
    ],
)
def test_compute_helpers_match_jax(name, args):
    atol = SUM_ATOL if name in ("_safe_matmul", "_safe_xlogy") else 0.0
    _same(getattr(compute, name)(*(_t(a) for a in args)), getattr(jcompute, name)(*(jnp.asarray(a) for a in args)), atol)


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("order", ["ascending", "descending", "mixed"])
def test_auc_matches_jax(reorder, order):
    x = np.sort(RNG.random(20).astype(np.float32))
    if order == "descending":
        x = x[::-1].copy()
    elif order == "mixed":
        x = RNG.permutation(x)
    y = RNG.random(20).astype(np.float32)
    _same(compute._auc_compute(_t(x), _t(y), reorder=reorder), jcompute._auc_compute(jnp.asarray(x), jnp.asarray(y), reorder=reorder), SUM_ATOL)


@pytest.mark.parametrize("name", ["dim_zero_sum", "dim_zero_mean", "dim_zero_max", "dim_zero_min", "dim_zero_cat"])
def test_dim_zero_reductions_match_jax(name):
    atol = SUM_ATOL if name in ("dim_zero_sum", "dim_zero_mean") else 0.0
    _same(getattr(data, name)(_t(X)), getattr(jdata, name)(jnp.asarray(X)), atol)


def test_list_helpers():
    assert data._flatten([[1, 2], [3], []]) == jdata._flatten([[1, 2], [3], []]) == [1, 2, 3]
    nested = {"a": 1, "b": {"c": 2, "d": 3}}
    assert data._flatten_dict(nested) == jdata._flatten_dict(nested) == {"a": 1, "c": 2, "d": 3}
    cat = data.dim_zero_cat([torch.tensor(1.0), torch.tensor([2.0, 3.0])])
    assert cat.tolist() == [1.0, 2.0, 3.0]
    with pytest.raises(ValueError, match="No samples"):
        data.dim_zero_cat([])
    out = data._squeeze_if_scalar({"x": [torch.ones(1), torch.ones(2)], "y": (torch.ones(1, 1),)})
    assert out["x"][0].shape == () and out["x"][1].shape == (2,) and out["y"][0].shape == ()


@pytest.mark.parametrize("shape", [(7,), (5, 3)])
@pytest.mark.parametrize("num_classes", [None, 6])
def test_to_onehot_matches_jax(shape, num_classes):
    labels = RNG.integers(0, 4, size=shape)
    _same(data.to_onehot(_t(labels), num_classes), jdata.to_onehot(jnp.asarray(labels), num_classes))


@pytest.mark.parametrize("topk", [1, 2, 3])
@pytest.mark.parametrize("dim", [1, 0])
def test_select_topk_matches_jax(topk, dim):
    scores = (RNG.integers(0, 4, size=(6, 5)) / 4).astype(np.float32)  # many ties
    _same(data.select_topk(_t(scores), topk, dim=dim), jdata.select_topk(jnp.asarray(scores), topk, dim=dim))


FORMAT_CASES = [
    ("binary", dict(), lambda: (RNG.random(9).astype(np.float32), RNG.integers(0, 2, 9))),
    ("binary-threshold", dict(threshold=0.7), lambda: (RNG.random(9).astype(np.float32), RNG.integers(0, 2, 9))),
    ("multiclass-probs", dict(), lambda: (RNG.random((9, 4)).astype(np.float32), RNG.integers(0, 4, 9))),
    ("multiclass-top2", dict(top_k=2), lambda: (RNG.random((9, 4)).astype(np.float32), RNG.integers(0, 4, 9))),
    ("multiclass-labels", dict(num_classes=5), lambda: (RNG.integers(0, 5, 9), RNG.integers(0, 5, 9))),
    ("multiclass-labels-inferred", dict(), lambda: (RNG.integers(0, 5, 9), RNG.integers(0, 5, 9))),
    ("multilabel", dict(), lambda: (RNG.random((9, 3)).astype(np.float32), RNG.integers(0, 2, (9, 3)))),
    ("multilabel-as-2-class", dict(multiclass=True, num_classes=2), lambda: (RNG.random((9, 3)).astype(np.float32), RNG.integers(0, 2, (9, 3)))),
    ("binary-as-2-class", dict(multiclass=True, num_classes=2), lambda: (RNG.random(9).astype(np.float32), RNG.integers(0, 2, 9))),
    ("mdmc-probs", dict(), lambda: (RNG.random((9, 4, 3)).astype(np.float32), RNG.integers(0, 4, (9, 3)))),
    ("mdmc-labels", dict(), lambda: (RNG.integers(0, 4, (9, 3)), RNG.integers(0, 4, (9, 3)))),
    ("single-row", dict(), lambda: (RNG.random((1, 4)).astype(np.float32), RNG.integers(0, 4, 1))),
]


@pytest.mark.parametrize(("case", "kwargs", "make"), FORMAT_CASES, ids=[c[0] for c in FORMAT_CASES])
def test_input_format_matches_jax(case, kwargs, make):
    preds, target = make()
    p, t, mode = checks._input_format_classification(_t(preds), _t(target), **kwargs)
    jp, jt, jmode = jchecks._input_format_classification(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    _same(p, jp)
    _same(t, jt)
    assert mode.value == jmode.value


def test_enums_match_jax():
    for ours, ref in ((enums.DataType, jenums.DataType), (enums.AverageMethod, jenums.AverageMethod), (enums.MDMCAverageMethod, jenums.MDMCAverageMethod)):
        assert [e.value for e in ours] == [e.value for e in ref]
    assert enums.AverageMethod.from_str("Macro") is enums.AverageMethod.MACRO
    assert enums.AverageMethod.coerce("none") is enums.AverageMethod.NONE
    for text in ("multi-label", "MULTILABEL", "multi_class", "binary", "bogus"):
        ours, ref = enums.DataType.from_str(text), jenums.DataType.from_str(text)
        assert (ours and ours.value) == (ref and ref.value)
    assert str(enums.MDMCAverageMethod.GLOBAL) == "global"
    with pytest.raises(ValueError, match="Invalid value"):
        enums.AverageMethod.coerce("median")


def _port_modules():
    return sorted(info.name for info in pkgutil.walk_packages(metrics_tpu_torch.__path__, prefix="metrics_tpu_torch."))


@pytest.mark.parametrize("module_name", _port_modules())
def test_port_doctests(module_name):
    """Docstring examples of the port run as written, on the CPU."""
    module = importlib.import_module(module_name)
    runner = doctest.DocTestRunner(optionflags=doctest.NORMALIZE_WHITESPACE)
    for test in doctest.DocTestFinder(exclude_empty=True).find(module, module.__name__):
        runner.run(test)
    assert runner.failures == 0
