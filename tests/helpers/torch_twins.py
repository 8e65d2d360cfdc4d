"""Leaf-by-leaf comparison of a port state with a JAX state, for the parity
tests of the pure layer, the wrappers and the regression metrics.

A state is flattened to named leaves (numpy arrays): dict keys and list
positions name the path, a ring contributes ``data``/``mask``/``dropped``,
the fault counters ``counts``, a sketch its fields. Both packages' classes
of those states are recognised by their field names, so neither package is
imported here.
"""
import numpy as np

_FIELDS = ("data", "mask", "dropped", "counts", "items", "n_seen", "registers")


def np_leaf(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def leaves(state, prefix=""):
    """``{path: numpy leaf}`` of a state of either package."""
    if isinstance(state, dict):
        out = {}
        for k in sorted(state):
            out.update(leaves(state[k], f"{prefix}/{k}"))
        return out
    fields = getattr(state, "_fields", None) or [f for f in ("data", "mask", "dropped") if hasattr(state, f) and not hasattr(state, "shape")]
    if fields:
        out = {}
        for f in fields:
            v = getattr(state, f)
            if v is not None:
                out.update(leaves(v, f"{prefix}.{f}"))
        return out
    if isinstance(state, (list, tuple)):
        out = {}
        for i, v in enumerate(state):
            out.update(leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: np_leaf(state)}


def assert_states_close(ours, ref, rtol=0.0, atol=0.0, exact_ints=True, check_dtype=True):
    """Equal paths and shapes; integer and bool leaves exact, float leaves
    within ``rtol``/``atol`` (exact when both are 0). The port carries the
    uint32 fault and CountMin counters as int64: compared by value."""
    a, b = leaves(ours), leaves(ref)
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for k in a:
        x, y = a[k], b[k]
        assert x.shape == y.shape, (k, x.shape, y.shape)
        if check_dtype and not (y.dtype == np.uint32 and x.dtype == np.int64):
            assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        if np.issubdtype(y.dtype, np.floating) and not (rtol == atol == 0.0):
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(x, y.astype(x.dtype) if exact_ints else y, err_msg=k)


def assert_bits_equal(ours, ref):
    """Bit-equal leaves (NaN payloads and the sign of zero included)."""
    a, b = leaves(ours), leaves(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.ascontiguousarray(a[k]), np.ascontiguousarray(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, (k, x.shape, y.shape, x.dtype, y.dtype)
        assert x.tobytes() == y.tobytes(), k
