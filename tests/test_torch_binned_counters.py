"""The port's binned counters (``metrics_tpu_torch/ops/binned_counters.py``)
against both JAX forms of ``metrics_tpu/ops/binned_counters.py``: the Pallas
kernel in interpret mode and the XLA reduction. The counts are integers, so
the float32 results must be bit-equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from metrics_tpu.ops import binned_counter_update as jax_binned  # noqa: E402
from metrics_tpu_torch.ops import binned_counters as port  # noqa: E402


def _inputs(n, c, t, seed):
    rng = np.random.default_rng(seed)
    preds = rng.random((n, c)).astype(np.float32)
    target = (rng.random((n, c)) < 0.3).astype(np.float32)
    thresholds = np.linspace(0, 1, t).astype(np.float32)
    return preds, target, thresholds


def _assert_bit_equal_to_jax(preds, target, thresholds):
    ours = port.binned_counter_update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    args = (jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thresholds))
    for ref in (jax_binned(*args, interpret=True), jax_binned(*args, backend="xla")):
        for got, want in zip(ours, ref):
            want = np.asarray(want)
            assert got.dtype == torch.float32 and want.dtype == np.float32
            assert got.shape == want.shape
            # bit-equal: the same float32 bit patterns, not merely close
            np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize(("n", "c", "t"), [(500, 16, 100), (64, 1, 5), (1024, 3, 128), (7, 4, 11), (0, 3, 5)])
def test_plain_matches_both_jax_forms(n, c, t):
    _assert_bit_equal_to_jax(*_inputs(n, c, t, seed=n + 7 * c + t))


def test_nan_and_infinite_scores():
    preds, target, thresholds = _inputs(64, 5, 11, seed=3)
    preds[::4, 0] = np.nan
    preds[1::4, 1] = np.inf
    preds[2::4, 2] = -np.inf
    target[:, :3] = 1.0
    _assert_bit_equal_to_jax(preds, target, thresholds)
    # a NaN score clears no threshold: each positive NaN row is a false
    # negative at every threshold
    tps, fps, fns = port.binned_counter_update_plain(
        torch.from_numpy(preds[::4, :1]), torch.ones((16, 1)), torch.from_numpy(thresholds)
    )
    assert torch.all(tps == 0) and torch.all(fps == 0) and torch.all(fns == 16)


def test_scores_equal_to_thresholds():
    rng = np.random.default_rng(11)
    thresholds = np.linspace(0, 1, 25).astype(np.float32)
    preds = thresholds[rng.integers(0, 25, (200, 6))]
    target = (rng.random((200, 6)) < 0.5).astype(np.float32)
    _assert_bit_equal_to_jax(preds, target, thresholds)


def test_unsorted_thresholds():
    rng = np.random.default_rng(5)
    preds, target, _ = _inputs(128, 4, 1, seed=5)
    thresholds = np.concatenate([rng.random(9), [0.5, 0.5, 0.0, 1.0]]).astype(np.float32)
    _assert_bit_equal_to_jax(preds, target, thresholds)


def test_cpu_dispatch_is_the_plain_version():
    preds, target, thresholds = (torch.from_numpy(a) for a in _inputs(33, 3, 7, seed=1))
    for got, want in zip(
        port.binned_counter_update(preds, target, thresholds),
        port.binned_counter_update_plain(preds, target, thresholds),
    ):
        assert torch.equal(got, want)
    # a bool or integer target counts the same as a float 0/1 one
    for tgt in (target.bool(), target.to(torch.int32)):
        for got, want in zip(port.binned_counter_update(preds, tgt, thresholds), port.binned_counter_update_plain(preds, target, thresholds)):
            assert torch.equal(got, want)
    assert port.launch_count == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize(
    ("preds_shape", "target_shape", "thr_shape"),
    [((4, 3), (4, 2), (5,)), ((4,), (4,), (5,)), ((4, 3), (4, 3), (5, 1))],
)
def test_wrapper_rejects_bad_shapes(preds_shape, target_shape, thr_shape):
    with pytest.raises(ValueError, match="binned_counters expects"):
        port.binned_counter_update(torch.zeros(preds_shape), torch.zeros(target_shape), torch.zeros(thr_shape))


def test_wrapper_rejects_other_devices_and_dtypes():
    with pytest.raises(TypeError, match="floating point"):
        port.binned_counter_update(torch.zeros((4, 3), dtype=torch.int32), torch.zeros((4, 3)), torch.zeros(5))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port.binned_counter_update(
            torch.zeros((4, 3), device="meta"), torch.zeros((4, 3), device="meta"), torch.zeros(5, device="meta")
        )
    with pytest.raises(ValueError, match="one device"):
        port.binned_counter_update(torch.zeros((4, 3)), torch.zeros((4, 3), device="meta"), torch.zeros(5))


def test_kernel_source_is_a_plain_c_library():
    """The CUDA source exists, exports the launcher the wrapper binds, and
    its library path is keyed by the source's hash (the build itself needs
    nvcc and a card)."""
    from metrics_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / port.SOURCE).read_text()
    assert 'extern "C" int binned_counters_launch' in src
    assert "metrics_tpu/ops/binned_counters.py::_counter_kernel" in src
    path = _build.library_path(port.SOURCE)
    assert path.parent.parent == _build.BUILD_DIR and path.name == "libbinned_counters.so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
