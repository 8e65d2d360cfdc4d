"""The port builds the binned metrics' thresholds with the float32 values of
``jnp.linspace(0, 1.0, T)``, bit for bit; ``torch.linspace`` differs, and a
score equal to a threshold would then fall in another bin."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from metrics_tpu import BinnedPrecisionRecallCurve as JaxCurve  # noqa: E402
from metrics_tpu_torch import BinnedPrecisionRecallCurve  # noqa: E402
from metrics_tpu_torch.utilities.data import jax_linspace  # noqa: E402


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("num", [2, 5, 11, 25, 100, 128, 1000])
def test_jax_linspace_is_bit_equal(num):
    ours = jax_linspace(0, 1.0, num)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(jnp.linspace(0, 1.0, num)))


@pytest.mark.parametrize("num", [0, 1])
def test_jax_linspace_degenerate_counts(num):
    np.testing.assert_array_equal(_bits(jax_linspace(0, 1.0, num).numpy()), _bits(jnp.linspace(0, 1.0, num)))


def test_torch_linspace_would_differ():
    """The trap the helper avoids: torch's own linspace rounds otherwise."""
    ref = _bits(jnp.linspace(0, 1.0, 1000))
    assert (_bits(torch.linspace(0, 1.0, 1000).numpy()) != ref).sum() > 0


@pytest.mark.parametrize("thresholds", [100, 25, [0.9, 0.1, 0.5, 0.5]])
def test_metric_thresholds_match_jax(thresholds):
    ours = BinnedPrecisionRecallCurve(num_classes=2, thresholds=thresholds, device="cpu").thresholds
    ref = JaxCurve(num_classes=2, thresholds=thresholds).thresholds
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))


def test_metric_rejects_other_threshold_types():
    with pytest.raises(ValueError, match="thresholds"):
        BinnedPrecisionRecallCurve(num_classes=2, thresholds=(0.1, 0.2), device="cpu")
