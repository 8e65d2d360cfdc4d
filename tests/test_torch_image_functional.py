"""The functional image metrics of the port (``metrics_tpu_torch/functional/image/``)
against JAX's on the same seeded numpy inputs, over their keyword arguments.

Tolerances (ROADMAP W6, as measured): SSIM, MS-SSIM and UQI ``atol=1e-5``,
with ``rtol=1e-5`` on the unnormalised sums (the separable window's sums
run in another order than XLA's); PSNR, ERGAS, SAM, D-lambda and the gradients
``atol=1e-5`` plus ``rtol=1e-5`` (SAM away from small angles; near an
angle of 0 within 1e-3 rad a pixel of float64, D63); FID ``rtol=1e-3``/``atol=1e-3`` against
scipy (``tests/image/test_image.py:229``'s bound) and ``rtol=1e-5`` against
JAX, at the same rung of the ladder; the FID and LPIPS gradients
``rtol=1e-4``/``atol=1e-6`` against ``jax.grad``.
"""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.linalg  # noqa: E402

import metrics_tpu.functional.image as jF  # noqa: E402
import metrics_tpu_torch.functional as tFF  # noqa: E402
import metrics_tpu_torch.functional.image as tF  # noqa: E402
from metrics_tpu.functional.image import fid as jfid  # noqa: E402
from metrics_tpu.functional.image import helper as jhelper  # noqa: E402
from metrics_tpu_torch.functional.image import fid as tfid  # noqa: E402
from metrics_tpu_torch.functional.image import helper as thelper  # noqa: E402

ATOL = 1e-5


def _pair(shape, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    p = rng.random(shape).astype(np.float32)
    t = np.clip(p + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return p, t


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol, rtol=rtol)


_JAX_VALUES = {}


def _both(name, preds, target, **kw):
    """The port's value and JAX's (jitted)."""
    key = (name, preds.tobytes(), target.tobytes(), repr(sorted(kw.items())))
    if key not in _JAX_VALUES:
        fn = jax.jit(functools.partial(getattr(jF, name), **kw))
        _JAX_VALUES[key] = fn(jnp.asarray(preds), jnp.asarray(target))
    return getattr(tF, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw), _JAX_VALUES[key]


SSIM_KWARGS = [
    {},
    {"gaussian_kernel": False},
    {"gaussian_kernel": False, "kernel_size": 7, "reduction": "none"},
    {"sigma": 0.8, "reduction": "sum"},
    {"data_range": 1.0, "k1": 0.02, "k2": 0.05},
    {"return_full_image": True},
    {"return_full_image": True, "reduction": "none"},
    {"return_contrast_sensitivity": True},
    {"return_contrast_sensitivity": True, "gaussian_kernel": False, "reduction": "none"},
]


@pytest.mark.parametrize("kw", SSIM_KWARGS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_ssim_against_jax(kw):
    p, t = _pair((3, 2, 40, 36), 0)
    _close(*_both("structural_similarity_index_measure", p, t, **kw), rtol=1e-5)


def test_ssim_3d_against_jax():
    p, t = _pair((2, 2, 16, 18, 20), 1)
    for kw in ({}, {"return_contrast_sensitivity": True}, {"gaussian_kernel": False, "kernel_size": 5}):
        _close(*_both("structural_similarity_index_measure", p, t, **kw))


@pytest.mark.parametrize(
    "kw",
    [{"data_range": 1.0}, {"data_range": 1.0, "gaussian_kernel": False, "kernel_size": 7}, {"normalize": "relu"},
     {"normalize": "simple", "reduction": "none"}, {"betas": (0.3, 0.3, 0.4), "reduction": "sum"}],
    ids=["data_range", "box", "relu", "simple_none", "three_betas_sum"],
)
def test_ms_ssim_against_jax(kw):
    p, t = _pair((2, 1, 176, 176), 2, noise=0.2)
    _close(*_both("multiscale_structural_similarity_index_measure", p, t, **kw))


def test_ssim_window_against_jax():
    """The depthwise-convolution window within float32 rounding of JAX's
    banded product, and of its convolution past ``_BANDED_MAX_SIZE``."""
    x = torch.from_numpy(np.random.default_rng(3).random((2, 3, 30, 33)).astype(np.float32))
    factors = thelper._separable_factors((11, 11), (1.5, 1.5), True, torch.float32)
    got = thelper._depthwise_conv_separable(x, factors)
    want = jhelper._depthwise_conv_separable(jnp.asarray(x.numpy()), [jnp.asarray(f.numpy()) for f in factors])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    wide = np.random.default_rng(13).random((1, 1, 3, jhelper._BANDED_MAX_SIZE + 5)).astype(np.float32)
    factors = thelper._separable_factors((3, 3), (1.0, 1.0), False, torch.float32)
    got = thelper._depthwise_conv_separable(torch.from_numpy(wide), factors)
    want = jhelper._depthwise_conv_separable(jnp.asarray(wide), [jnp.asarray(f.numpy()) for f in factors])
    assert got.shape == (1, 1, 1, jhelper._BANDED_MAX_SIZE + 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_ssim_helpers_against_jax():
    np.testing.assert_allclose(thelper._gaussian(11, 1.5, torch.float32).numpy(), np.asarray(jhelper._gaussian(11, 1.5, jnp.float32)), atol=1e-7)
    for gaussian in (True, False):
        got = thelper._separable_factors((5, 7), (1.0, 2.0), gaussian, torch.float32)
        want = jhelper._separable_factors((5, 7), (1.0, 2.0), gaussian, jnp.float32)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)
    x = np.random.default_rng(5).random((1, 2, 6, 7)).astype(np.float32)
    np.testing.assert_array_equal(thelper._reflect_pad(torch.from_numpy(x), (2, 3)).numpy(), np.asarray(jhelper._reflect_pad(jnp.asarray(x), (2, 3))))


@pytest.mark.parametrize("kw", [{}, {"kernel_size": (7, 9), "sigma": (1.0, 2.0)}, {"reduction": "none"}, {"reduction": "sum"}])
def test_uqi_against_jax(kw):
    p, t = _pair((2, 3, 32, 30), 6)
    _close(*_both("universal_image_quality_index", p, t, **kw), rtol=1e-5)


@pytest.mark.parametrize(
    "kw",
    [{}, {"data_range": 2.0}, {"base": 2.0}, {"dim": 1, "data_range": 1.0}, {"dim": (1, 2, 3), "data_range": 1.0, "reduction": "none"},
     {"dim": (2, 3), "data_range": 1.0, "reduction": "sum"}, {"dim": (), "data_range": 1.0}],
    ids=["default", "data_range", "base2", "dim1", "dim123_none", "dim23_sum", "dim_empty"],
)
def test_psnr_against_jax(kw):
    p, t = _pair((3, 2, 8, 9), 7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _close(*_both("peak_signal_noise_ratio", p, t, **kw), rtol=1e-5)


def test_psnr_refuses_dim_without_data_range():
    p, t = _pair((2, 1, 4, 4), 8)
    with pytest.raises(ValueError, match="data_range"):
        tF.peak_signal_noise_ratio(torch.from_numpy(p), torch.from_numpy(t), dim=1)


@pytest.mark.parametrize("kw", [{}, {"ratio": 2}, {"reduction": "none"}, {"reduction": "sum"}])
def test_ergas_against_jax(kw):
    p, t = _pair((3, 4, 16, 12), 9)
    _close(*_both("error_relative_global_dimensionless_synthesis", p + 0.1, t + 0.1, **kw), rtol=1e-5)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_sam_against_jax(reduction):
    p, t = _pair((3, 5, 10, 11), 10)
    _close(*_both("spectral_angle_mapper", p, t, reduction=reduction), rtol=1e-5)


SAM_SMALL_ANGLE_RAD = 1e-3  # a pixel's SAM near angle 0, against float64 and between the packages (D63)


def _sam64(p, t):
    p, t = p.astype(np.float64), t.astype(np.float64)
    cos = (p * t).sum(1) / (np.linalg.norm(p, axis=1) * np.linalg.norm(t, axis=1))
    return np.arccos(np.clip(cos, -1, 1))


@pytest.mark.parametrize("channels", [2, 3, 8])
@pytest.mark.parametrize("kind", ["near_equal", "identical"])
def test_sam_at_small_angles_against_float64(channels, kind):
    """D63: near an angle of 0, ``arccos`` turns a few float32 ulps of the
    cosine into a few 1e-4 rad (one ulp below 1 is 3.5e-4 rad), in both
    packages, which run the same formula. Each package's per-pixel SAM is
    within 1e-3 rad of float64 SAM of the same float32 inputs (read on the
    CPU: up to 4.9e-4 for the port and 8.5e-4 for JAX), the port within 1e-3
    of JAX, and a ``sum`` within 1e-3 rad a pixel."""
    rng = np.random.default_rng(100 + channels)
    p = (rng.random((4, channels, 64, 64)) + 0.05).astype(np.float32)
    d = 1e-4 * rng.standard_normal(p.shape) if kind == "near_equal" else 0.0
    t = (p * (1 + d)).astype(np.float32)
    exact = _sam64(p, t)
    port = tF.spectral_angle_mapper(torch.from_numpy(p), torch.from_numpy(t), reduction="none").numpy()
    ref = np.asarray(jF.spectral_angle_mapper(jnp.asarray(p), jnp.asarray(t), reduction="none"))
    assert port.shape == ref.shape == exact.shape
    np.testing.assert_allclose(port, exact, rtol=0, atol=SAM_SMALL_ANGLE_RAD)
    np.testing.assert_allclose(ref, exact, rtol=0, atol=SAM_SMALL_ANGLE_RAD)
    np.testing.assert_allclose(port, ref, rtol=0, atol=SAM_SMALL_ANGLE_RAD)
    pixels = exact.size
    port_sum = float(tF.spectral_angle_mapper(torch.from_numpy(p), torch.from_numpy(t), reduction="sum"))
    ref_sum = float(jF.spectral_angle_mapper(jnp.asarray(p), jnp.asarray(t), reduction="sum"))
    assert abs(port_sum - exact.sum()) <= SAM_SMALL_ANGLE_RAD * pixels
    assert abs(ref_sum - exact.sum()) <= SAM_SMALL_ANGLE_RAD * pixels
    assert abs(port_sum - ref_sum) <= SAM_SMALL_ANGLE_RAD * pixels


@pytest.mark.parametrize("p_norm", [1, 2, 3])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "none"])
def test_d_lambda_against_jax(p_norm, reduction):
    p, t = _pair((2, 4, 24, 24), 11)
    _close(*_both("spectral_distortion_index", p, t, p=p_norm, reduction=reduction), rtol=1e-5)


def test_image_gradients_against_jax():
    x = np.random.default_rng(12).random((2, 3, 7, 6)).astype(np.float32)
    got = tF.image_gradients(torch.from_numpy(x))
    want = jF.image_gradients(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(RuntimeError, match="4D"):
        tF.image_gradients(torch.zeros(3, 4, 5))


@pytest.mark.parametrize(
    "name,shape",
    [("structural_similarity_index_measure", (2, 3, 4)), ("universal_image_quality_index", (2, 3, 16, 16, 1)),
     ("error_relative_global_dimensionless_synthesis", (2, 3, 4)), ("spectral_angle_mapper", (2, 1, 8, 8)),
     ("spectral_distortion_index", (2, 3, 8))],
)
def test_refusals_match_jax(name, shape):
    x = np.zeros(shape, np.float32)
    with pytest.raises(Exception) as want:
        getattr(jF, name)(jnp.asarray(x), jnp.asarray(x))
    with pytest.raises(type(want.value)):
        getattr(tF, name)(torch.from_numpy(x), torch.from_numpy(x))


def test_functional_package_exports_the_image_functions():
    for name in jF.__dict__:
        if not name.startswith("_") and callable(getattr(jF, name)) and not isinstance(getattr(jF, name), type(jF)):
            assert getattr(tFF, name) is getattr(tF, name)


# -- FID: the ladder at each rung ---------------------------------------


def _scipy_fid(f1, f2):
    s1, s2 = np.cov(f1.T), np.cov(f2.T)
    return float(((f1.mean(0) - f2.mean(0)) ** 2).sum() + np.trace(s1 + s2 - 2 * scipy.linalg.sqrtm(s1 @ s2).real))


def _ladder_case(case):
    """The three constructions of ``tests/image/test_image.py``: well
    conditioned (:218), ill conditioned (:336), rank deficient (:407)."""
    if case == "well":
        rng = np.random.default_rng(13)
        return rng.standard_normal((128, 16)).astype(np.float32), (rng.standard_normal((128, 16)) + 0.3).astype(np.float32)
    if case == "ill":
        rng = np.random.default_rng(21)
        f1 = (0.03 * rng.standard_normal((64, 16))).astype(np.float32) * np.asarray([1.0] * 8 + [1e-4] * 8, np.float32)
        return f1, f1 * 1.001
    rng = np.random.default_rng(11)
    return rng.standard_normal((8, 32)).astype(np.float32), (rng.standard_normal((8, 32)) + 0.4).astype(np.float32)


@pytest.mark.parametrize(
    "case,rung", [("well", "newton_schulz"), ("ill", "newton_schulz_loaded"), ("rank_deficient", "nuclear_norm")]
)
def test_fid_ladder_rungs_against_scipy_and_jax(case, rung):
    f1, f2 = _ladder_case(case)
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    mu1, s1, xc = tfid._mean_cov(t1)
    mu2, s2, yc = tfid._mean_cov(t2)
    got, took = tfid._compute_fid_with_rung(mu1, s1, mu2, s2, centered=(xc, yc))
    assert took == rung
    want = float(jfid.frechet_inception_distance_from_features(jnp.asarray(f1), jnp.asarray(f2)))
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tfid.frechet_inception_distance_from_features(t1, t2)), want, rtol=1e-5, atol=1e-6)
    if case != "ill":  # JAX's own test holds the ill case to its rung, not to scipy
        np.testing.assert_allclose(float(got), _scipy_fid(f1, f2), rtol=1e-3, atol=1e-3)


def test_fid_eigh_terminal_against_jax_and_scipy():
    """Without centered features the terminal is the eigh trace (the
    capacity mode's), and past ``16 * d * d`` rows squared too."""
    f1, f2 = _ladder_case("rank_deficient")
    mu1, s1, xc = tfid._mean_cov(torch.from_numpy(f1))
    mu2, s2, yc = tfid._mean_cov(torch.from_numpy(f2))
    got, took = tfid._compute_fid_with_rung(mu1, s1, mu2, s2)
    assert took == "eigh"
    jm1, js1, _ = jfid._mean_cov(jnp.asarray(f1))
    jm2, js2, _ = jfid._mean_cov(jnp.asarray(f2))
    np.testing.assert_allclose(float(got), float(jfid._compute_fid(jm1, js1, jm2, js2)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got), _scipy_fid(f1, f2), rtol=1e-3, atol=1e-3)
    # 129 * 129 rows past 16 * 32 * 32: the cross matrix would be too large
    big = torch.zeros((129, 32))
    value, took = tfid._compute_fid_with_rung(mu1, s1, mu2, s2, centered=(big, big))
    assert took == "eigh" and float(value) == float(got)
    np.testing.assert_allclose(
        tfid._trace_sqrtm_psd_product(s1, s2).item(), jfid._trace_sqrtm_psd_product(js1, js2).item(), rtol=1e-4
    )


def test_fid_masked_mean_cov_against_jax():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((20, 6)).astype(np.float32)
    mask = rng.random(20) < 0.6
    got = tfid._mean_cov_masked(torch.from_numpy(x), torch.from_numpy(mask))
    want = jfid._mean_cov_masked(jnp.asarray(x), jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_newton_schulz_against_jax():
    rng = np.random.default_rng(15)
    a = rng.standard_normal((12, 12)).astype(np.float32)
    spd = a @ a.T / 12 + np.eye(12, dtype=np.float32)
    got = tfid._newton_schulz_sqrtm(torch.from_numpy(spd))
    np.testing.assert_allclose(got.numpy(), np.asarray(jfid._newton_schulz_sqrtm(jnp.asarray(spd))), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose((got @ got).numpy(), spd, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [{}, {"degree": 2, "gamma": 0.5, "coef": 2.0}])
def test_poly_mmd_against_jax(kw):
    rng = np.random.default_rng(16)
    a, b = rng.standard_normal((30, 8)).astype(np.float32), (rng.standard_normal((30, 8)) + 0.5).astype(np.float32)
    got = tfid._poly_mmd(torch.from_numpy(a), torch.from_numpy(b), **kw)
    np.testing.assert_allclose(float(got), float(jfid._poly_mmd(jnp.asarray(a), jnp.asarray(b), **kw)), rtol=1e-5)
    np.testing.assert_allclose(
        tfid._poly_kernel(torch.from_numpy(a), torch.from_numpy(b), **kw).numpy(),
        np.asarray(jfid._poly_kernel(jnp.asarray(a), jnp.asarray(b), **kw)), rtol=1e-5,
    )


@pytest.mark.parametrize("case", ["well", "rank_deficient"])
def test_fid_gradients_against_jax_grad(case):
    f1, f2 = _ladder_case(case)
    t1, t2 = torch.from_numpy(f1).requires_grad_(True), torch.from_numpy(f2).requires_grad_(True)
    tfid.frechet_inception_distance_from_features(t1, t2).backward()
    g1, g2 = jax.jit(jax.grad(jfid.frechet_inception_distance_from_features, argnums=(0, 1)))(jnp.asarray(f1), jnp.asarray(f2))
    for got, want in ((t1.grad, g1), (t2.grad, g2)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_lpips_gradients_against_jax_grad():
    from metrics_tpu.nets import lpips_net as jlp
    from metrics_tpu_torch.nets import lpips_net as tlp

    rng = np.random.default_rng(17)
    i0 = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    i1 = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    jm = jlp._LPIPSModule(net_type="alex")
    # flax-layout variables drawn with numpy (JAX's own init is the nets
    # file's): the gradient is what this test holds
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(i0[:1]), jnp.asarray(i1[:1]))
    variables = jax.tree_util.tree_map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32), shapes)
    tm = tlp.load_jax_variables(tlp._LPIPSModule("alex"), variables)
    x0 = torch.from_numpy(i0).requires_grad_(True)
    tm(x0, torch.from_numpy(i1)).sum().backward()
    want = jax.jit(jax.grad(lambda a: jm.apply(variables, a, jnp.asarray(i1)).sum()))(jnp.asarray(i0))
    np.testing.assert_allclose(x0.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_ssim_gradient_against_jax_grad():
    p, t = _pair((1, 1, 24, 24), 18)
    x = torch.from_numpy(p).requires_grad_(True)
    tF.structural_similarity_index_measure(x, torch.from_numpy(t), data_range=1.0).backward()
    want = jax.jit(jax.grad(lambda a: jF.structural_similarity_index_measure(a, jnp.asarray(t), data_range=1.0)))(jnp.asarray(p))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_full_float32_is_scoped():
    """TF32 off inside the block (D46), the caller's settings back after
    it, and nothing changed when the block is off."""
    from metrics_tpu_torch.utilities.compute import full_float32

    before = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high")
    try:
        with full_float32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32 == before[1]
        with full_float32(False):
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before[0])


def test_full_float32_counts_blocks_across_threads():
    """Blocks open in two threads (A opens, B opens, A ends, B ends): TF32
    stays off in B after A's block ends, and the caller's settings come
    back when B's ends."""
    import threading

    from metrics_tpu_torch.utilities.compute import full_float32

    before = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    a_open, b_open, a_closed = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def thread_a():
        with full_float32():
            a_open.set()
            assert b_open.wait(10)
        a_closed.set()

    def thread_b():
        assert a_open.wait(10)
        with full_float32():
            b_open.set()
            assert a_closed.wait(10)
            seen["inside_b"] = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)

    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        threads = [threading.Thread(target=thread_a), threading.Thread(target=thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert seen["inside_b"] == ("highest", False)
        assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == ("high", True)
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]
