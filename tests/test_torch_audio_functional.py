"""The functional audio metrics of the port (``metrics_tpu_torch/functional/audio/``)
against JAX's on the same seeded numpy inputs.

Tolerances (ROADMAP W6's audio line, as measured on the CPU, float32 inputs
in both packages): SNR, SI-SNR and SI-SDR ``atol=1e-5`` dB (2.9e-6 read);
SDR dense and CG ``atol=1e-5`` dB near 12 dB (2.9e-6 read), and
``atol=5e-4`` dB in the high-SDR regime of 40-80 dB (1.5e-4 read at 80 dB);
a silent reference inf or NaN where JAX's is; PIT's permutations bit-equal
(int64 here, int32 in JAX) and its values ``atol=1e-5`` plus ``rtol=1e-5``
(the worst permutations, near -56 dB, cancel in float32: 1.6e-6 relative
read); native STOI and
ESTOI ``atol=2e-4`` (9.4e-5 read, ESTOI with the VAD at 10 kHz); the band
matrix and the VAD's frames bit-equal. A float64 input computes in float64
in the port and in float32 in JAX (ROADMAP "Dtypes"):
``test_float64_input_computes_in_float64`` is the only case that uses one.
"""
import itertools
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu.functional.audio as J  # noqa: E402
import metrics_tpu_torch.functional.audio as T  # noqa: E402
from metrics_tpu.functional.audio import stoi_native as jstoi  # noqa: E402
from metrics_tpu_torch.functional.audio import pit as tpit  # noqa: E402
from metrics_tpu_torch.functional.audio import stoi_native as tstoi  # noqa: E402

DB_ATOL = 1e-5
HIGH_SDR_ATOL = 5e-4
STOI_ATOL = 2e-4
PIT_RTOL = 1e-5  # the worst permutations' SI-SDR near -56 dB: alpha's sum cancels in float32 (1.6e-6 read)

_rng = np.random.default_rng(31)
TARGET = _rng.standard_normal((3, 500)).astype(np.float32)
PREDS = (TARGET + 0.3 * _rng.standard_normal((3, 500))).astype(np.float32)


def _both(name, *arrays, **kwargs):
    ours = getattr(T, name)(*(torch.from_numpy(a) for a in arrays), **kwargs)
    ref = getattr(J, name)(*(jnp.asarray(a) for a in arrays), **kwargs)
    return ours, ref


def _close(ours, ref, atol, rtol=0.0):
    ours, ref = ours.numpy().astype(np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    ("name", "kwargs"),
    [
        ("signal_noise_ratio", {}), ("signal_noise_ratio", {"zero_mean": True}),
        ("scale_invariant_signal_distortion_ratio", {}), ("scale_invariant_signal_distortion_ratio", {"zero_mean": True}),
        ("scale_invariant_signal_noise_ratio", {}),
    ],
)
def test_snr_family_against_jax(name, kwargs):
    ours, ref = _both(name, PREDS, TARGET, **kwargs)
    assert ours.dtype == torch.float32
    _close(ours, ref, DB_ATOL)


@pytest.mark.parametrize(
    "kwargs",
    [
        {}, {"zero_mean": True}, {"load_diag": 1e-6}, {"filter_length": 64},
        {"use_cg_iter": 10}, {"use_cg_iter": 30, "zero_mean": True, "load_diag": 1e-3},
    ],
    ids=["dense", "zero_mean", "load_diag", "filter64", "cg10", "cg30_zero_mean_load_diag"],
)
def test_sdr_against_jax(kwargs):
    kwargs = {"filter_length": 128, **kwargs}
    ours, ref = _both("signal_distortion_ratio", PREDS, TARGET, **kwargs)
    assert ours.dtype == torch.float32
    _close(ours, ref, DB_ATOL)


def test_sdr_default_filter_against_jax():
    """The default 512-tap filter: a 512 x 512 system per clip."""
    _close(*_both("signal_distortion_ratio", PREDS, TARGET), DB_ATOL)


def test_sdr_high_regime_against_jax():
    """preds close to target: the time-domain residual keeps float32 SDR
    within 5e-4 dB of JAX up to 80 dB."""
    rng = np.random.default_rng(0)
    t = rng.standard_normal(4000).astype(np.float32)
    for scale in (1e-4, 1e-3, 1e-2):
        p = (t + scale * rng.standard_normal(4000)).astype(np.float32)
        ours, ref = _both("signal_distortion_ratio", p, t, filter_length=128)
        assert float(ref) > 39
        _close(ours, ref, HIGH_SDR_ATOL)


@pytest.mark.parametrize("kwargs", [{}, {"load_diag": 1e-6}, {"use_cg_iter": 10}])
def test_sdr_silent_reference_like_jax(kwargs):
    """A silent reference: no error and no read back; the same inf or NaN
    as JAX's solve."""
    preds = np.random.default_rng(5).standard_normal((2, 400)).astype(np.float32)
    ours, ref = _both("signal_distortion_ratio", preds, np.zeros_like(preds), filter_length=64, **kwargs)
    ours, ref = ours.numpy(), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_array_equal(ours[np.isinf(ref)], ref[np.isinf(ref)])


def test_cg_close_to_dense():
    dense = T.signal_distortion_ratio(torch.from_numpy(PREDS), torch.from_numpy(TARGET), filter_length=128)
    cg = T.signal_distortion_ratio(torch.from_numpy(PREDS), torch.from_numpy(TARGET), filter_length=128, use_cg_iter=30)
    np.testing.assert_allclose(cg.numpy(), dense.numpy(), atol=5e-2)


def test_sdr_autocorrelation_irfft_of_a_real_spectrum():
    """JAX promotes the real power spectrum to complex before its irfft; the
    port builds that complex spectrum, and both give one autocorrelation."""
    from metrics_tpu.functional.audio import sdr as jsdr
    from metrics_tpu_torch.functional.audio import sdr as tsdr

    r_t, b_t = tsdr._compute_autocorr_crosscorr(torch.from_numpy(TARGET), torch.from_numpy(PREDS), 64)
    r_j, b_j = jsdr._compute_autocorr_crosscorr(jnp.asarray(TARGET), jnp.asarray(PREDS), 64)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=0, atol=1e-4)


def test_float64_input_computes_in_float64():
    """ROADMAP "Dtypes": float64 stays float64 here; JAX (x64 off) computes
    float32. The values agree within float32's rounding."""
    p, t = PREDS.astype(np.float64), TARGET.astype(np.float64)
    for name, kwargs in (("signal_distortion_ratio", {"filter_length": 64}), ("scale_invariant_signal_distortion_ratio", {})):
        ours, ref = _both(name, p, t, **kwargs)
        assert ours.dtype == torch.float64 and np.asarray(ref).dtype == np.float32
        _close(ours, ref, 1e-4)


def test_sdr_shape_refusal_like_jax():
    with pytest.raises(RuntimeError, match="same shape"):
        T.signal_distortion_ratio(torch.zeros(3, 10), torch.zeros(3, 11))
    with pytest.raises(RuntimeError, match="same shape"):
        J.signal_distortion_ratio(jnp.zeros((3, 10)), jnp.zeros((3, 11)))


def _si_sdr_np(est, ref):
    """SI-SDR in float64, with both packages' float32 eps terms."""
    est, ref, eps = est.astype(np.float64), ref.astype(np.float64), float(np.finfo(np.float32).eps)
    alpha = ((est * ref).sum(-1, keepdims=True) + eps) / ((ref**2).sum(-1, keepdims=True) + eps)
    noise = alpha * ref - est
    return 10 * np.log10((((alpha * ref) ** 2).sum(-1) + eps) / ((noise**2).sum(-1) + eps))


@pytest.mark.parametrize("spk", [2, 3, 4])
@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_against_brute_force_and_jax(spk, eval_func):
    rng = np.random.default_rng(3 + spk)
    p = rng.standard_normal((3, spk, 64)).astype(np.float32)
    t = rng.standard_normal((3, spk, 64)).astype(np.float32)
    best, perm = T.permutation_invariant_training(
        torch.from_numpy(p), torch.from_numpy(t), T.scale_invariant_signal_distortion_ratio, eval_func
    )
    jbest, jperm = J.permutation_invariant_training(p, t, J.scale_invariant_signal_distortion_ratio, eval_func)
    assert perm.dtype == torch.int64 and tuple(perm.shape) == (3, spk)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    _close(best, jbest, DB_ATOL, rtol=PIT_RTOL)
    pick = max if eval_func == "max" else min
    for b in range(p.shape[0]):
        scores = {pm: np.mean([_si_sdr_np(p[b, pm[j]], t[b, j]) for j in range(spk)]) for pm in itertools.permutations(range(spk))}
        best_pm = pick(scores, key=scores.get)
        assert tuple(perm[b].tolist()) == best_pm
        np.testing.assert_allclose(float(best[b]), scores[best_pm], atol=1e-3)


@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_ties_pick_the_first_permutation_as_jax(eval_func):
    """Two equal estimates tie every permutation: the first wins, as
    ``jnp.argmax``/``jnp.argmin`` pick it."""
    p = np.random.default_rng(1).standard_normal((2, 2, 50)).astype(np.float32)
    p[:, 1] = p[:, 0]
    t = np.random.default_rng(2).standard_normal((2, 2, 50)).astype(np.float32)
    best, perm = T.permutation_invariant_training(torch.from_numpy(p), torch.from_numpy(t), T.scale_invariant_signal_distortion_ratio, eval_func)
    jbest, jperm = J.permutation_invariant_training(p, t, J.scale_invariant_signal_distortion_ratio, eval_func)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(perm.numpy(), [[0, 1], [0, 1]])
    _close(best, jbest, DB_ATOL)


@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_nan_estimate_like_jax(eval_func):
    p = np.random.default_rng(1).standard_normal((2, 3, 50)).astype(np.float32)
    p[0, 1, 3] = np.nan
    t = np.random.default_rng(2).standard_normal((2, 3, 50)).astype(np.float32)
    best, perm = T.permutation_invariant_training(torch.from_numpy(p), torch.from_numpy(t), T.scale_invariant_signal_distortion_ratio, eval_func)
    jbest, jperm = J.permutation_invariant_training(p, t, J.scale_invariant_signal_distortion_ratio, eval_func)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert np.isnan(best[0].item()) and np.isnan(np.asarray(jbest)[0])
    _close(best[1:], np.asarray(jbest)[1:], DB_ATOL)


def test_pit_denormal_scores_tie_with_zero_as_xla():
    """A metric whose permutation scores differ only by a float32 denormal:
    the compares see a tie (XLA flushes), so the first permutation wins."""
    tiny = np.float32(1e-40)

    def metric(preds, target):
        return (preds[..., 0] * target[..., 0]).to(torch.float32) if isinstance(preds, torch.Tensor) else preds[..., 0] * target[..., 0]

    p = np.array([[[0.0], [tiny]]], np.float32)
    t = np.array([[[0.0], [1.0]]], np.float32)
    _, perm = T.permutation_invariant_training(torch.from_numpy(p), torch.from_numpy(t), metric, "min")
    _, jperm = J.permutation_invariant_training(jnp.asarray(p), jnp.asarray(t), metric, "min")
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


def test_pit_errors_like_jax():
    p = torch.zeros(2, 2, 10)
    with pytest.raises(ValueError, match="eval_func"):
        T.permutation_invariant_training(p, p, T.scale_invariant_signal_distortion_ratio, "median")
    with pytest.raises(RuntimeError, match="same shape"):
        T.permutation_invariant_training(p, p[:, :1], T.scale_invariant_signal_distortion_ratio)
    with pytest.raises(ValueError, match="Inputs must be of shape"):
        T.permutation_invariant_training(torch.zeros(3), torch.zeros(3), T.scale_invariant_signal_distortion_ratio)


def test_pit_table_is_built_once_per_speakers_and_device():
    """A host-to-device copy cannot be captured: the second call reuses the
    first call's table."""
    p = torch.randn(2, 3, 20)
    T.permutation_invariant_training(p, p.flip(1), T.scale_invariant_signal_distortion_ratio)
    table = tpit._TABLES[(3, torch.device("cpu"))]
    T.permutation_invariant_training(p, p, T.scale_invariant_signal_distortion_ratio)
    assert tpit._TABLES[(3, torch.device("cpu"))] is table
    np.testing.assert_array_equal(table.numpy(), list(itertools.permutations(range(3))))


def test_pit_permutate_against_jax():
    rng = np.random.default_rng(6)
    preds = rng.standard_normal((4, 3, 7)).astype(np.float32)
    perm = np.array([list(pm) for pm in itertools.permutations(range(3))][:4])
    ours = T.pit_permutate(torch.from_numpy(preds), torch.from_numpy(perm))
    ref = J.pit_permutate(jnp.asarray(preds), jnp.asarray(perm))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    _, best_perm = T.permutation_invariant_training(torch.from_numpy(preds[:, ::-1].copy()), torch.from_numpy(preds), T.scale_invariant_signal_distortion_ratio)
    np.testing.assert_array_equal(T.pit_permutate(torch.from_numpy(preds[:, ::-1].copy()), best_perm).numpy(), preds)


# -- native STOI -------------------------------------------------------------


def _speechlike(seconds, fs, seed, snr_db):
    """Harmonics under a syllabic envelope with a near-silent gap (the VAD
    drops it), and noise at ``snr_db``."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    clean = np.zeros_like(t)
    for f0, a in ((110, 1.0), (220, 0.6), (440, 0.4), (880, 0.2)):
        clean += a * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
    clean *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    clean[int(0.4 * len(t)):int(0.45 * len(t))] *= 1e-4
    noise = rng.standard_normal(len(t))
    noise *= np.linalg.norm(clean) / (np.linalg.norm(noise) * 10 ** (snr_db / 20))
    return clean.astype(np.float32), (clean + noise).astype(np.float32)


@pytest.mark.parametrize("fs", [10_000, 8_000, 16_000])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("vad", [True, False])
def test_native_stoi_against_jax(fs, extended, vad):
    clean, noisy = _speechlike(1.0, fs, 3, 5)
    ours = tstoi.stoi_on_device(noisy, clean, fs=fs, extended=extended, vad=vad, device="cpu")
    ref = jstoi.stoi_on_device(noisy, clean, fs=fs, extended=extended, vad=vad)
    assert ours.dtype == torch.float32 and ours.shape == ()
    _close(ours, ref, STOI_ATOL)


def test_native_stoi_batch_of_tensors_against_jax():
    pairs = [_speechlike(1.0, 10_000, s, 8) for s in range(3)]
    clean = np.stack([c for c, _ in pairs]).reshape(3, 1, -1)
    noisy = np.stack([n for _, n in pairs]).reshape(3, 1, -1)
    ours = T.short_time_objective_intelligibility(
        torch.from_numpy(noisy), torch.from_numpy(clean), 10_000, use_device_implementation=True, device="cpu"
    )
    ref = J.short_time_objective_intelligibility(noisy, clean, 10_000, use_device_implementation=True)
    assert tuple(ours.shape) == (3, 1)
    _close(ours, ref, STOI_ATOL)


def test_native_stoi_short_clip_sentinel_like_jax():
    x = np.random.default_rng(0).standard_normal(500).astype(np.float32)
    ours = tstoi.stoi_on_device(x, x, fs=10_000, device="cpu")
    assert float(ours) == float(jstoi.stoi_on_device(x, x, fs=10_000)) == pytest.approx(1e-5)


def test_third_octave_matrix_and_vad_frames_equal_jax():
    np.testing.assert_array_equal(tstoi.third_octave_matrix(), jstoi.third_octave_matrix())
    clean, noisy = _speechlike(0.8, 10_000, 5, 10)
    for a, b in zip(tstoi.remove_silent_frames(clean, noisy), jstoi.remove_silent_frames(clean, noisy)):
        np.testing.assert_array_equal(a, b)


def test_stoi_core_is_differentiable():
    clean, noisy = _speechlike(0.6, 10_000, 6, 0)
    y = torch.from_numpy(noisy).requires_grad_(True)
    tstoi.stoi_core(torch.from_numpy(clean), y).backward()
    assert y.grad.shape == y.shape and bool(torch.isfinite(y.grad).all()) and float(y.grad.abs().max()) > 0


def test_native_stoi_shape_refusal_like_jax():
    with pytest.raises(ValueError, match="same shape"):
        tstoi.stoi_on_device(np.zeros(3000, np.float32), np.zeros(2999, np.float32), device="cpu")
    with pytest.raises(RuntimeError, match="same shape"):
        T.short_time_objective_intelligibility(torch.zeros(3000), torch.zeros(2999), 10_000, use_device_implementation=True, device="cpu")


# -- the gated wrappers --------------------------------------------------------


def _refusal(fn, *args, **kwargs):
    with pytest.raises(ModuleNotFoundError) as info:
        fn(*args, **kwargs)
    return str(info.value)


def test_gated_wrappers_refuse_as_jax_without_their_packages():
    from metrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE, _PYSTOI_AVAILABLE

    assert not _PESQ_AVAILABLE and not _PYSTOI_AVAILABLE
    x = np.random.default_rng(0).standard_normal(8000).astype(np.float32)
    assert _refusal(T.perceptual_evaluation_speech_quality, torch.from_numpy(x), torch.from_numpy(x), 16000, "wb", device="cpu") == _refusal(
        J.perceptual_evaluation_speech_quality, x, x, 16000, "wb")
    assert _refusal(T.short_time_objective_intelligibility, torch.from_numpy(x), torch.from_numpy(x), 16000, device="cpu") == _refusal(
        J.short_time_objective_intelligibility, x, x, 16000)


@pytest.fixture()
def stand_in_backends(monkeypatch):
    """The JAX tests' stand-in ``pesq`` (and a ``pystoi`` alike), injected into
    both packages: each clip scores a fingerprint of its own samples, so the
    order of clips, the reshape and the arguments show."""
    calls = []

    def fake_pesq(fs, ref, deg, mode):
        calls.append(("pesq", fs, mode, ref.shape, deg.shape))
        return float(deg.mean()) + (1.0 if mode == "wb" else 2.0)

    def fake_stoi(ref, deg, fs, extended):
        calls.append(("stoi", fs, extended, ref.shape, deg.shape))
        return float(deg.mean() - ref.mean()) + (3.0 if extended else 4.0)

    pesq_mod, stoi_mod = types.ModuleType("pesq"), types.ModuleType("pystoi")
    pesq_mod.pesq, stoi_mod.stoi = fake_pesq, fake_stoi
    monkeypatch.setitem(sys.modules, "pesq", pesq_mod)
    monkeypatch.setitem(sys.modules, "pystoi", stoi_mod)
    import metrics_tpu.audio.pesq as jm_pesq
    import metrics_tpu.audio.stoi as jm_stoi
    import metrics_tpu.functional.audio.pesq as jf_pesq
    import metrics_tpu.functional.audio.stoi as jf_stoi
    import metrics_tpu_torch.audio.pesq as tm_pesq
    import metrics_tpu_torch.audio.stoi as tm_stoi

    tf_pesq = sys.modules["metrics_tpu_torch.functional.audio.pesq"]
    tf_stoi = sys.modules["metrics_tpu_torch.functional.audio.stoi"]
    for mod in (jm_pesq, jf_pesq, tm_pesq, tf_pesq):
        monkeypatch.setattr(mod, "_PESQ_AVAILABLE", True)
    for mod in (jm_stoi, jf_stoi, tm_stoi, tf_stoi):
        monkeypatch.setattr(mod, "_PYSTOI_AVAILABLE", True)
    return calls


@pytest.mark.parametrize(("name", "args"), [("perceptual_evaluation_speech_quality", (16000, "wb")), ("short_time_objective_intelligibility", (16000, True))])
def test_gated_wrappers_batch_as_jax_through_the_stand_in(stand_in_backends, name, args):
    rng = np.random.default_rng(0)
    preds = rng.normal(size=(2, 3, 800)).astype(np.float32)
    target = rng.normal(size=(2, 3, 800)).astype(np.float32)
    ours = getattr(T, name)(torch.from_numpy(preds), torch.from_numpy(target), *args, device="cpu")
    ours_calls = list(stand_in_backends)
    stand_in_backends.clear()
    ref = getattr(J, name)(jnp.asarray(preds), jnp.asarray(target), *args)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (2, 3)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert ours_calls == stand_in_backends and len(ours_calls) == 6


def test_gated_wrappers_single_clip_and_validation_as_jax(stand_in_backends):
    x = np.full(640, 0.25, np.float32)
    ours = T.perceptual_evaluation_speech_quality(torch.from_numpy(x), torch.from_numpy(x), 8000, "nb", device="cpu")
    assert ours.shape == () and float(ours) == float(J.perceptual_evaluation_speech_quality(x, x, 8000, "nb"))
    ours = T.short_time_objective_intelligibility(torch.from_numpy(x), torch.from_numpy(x), 8000, device="cpu")
    assert ours.shape == () and float(ours) == float(J.short_time_objective_intelligibility(x, x, 8000))
    y = torch.ones(100)
    for fn, args, exc, match in (
        (T.perceptual_evaluation_speech_quality, (y, y, 44100, "wb"), ValueError, "fs"),
        (T.perceptual_evaluation_speech_quality, (y, y, 16000, "ultra"), ValueError, "mode"),
        (T.perceptual_evaluation_speech_quality, (y, torch.ones(90), 16000, "wb"), RuntimeError, "same shape"),
        (T.short_time_objective_intelligibility, (y, torch.ones(90), 16000), RuntimeError, "same shape"),
    ):
        with pytest.raises(exc, match=match):
            fn(*args, device="cpu")


def test_cusolver_linalg_is_counted_and_restores_the_backend(monkeypatch):
    """The dense solve's backend block (D65) nests and crosses threads as
    ``full_float32`` does: the caller's backend comes back when the last
    block open ends. (This PyTorch has no cuSOLVER: the setting is stood
    in by a recorder.)"""
    import threading

    from metrics_tpu_torch.utilities.compute import cusolver_linalg

    setting = ["default"]

    def preferred(backend=None):
        if backend is not None:
            setting[0] = backend
        return setting[0]

    monkeypatch.setattr(torch.backends.cuda, "preferred_linalg_library", preferred)
    inside, release = threading.Event(), threading.Event()

    def other():
        with cusolver_linalg():
            inside.set()
            release.wait(5)

    th = threading.Thread(target=other, daemon=True)
    with cusolver_linalg():
        th.start()
        assert inside.wait(5)
        assert setting[0] == "cusolver"
    assert setting[0] == "cusolver"  # the thread's block is still open
    release.set()
    th.join(5)
    assert not th.is_alive()
    assert setting[0] == "default"
    # the CPU's solve never enters the block
    T.signal_distortion_ratio(torch.from_numpy(PREDS), torch.from_numpy(TARGET), filter_length=32)
    assert setting == ["default"]
