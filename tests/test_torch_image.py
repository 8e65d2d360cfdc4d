"""The image metric classes of the port (``metrics_tpu_torch/image/``)
against JAX's, on the same seeded numpy inputs, in every mode: the
accumulate mode, ``streaming=True`` (with ``valid`` masks) and
``capacity=`` rings, with ``reset``, ``reset_real_features=False``,
``state_dict`` and a JAX state carried over through ``interop``.

Tolerances: image lists, ring masks, ring counts, KID/IS subsets and
permutations exact; streaming sums and values ``rtol=1e-5``/``atol=1e-5``
(W6); FID ``rtol=1e-4`` against JAX, KID and IS ``rtol=1e-5``.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.image.extractor import TinyImageEncoder as JaxEncoder  # noqa: E402
from metrics_tpu.image.extractor import perceptual_distance as jax_perceptual_distance  # noqa: E402
from metrics_tpu.ops import ascending_order as jax_ascending_order  # noqa: E402
from metrics_tpu.ops import inverse_permutation as jax_inverse_permutation  # noqa: E402
from metrics_tpu_torch._capture import UpdateGraphs  # noqa: E402
from metrics_tpu_torch.image import TinyImageEncoder, perceptual_distance  # noqa: E402
from metrics_tpu_torch.interop import load_jax_state  # noqa: E402
from tests.helpers.torch_twins import assert_states_close  # noqa: E402

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _images(shape, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    p = rng.random(shape).astype(np.float32)
    return p, np.clip(p + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)


def _value(x):
    return tuple(np.asarray(v, np.float64) for v in x) if isinstance(x, tuple) else np.asarray(x, np.float64)


def _values_close(got, want, rtol=1e-5, atol=1e-5):
    got, want = _value(got), _value(want)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _stand_in_capture(metric):
    """A capture step that runs the body eagerly, so that a CPU metric goes
    through ``_capture.py``'s table (eager, capture, replays)."""
    object.__setattr__(metric, "_update_graphs", UpdateGraphs(capture=lambda run, pool: run))
    return metric.__dict__["_update_graphs"]


STREAMABLE = {
    "ssim": ("StructuralSimilarityIndexMeasure", {"data_range": 1.0}, (3, 2, 32, 32)),
    "ssim_box": ("StructuralSimilarityIndexMeasure", {"data_range": 1.0, "gaussian_kernel": False, "reduction": "sum"}, (3, 2, 32, 32)),
    "ms_ssim": ("MultiScaleStructuralSimilarityIndexMeasure", {"data_range": 1.0, "betas": (0.5, 0.5)}, (2, 1, 48, 48)),
    "uqi": ("UniversalImageQualityIndex", {"data_range": 1.0}, (3, 2, 24, 24)),
    "ergas": ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 2}, (3, 4, 12, 12)),
    "sam": ("SpectralAngleMapper", {}, (3, 4, 12, 12)),
}


def _batches(shape, seed, n=3):
    out = []
    for i in range(n):
        p, t = _images(shape, seed + i)
        out.append((p + 0.05, t + 0.05))
    return out


@pytest.mark.parametrize("key", sorted(STREAMABLE))
@pytest.mark.parametrize("streaming", [False, True])
def test_streamable_metrics_against_jax(key, streaming):
    name, kw, shape = STREAMABLE[key]
    tm = getattr(mtt, name)(streaming=streaming, device="cpu", **kw)
    jm = getattr(mt, name)(streaming=streaming, **kw)
    for p, t in _batches(shape, 20):
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
        jm.update(jnp.asarray(p), jnp.asarray(t))
        assert_states_close(tm.metric_state, jm.metric_state, **TOL)
    _values_close(tm.compute(), jm.compute())


@pytest.mark.parametrize("key", sorted(STREAMABLE))
def test_streaming_valid_masks_against_jax(key):
    name, kw, shape = STREAMABLE[key]
    tm = getattr(mtt, name)(streaming=True, device="cpu", **kw)
    jm = getattr(mt, name)(streaming=True, **kw)
    for i, (p, t) in enumerate(_batches(shape, 30)):
        valid = np.arange(shape[0]) != i % shape[0]
        p[~valid] = np.nan  # a masked image's NaN never reaches the sums
        tm.update(torch.from_numpy(p), torch.from_numpy(t), valid=torch.from_numpy(valid))
        jm.update(jnp.asarray(p), jnp.asarray(t), valid=jnp.asarray(valid))
    assert_states_close(tm.metric_state, jm.metric_state, **TOL)
    assert np.isfinite(float(tm.compute()))
    _values_close(tm.compute(), jm.compute())
    acc = getattr(mtt, name)(device="cpu", **kw)
    with pytest.raises(ValueError, match="streaming mode"):
        acc.update(torch.from_numpy(p), torch.from_numpy(t), valid=torch.from_numpy(valid))


@pytest.mark.parametrize("key", ["ssim", "ms_ssim", "uqi", "ergas", "sam"])
def test_streaming_equals_accumulate_and_captures(key):
    """The streaming sums give the accumulate mode's value; the streaming
    update goes through the capture table (eager, capture, replays)."""
    name, kw, shape = STREAMABLE[key]
    stream = getattr(mtt, name)(streaming=True, device="cpu", **kw)
    table = _stand_in_capture(stream)
    acc = getattr(mtt, name)(device="cpu", **kw)
    for p, t in _batches(shape, 40, n=4):
        stream.update(torch.from_numpy(p), torch.from_numpy(t))
        acc.update(torch.from_numpy(p), torch.from_numpy(t))
    assert (table.eager_updates, table.captures, table.replays) == (1, 1, 3)
    _values_close(stream.compute(), acc.compute(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["StructuralSimilarityIndexMeasure", "MultiScaleStructuralSimilarityIndexMeasure", "UniversalImageQualityIndex"])
def test_streaming_refusals_match_jax(name):
    for kw in ({"streaming": True}, {"streaming": True, "data_range": 1.0, "reduction": "none"}):
        with pytest.raises(ValueError):
            getattr(mt, name)(**kw)
        with pytest.raises(ValueError):
            getattr(mtt, name)(device="cpu", **kw)


@pytest.mark.parametrize("kw", [{}, {"return_full_image": True}, {"return_contrast_sensitivity": True, "reduction": "none"}])
def test_ssim_accumulate_options_against_jax(kw):
    tm = mtt.StructuralSimilarityIndexMeasure(device="cpu", **kw)
    jm = mt.StructuralSimilarityIndexMeasure(**kw)
    for p, t in _batches((2, 1, 24, 24), 50):
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
        jm.update(jnp.asarray(p), jnp.asarray(t))
    _values_close(tm.compute(), jm.compute())


@pytest.mark.parametrize("p_norm,reduction", [(1, "elementwise_mean"), (2, "sum"), (3, "none")])
def test_d_lambda_against_jax(p_norm, reduction):
    tm = mtt.SpectralDistortionIndex(p=p_norm, reduction=reduction, device="cpu")
    jm = mt.SpectralDistortionIndex(p=p_norm, reduction=reduction)
    for p, t in _batches((2, 3, 16, 16), 60):
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
        jm.update(jnp.asarray(p), jnp.asarray(t))
    assert_states_close(tm.metric_state, jm.metric_state)
    _values_close(tm.compute(), jm.compute())
    with pytest.raises(ValueError):
        mtt.SpectralDistortionIndex(p=0, device="cpu")
    with pytest.raises(ValueError):
        mtt.SpectralDistortionIndex(reduction="max", device="cpu")


@pytest.mark.parametrize(
    "kw", [{}, {"data_range": 1.0}, {"base": 2.0}, {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, {"data_range": 1.0, "dim": 1, "reduction": "sum"}],
    ids=["infer_range", "data_range", "base2", "dim_none", "dim1_sum"],
)
def test_psnr_against_jax(kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = mtt.PeakSignalNoiseRatio(device="cpu", **kw)
        jm = mt.PeakSignalNoiseRatio(**kw)
    for p, t in _batches((2, 3, 8, 8), 70):
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
        jm.update(jnp.asarray(p), jnp.asarray(t))
        # the count is int64 in the port, int32 in JAX (D48): equal values
        assert_states_close(tm.metric_state, jm.metric_state, check_dtype=False, **TOL)
    _values_close(tm.compute(), jm.compute())


def test_psnr_count_past_2_31_pixels_d48():
    """D48: the port's int64 count goes past 2^31 pixels, where JAX's int32
    count wraps negative (a reference-side fault, ROADMAP F8)."""
    start = {"sum_squared_error": np.float32(2.0 ** 27), "total": 2**31 - 100}
    tm = mtt.PeakSignalNoiseRatio(data_range=1.0, device="cpu")
    tm.load_state_dict({k: torch.tensor(v) for k, v in start.items()})
    jm = mt.PeakSignalNoiseRatio(data_range=1.0)
    load = getattr(jm, "load_state_dict")
    load({"sum_squared_error": jnp.asarray(start["sum_squared_error"]), "total": jnp.asarray(start["total"], jnp.int32)})
    p, t = _images((1, 3, 16, 16), 71)
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    jm.update(jnp.asarray(p), jnp.asarray(t))
    assert int(tm.total) == 2**31 - 100 + 768
    assert int(np.asarray(jm.metric_state["total"])) < 0
    want = 10 * np.log10(1.0 / ((2.0**27 + float(((p - t) ** 2).sum())) / (2**31 + 668)))
    np.testing.assert_allclose(float(tm.compute()), want, rtol=1e-5)


def test_psnr_captures_and_resets():
    tm = mtt.PeakSignalNoiseRatio(device="cpu")
    table = _stand_in_capture(tm)
    eager = mtt.PeakSignalNoiseRatio(device="cpu")
    for p, t in _batches((2, 3, 8, 8), 80, n=4):
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
        eager.update(torch.from_numpy(p), torch.from_numpy(t))
    assert (table.eager_updates, table.captures, table.replays) == (1, 1, 3)
    assert_states_close(tm.metric_state, eager.metric_state)
    tm.reset()
    assert int(tm.total) == 0 and float(tm.max_target) == float("-inf")


@pytest.mark.parametrize("key", ["ssim", "ergas"])
def test_state_dict_round_trip(key):
    name, kw, shape = STREAMABLE[key]
    for streaming in (False, True):
        a = getattr(mtt, name)(streaming=streaming, device="cpu", **kw)
        for p, t in _batches(shape, 90):
            a.update(torch.from_numpy(p), torch.from_numpy(t))
        a.persistent(True)
        b = getattr(mtt, name)(streaming=streaming, device="cpu", **kw)
        b.load_state_dict(a.state_dict())
        _values_close(b.compute(), a.compute(), rtol=0, atol=0)
        a.reset()
        assert all((len(v) == 0) if isinstance(v, list) else float(v) == 0.0 for v in a.metric_state.values())


# -- FID, KID, IS ------------------------------------------------------------


def _features(seed, n=40, d=8, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) + shift).astype(np.float32)


def _feed_fid(tm, jm, valid=False):
    for i in range(3):
        f = _features(100 + i, n=12)
        real = i != 1
        kw_t, kw_j = {}, {}
        if valid:
            v = np.arange(12) % 4 != i
            kw_t, kw_j = {"valid": torch.from_numpy(v)}, {"valid": jnp.asarray(v)}
        tm.update(torch.from_numpy(f + (0 if real else 0.3)), real=real, **kw_t)
        jm.update(jnp.asarray(f + (0 if real else 0.3)), real=real, **kw_j)
    f = _features(110, n=12, shift=0.3)
    tm.update(torch.from_numpy(f), real=False, **({"valid": torch.ones(12, dtype=torch.bool)} if valid else {}))
    jm.update(jnp.asarray(f), real=False, **({"valid": jnp.ones(12, bool)} if valid else {}))


@pytest.mark.parametrize("capacity", [None, 64, 20])
def test_fid_against_jax(capacity):
    tm = mtt.FrechetInceptionDistance(feature=8, capacity=capacity, device="cpu")
    jm = mt.FrechetInceptionDistance(feature=8, capacity=capacity)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _feed_fid(tm, jm, valid=capacity is not None)
        assert_states_close(tm.metric_state, jm.metric_state)
        _values_close(tm.compute(), jm.compute(), rtol=1e-4, atol=1e-5)
    if capacity == 20:
        assert tm.dropped_count == jm.dropped_count > 0
    assert tm.ladder_rung in ("newton_schulz", "newton_schulz_loaded", "nuclear_norm", "eigh")


def test_fid_capacity_update_captures_with_python_and_tensor_real():
    """A Python ``real`` keys one graph per side; a tensor ``real`` routes
    the rows by mask through one graph; both equal an eager twin."""
    ring = mtt.FrechetInceptionDistance(feature=8, capacity=64, device="cpu")
    table = _stand_in_capture(ring)
    routed = mtt.FrechetInceptionDistance(feature=8, capacity=64, device="cpu")
    routed_table = _stand_in_capture(routed)
    eager = mtt.FrechetInceptionDistance(feature=8, capacity=64, device="cpu")
    for i in range(6):
        f = torch.from_numpy(_features(120 + i, n=8))
        real = i % 2 == 0
        ring.update(f, real=real)
        routed.update(f, real=torch.tensor(real))
        eager.update(f, real=real)
    assert (table.eager_updates, table.captures, table.replays) == (2, 2, 4)
    assert (routed_table.eager_updates, routed_table.captures, routed_table.replays) == (1, 1, 5)
    assert_states_close(ring.metric_state, eager.metric_state)
    assert_states_close(routed.metric_state, eager.metric_state)


def test_fid_with_carried_encoder_against_jax():
    """FID through the bundled encoder, JAX's weights carried over, in both
    modes; the list mode's features bit-for-bit within float32 rounding."""
    jenc = JaxEncoder(feature_dim=16)
    tenc = TinyImageEncoder(feature_dim=16, device="cpu").load_jax_params([np.asarray(p) for p in jenc.params], np.asarray(jenc.head))
    imgs = np.random.default_rng(130).integers(0, 256, (10, 3, 20, 22)).astype(np.uint8)
    np.testing.assert_allclose(tenc(torch.from_numpy(imgs)).numpy(), np.asarray(jenc(jnp.asarray(imgs))), rtol=1e-5, atol=1e-6)
    for capacity in (None, 32):
        tm = mtt.FrechetInceptionDistance(feature=tenc, capacity=capacity, device="cpu")
        jm = mt.FrechetInceptionDistance(feature=jenc, capacity=capacity)
        for i, real in enumerate((True, False, True, False)):
            batch = np.roll(imgs, i, axis=0)
            tm.update(torch.from_numpy(batch), real=real)
            jm.update(jnp.asarray(batch), real=real)
        _values_close(tm.compute(), jm.compute(), rtol=1e-4, atol=1e-5)


def test_fid_reset_real_features_and_errors():
    for capacity in (None, 16):
        m = mtt.FrechetInceptionDistance(feature=4, reset_real_features=False, capacity=capacity, device="cpu")
        m.update(torch.from_numpy(_features(140, n=6, d=4)), real=True)
        m.update(torch.from_numpy(_features(141, n=6, d=4)), real=False)
        real_before = m.metric_state["real_features"]
        m.reset()
        state = m.metric_state
        if capacity is None:
            assert len(state["real_features"]) == 1 and len(state["fake_features"]) == 0
        else:
            assert int(state["real_features"].count()) == 6 and int(state["fake_features"].count()) == 0
            assert torch.equal(state["real_features"].data, real_before.data)
    m = mtt.FrechetInceptionDistance(feature=4, device="cpu")
    m.update(torch.from_numpy(_features(142, n=1, d=4)), real=True)
    m.update(torch.from_numpy(_features(143, n=5, d=4)), real=False)
    with pytest.raises(ValueError, match="More than one sample"):
        m.compute()
    with pytest.raises(TypeError):
        mtt.FrechetInceptionDistance(feature=2.5, device="cpu")
    with pytest.raises(ValueError, match="static feature width"):
        mtt.FrechetInceptionDistance(feature=lambda x: x, capacity=8, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        mtt.FrechetInceptionDistance(feature=4, device="cpu").update(torch.zeros(3, 4), real=True, valid=torch.ones(3, dtype=torch.bool))


def test_jax_capacity_fid_state_loads_through_interop():
    jm = mt.FrechetInceptionDistance(feature=8, capacity=64)
    jm.update(jnp.asarray(_features(150, n=30)), real=True)
    jm.update(jnp.asarray(_features(151, n=25, shift=0.5)), real=False)
    tm = mtt.FrechetInceptionDistance(feature=8, capacity=64, device="cpu")
    load_jax_state(tm, dict(jm.metric_state))
    assert_states_close(tm.metric_state, jm.metric_state)
    _values_close(tm.compute(), jm.compute(), rtol=1e-4, atol=1e-5)
    # and the stream goes on in the port
    tm.update(torch.from_numpy(_features(152, n=5)), real=True)
    jm.update(jnp.asarray(_features(152, n=5)), real=True)
    _values_close(tm.compute(), jm.compute(), rtol=1e-4, atol=1e-5)


def test_jax_list_states_load_through_interop():
    jk = mt.KernelInceptionDistance(feature=8, subsets=3, subset_size=10)
    jk.update(jnp.asarray(_features(153, n=20)), real=True)
    jk.update(jnp.asarray(_features(154, n=20, shift=0.4)), real=False)
    tk = mtt.KernelInceptionDistance(feature=8, subsets=3, subset_size=10, device="cpu")
    load_jax_state(tk, {k: [np.asarray(x) for x in v] for k, v in jk.metric_state.items()})
    np.random.seed(7)
    want = jk.compute()
    np.random.seed(7)
    _values_close(tk.compute(), want)


@pytest.mark.parametrize("seed", [0, 3])
def test_kid_list_mode_same_numpy_seed_same_subsets(seed):
    kw = {"feature": 8, "subsets": 5, "subset_size": 15}
    tm, jm = mtt.KernelInceptionDistance(device="cpu", **kw), mt.KernelInceptionDistance(**kw)
    for i in range(2):
        for real, shift in ((True, 0.0), (False, 0.5)):
            f = _features(160 + i + 10 * real, n=20, shift=shift)
            tm.update(torch.from_numpy(f), real=real)
            jm.update(jnp.asarray(f), real=real)
    np.random.seed(seed)
    want = jm.compute()
    np.random.seed(seed)
    _values_close(tm.compute(), want)
    with pytest.raises(ValueError, match="subset_size"):
        small = mtt.KernelInceptionDistance(feature=8, subset_size=50, device="cpu")
        small.update(torch.from_numpy(_features(1, n=10)), real=True)
        small.update(torch.from_numpy(_features(2, n=10)), real=False)
        small.compute()


def _jax_kid_indices(jm):
    """The subsets JAX's capacity mode draws (``metrics_tpu/image/kid.py:146-164``)."""
    real, fake = jm.real_features, jm.fake_features
    base = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(jm.seed), real.count()), fake.count())
    ir, if_ = [], []
    for key in jax.random.split(base, jm.subsets):
        kr, kf = jax.random.split(key)
        sr = jnp.where(real.mask, jax.random.uniform(kr, (real.capacity,)), -jnp.inf)
        sf = jnp.where(fake.mask, jax.random.uniform(kf, (fake.capacity,)), -jnp.inf)
        ir.append(np.asarray(jax.lax.top_k(sr, jm.subset_size)[1]))
        if_.append(np.asarray(jax.lax.top_k(sf, jm.subset_size)[1]))
    return np.stack(ir), np.stack(if_)


def test_kid_capacity_mode_on_jax_indices():
    kw = {"feature": 8, "subsets": 6, "subset_size": 12, "capacity": 40, "seed": 5}
    tm, jm = mtt.KernelInceptionDistance(device="cpu", **kw), mt.KernelInceptionDistance(**kw)
    for real, shift, n in ((True, 0.0, 18), (False, 0.5, 16), (True, 0.0, 10)):
        f = _features(170 + n, n=n, shift=shift)
        valid = np.arange(n) % 5 != 0
        tm.update(torch.from_numpy(f), real=real, valid=torch.from_numpy(valid))
        jm.update(jnp.asarray(f), real=real, valid=jnp.asarray(valid))
    assert_states_close(tm.metric_state, jm.metric_state)
    ir, if_ = _jax_kid_indices(jm)
    _values_close(tm.kid_from_indices(torch.from_numpy(ir), torch.from_numpy(if_)), jm.compute())
    # the port's own draw: subset_size distinct valid rows a subset, the
    # same for the same seed and counts
    r1, f1 = tm.draw_subsets()
    r2, f2 = tm.draw_subsets()
    assert torch.equal(r1, r2) and torch.equal(f1, f2)
    for idx, ring in ((r1, tm.real_features), (f1, tm.fake_features)):
        assert idx.shape == (6, 12)
        assert all(len(set(row.tolist())) == 12 for row in idx)
        assert bool(ring.mask[idx].all())
    mean, std = tm.compute()
    assert np.isfinite(float(mean)) and np.isfinite(float(std))
    with pytest.raises(ValueError, match="capacity"):
        mtt.KernelInceptionDistance(feature=8, subset_size=50, capacity=10, device="cpu")


@pytest.mark.parametrize("splits", [1, 3])
def test_inception_score_list_mode_same_numpy_seed(splits):
    tm, jm = mtt.InceptionScore(feature=10, splits=splits, device="cpu"), mt.InceptionScore(feature=10, splits=splits)
    for i in range(3):
        f = _features(180 + i, n=11, d=10) * 2
        tm.update(torch.from_numpy(f))
        jm.update(jnp.asarray(f))
    assert_states_close(tm.metric_state, jm.metric_state)
    np.random.seed(splits)
    want = jm.compute()
    np.random.seed(splits)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # one split has no std
        got = tm.compute()
    _values_close(got, want, atol=1e-6) if splits > 1 else _values_close(got[0], want[0])


def test_inception_score_capacity_mode_on_jax_ranks():
    kw = {"feature": 10, "splits": 4, "capacity": 48, "seed": 2}
    tm, jm = mtt.InceptionScore(device="cpu", **kw), mt.InceptionScore(**kw)
    for i in range(3):
        f = _features(190 + i, n=13, d=10) * 2
        valid = np.arange(13) % 6 != i
        tm.update(torch.from_numpy(f), valid=torch.from_numpy(valid))
        jm.update(jnp.asarray(f), valid=jnp.asarray(valid))
    assert_states_close(tm.metric_state, jm.metric_state)
    buf = jm.features
    key = jax.random.fold_in(jax.random.PRNGKey(jm.seed), buf.count())
    scores = jnp.where(buf.mask, jax.random.uniform(key, (buf.capacity,)), jnp.inf)
    rank = np.array(jax_inverse_permutation(jax_ascending_order(scores)))
    _values_close(tm.score_from_ranks(torch.from_numpy(rank)), jm.compute())
    # the port's own draw ranks the valid rows first, a permutation
    own = tm.draw_ranks()
    assert sorted(own.tolist()) == list(range(48))
    assert set(own[tm.features.mask].tolist()) == set(range(int(tm.features.count())))
    mean, _ = tm.compute()
    assert float(mean) >= 1.0 - 1e-5


def test_inception_score_empty_ring_and_fewer_rows_than_splits():
    tm = mtt.InceptionScore(feature=5, splits=4, capacity=8, device="cpu")
    jm = mt.InceptionScore(feature=5, splits=4, capacity=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert np.isnan(float(tm.compute()[0]))
    f = _features(200, n=2, d=5)
    tm.update(torch.from_numpy(f))
    jm.update(jnp.asarray(f))
    rank = np.array([1, 0, 2, 3, 4, 5, 6, 7], np.int32)
    got = tm.score_from_ranks(torch.from_numpy(rank))
    assert np.isfinite(float(got[0])) and np.isfinite(float(got[1]))


# -- LPIPS ------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"normalize": True}, {"reduction": "sum"}])
def test_lpips_with_carried_encoder_against_jax(kw):
    jenc = JaxEncoder(feature_dim=8)
    tenc = TinyImageEncoder(feature_dim=8, device="cpu").load_jax_params([np.asarray(p) for p in jenc.params], np.asarray(jenc.head))
    tm = mtt.LearnedPerceptualImagePatchSimilarity(net=perceptual_distance(tenc), device="cpu", **kw)
    jm = mt.LearnedPerceptualImagePatchSimilarity(net=jax_perceptual_distance(jenc), **kw)
    for i in range(2):
        a, b = _images((3, 3, 16, 16), 210 + i, noise=0.3)
        if not kw.get("normalize"):
            a, b = 2 * a - 1, 2 * b - 1
        tm.update(torch.from_numpy(a), torch.from_numpy(b))
        jm.update(jnp.asarray(a), jnp.asarray(b))
        assert_states_close(tm.metric_state, jm.metric_state, **TOL)
    _values_close(tm.compute(), jm.compute())


def test_lpips_default_nets_are_shared_and_differentiable():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = mtt.LearnedPerceptualImagePatchSimilarity(device="cpu")
        b = mtt.LearnedPerceptualImagePatchSimilarity(device="cpu")
    assert a.net is b.net
    x = torch.zeros((2, 3, 64, 64), requires_grad=True)
    y = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(0))
    a.update(x, y * 2 - 1)
    a.compute().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    with pytest.raises(ValueError, match="net_type"):
        mtt.LearnedPerceptualImagePatchSimilarity(net_type="squeeze", device="cpu")
    with pytest.raises(ValueError, match="callable"):
        mtt.LearnedPerceptualImagePatchSimilarity(net=3, device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        mtt.LearnedPerceptualImagePatchSimilarity(net=lambda p, q: p.sum(), reduction="max", device="cpu")


def test_image_package_exports_and_lazy_nets():
    import metrics_tpu_torch.image as timage

    assert timage.InceptionV3Extractor.__module__ == "metrics_tpu_torch.nets.inception_v3"
    assert timage.load_lpips_torch_state_dict.__module__ == "metrics_tpu_torch.nets.lpips_net"
    with pytest.raises(AttributeError):
        timage.NoSuchNet
