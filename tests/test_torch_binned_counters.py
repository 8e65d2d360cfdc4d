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


def test_plain_counts_past_2_24_rows_round_once():
    """F19: at 2^24 + 1 rows every count is an int64 count rounded to float32
    once, as the kernel's int32 counts are on the card (no refusal below 2^31
    rows); a NaN score is a false negative at every threshold."""
    n = (1 << 24) + 1
    rng = np.random.default_rng(19)
    preds = rng.random((n, 1), dtype=np.float32)
    preds[rng.integers(0, n, 1000), 0] = np.nan
    target = np.ones((n, 1), np.float32)
    thresholds = np.array([2.0, 0.5, -1.0], np.float32)
    got = port.binned_counter_update_plain(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    ge, pos = preds >= thresholds, target == 1
    want = [(pos & ge).sum(0, keepdims=True), (~pos & ge).sum(0, keepdims=True), (pos & ~ge).sum(0, keepdims=True)]
    assert max(int(w.max()) for w in want) > 1 << 24  # past float32's exact integers
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32), w.astype(np.int64).astype(np.float32).view(np.int32))


def _jax_tile_accumulation(preds, target, thresholds):
    """The JAX package's kernel arithmetic (``_counter_kernel``): each grid
    step's tile of ``_TILE_N`` rows adds its float32 counts (exact: at most
    ``_TILE_N``) into float32 accumulators, in grid order. Written with jnp
    over the tiles, because the kernel in interpret mode takes minutes at
    2^24 rows; held against that kernel on a small input below."""
    import jax

    from metrics_tpu.ops.binned_counters import _TILE_N

    n, c = preds.shape
    pad = (-n) % _TILE_N
    p = jnp.concatenate([jnp.asarray(preds), jnp.full((pad, c), -jnp.inf, jnp.float32)]).reshape(-1, _TILE_N, c, 1)
    t = jnp.concatenate([jnp.asarray(target), jnp.zeros((pad, c), jnp.float32)]).reshape(-1, _TILE_N, c, 1)

    @jax.jit
    def run(p, t, thr):
        ge = (p >= thr).astype(jnp.float32)
        tiles = jnp.stack([jnp.sum(t * ge, axis=1), jnp.sum((1.0 - t) * ge, axis=1), jnp.sum(t * (1.0 - ge), axis=1)], axis=1)
        acc, _ = jax.lax.scan(lambda a, x: (a + x, None), jnp.zeros(tiles.shape[1:], jnp.float32), tiles)
        return acc

    return np.asarray(run(p, t, jnp.asarray(thresholds)))


def test_d71_jax_rounds_each_tile_past_2_24_rows():
    """D71: the port rounds each exact count to float32 once; the JAX
    package's kernel adds float32 tile counts. The two are bit-equal while
    every count stays below 2^24, and past it JAX's sums drift by at most
    one per tile added (an ulp of 2 rounds half away)."""
    small = _inputs(5 * 256 + 17, 2, 3, seed=71)
    want = np.stack([np.asarray(x) for x in jax_binned(*(jnp.asarray(a) for a in small), interpret=True)])
    np.testing.assert_array_equal(_jax_tile_accumulation(*small).view(np.int32), want.view(np.int32))

    # every tile holds 255 positives above all thresholds and one below
    tiles = (1 << 16) + 1024
    preds = np.ones((tiles * 256, 1), np.float32)
    preds[::256] = -1.0
    target = np.ones_like(preds)
    thresholds = np.array([0.25, 0.5, 0.75], np.float32)
    below = ((1 << 24) // 256 - 1) * 256  # the tiles whose counts stay under 2^24
    for rows, equal in ((below, True), (tiles * 256, False)):
        p, t = preds[:rows], target[:rows]
        ours = np.stack([x.numpy() for x in port.binned_counter_update_plain(*(torch.from_numpy(a) for a in (p, t, thresholds)))])
        jax_sums = _jax_tile_accumulation(p, t, thresholds)
        exact = np.array([255, 0, 1], np.int64)[:, None, None] * (rows // 256) * np.ones((1, 1, 3), np.int64)
        np.testing.assert_array_equal(ours.view(np.int32), exact.astype(np.float32).view(np.int32))
        assert np.array_equal(jax_sums, ours) == equal
        assert np.abs(jax_sums.astype(np.int64) - exact).max() <= rows // 256


def _flat_edge_inputs(n, c, draw, seed):
    """Inputs at the edges of the kernel's flat design: ``background_heavy``
    puts 90 % of the scores in one bin (a mostly-background score map) and
    a few in no bin (NaN, below every threshold); ``on_thresholds`` draws
    every score from the thresholds themselves."""
    rng = np.random.default_rng(seed)
    thresholds = np.linspace(0, 1, 100).astype(np.float32)
    if draw == "background_heavy":
        preds = np.where(rng.random((n, c)) < 0.9, rng.random((n, c)) * 0.005, rng.random((n, c))).astype(np.float32)
        preds[rng.random((n, c)) < 0.01] = np.nan
        preds[rng.random((n, c)) < 0.01] = -0.5
    else:
        preds = thresholds[rng.integers(0, thresholds.size, (n, c))]
    target = (rng.random((n, c)) < 0.25).astype(np.float32)
    return preds, target, thresholds


@pytest.mark.parametrize("draw", ["background_heavy", "on_thresholds"])
@pytest.mark.parametrize(("n", "c"), [(4095, 1), (4097, 1), (4097, 2), (4095, 3)])
def test_plain_matches_both_jax_forms_at_the_flat_designs_edges(n, c, draw):
    """The plain version, which the card holds the flat design against bit
    for bit, is itself bit-equal to both JAX forms at few classes, ragged
    row counts (4k +- 1: the flat stream's scalar head and tail), a
    background-heavy draw and scores on the thresholds."""
    _assert_bit_equal_to_jax(*_flat_edge_inputs(n, c, draw, seed=n + 10 * c + len(draw)))


def test_flat_design_entry_points_and_variants():
    """The flat design is part of the same plain-C library: its kernel, its
    plan's exported query (which the wrapper counts launches by) and the
    variants ``tools/k1_flat_variants.py`` builds from the source, each
    substitution found exactly once."""
    import importlib.util

    from metrics_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / port.SOURCE).read_text()
    assert "binned_counters_flat_kernel" in src
    assert 'extern "C" int binned_counters_flat_plan' in src
    spec = importlib.util.spec_from_file_location("k1_flat_variants", _build.PACKAGE_DIR.parent / "tools" / "k1_flat_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in tool.VARIANTS:
        variant = tool.variant_source(name)
        assert (variant == src) == (name == "plan")
    assert port.flat_launch_count == 0  # nothing here launched a kernel
