"""The port's wire codecs (``metrics_tpu_torch/ops/quantize.py``) against the
JAX package's (``metrics_tpu/ops/quantize.py``), on the same seeded numpy
inputs, in the cases of ``tests/ops/test_quantize.py``.

- The torch codecs are bit-equal to the port's numpy twins on every input,
  denormals included, and both to the JAX package's numpy twins.
- They are bit-equal to JAX's in-graph codecs (``_int8_encode`` etc.) on
  inputs without denormals. XLA flushes denormals, torch and numpy do not:
  on denormal lanes both stay inside the documented envelope (absolute
  error below ``2**-126``).
- The error bounds, the special lanes, the exact tail, the host wire and
  the resolution rule (argument > ``METRICS_TPU_SYNC_TRANSPORT`` >
  ``exact``, a bad variable warned once).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from metrics_tpu.ops import quantize as jq  # noqa: E402
from metrics_tpu_torch.ops import quantize as tq  # noqa: E402

RNG = np.random.default_rng(71)
CODECS = {"int8": (tq.INT8_CODEC, jq.INT8_CODEC), "fp16": (tq.FP16_CODEC, jq.FP16_CODEC), "exact": (tq.EXACT_CODEC, jq.EXACT_CODEC)}


@pytest.fixture(autouse=True)
def _fresh_env(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_SYNC_TRANSPORT", raising=False)
    tq.reset_transport_env_state()
    yield
    tq.reset_transport_env_state()


def _with_specials(n):
    x = RNG.standard_normal(n).astype(np.float32) * 1e3
    if n >= 10:
        x[::7] = np.inf
        x[3::11] = -np.inf
        x[5::13] = np.nan
    return x


DISTRIBUTIONS = {
    "uniform": lambda n: RNG.random(n, dtype=np.float32) * 2 - 1,
    "tie_heavy": lambda n: RNG.integers(0, 4, n).astype(np.float32) * 0.25,
    "skew_50_decades": lambda n: (np.exp(RNG.uniform(-57, 57, n)) * np.where(RNG.random(n) < 0.5, -1, 1)).astype(np.float32),
    "normal_sorted": lambda n: np.sort(RNG.standard_normal(n).astype(np.float32)),
    "with_specials": _with_specials,
    "denormals": lambda n: RNG.random(n).astype(np.float32) * 1e-40,
}


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint8)


def _has_denormals(x):
    a = np.abs(x[np.isfinite(x)])
    return bool(((a > 0) & (a < tq.TINY_NORMAL)).any())


def _bound(codec, x, h):
    """The per-lane worst case: int8 the block's absmax / 252, fp16
    relative 2**-10 or the block's absmax * 2**-24; denormal lanes the
    collapse envelope."""
    nb = -(-h // tq.DEFAULT_BLOCK) if h else 0
    x2 = np.zeros((nb * tq.DEFAULT_BLOCK,), np.float32)
    x2[:h] = np.where(np.isfinite(x[:h]), x[:h], 0)
    absmax = np.maximum(np.abs(x2.reshape(-1, tq.DEFAULT_BLOCK)).max(axis=1), np.float32(tq.TINY_NORMAL))
    lane = np.repeat(absmax, tq.DEFAULT_BLOCK)[:h]
    base = lane / (2 * tq.MAX_CODE) if codec == "int8" else np.maximum(np.abs(x[:h]) * 2.0 ** -10, lane * 2.0 ** -24)
    return np.where(np.abs(x[:h]) < tq.TINY_NORMAL, np.float32(tq.TINY_NORMAL), base)


@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
@pytest.mark.parametrize("n,tail", [(1000, 0), (1000, 14), (257, 2), (tq.DEFAULT_BLOCK, 0)])
@pytest.mark.parametrize("codec", ["int8", "fp16"])
def test_codec_against_jax_and_the_numpy_twins(codec, dist, n, tail):
    x = DISTRIBUTIONS[dist](n)
    tc, jc = CODECS[codec]
    wire = tc.encode(torch.from_numpy(x), tail)
    assert wire.dtype == tc.wire_dtype and wire.shape[0] == tc.wire_size(n, tail) == jc.wire_size(n, tail)
    # the numpy twins: the port's and the JAX package's, on every input
    assert np.array_equal(_bits(wire.numpy()), _bits(tc.encode_np(x, tail)))
    assert np.array_equal(_bits(tc.encode_np(x, tail)), _bits(jc.encode_np(x, tail)))
    dec = tc.decode(tq.as_bytes(wire), n, tail).numpy()
    assert np.array_equal(_bits(dec), _bits(jc.decode_np(jc.encode_np(x, tail), n, tail)))
    if not _has_denormals(x):
        # JAX's in-graph codec, bit for bit
        assert np.array_equal(_bits(wire.numpy()), _bits(np.asarray(jc.encode(jnp.asarray(x), tail))))
        assert np.array_equal(_bits(dec), _bits(np.asarray(jc.decode(jc.encode(jnp.asarray(x), tail), n, tail))))
    # the special lanes keep their class, the tail its bits
    assert np.array_equal(np.isnan(dec), np.isnan(x))
    assert np.array_equal(dec == np.inf, x == np.inf) and np.array_equal(dec == -np.inf, x == -np.inf)
    if tail:
        assert np.array_equal(_bits(dec[n - tail:]), _bits(x[n - tail:]))
    h = n - tail
    fin = np.isfinite(x[:h])
    assert (np.abs(dec[:h][fin] - x[:h][fin]) <= _bound(codec, x, h)[fin] * (1 + 1e-5)).all()


def test_denormal_lanes_within_the_envelope_of_jax():
    """On denormal lanes JAX (which flushes) and the port (which does not)
    may differ; both stay within 2**-126 of the input."""
    x = RNG.random(200).astype(np.float32) * 1e-40
    for codec in ("int8", "fp16"):
        tc, jc = CODECS[codec]
        ours = tc.decode(tc.encode(torch.from_numpy(x)), 200).numpy()
        theirs = np.asarray(jc.decode(jc.encode(jnp.asarray(x)), 200))
        assert (np.abs(ours - x) < tq.TINY_NORMAL).all() and (np.abs(theirs - x) < tq.TINY_NORMAL).all()


@pytest.mark.parametrize("n,tail", [(0, 0), (1, 0), (3, 3), (1000, 7)])
def test_empty_and_short_payloads(n, tail):
    x = _with_specials(n) if n >= 10 else RNG.standard_normal(n).astype(np.float32)
    for tc, jc in CODECS.values():
        wire = tc.encode(torch.from_numpy(x), tail)
        assert np.array_equal(_bits(wire.numpy()), _bits(np.asarray(jc.encode(jnp.asarray(x), tail))))
        dec = tc.decode(wire, n, tail).numpy()
        assert np.array_equal(_bits(dec), _bits(np.asarray(jc.decode(jc.encode(jnp.asarray(x), tail), n, tail))))


def test_exact_codec_is_the_identity():
    x = _with_specials(333)
    wire = tq.EXACT_CODEC.encode(torch.from_numpy(x))
    assert wire.dtype == torch.float32 and np.array_equal(_bits(wire.numpy()), _bits(x))
    assert np.array_equal(_bits(tq.EXACT_CODEC.decode(tq.as_bytes(wire), 333).numpy()), _bits(x))


def test_zero_and_single_value_blocks():
    for codec in (tq.INT8_CODEC, tq.FP16_CODEC):
        assert torch.equal(codec.decode(codec.encode(torch.zeros(100)), 100), torch.zeros(100))
    for v in (127.375, -3.0, 1e30, 1e-30):
        dec = float(tq.INT8_CODEC.decode(tq.INT8_CODEC.encode(torch.tensor([v])), 1)[0])
        assert abs(dec - np.float32(v)) <= 2 * abs(np.float32(v)) * 2.0 ** -23, v


def test_wire_bytes_shrink_and_match_jax():
    n = 1 << 16
    assert tq.EXACT_CODEC.wire_bytes(n) / tq.INT8_CODEC.wire_bytes(n) >= 3.5
    assert tq.EXACT_CODEC.wire_bytes(n) / tq.FP16_CODEC.wire_bytes(n) >= 1.8
    for tc, jc in CODECS.values():
        assert tc.wire_bytes(n, 12) == jc.wire_bytes(n, 12)


def test_resolution_rule(monkeypatch):
    assert tq.resolve_codec().name == "exact"
    monkeypatch.setenv("METRICS_TPU_SYNC_TRANSPORT", "int8")
    tq.reset_transport_env_state()
    assert tq.resolve_codec().name == "int8"
    assert tq.resolve_codec("fp16").name == "fp16"  # the argument wins
    with pytest.raises(ValueError, match="sync_transport"):
        tq.validate_transport("int4")
    assert tq.validate_transport(None) is None


def test_bad_env_var_warns_once_and_keeps_exact(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_TRANSPORT", "int4")
    tq.reset_transport_env_state()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert tq.resolve_codec().name == "exact"
        assert tq.resolve_codec().name == "exact"
    assert sum("int4" in str(w.message) for w in rec) == 1


@pytest.mark.parametrize("codec", ["int8", "fp16", "exact"])
def test_host_wire_bit_equal_to_jax(codec):
    """``encode_leaf``/``decode_leaf`` (torch, on the tensor's device) and
    ``host_encode``/``host_decode`` (numpy) make the JAX package's host
    wire, bit for bit."""
    tc, jc = CODECS[codec]
    x = _with_specials(500)
    want = jq.host_encode(x, jc)
    assert np.array_equal(_bits(tq.host_encode(x, tc)), _bits(want))
    assert np.array_equal(_bits(tq.encode_leaf(torch.from_numpy(x), tc).numpy()), _bits(want))
    dec = tq.decode_leaf(tq.as_bytes(tq.encode_leaf(torch.from_numpy(x), tc)), tc).numpy()
    assert np.array_equal(_bits(dec), _bits(jq.host_decode(want, jc)))
    assert np.array_equal(_bits(tq.host_decode(want, tc)), _bits(dec))


def test_wrapped_gather_quantizes_float_and_bypasses_the_rest():
    shipped = []

    def gather(x, group=None):
        shipped.append(x)
        return [x, x]

    wrapped = tq.wrap_gather_transport(gather, tq.INT8_CODEC)
    big = torch.from_numpy(RNG.standard_normal((1024, 4)).astype(np.float32))
    rows = wrapped(big)
    assert shipped[-1].dtype == torch.uint8 and shipped[-1].numel() < big.numel() * 4 / 3
    assert len(rows) == 2 and rows[0].shape == big.shape and rows[0].dtype == big.dtype
    assert float((rows[0] - big).abs().max()) <= float(big.abs().max()) / (2 * tq.MAX_CODE)
    counts = torch.from_numpy(RNG.integers(0, 1000, 512))
    rows = wrapped(counts)
    assert shipped[-1] is counts and torch.equal(rows[0], counts)
    small = torch.from_numpy(RNG.standard_normal(tq.MIN_HOST_QUANTIZE_SIZE - 1).astype(np.float32))
    rows = wrapped(small)
    assert shipped[-1] is small and torch.equal(rows[0], small)


def test_wrapped_gather_decodes_ragged_rows():
    def gather(x, group=None):
        return [x, tq.as_bytes(tq.encode_leaf(torch.arange(7, dtype=torch.float32), tq.INT8_CODEC))]

    rows = tq.wrap_gather_transport(gather, tq.INT8_CODEC)(torch.linspace(0, 1, 300))
    assert rows[0].shape == (300,) and rows[1].shape == (7,)


def test_exact_wrap_is_the_gather_itself():
    gather = lambda x, group=None: [x]  # noqa: E731
    assert tq.wrap_gather_transport(gather, tq.EXACT_CODEC) is gather
