"""The streaming-sketch slice of the port against the JAX package, on the
same seeded numpy inputs.

``QuantileSketch`` twins run interleaved ``update`` and ``forward`` calls;
JAX runs once with its default (XLA) fold and once with the Pallas fold in
interpret mode. After every call the sketch states are bit-equal (items,
counts, n_seen) and each value is exact: the quantiles are selected items,
and the cumulative weights are sums of powers of two, exact below 2^24.
CountMin counters are int64 in the port and uint32 in JAX, compared by
value; HyperLogLog registers are bit-equal and its estimate holds to
``rtol=1e-6`` (a float32 sum over the registers, added in another order).

Hashing ``-0.0`` and denormals: the port hashes them as ``+0.0``, as JAX's
``_hash_keys`` does when it runs op by op (its ``x + 0.0``). Inside the JAX
metric's jitted update XLA drops that addition, so there they hash by their
own bits. The metric twins of CountMin and HyperLogLog therefore stream
no ``-0.0`` and no denormal; the state-level twins, run op by op in JAX,
do."""
import pickle
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.ops import dispatch as kdispatch  # noqa: E402
from metrics_tpu_torch.interop import load_jax_state  # noqa: E402
from metrics_tpu_torch.streaming import sketches  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402

HLL_RTOL = 1e-6  # float32 sum over the registers, added in another order
GEOMETRY = dict(eps=0.1, k=64, levels=7)
QUANTILES = (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    a = _np(x)
    return a.reshape(-1).view(np.uint8)


def assert_sketch_equal(ours, ref):
    """Field by field: the same names, the same values; the same dtype,
    except the CountMin counters (int64 here, uint32 in JAX)."""
    assert type(ours).__name__ == type(ref).__name__ and ours._fields == ref._fields
    for name, o, r in zip(ours._fields, ours, ref):
        o, r = _np(o), np.asarray(r)
        assert o.shape == r.shape, name
        if name == "counts" and r.dtype == np.uint32:
            assert o.dtype == np.int64
            np.testing.assert_array_equal(o, r.astype(np.int64))
        else:
            assert o.dtype == r.dtype, name
            np.testing.assert_array_equal(o.reshape(-1).view(np.uint8), r.reshape(-1).view(np.uint8), err_msg=name)


def _stream(seed, sizes):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        x = rng.lognormal(size=n).astype(np.float32)
        pick = rng.random(n)
        x[pick < 0.02] = np.nan
        x[(pick >= 0.02) & (pick < 0.03)] = np.inf
        x[(pick >= 0.03) & (pick < 0.04)] = -np.inf
        x[(pick >= 0.04) & (pick < 0.06)] = -0.0
        x[(pick >= 0.06) & (pick < 0.07)] = np.float32(1e-40)
        x[(pick >= 0.07) & (pick < 0.2)] = np.round(x[(pick >= 0.07) & (pick < 0.2)], 1)
        out.append(x)
    return out


SIZES = [50, 7, 300, 64, 1, 2000, 0, 129, 4096, 33]


def run_twins(ours, ref, batches, forward_every=3, value_exact=True):
    """Interleave update and forward on both twins; compare after each call."""
    for i, x in enumerate(batches):
        if i % forward_every == 0:
            got = ours(torch.from_numpy(x))
            want = ref(jnp.asarray(x))
            np.testing.assert_array_equal(_np(got), np.asarray(want)) if value_exact else None
        else:
            ours.update(torch.from_numpy(x))
            ref.update(jnp.asarray(x))
        assert_sketch_equal(ours.metric_state["sketch"], ref.metric_state["sketch"])
    return ours.compute(), ref.compute()


@pytest.mark.parametrize("fold", ["xla", "pallas-interpret"])
def test_quantile_sketch_twins(fold):
    with kdispatch.kernel_override(compactor_fold=fold):
        ref = mt.QuantileSketch(quantiles=QUANTILES, **GEOMETRY)
        ours = mtt.QuantileSketch(quantiles=QUANTILES, device="cpu", **GEOMETRY)
        got, want = run_twins(ours, ref, _stream(1, SIZES))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    rng = np.random.default_rng(2)
    st, jst = ours.metric_state["sketch"], ref.metric_state["sketch"]
    for v in rng.lognormal(size=5).astype(np.float32):
        np.testing.assert_array_equal(_np(st.rank(float(v))), np.asarray(jst.rank(float(v))))
    pts = np.sort(rng.lognormal(size=9).astype(np.float32))
    np.testing.assert_allclose(_np(st.cdf(torch.from_numpy(pts))), np.asarray(jst.cdf(jnp.asarray(pts))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(ours.quantile([0.25, 0.75])), np.asarray(ref.quantile(jnp.asarray([0.25, 0.75]))))
    assert st.eps_bound == jst.eps_bound


def test_default_geometry_matches_jax():
    for kwargs in [{}, dict(eps=0.05, max_items=4096), dict(eps=0.3, max_items=10), dict(k=13, levels=3)]:
        ours = sketches.QuantileSketchState.create(device="cpu", **kwargs)
        ref = mt.QuantileSketchState.create(**kwargs)
        assert_sketch_equal(ours, ref)
    assert tuple(sketches.QuantileSketchState.create(device="cpu").items.shape) == (20, 6600)


def test_sketch_merge_commutative_and_matches_jax():
    a_np, b_np = _stream(3, [3000, 500])
    st_a = sketches.QuantileSketchState.create(device="cpu", **GEOMETRY)
    st_b = sketches.QuantileSketchState.create(device="cpu", **GEOMETRY)
    j_a = mt.QuantileSketchState.create(**GEOMETRY)
    j_b = mt.QuantileSketchState.create(**GEOMETRY)
    for x in _stream(4, [700, 90, 1500]):
        st_a, j_a = st_a.insert(torch.from_numpy(x)), j_a.insert(jnp.asarray(x))
    st_b, j_b = st_b.insert(torch.from_numpy(b_np)), j_b.insert(jnp.asarray(b_np))
    st_b, j_b = st_b.insert(torch.from_numpy(a_np)), j_b.insert(jnp.asarray(a_np))
    ab, ba = st_a.sketch_merge(st_b), st_b.sketch_merge(st_a)
    assert_sketch_equal(ab, j_a.sketch_merge(j_b))
    for o, r in zip(ab, ba):
        np.testing.assert_array_equal(_bits(o), _bits(r))
    with pytest.raises(ValueError, match="same eps/k/levels"):
        st_a.sketch_merge(sketches.QuantileSketchState.create(device="cpu", k=16, levels=6))


@pytest.mark.parametrize("fill", [[], [700, 90], [5000, 3000, 20000]])
def test_merge_with_an_empty_sketch_matches_jax_both_ways(fill):
    """Merging with an empty sketch, on either side, through the merge
    cascade: bit-equal to JAX's merge, and the same either way round."""
    st, jst = sketches.QuantileSketchState.create(device="cpu", **GEOMETRY), mt.QuantileSketchState.create(**GEOMETRY)
    for x in _stream(7, fill):
        st, jst = st.insert(torch.from_numpy(x)), jst.insert(jnp.asarray(x))
    empty, jempty = sketches.QuantileSketchState.create(device="cpu", **GEOMETRY), mt.QuantileSketchState.create(**GEOMETRY)
    assert_sketch_equal(st.sketch_merge(empty), jst.sketch_merge(jempty))
    assert_sketch_equal(empty.sketch_merge(st), jempty.sketch_merge(jst))
    for o, r in zip(st.sketch_merge(empty), empty.sketch_merge(st)):
        np.testing.assert_array_equal(_bits(o), _bits(r))


def test_saturated_top_level_matches_jax():
    """A geometry far below the stream's size: the cascade reaches the top
    level, which absorbs and saturates at k, on insert and on merge."""
    geometry = dict(k=8, levels=3)
    st, jst = sketches.QuantileSketchState.create(device="cpu", **geometry), mt.QuantileSketchState.create(**geometry)
    other, jother = sketches.QuantileSketchState.create(device="cpu", **geometry), mt.QuantileSketchState.create(**geometry)
    for i, x in enumerate(_stream(8, [8, 7, 8, 8, 5, 8, 8, 8, 6, 8, 8, 8])):
        st, jst = st.insert(torch.from_numpy(x)), jst.insert(jnp.asarray(x))
        if i % 2:
            other, jother = other.insert(torch.from_numpy(x)), jother.insert(jnp.asarray(x))
        assert_sketch_equal(st, jst)
    assert int(st.counts[-1]) == 8
    assert_sketch_equal(st.sketch_merge(other), jst.sketch_merge(jother))
    assert_sketch_equal(other.sketch_merge(st), jother.sketch_merge(jst))


def test_oversized_batch_is_split():
    """A batch that would promote past the top level is split, as in JAX,
    and no row is lost."""
    x = _stream(5, [1000])[0]
    ours = mtt.QuantileSketch(k=8, levels=4, quantiles=(0.5,), on_overflow="ignore", device="cpu")
    ref = mt.QuantileSketch(k=8, levels=4, quantiles=(0.5,), on_overflow="ignore")
    ours.update(torch.from_numpy(x))
    ref.update(jnp.asarray(x))
    assert_sketch_equal(ours.metric_state["sketch"], ref.metric_state["sketch"])
    assert int(ours.metric_state["sketch"].n_seen) == int(np.isfinite(x).sum())
    np.testing.assert_array_equal(_np(ours.compute()), np.asarray(ref.compute()))


def test_split_batches_then_merge_match_jax():
    """Batches that split past the top level, on two sketches, then merged
    both ways: every chunk is one insert cascade and the union one merge
    cascade, bit-equal to JAX's."""
    geometry = dict(k=8, levels=4)
    states = []
    for seed in (9, 10):
        st, jst = sketches.QuantileSketchState.create(device="cpu", **geometry), mt.QuantileSketchState.create(**geometry)
        for x in _stream(seed, [1000, 333]):
            st, jst = st.insert(torch.from_numpy(x)), jst.insert(jnp.asarray(x))
            assert_sketch_equal(st, jst)
        states.append((st, jst))
    (a, ja), (b, jb) = states
    assert_sketch_equal(a.sketch_merge(b), ja.sketch_merge(jb))
    for o, r in zip(a.sketch_merge(b), b.sketch_merge(a)):
        np.testing.assert_array_equal(_bits(o), _bits(r))


def test_on_overflow_policies():
    x = torch.from_numpy(_stream(6, [1000])[0])
    with pytest.warns(UserWarning, match="design capacity"):
        m = mtt.QuantileSketch(k=8, levels=4, device="cpu")
        m.update(x)
        m.compute()
    m = mtt.QuantileSketch(k=8, levels=4, on_overflow="error", device="cpu")
    m.update(x)
    with pytest.raises(MetricsTPUUserError, match="design capacity"):
        m.compute()
    m = mtt.QuantileSketch(k=8, levels=4, on_overflow="ignore", device="cpu")
    m.update(x)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.compute()
    with pytest.raises(ValueError, match="on_overflow"):
        mtt.QuantileSketch(on_overflow="sometimes", device="cpu")


def test_state_dict_round_trip_and_geometry_refusal():
    m = mtt.QuantileSketch(device="cpu", **GEOMETRY)
    m.persistent(True)
    for x in _stream(7, [500, 60]):
        m.update(torch.from_numpy(x))
    sd = m.state_dict()
    assert set(sd["sketch"]) == {"items", "counts", "n_seen"}
    fresh = mtt.QuantileSketch(device="cpu", **GEOMETRY)
    fresh.load_state_dict(sd)
    for o, r in zip(fresh.metric_state["sketch"], m.metric_state["sketch"]):
        np.testing.assert_array_equal(_bits(o), _bits(r))
    np.testing.assert_array_equal(_np(fresh.compute()), _np(m.compute()))
    other = mtt.QuantileSketch(device="cpu", eps=0.1, k=32, levels=6)
    with pytest.raises(ValueError, match="sketch-state validation"):
        other.load_state_dict(sd)
    hll = mtt.HyperLogLog(precision=5, device="cpu")
    with pytest.raises(ValueError, match="precision config mismatch"):
        hll.load_state_dict({"sketch": {"registers": np.zeros(64, np.int32)}})


@pytest.mark.parametrize("form", ["namedtuple", "primitives"])
def test_load_jax_state_mid_stream(form):
    batches = _stream(8, [400, 90, 3000, 7, 1200, 65])
    ref = mt.QuantileSketch(**GEOMETRY)
    for x in batches[:3]:
        ref.update(jnp.asarray(x))
    jax_state = ref.metric_state["sketch"]
    ours = mtt.QuantileSketch(device="cpu", **GEOMETRY)
    load_jax_state(ours, {"sketch": jax_state if form == "namedtuple" else jax_state.to_primitives()})
    assert_sketch_equal(ours.metric_state["sketch"], jax_state)
    got, want = run_twins(ours, ref, batches[3:], forward_every=2)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_load_jax_state_into_a_collection():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 500, 3000)
    ref = mt.MetricCollection({"freq": mt.CountMinSketch(depth=3, width=64), "distinct": mt.HyperLogLog(precision=6)})
    ref.update(jnp.asarray(ids))
    ours = mtt.MetricCollection(
        {"freq": mtt.CountMinSketch(depth=3, width=64, device="cpu"), "distinct": mtt.HyperLogLog(precision=6, device="cpu")}
    )
    load_jax_state(ours, {name: {"sketch": m.metric_state["sketch"]} for name, m in ref.items(keep_base=True)})
    more = rng.integers(0, 800, 1000)
    ref.update(jnp.asarray(more))
    ours.update(torch.from_numpy(more))
    for name, m in ref.items(keep_base=True):
        assert_sketch_equal(ours[name].metric_state["sketch"], m.metric_state["sketch"])


def test_two_quantile_sketches_form_one_compute_group():
    x = torch.from_numpy(np.random.default_rng(10).random(256).astype(np.float32))
    coll = mtt.MetricCollection(
        {
            "a": mtt.QuantileSketch(eps=0.1, k=64, levels=6, quantiles=(0.5,), device="cpu"),
            "b": mtt.QuantileSketch(eps=0.1, k=64, levels=6, quantiles=(0.9,), device="cpu"),
            "c": mtt.QuantileSketch(eps=0.1, k=32, levels=6, quantiles=(0.5,), device="cpu"),
        }
    )
    coll.update(x)
    coll.update(x[:100])
    out = coll.compute()
    assert coll.compute_groups == {0: ["a", "b"], 1: ["c"]}
    ref = mt.QuantileSketch(eps=0.1, k=64, levels=6, quantiles=(0.5, 0.9))
    ref.update(jnp.asarray(x.numpy()))
    ref.update(jnp.asarray(x.numpy()[:100]))
    want = np.asarray(ref.compute())
    assert float(out["a"]) == want[0] and float(out["b"]) == want[1]


def _ids_and_floats(seed, n):
    """int32 ids with heavy hitters, and floats with NaN, ±inf and ties but
    no ``-0.0`` and no denormal (see the module docstring)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-(1 << 31), (1 << 31) - 1, n)
    ids[: n // 2] = rng.integers(0, 50, n // 2)  # heavy hitters
    floats = _stream(seed, [n])[0]
    floats[(floats == 0.0) | (np.abs(floats) < np.finfo(np.float32).tiny)] = 0.0
    return ids.astype(np.int32), floats


@pytest.mark.parametrize("precision", [4, 11])
def test_count_min_and_hll_states_match_jax_op_by_op(precision):
    """The states' own ``insert`` on streams with ``-0.0`` and denormals,
    against JAX's run op by op (outside jit)."""
    x = _stream(15, [3000])[0]
    valid = np.isfinite(x)
    cm = sketches.CountMinState.create(4, 64, device="cpu").insert(torch.from_numpy(x), torch.from_numpy(valid))
    assert_sketch_equal(cm, mt.CountMinState.create(4, 64).insert(jnp.asarray(x), jnp.asarray(valid)))
    hll = sketches.HllState.create(precision, device="cpu").insert(torch.from_numpy(x), torch.from_numpy(valid))
    assert_sketch_equal(hll, mt.HllState.create(precision).insert(jnp.asarray(x), jnp.asarray(valid)))
    # -0.0 and +0.0 are one value to both sketches
    zeros = sketches.HllState.create(precision, device="cpu").insert(torch.tensor([0.0, -0.0, 1e-40]))
    assert int((zeros.registers > 0).sum()) == 1


@pytest.mark.parametrize("kind", ["ids", "floats"])
def test_count_min_twins(kind):
    ours = mtt.CountMinSketch(depth=4, width=128, device="cpu")
    ref = mt.CountMinSketch(depth=4, width=128)
    batches = [_ids_and_floats(s, n)[0 if kind == "ids" else 1] for s, n in [(11, 500), (12, 1), (13, 3000), (14, 0)]]
    for i, x in enumerate(batches):
        if i % 2 == 0:
            np.testing.assert_array_equal(_np(ours(torch.from_numpy(x))), np.asarray(ref(jnp.asarray(x))).astype(np.int64))
        else:
            ours.update(torch.from_numpy(x))
            ref.update(jnp.asarray(x))
        assert_sketch_equal(ours.metric_state["sketch"], ref.metric_state["sketch"])
    probe = np.concatenate([b[:50] for b in batches if len(b)])
    np.testing.assert_array_equal(_np(ours.query(torch.from_numpy(probe))), np.asarray(ref.query(jnp.asarray(probe))).astype(np.int64))
    np.testing.assert_array_equal(_np(ours.compute()), np.asarray(ref.compute()).astype(np.int64))


@pytest.mark.parametrize("kind", ["ids", "floats"])
@pytest.mark.parametrize("precision", [4, 11])
def test_hyperloglog_twins(kind, precision):
    ours = mtt.HyperLogLog(precision=precision, device="cpu")
    ref = mt.HyperLogLog(precision=precision)
    for i, (s, n) in enumerate([(21, 2000), (22, 1), (23, 40000), (24, 0)]):
        x = _ids_and_floats(s, n)[0 if kind == "ids" else 1]
        if i % 2 == 0:
            got, want = ours(torch.from_numpy(x)), ref(jnp.asarray(x))
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=HLL_RTOL)
        else:
            ours.update(torch.from_numpy(x))
            ref.update(jnp.asarray(x))
        assert_sketch_equal(ours.metric_state["sketch"], ref.metric_state["sketch"])
    np.testing.assert_allclose(_np(ours.compute()), np.asarray(ref.compute()), rtol=HLL_RTOL)


def test_hash_keys_and_fmix_match_jax():
    from metrics_tpu.streaming import sketches as jax_sketches

    x = _stream(30, [3000])[0]
    ours = sketches._hash_keys(torch.from_numpy(x))
    ref = np.asarray(jax_sketches._hash_keys(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(_np(ours), ref)
    keys = np.random.default_rng(31).integers(0, 1 << 32, 5000, dtype=np.uint64)
    keys[:3] = [0, 1, (1 << 32) - 1]
    np.testing.assert_array_equal(
        _np(sketches._fmix32(torch.from_numpy(keys.astype(np.int64)))),
        np.asarray(jax_sketches._fmix32(jnp.asarray(keys.astype(np.uint32)))).astype(np.int64),
    )
    w = torch.from_numpy(keys[1:].astype(np.int64))
    np.testing.assert_array_equal(_np(sketches._clz32(w)), [32 - int(v).bit_length() for v in keys[1:]])


def test_sketch_metrics_default_to_cuda_and_keep_states_on_their_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (mtt.QuantileSketch, mtt.CountMinSketch, mtt.HyperLogLog):
        with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
            cls()
        m = cls(device="cpu")
        assert all(t.device.type == "cpu" for t in m.metric_state["sketch"])


def test_reset_clone_and_pickle_keep_sketch_states_apart():
    m = mtt.QuantileSketch(device="cpu", **GEOMETRY)
    x = torch.from_numpy(_stream(40, [900])[0])
    m.update(x)
    clone = m.clone()
    restored = pickle.loads(pickle.dumps(m))
    m.update(x)
    np.testing.assert_array_equal(_np(clone.compute()), _np(restored.compute()))
    assert int(clone.metric_state["sketch"].n_seen) == int(restored.metric_state["sketch"].n_seen) != int(m.metric_state["sketch"].n_seen)
    m.reset()
    assert int(m.metric_state["sketch"].n_seen) == 0 and bool(torch.isinf(m.metric_state["sketch"].items).all())
    assert int(clone.metric_state["sketch"].n_seen) > 0


def test_pack_round_trip_matches_jax():
    st = sketches.QuantileSketchState.create(device="cpu", **GEOMETRY).insert(torch.from_numpy(_stream(41, [2000])[0]))
    st = st._replace(n_seen=torch.tensor(123_456_789, dtype=torch.int32))
    flat = st.pack()
    ref = mt.QuantileSketchState(*(jnp.asarray(_np(t)) for t in st)).pack()
    np.testing.assert_array_equal(_bits(flat), _bits(ref))
    assert flat.shape[0] == st.packed_size
    back = sketches.QuantileSketchState.unpack_like(flat, st)
    for o, r in zip(back, st):
        np.testing.assert_array_equal(_bits(o), _bits(r))
