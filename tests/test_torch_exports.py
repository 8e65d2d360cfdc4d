"""The port's package exports against the JAX package's (F7), the functions
F7 added, and stated difference D35 (``mdmc_average="samplewise"`` on input
without extra dimensions)."""
import importlib
import importlib.util
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import metrics_tpu.functional as JF  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import metrics_tpu_torch.functional as TF  # noqa: E402
from metrics_tpu.parallel import sync as jsync  # noqa: E402
from metrics_tpu.utilities import data as jdata  # noqa: E402
from metrics_tpu_torch.parallel import sync as tsync  # noqa: E402
from metrics_tpu_torch.utilities import data as tdata  # noqa: E402
from tests.helpers.torch_thread_world import ThreadWorld  # noqa: E402
from tests.helpers.torch_twin_world import TwinWorld  # noqa: E402

PACKAGES = [
    "", ".classification", ".functional", ".utilities", ".parallel", ".streaming", ".regression",
    ".retrieval", ".wrappers", ".sliced", ".serving", ".resilience",
    ".functional.classification", ".functional.regression", ".functional.retrieval", ".functional.pairwise",
    ".image", ".functional.image", ".nets", ".text", ".functional.text", ".obs", ".fleet", ".detection",
    ".audio", ".functional.audio", ".analysis",
]

# names the JAX package exports from modules the port has not reached yet
# (ROADMAP Queue 1): the lint pass, its baseline and rules (item 18)
NOT_YET_PORTED = {
    ".analysis": {
        "ALL_RULES", "Finding", "apply_baseline", "default_baseline_path", "lint_package", "lint_paths",
        "lint_source", "load_baseline", "rule_catalog", "save_baseline",
    },
}


def _exports(module: types.ModuleType) -> set:
    """``__all__`` where the package has one, else its public names that are
    not modules and not JAX's own objects."""
    names = getattr(module, "__all__", None)
    if names is None:
        names = [
            n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and not str(getattr(v, "__module__", "") or "").startswith("jax")
        ]
    return set(names)


def _ported(jax_module: str) -> bool:
    """Whether the port has a counterpart of ``jax_module``."""
    name = "metrics_tpu_torch" + jax_module[len("metrics_tpu"):]
    parts = name.split(".")
    for i in range(2, len(parts) + 1):
        if importlib.util.find_spec(".".join(parts[:i])) is None:
            return False
    return True


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_mirror_jax(pkg):
    jmod = importlib.import_module("metrics_tpu" + pkg)
    tmod = importlib.import_module("metrics_tpu_torch" + pkg)
    missing = {n for n in _exports(jmod) if not hasattr(tmod, n)}
    allowed = NOT_YET_PORTED.get(pkg, set())
    assert missing == allowed, f"metrics_tpu_torch{pkg} lacks {sorted(missing - allowed)}; stale allow-list: {sorted(allowed - missing)}"


@pytest.mark.parametrize("pkg", sorted(NOT_YET_PORTED))
def test_allow_list_names_only_unported_modules(pkg):
    """Every allowed gap comes from a JAX module with no counterpart in the
    port."""
    jmod = importlib.import_module("metrics_tpu" + pkg)
    for name in NOT_YET_PORTED[pkg]:
        obj = getattr(jmod, name)
        origin = obj.__name__ if isinstance(obj, types.ModuleType) else _defining_module(jmod, name, obj)
        assert not _ported(origin), f"{name} comes from {origin}, which is ported"


def _defining_module(jmod: types.ModuleType, name: str, obj: object) -> str:
    """The module that defines ``obj``: its ``__module__``, or for a plain
    value (a tuple of rules) the deepest loaded submodule of ``jmod`` that
    holds it under ``name``."""
    origin = getattr(obj, "__module__", None)
    if origin:
        return origin
    import sys

    holders = [
        m for m, mod in list(sys.modules.items())
        if (m == jmod.__name__ or m.startswith(jmod.__name__ + ".")) and getattr(mod, name, None) is obj
    ]
    return max(holders, key=lambda m: m.count("."))


def test_top_level_names_named_by_f7():
    for name in ("BaseAggregator", "FAULT_CLASSES", "AsyncSyncScheduler", "slices_max_labels", "ServeLoop", "Warmup",
                 "SnapshotManager", "DriftMonitor", "ReferenceWindow", "ensure_backend", "obs"):
        assert name in mtt.__all__ and hasattr(mtt, name)
    assert tuple(mtt.FAULT_CLASSES) == tuple(importlib.import_module("metrics_tpu").FAULT_CLASSES)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none", None])
def test_reduce_against_jax(reduction):
    x = np.random.default_rng(3).normal(size=(5, 7)).astype(np.float32)
    got = tsync.reduce(torch.from_numpy(x), reduction)
    want = jsync.reduce(jnp.asarray(x), reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tsync.reduce(torch.from_numpy(x), "max")


@pytest.mark.parametrize("class_reduction", ["micro", "macro", "weighted", "none", None])
def test_class_reduce_against_jax(class_reduction):
    rng = np.random.default_rng(4)
    num = rng.integers(0, 10, 6).astype(np.int32)
    denom = num + rng.integers(0, 3, 6).astype(np.int32)
    denom[2] = 0
    num[2] = 0
    weights = rng.integers(1, 5, 6).astype(np.int32)
    got = tsync.class_reduce(torch.from_numpy(num), torch.from_numpy(denom), torch.from_numpy(weights), class_reduction)
    want = jsync.class_reduce(jnp.asarray(num), jnp.asarray(denom), jnp.asarray(weights), class_reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tsync.class_reduce(torch.from_numpy(num), torch.from_numpy(denom), torch.from_numpy(weights), "bogus")


def test_to_categorical_against_jax():
    rng = np.random.default_rng(5)
    x = rng.random((9, 5)).astype(np.float32)
    x[3] = [0.2, 0.7, 0.7, 0.1, 0.0]  # a tie: the first maximum wins
    x[4] = [1e-40, 0.0, -1e-40, -1.0, 0.0]  # denormals compare as zero
    for dim in (1, 0):
        got = tdata.to_categorical(torch.from_numpy(x), argmax_dim=dim)
        want = jdata.to_categorical(jnp.asarray(x), argmax_dim=dim)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_get_group_indexes_against_jax():
    idx = np.random.default_rng(6).integers(0, 5, 40)
    got = tdata.get_group_indexes(torch.from_numpy(idx))
    want = jdata.get_group_indexes(jnp.asarray(idx))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_is_sketch_state_and_jit_distributed_available():
    from metrics_tpu_torch.metric import jit_distributed_available
    from metrics_tpu_torch.streaming.sketches import is_sketch_state

    assert is_sketch_state(mtt.QuantileSketch(device="cpu").sketch)
    assert is_sketch_state(mtt.HyperLogLog(device="cpu").sketch)
    assert not is_sketch_state(torch.zeros(3))
    assert jit_distributed_available() is False


def _jax_twin_sync(fn):
    """A JAX sync over an axis of two identical shards (what the TwinWorld
    communicator fakes for the port)."""
    return jax.vmap(fn, axis_name="x")


@pytest.mark.parametrize("fx", ["sum", "mean", "max", "min", "cat", None])
def test_sync_leaf_against_jax_over_two_twin_ranks(fx):
    x = np.random.default_rng(7).normal(size=(3, 4)).astype(np.float32)
    got = tsync.sync_leaf(torch.from_numpy(x), fx, comm=TwinWorld())
    want = _jax_twin_sync(lambda v: jsync.sync_leaf(v, fx, "x"))(jnp.stack([jnp.asarray(x)] * 2))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_sync_state_against_jax_over_two_twin_ranks():
    rng = np.random.default_rng(8)
    tp = rng.integers(0, 9, 4).astype(np.int32)
    total = rng.normal(size=()).astype(np.float32)
    rows = [rng.normal(size=(2,)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)]
    reds = {"tp": "sum", "total": "max", "rows": "cat"}
    got = tsync.sync_state(
        {"tp": torch.from_numpy(tp), "total": torch.tensor(total), "rows": [torch.from_numpy(r) for r in rows]},
        reds,
        comm=TwinWorld(),
    )

    def jfn(tp_, total_, r0, r1):
        return jsync.sync_state({"tp": tp_, "total": total_, "rows": [r0, r1]}, reds, "x")

    want = jax.vmap(jfn, axis_name="x")(*[jnp.stack([jnp.asarray(v)] * 2) for v in (tp, total, rows[0], rows[1])])
    for key in reds:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key])[0], rtol=1e-6)


def test_sync_sketch_state_is_the_union_of_the_ranks():
    """Two ranks as threads (each writes its quantile payload at its own
    offset): the synced quantile sketch is the ranks' ``sketch_merge`` in
    rank order; CountMin sums, HyperLogLog takes the maximum."""
    rng = np.random.default_rng(9)
    ranks = []
    for _ in range(2):
        x = torch.from_numpy(rng.normal(size=500).astype(np.float32))
        ms = (mtt.QuantileSketch(eps=0.05, device="cpu"), mtt.CountMinSketch(depth=2, width=64, device="cpu"), mtt.HyperLogLog(device="cpu"))
        for m in ms:
            m.update(x)
        ranks.append([m.sketch for m in ms])
    world = ThreadWorld(2)
    synced = world.run(lambda rank, comm: [tsync.sync_sketch_state(s, comm=comm) for s in ranks[rank]])
    want = [ranks[0][0].sketch_merge(ranks[1][0]), ranks[0][1][0] + ranks[1][1][0], torch.maximum(ranks[0][2][0], ranks[1][2][0])]
    for got in synced:
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)
        assert torch.equal(got[1][0], want[1])
        assert torch.equal(got[2][0], want[2])


D35_FUNCTIONS = ["accuracy", "precision", "recall", "f1_score", "specificity", "dice"]


@pytest.mark.parametrize("name", D35_FUNCTIONS)
@pytest.mark.parametrize("form", ["probs", "labels"])
def test_d35_samplewise_without_extra_dims(name, form):
    """D35: JAX raises an ``IndexError``; the port returns the micro value
    (the value without ``mdmc_average``), as ``torch.mean(dim=0)`` of a 0-d
    score allows."""
    rng = np.random.default_rng(10)
    p = rng.random((16, 4)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    t = rng.integers(0, 4, 16)
    if form == "labels":
        p = p.argmax(1)
    kw = {} if name == "accuracy" else {"num_classes": 4}
    jf, tf = getattr(JF, name), getattr(TF, name)
    with pytest.raises(IndexError):
        jf(jnp.asarray(p), jnp.asarray(t), mdmc_average="samplewise", **kw)
    got = tf(torch.from_numpy(p), torch.from_numpy(t), mdmc_average="samplewise", **kw)
    micro = jf(jnp.asarray(p), jnp.asarray(t), **kw)
    assert float(got) == float(np.asarray(micro))
