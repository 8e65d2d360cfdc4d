"""The port's static lock-order pass (``metrics_tpu_torch/analysis/concurrency.py``)
and its manifest (``metrics_tpu_torch/analysis/LOCK_ORDER.md``), against
the JAX package's pass over the JAX package
(``tests/analysis/test_concurrency.py``'s contracts): the same locks and
edges by mapped id, every lock ranked, JAX's ranks kept, a seeded inversion
caught; and ROADMAP F13, the port's ``Metric._overlap_lock`` that the pass
could not see.
"""
import pathlib

import pytest

torch = pytest.importorskip("torch")

from metrics_tpu_torch.analysis import concurrency as C  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
MANIFEST = ROOT / "metrics_tpu_torch" / "analysis" / "LOCK_ORDER.md"
JAX_MANIFEST = ROOT / "metrics_tpu" / "analysis" / "LOCK_ORDER.md"


def _to_port(lock_id):
    return lock_id.replace("metrics_tpu/", "metrics_tpu_torch/", 1)


@pytest.fixture(scope="module")
def reports():
    from metrics_tpu.analysis.concurrency import analyze_package as jax_analyze

    return C.analyze_package(), jax_analyze()


def test_port_pass_finds_jax_locks_and_edges_by_mapped_id(reports):
    port, jax = reports
    assert {_to_port(k) for k in jax.locks} <= set(port.locks)
    assert len(port.locks) >= 26
    assert {(_to_port(a), _to_port(b)) for a, b in jax.edges} == set(port.edges)
    assert port.cycles == [] and jax.cycles == []


def test_port_manifest_ranks_every_lock_with_no_violation(reports):
    port, _ = reports
    ranks, allowed = C.parse_manifest(MANIFEST.read_text())
    assert set(ranks) == set(port.locks)
    assert allowed == {("<outer-lock-id>", "<inner-lock-id>")}  # the format's example only
    assert C.check_manifest(port, MANIFEST.read_text()) == []
    assert C.default_manifest_path() == str(MANIFEST)


def test_port_manifest_keeps_jax_ranks():
    ranks, _ = C.parse_manifest(MANIFEST.read_text())
    jax_ranks, _ = C.parse_manifest(JAX_MANIFEST.read_text())
    assert {lock_id: ranks[_to_port(lock_id)] for lock_id in jax_ranks} == jax_ranks


def test_overlap_lock_is_seen_on_the_construction_path(reports):
    """ROADMAP F13: the port minted ``Metric._overlap_lock`` through a local
    in ``_init_overlap``, where neither this pass nor GL403 saw it (26 locks,
    the swap guard unranked); each construction method now mints it."""
    from metrics_tpu_torch.analysis.lint import lint_paths

    port, _ = reports
    lock = port.locks["metrics_tpu_torch/metric.py:Metric._overlap_lock"]
    assert lock.kind == "RLock"
    metric_py = ROOT / "metrics_tpu_torch" / "metric.py"
    assert [f for f in lint_paths([str(metric_py)], str(ROOT)) if f.rule_id == "GL403"] == []
    import metrics_tpu_torch as mtt

    m = mtt.Accuracy(num_classes=3, device="cpu", sync_mode="overlapped")
    import copy
    import pickle

    assert m._overlap_lock is not None and copy.deepcopy(m)._overlap_lock is not m._overlap_lock
    assert pickle.loads(pickle.dumps(m))._overlap_lock is not None
    assert mtt.Accuracy(num_classes=3, device="cpu")._overlap_lock is None


SEEDED = {
    "metrics_tpu_torch/a.py": (
        "import threading\n"
        "from metrics_tpu_torch.analysis.lockwitness import named_lock\n"
        "outer = named_lock('a.outer', threading.Lock())\n"
        "inner = named_lock('a.inner', threading.Lock())\n"
        "def good():\n"
        "    with outer:\n"
        "        with inner:\n"
        "            pass\n"
    ),
    "metrics_tpu_torch/b.py": (
        "from metrics_tpu_torch.a import outer, inner\n"
        "def bad():\n"
        "    with inner:\n"
        "        take_outer()\n"
        "def take_outer():\n"
        "    with outer:\n"
        "        pass\n"
    ),
}
SEEDED_MANIFEST = "- rank 10: metrics_tpu_torch/a.py:outer\n- rank 20: metrics_tpu_torch/a.py:inner\n"


@pytest.mark.parametrize("with_inversion", [False, True])
def test_seeded_inversion_fails(with_inversion):
    sources = dict(SEEDED)
    if not with_inversion:
        sources["metrics_tpu_torch/b.py"] = "def bad():\n    pass\n"
    report = C.analyze_sources([(text, rel) for rel, text in sources.items()])
    violations = C.check_manifest(report, SEEDED_MANIFEST)
    if with_inversion:
        assert {v.kind for v in violations} == {"cycle", "order"}
        assert any("via take_outer()" in v.message for v in violations)
    else:
        assert violations == []
