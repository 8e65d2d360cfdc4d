"""The port's snapshots (``resilience/snapshot.py``) and its CUDA bootstrap
probe (``utilities/backend.py``), against the JAX package.

A snapshot file written by either package's ``SnapshotManager`` restores in
the other, and both then compute the same values. An elastic restore of
four ranks' files at world 2, 1 or 3 gives, rank by rank, the states JAX's
restore of the same files gives: integer states bit-equal, float32 sums
within ``SUM_ATOL`` (merged in another order). The manager's integrity,
fallback, pruning and ``reduced`` paths follow JAX's. The probe bounds a
hanging bootstrap, and its failure (on a machine without CUDA) never moves a
metric to the CPU (D53).
"""
import os
import pickle
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.resilience import snapshot as jsnap  # noqa: E402
from metrics_tpu_torch.resilience import health as thealth  # noqa: E402
from metrics_tpu_torch.resilience import snapshot as tsnap  # noqa: E402
from metrics_tpu_torch.utilities import backend as tbackend  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402
from tests.helpers.torch_twins import leaves  # noqa: E402
from tests.test_torch_snapshot import CASES, SUM_ATOL, _build, _close, _feed, _value  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_registries():
    thealth.registry.clear()
    mt.resilience.health.registry.clear()
    tbackend.reset_backend_state()
    yield
    thealth.registry.clear()
    mt.resilience.health.registry.clear()
    tbackend.reset_backend_state()


def _payload_leaves(payload):
    return leaves(payload["states"]) if "states" in payload else leaves(payload)


def _same_states(ours, ref):
    """Two snapshot payloads' states, leaf by leaf: integers and booleans
    equal, floats within SUM_ATOL."""
    a, b = _payload_leaves(ours), _payload_leaves(ref)
    assert set(a) == set(b)
    for path in a:
        x, y = a[path], b[path]
        assert x.shape == y.shape, path
        if np.issubdtype(y.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=0, atol=SUM_ATOL, equal_nan=True, err_msg=path)
        else:
            np.testing.assert_array_equal(x.astype(np.int64), y.astype(np.int64), err_msg=path)


@pytest.mark.parametrize(("name", "kwargs", "kind"), CASES, ids=[c[0] for c in CASES])
def test_files_restore_across_packages(tmp_path, name, kwargs, kind):
    jm, tm = _build(mt, name, kwargs), _build(mtt, name, kwargs)
    _feed(jm, mt, kind, (0, 1))
    _feed(tm, mtt, kind, (0, 1))
    jmgr = jsnap.SnapshotManager(str(tmp_path / "jax"))
    tmgr = tsnap.SnapshotManager(str(tmp_path / "port"))
    jmgr.save(jm, step=3)
    tmgr.save(tm, step=3)
    # the same magic, schema and header keys, numpy leaves only
    jh, _ = jmgr.load_file(os.path.join(jmgr.directory, jmgr._filename(3, 0, 1)))
    th, tp = tmgr.load_file(os.path.join(tmgr.directory, tmgr._filename(3, 0, 1)))
    assert set(jh) == set(th) and th["library_version"] == mtt.__version__
    assert not any(isinstance(v, torch.Tensor) for v in _payload_leaves(tp).values())
    # JAX's file into the port, the port's into JAX
    ours = _build(mtt, name, kwargs)
    info = tsnap.SnapshotManager(jmgr.directory).restore(ours)
    assert info["step"] == 3 and info["fallbacks"] == 0
    theirs = _build(mt, name, kwargs)
    jsnap.SnapshotManager(tmgr.directory).restore(theirs)
    _close(_value(ours), _value(jm))
    _close(_value(tm), _value(theirs))
    _feed(ours, mtt, kind, (2,))
    _feed(theirs, mt, kind, (2,))
    _feed(jm, mt, kind, (2,))
    _close(_value(ours), _value(jm))
    _close(_value(theirs), _value(jm))


def test_same_state_digests_alike_in_both_packages():
    tm = _build(mtt, "Accuracy", dict(num_classes=4))
    _feed(tm, mtt, "labels", (0,))
    payload = tm.snapshot_state()
    assert tsnap._checksum_tree(payload) == jsnap._checksum_tree(payload)
    assert tsnap.MAGIC == jsnap.MAGIC and tsnap.SCHEMA_VERSION == jsnap.SCHEMA_VERSION


ELASTIC = [c for c in CASES if c[0] in ("ConfusionMatrix", "AUROC", "CalibrationError", "Precision", "QuantileSketch")]


# (case, world): every case at 2, 1 and 3, except the sketch (whose JAX
# merges run op by op on the CPU) at 3 only: uneven shares, merged and single
ELASTIC_RUNS = [(c, w) for c in ELASTIC for w in ((3,) if c[0] == "QuantileSketch" else (2, 1, 3))]


@pytest.mark.parametrize(("case", "world"), ELASTIC_RUNS, ids=[f"{c[0]}-{w}" for c, w in ELASTIC_RUNS])
def test_elastic_restore_equals_jax(tmp_path, case, world):
    name, kwargs, kind = case
    _elastic(tmp_path, name, kwargs, kind, world)


def _elastic(tmp_path, name, kwargs, kind, world):
    jmgr = jsnap.SnapshotManager(str(tmp_path))
    for r in range(4):
        jm = _build(mt, name, kwargs)
        _feed(jm, mt, kind, (10 * r, 10 * r + 1))
        jmgr.save(jm, step=7, rank=r, world_size=4)
    tmgr = tsnap.SnapshotManager(str(tmp_path))
    for r in range(world):
        ours, ref = _build(mtt, name, kwargs), _build(mt, name, kwargs)
        tinfo = tmgr.restore(ours, rank=r, world_size=world)
        jinfo = jmgr.restore(ref, rank=r, world_size=world)
        assert tinfo == jinfo
        assert ours.update_count == ref.update_count
        _same_states(ours.snapshot_state(), ref.snapshot_state())
    if world in (1, 3):
        _close(_value(ours), _value(ref))


class _JaxMeanState(mt.Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("avg", mt.metric.jnp.zeros(()), dist_reduce_fx="mean")

    def update(self, x):
        self.avg = self.avg + x

    def compute(self):
        return self.avg


class _PortMeanState(mtt.Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("avg", torch.zeros(()), dist_reduce_fx="mean")

    def update(self, x):
        self.avg = self.avg + x

    def compute(self):
        return self.avg


def test_mean_state_warns_and_records_on_an_uneven_hop(tmp_path):
    jmgr = jsnap.SnapshotManager(str(tmp_path))
    for r in range(4):
        jm = _JaxMeanState()
        jm.update(float(r + 1))
        jmgr.save(jm, step=1, rank=r, world_size=4)
    ours, ref = _PortMeanState(device="cpu"), _JaxMeanState()
    with pytest.warns(UserWarning, match="merged means are approximate"):
        tsnap.SnapshotManager(str(tmp_path)).restore(ours, rank=0, world_size=3)
    with pytest.warns(UserWarning, match="merged means are approximate"):
        jmgr.restore(ref, rank=0, world_size=3)
    assert thealth.registry.counts().get("snapshot_mean_approx") == 1
    assert float(ours.avg) == float(np.asarray(ref.avg)) == 1.5
    # an even hop is exact and quiet
    even = _PortMeanState(device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsnap.SnapshotManager(str(tmp_path)).restore(even, rank=1, world_size=2)
    assert float(even.avg) == 3.5


def _rank_files(tmp_path, world=4, step=5, **mgr_kw):
    mgr = tsnap.SnapshotManager(str(tmp_path), **mgr_kw)
    for r in range(world):
        m = _build(mtt, "ConfusionMatrix", dict(num_classes=4))
        _feed(m, mtt, "labels", (r,))
        mgr.save(m, step=step, rank=r, world_size=world)
    return mgr


@pytest.mark.parametrize("mode", ["full", "assigned"])
def test_group_verification_modes(tmp_path, mode):
    mgr = _rank_files(tmp_path, group_verification=mode)
    _rank_files(tmp_path, step=6)
    # a leaf of old rank 2 flipped: outside new rank 0's share (old 0, 1)
    path = os.path.join(mgr.directory, mgr._filename(6, 2, 4))
    record = pickle.load(open(path, "rb"))
    record["payload"]["states"]["confmat"] = record["payload"]["states"]["confmat"] + 1
    with open(path, "wb") as f:
        pickle.dump(record, f, protocol=4)
    m = _build(mtt, "ConfusionMatrix", dict(num_classes=4))
    if mode == "full":
        # every file is checksummed: the group is refused, step 5 restores
        with pytest.warns(UserWarning, match="skipping snapshot step 6"):
            info = mgr.restore(m, rank=0, world_size=2)
        assert (info["step"], info["fallbacks"]) == (5, 1)
    else:
        # only the share (and old rank 0's header) is read
        info = mgr.restore(m, rank=0, world_size=2)
        assert (info["step"], info["fallbacks"], info["merged_ranks"]) == (6, 0, [0, 1])
    # an empty (torn) file is refused in both modes, read or not
    with open(os.path.join(mgr.directory, mgr._filename(6, 3, 4)), "wb"):
        pass
    with pytest.warns(UserWarning, match="skipping snapshot step 6"):
        info = mgr.restore(m, rank=0, world_size=2)
    assert info["step"] == 5


def test_bit_flip_names_the_file_and_the_leaf(tmp_path):
    mgr = _rank_files(tmp_path, world=1)
    path = os.path.join(mgr.directory, mgr._filename(5, 0, 1))
    record = pickle.load(open(path, "rb"))
    leaf = record["payload"]["states"]["confmat"]
    leaf.view(np.uint8)[3] ^= 0x10  # one bit of one leaf
    with open(path, "wb") as f:
        pickle.dump(record, f, protocol=4)
    with pytest.raises(tsnap.SnapshotCorruptionError) as err:
        mgr.load_file(path)
    assert path in str(err.value) and "/payload/states/confmat" in str(err.value)


def test_corrupt_newest_falls_back_and_sweeps_stale_tmp(tmp_path):
    mgr = tsnap.SnapshotManager(str(tmp_path), keep=3)
    m = _build(mtt, "ConfusionMatrix", dict(num_classes=4))
    _feed(m, mtt, "labels", (0,))
    mgr.save(m, step=1)
    older = _value(m).clone()
    _feed(m, mtt, "labels", (1,))
    newest = mgr.save(m, step=2)
    with open(newest, "r+b") as f:
        f.seek(40)
        byte = f.read(1)
        f.seek(40)
        f.write(bytes([byte[0] ^ 0xFF]))
    stale = os.path.join(mgr.directory, f"{mgr.tag}.step0000000002.rank00000.of00001.snap.tmp.99999")
    fresh_tmp = stale.replace("99999", "99998")
    for p in (stale, fresh_tmp):
        with open(p, "wb") as f:
            f.write(b"torn")
    old = time.time() - 2 * 3600
    os.utime(stale, (old, old))
    restored = _build(mtt, "ConfusionMatrix", dict(num_classes=4))
    with pytest.warns(UserWarning, match="falling back"):
        info = mgr.restore(restored)
    assert info["step"] == 1 and info["fallbacks"] == 1
    assert thealth.registry.counts()["snapshot_fallback"] == 1
    np.testing.assert_array_equal(_value(restored).numpy(), older.numpy())
    assert mgr.latest_intact() == (1, 1)
    mgr.save(m, step=3)  # the save's prune sweeps the stale tmp, keeps the fresh one
    assert not os.path.exists(stale) and os.path.exists(fresh_tmp)


def test_prune_keeps_the_newest_steps_and_reduced_restores_on_rank_zero(tmp_path):
    mgr = tsnap.SnapshotManager(str(tmp_path), keep=3)
    m = _build(mtt, "ConfusionMatrix", dict(num_classes=4))
    for step in range(1, 6):
        _feed(m, mtt, "labels", (step,))
        mgr.save(m, step=step, reduced=True)
    assert mgr.steps() == [3, 4, 5]
    with pytest.raises(ValueError, match="world_size=1"):
        mgr.save(m, step=9, world_size=2, rank=0, reduced=True)
    r0, r1 = (_build(mtt, "ConfusionMatrix", dict(num_classes=4)) for _ in range(2))
    assert mgr.restore(r0, rank=0, world_size=2)["reduced"] is True
    mgr.restore(r1, rank=1, world_size=2)
    np.testing.assert_array_equal(_value(r0).numpy(), _value(m).numpy())
    assert int(r1.metric_state["confmat"].sum()) == 0 and r1.update_count == 0
    with pytest.raises(tsnap.SnapshotError, match="no 'other' snapshots"):
        tsnap.SnapshotManager(str(tmp_path), tag="other").restore(r0)


def test_merge_refuses_a_foreign_state(tmp_path):
    mgr = _rank_files(tmp_path, world=2)
    wrong = _build(mtt, "Accuracy", dict(num_classes=4))
    with pytest.raises(ValueError, match="unknown state"):
        mgr.restore(wrong, rank=0, world_size=1)


# --------------------------------------------------------------------------
# the CUDA bootstrap probe
# --------------------------------------------------------------------------


def test_hanging_probe_is_killed_within_its_deadline(monkeypatch):
    monkeypatch.setenv(tbackend.PROBE_CMD_ENV, "import time; time.sleep(120)")
    t0 = time.monotonic()
    result = tbackend.probe_backend(deadline_s=1.0)
    assert time.monotonic() - t0 < 1.0 + 5.0
    assert result["ok"] is False and result["timed_out"] is True and "deadline" in result["reason"]
    with pytest.raises(tbackend.BackendProbeError):
        tbackend.ensure_backend(deadline_s=1.0)
    assert thealth.registry.counts()["backend_probe_timeout"] == 1


def test_malformed_deadline_warns_and_keeps_the_default(monkeypatch):
    monkeypatch.setenv(tbackend.PROBE_DEADLINE_ENV, "1m")
    monkeypatch.setenv(tbackend.PROBE_CMD_ENV, "print('H100'); print('cuda')")
    with pytest.warns(UserWarning, match="malformed METRICS_TPU_PROBE_DEADLINE_S"):
        result = tbackend.probe_backend()
    assert result["ok"] and result["platform"] == "cuda" and result["device"] == "H100"
    assert result["deadline_s"] == 60.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the probe's failure on a machine without CUDA")
def test_failed_probe_moves_no_metric_to_the_cpu():
    with pytest.raises(tbackend.BackendProbeError):
        tbackend.ensure_backend(deadline_s=120.0)
    assert thealth.registry.counts()["backend_probe_failed"] == 1
    status = mtt.health_report()["backend"]
    assert status["probe"]["ok"] is False and status["initialized"] is False and status["forced_cpu"] is False
    with pytest.raises(MetricsTPUUserError, match="failed its bootstrap probe"):
        mtt.Accuracy(num_classes=3)
    assert mtt.Accuracy(num_classes=3, device="cpu").device.type == "cpu"
    with pytest.warns(UserWarning, match="pass device='cpu'"):
        assert tbackend.ensure_backend(fallback_cpu=True, refresh=True) == "cpu"
    # JAX's default falls back to the CPU and says so
    import inspect

    assert inspect.signature(mt.utilities.backend.ensure_backend).parameters["fallback_cpu"].default is True
    assert inspect.signature(tbackend.ensure_backend).parameters["fallback_cpu"].default is False


def test_escape_hatch_refuses_the_default_device_and_touches_no_cuda():
    code = (
        "import torch, metrics_tpu_torch as mtt\n"
        "rep = mtt.health_report()\n"
        "assert rep['backend']['forced_cpu'] and rep['backend']['force_cpu_env'], rep['backend']\n"
        "assert rep['event_counts'].get('forced_cpu') == 1, rep['event_counts']\n"
        "assert mtt.ensure_backend() == 'cpu'\n"
        "try:\n"
        "    mtt.Accuracy(num_classes=3)\n"
        "except Exception as err:\n"
        "    assert 'METRICS_TPU_FORCE_CPU' in str(err), err\n"
        "else:\n"
        "    raise AssertionError('Metric() ran under the hatch')\n"
        "mtt.Accuracy(num_classes=3, device='cpu')\n"
        "assert not torch.cuda.is_initialized()\n"
        "import sys\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m.startswith('metrics_tpu.') for m in sys.modules)\n"
        "print('hatch ok')\n"
    )
    env = dict(os.environ, METRICS_TPU_FORCE_CPU="1", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "hatch ok" in out.stdout, out.stderr[-2000:]


def test_health_report_keys_equal_jax():
    mt.obs.registry.counter("parity_probe_total").inc()
    mtt.obs.registry.counter("parity_probe_total").inc()
    try:
        ours, ref = mtt.health_report(), mt.health_report()
        assert set(ours) == set(ref)
        assert set(ours["backend"]) == set(ref["backend"])
        assert set(ours["runtime"]) >= {"counters", "histograms"}
    finally:
        mt.obs.registry.reset()
        mtt.obs.registry.reset()
