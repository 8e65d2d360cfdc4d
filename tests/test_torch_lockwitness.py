"""The port's runtime lock witness (``metrics_tpu_torch/analysis/lockwitness.py``)
against the contracts of the JAX package's ``tests/analysis/test_lockwitness.py``,
and a witnessed run of the port's locks.

The contracts: the disabled shim is the identity, an inversion between two
threads (and one that closes through a third lock) is flagged, RLock
re-entry records no edge, a condition's ``wait`` un-holds, blocking under a
hot lock is flagged (under a cold one it is sanctioned), and the findings
dump through the torn-write-proof writer.

The witnessed run: two Gloo processes started with
``METRICS_TPU_LOCKCHECK=1`` (``tests/helpers/torch_lockwitness_ranks.py``)
serve a stream with tracing, drift, snapshots, a flight recorder and a
fleet publish, then read an overlapped-sync collection. It ends with no
finding, and every order edge it observes between two locks that the JAX
package's ``metrics_tpu/analysis/LOCK_ORDER.md`` names rises in rank (and
between the port's own locks, in the ranks ROADMAP D64 gives them). Threads
and processes are joined with timeouts.
"""
import json
import multiprocessing as mp
import os
import pathlib
import re
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from metrics_tpu_torch.analysis import lockwitness as lw  # noqa: E402
from tests.helpers import torch_lockwitness_ranks as R  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
JOIN_S = 5


@pytest.fixture(autouse=True)
def _isolated_witness():
    lw.reset_lockwitness_state()
    yield
    lw.reset_lockwitness_state()


def _run_thread(target, name):
    th = threading.Thread(target=target, name=name, daemon=True)
    th.start()
    th.join(timeout=JOIN_S)
    assert not th.is_alive(), f"{name} did not end"


class TestDisabledIsIdentity:
    def test_unset_env_means_identity(self, monkeypatch):
        monkeypatch.delenv("METRICS_TPU_LOCKCHECK", raising=False)
        lw.reset_lockwitness_state()
        base = threading.Lock()
        assert lw.named_lock("x", base) is base

    def test_default_lock_is_a_real_lock(self, monkeypatch):
        monkeypatch.delenv("METRICS_TPU_LOCKCHECK", raising=False)
        lw.reset_lockwitness_state()
        assert type(lw.named_lock("x")) is type(threading.Lock())

    def test_explicit_off_is_identity_too(self):
        lw.force_lockcheck(False)
        base = threading.RLock()
        assert lw.named_lock("x", base) is base

    def test_note_blocking_is_inert_when_disabled(self):
        lw.note_blocking("fsync", "/tmp/x")
        assert lw.findings() == []

    def test_malformed_env_token_warns_once_and_stays_off(self, monkeypatch):
        monkeypatch.setenv("METRICS_TPU_LOCKCHECK", "banana")
        with pytest.warns(UserWarning, match="METRICS_TPU_LOCKCHECK"):
            enabled = lw.lockcheck_enabled()
        assert enabled is False
        base = threading.Lock()
        assert lw.named_lock("x", base) is base

    def test_the_port_s_locks_are_plain_when_unarmed(self):
        """Unarmed (the variable unset, in a fresh process), every named lock
        of the port is the lock itself: nothing on the card's paths
        changes."""
        code = (
            "import threading\n"
            "import metrics_tpu_torch, metrics_tpu_torch.serving, metrics_tpu_torch.fleet\n"
            "from metrics_tpu_torch.obs import flightrec, trace\n"
            "from metrics_tpu_torch.ops import _build\n"
            "from metrics_tpu_torch.parallel import sync\n"
            "from metrics_tpu_torch.utilities import compute\n"
            "plain = (type(threading.Lock()), type(threading.RLock()))\n"
            "locks = (trace._ring_lock, trace._append_lock, flightrec._sources_lock, flightrec._state_lock, _build._lock,\n"
            "         _build._count_lock, compute._FLOAT32_LOCK, sync.gather_sequence_lock)\n"
            "loop = metrics_tpu_torch.ServeLoop(metrics_tpu_torch.SumMetric(device='cpu'), workers=1)\n"
            "locks += (loop._stats_lock, loop._snapshot_step_lock, *loop._replica_locks)\n"
            "loop.stop()\n"
            "assert all(type(lock) in plain for lock in locks), [type(lock) for lock in locks]\n"
            "print('ok')\n"
        )
        env = {k: v for k, v in os.environ.items() if k != "METRICS_TPU_LOCKCHECK"}
        env["PYTHONPATH"] = str(ROOT)
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


class TestInversionDetection:
    def _armed_pair(self):
        lw.force_lockcheck(True)
        return lw.named_lock("A", threading.Lock()), lw.named_lock("B", threading.Lock())

    def test_two_thread_inversion_is_flagged(self):
        a, b = self._armed_pair()

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        _run_thread(t1, "wit-t1")
        _run_thread(t2, "wit-t2")
        found = lw.findings()
        assert len(found) == 1
        assert found[0]["kind"] == "inversion" and found[0]["edge"] == "B -> A" and "wit-t2" in found[0]["site"]

    def test_consistent_order_is_clean(self):
        a, b = self._armed_pair()
        for _ in range(3):
            with a:
                with b:
                    pass
        assert lw.findings() == []

    def test_transitive_inversion_through_a_third_lock(self):
        lw.force_lockcheck(True)
        a, b, c = (lw.named_lock(n, threading.Lock()) for n in "ABC")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with c:
            with a:
                pass
        assert [f["kind"] for f in lw.findings()] == ["inversion"]

    def test_rlock_reentrancy_records_no_self_edge(self):
        lw.force_lockcheck(True)
        r = lw.named_lock("R", threading.RLock())
        with r:
            with r:
                pass
        assert lw.findings() == [] and lw._order == {}

    def test_condition_wait_unholds(self):
        lw.force_lockcheck(True)
        cv = lw.named_lock("CV", threading.Condition())
        outer = lw.named_lock("OUTER", threading.Lock())
        ready = threading.Event()

        def waiter():
            with cv:
                ready.set()
                cv.wait(timeout=JOIN_S)
                with outer:  # reacquired after wait: the held stack is restored
                    pass

        th = threading.Thread(target=waiter, name="wit-waiter", daemon=True)
        th.start()
        assert ready.wait(timeout=JOIN_S)
        with cv:
            cv.notify_all()
        th.join(timeout=JOIN_S)
        assert not th.is_alive()
        assert [f for f in lw.findings() if f["kind"] == "inversion"] == []
        assert lw._order == {"CV": {"OUTER": lw._order["CV"]["OUTER"]}}


class TestBlockingUnderHotLock:
    def test_blocking_under_hot_lock_is_flagged(self):
        lw.force_lockcheck(True)
        hot = lw.named_lock("HOT", threading.Lock(), hot=True)
        with hot:
            lw.note_blocking("fsync", "/tmp/dump.json")
        found = lw.findings()
        assert len(found) == 1
        assert found[0]["kind"] == "blocking-under-hot-lock" and found[0]["blocking"] == "fsync" and found[0]["held"] == ["HOT"]

    def test_blocking_under_cold_lock_is_sanctioned(self):
        lw.force_lockcheck(True)
        cold = lw.named_lock("COLD", threading.RLock(), hot=False)
        with cold:
            lw.note_blocking("collective", "run_gather_jobs")
        assert lw.findings() == []

    def test_blocking_with_nothing_held_is_clean(self):
        lw.force_lockcheck(True)
        lw.named_lock("HOT", threading.Lock(), hot=True)
        lw.note_blocking("http", "http://127.0.0.1:1")
        assert lw.findings() == []

    def test_the_port_s_seams_reach_the_witness(self, tmp_path):
        """The fsync of ``atomic_write_bytes`` is a seam: under a hot lock it
        is a finding."""
        from metrics_tpu_torch.resilience.snapshot import atomic_write_bytes

        lw.force_lockcheck(True)
        hot = lw.named_lock("HOT", threading.Lock(), hot=True)
        with hot:
            atomic_write_bytes(str(tmp_path / "x.bin"), b"x")
        assert [(f["kind"], f["blocking"]) for f in lw.findings()] == [("blocking-under-hot-lock", "fsync")]


class TestFindingsLifecycle:
    def test_dump_findings_writes_torn_proof_json(self, tmp_path):
        lw.force_lockcheck(True)
        hot = lw.named_lock("HOT", threading.Lock(), hot=True)
        with hot:
            lw.note_blocking("json-serialize", "payload")
        path = str(tmp_path / "lockcheck.json")
        assert lw.dump_findings(path) == path
        doc = json.loads((tmp_path / "lockcheck.json").read_text())
        assert doc["findings"][0]["blocking"] == "json-serialize"
        assert [p.name for p in tmp_path.iterdir()] == ["lockcheck.json"]

    def test_clear_and_reset(self):
        lw.force_lockcheck(True)
        hot = lw.named_lock("HOT", threading.Lock(), hot=True)
        with hot:
            lw.note_blocking("fsync")
        assert lw.findings()
        lw.clear_findings()
        assert lw.findings() == []
        lw.reset_lockwitness_state()
        assert lw.lockcheck_enabled() in (False, True)
        assert lw.findings() == [] and lw._order == {}


# -- the witnessed run ---------------------------------------------------------

# the witness's names of the locks that the JAX package's LOCK_ORDER.md ranks
LOCK_ORDER_IDS = {
    "metric._overlap_lock": "metrics_tpu/metric.py:Metric._overlap_lock",
    "aggregator._publish_lock": "metrics_tpu/fleet/aggregator.py:Aggregator._publish_lock",
    "publisher._snapshot_lock": "metrics_tpu/fleet/publisher.py:FleetPublisher._snapshot_lock",
    "drift._check_lock": "metrics_tpu/obs/drift.py:DriftMonitor._check_lock",
    "aggregator._lock": "metrics_tpu/fleet/aggregator.py:Aggregator._lock",
    "publisher._lock": "metrics_tpu/fleet/publisher.py:FleetPublisher._lock",
    "drift._lock": "metrics_tpu/obs/drift.py:DriftMonitor._lock",
    "async_sync._cv": "metrics_tpu/parallel/async_sync.py:AsyncSyncScheduler._cv",
    "async_sync._lock": "metrics_tpu/parallel/async_sync.py:AsyncSyncScheduler._lock",
    "loop._stats_lock": "metrics_tpu/serving/loop.py:ServeLoop._stats_lock",
    "gather_sequence_lock": "metrics_tpu/parallel/sync.py:gather_sequence_lock",
    "flightrec.FlightRecorder._lock": "metrics_tpu/obs/flightrec.py:FlightRecorder._lock",
    "flightrec._sources_lock": "metrics_tpu/obs/flightrec.py:_sources_lock",
    "flightrec._state_lock": "metrics_tpu/obs/flightrec.py:_state_lock",
    "runtime_metrics.RuntimeMetrics._lock": "metrics_tpu/obs/runtime_metrics.py:RuntimeMetrics._lock",
    "trace._append_lock": "metrics_tpu/obs/trace.py:_append_lock",
    "trace._ring_lock": "metrics_tpu/obs/trace.py:_ring_lock",
    "health.HealthRegistry._lock": "metrics_tpu/resilience/health.py:HealthRegistry._lock",
    "runtime_metrics.Counter._lock": "metrics_tpu/obs/runtime_metrics.py:Counter._lock",
    "runtime_metrics.Gauge._lock": "metrics_tpu/obs/runtime_metrics.py:Gauge._lock",
    "runtime_metrics.LatencyHistogram._lock": "metrics_tpu/obs/runtime_metrics.py:LatencyHistogram._lock",
}

# the ranks of the port's own locks in that hierarchy (ROADMAP D64)
PORT_RANKS = {
    "loop.ServeLoop._replica_locks": 5,
    "loop.ServeLoop._snapshot_step_lock": 35,
    "_build._lock": 70,
    "_build._count_lock": 80,
    "compute._FLOAT32_LOCK": 80,
}


def lock_order_ranks():
    """``{witness name: rank}`` from LOCK_ORDER.md, plus the port's own."""
    text = (ROOT / "metrics_tpu" / "analysis" / "LOCK_ORDER.md").read_text()
    by_id = {m.group(2): int(m.group(1)) for m in re.finditer(r"^- rank (\d+): (\S+)$", text, re.M)}
    ranks = {name: by_id[lock_id] for name, lock_id in LOCK_ORDER_IDS.items()}
    return {**ranks, **PORT_RANKS}


def test_every_named_lock_of_lock_order_has_a_name_here():
    """The map above covers every lock the manifest ranks but the witness's
    own table lock, which is never witnessed."""
    text = (ROOT / "metrics_tpu" / "analysis" / "LOCK_ORDER.md").read_text()
    ids = set(re.findall(r"^- rank \d+: (\S+)$", text, re.M))
    assert ids - set(LOCK_ORDER_IDS.values()) == {"metrics_tpu/analysis/lockwitness.py:_meta_lock"}


@pytest.fixture(scope="module")
def witnessed(tmp_path_factory):
    n = 2
    store = tmp_path_factory.mktemp("witness") / "store"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    mp_env = pytest.MonkeyPatch()
    mp_env.setenv("METRICS_TPU_LOCKCHECK", "1")  # the children import the port armed
    procs = [ctx.Process(target=R.rank_main, args=(r, n, str(store), queue)) for r in range(n)]
    try:
        for proc in procs:
            proc.start()
    finally:
        mp_env.undo()
    try:
        results = dict(queue.get(timeout=240) for _ in procs)
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    for r, res in sorted(results.items()):
        if "error" in res:
            pytest.fail(f"rank {r} failed:\n{res['error']}")
    assert [proc.exitcode for proc in procs] == [0] * n
    return [results[r] for r in range(n)]


def test_witnessed_run_has_no_findings(witnessed):
    served = witnessed[0]["served"]
    assert served["updates"] == served["aggregated_updates"] == R.REQUESTS and served["spans"] == R.REQUESTS
    assert served["published"] == {"default": "ok"}
    for res in witnessed:
        assert res["armed"]
        assert res["findings"] == []
        assert res["overlapped"]["read"] == res["overlapped"]["fresh"]
    assert witnessed[0]["overlapped"] == witnessed[1]["overlapped"]


def test_witnessed_edges_rise_in_rank(witnessed):
    ranks = lock_order_ranks()
    seen = set()
    for res in witnessed:
        for held, acquired in ((a, b) for a, bs in res["edges"].items() for b in bs):
            seen.update((held, acquired))
            if held in ranks and acquired in ranks:
                assert ranks[held] < ranks[acquired], f"{held} (rank {ranks[held]}) -> {acquired} (rank {ranks[acquired]})"
    # the run nested the served, telemetry, fleet, drift and sync locks
    assert {"loop.ServeLoop._replica_locks", "trace._append_lock", "publisher._snapshot_lock", "drift._lock",
            "gather_sequence_lock", "runtime_metrics.RuntimeMetrics._lock"} <= seen
