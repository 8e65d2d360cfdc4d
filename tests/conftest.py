"""Test configuration: force CPU jax with 8 virtual devices.

The analogue of the reference's 2-process Gloo pool
(``test/unittests/helpers/testers.py:35-61``): distributed behavior is tested
on a virtual 8-device CPU mesh via ``shard_map``/``pjit`` instead of a
process-pool DDP simulation. Backend reset rationale lives in
``metrics_tpu/utilities/backend.py``.
"""
import jax
import pytest

from metrics_tpu.utilities.backend import force_cpu_backend

NUM_DEVICES = 8

force_cpu_backend(NUM_DEVICES)


@pytest.fixture(autouse=True)
def _lockwitness_gate():
    """The `make lockcheck` lane's per-test assertion: with
    ``METRICS_TPU_LOCKCHECK=1`` in the environment, every test must finish
    with ZERO witness findings — no lock-order inversions, no blocking
    calls under a hot lock. Unarmed (the default), this is two function
    calls of overhead. Witness self-tests that seed findings on purpose
    clear them via ``reset_lockwitness_state()`` in their own teardown,
    which runs before this gate's assert."""
    from metrics_tpu.analysis import lockwitness

    if not lockwitness.lockcheck_enabled():
        yield
        return
    lockwitness.clear_findings()
    yield
    found = lockwitness.findings()
    assert found == [], "lock witness findings:\n" + "\n".join(map(repr, found))


def pytest_configure(config):
    assert jax.device_count() >= NUM_DEVICES, f"expected {NUM_DEVICES} devices, got {jax.device_count()}"
    config.addinivalue_line(
        "markers",
        "reference_fault: documents a fault of the JAX package that the "
        "PyTorch port repairs (ROADMAP Queue 3); it runs in tier-1 and "
        "passes while the JAX package shows the fault",
    )
    config.addinivalue_line(
        "markers",
        "slow: heavyweight tests (real pretrained-weight loads, subprocess example "
        "runs, multi-seed fuzz repeats) excluded from the tier-1 fast lane "
        "(ROADMAP.md runs pytest -m 'not slow' under a hard timeout)",
    )
    config.addinivalue_line(
        "markers",
        "faults: fault-injection coverage of the in-graph fault channel "
        "(utilities/guard.py) and degraded transports — small seeds run in the "
        "tier-1 fast lane (select with -m faults); the heavy repeat-seed sweep "
        "is additionally marked slow",
    )
    config.addinivalue_line(
        "markers",
        "streaming: the streaming subsystem (metrics_tpu/streaming/ — windowed/"
        "decayed wrappers and mergeable sketches); select with -m streaming, "
        "or run the directory via `make test-streaming`",
    )
    config.addinivalue_line(
        "markers",
        "ops: the kernel layer (metrics_tpu/ops/ — dispatch registry, "
        "packed-radix orders, binned sketch precompaction, pallas kernels "
        "with interpret-mode parity); select with -m ops, or run the "
        "directory via `make test-ops` (1M-row variants additionally "
        "marked slow)",
    )
    config.addinivalue_line(
        "markers",
        "analysis: the static-analysis subsystem (metrics_tpu/analysis/ — "
        "graft-lint AST rules + compiled-graph budget auditor); select with "
        "-m analysis, or run the directory via `make test-analysis` (the "
        "compile-heavy full-registry audit is additionally marked slow and "
        "runs in CI through `make lint`)",
    )
    config.addinivalue_line(
        "markers",
        "serving: the serving-hardening subsystem (metrics_tpu/serving/ "
        "ServeLoop + the ops/padding.py capacity ladder) — multi-thread "
        "request-driver stress, overload shedding, recompile budgets; "
        "select with -m serving, or run the directory via `make test-serving`",
    )
    config.addinivalue_line(
        "markers",
        "obs: the observability layer (metrics_tpu/obs/ — span tracer, "
        "sketch-backed self-telemetry histograms, Prometheus/JSON exporters) "
        "plus the instrumented runtime seams and overhead budgets; select "
        "with -m obs, or run the directory via `make test-obs`",
    )
    config.addinivalue_line(
        "markers",
        "fleet: the fleet aggregation tier (metrics_tpu/fleet/ — checksummed "
        "view wire format, multi-hop host→pod→global aggregators, the "
        "cadenced publisher with retry/breaker degradation, HTTP transport) "
        "plus the shared parallel/retry.py policy; select with -m fleet, or "
        "run the lane via `make test-fleet` (the heavyweight multiprocess "
        "acceptance tests — 8-host parity, SIGKILL-mid-run — are "
        "additionally marked slow and run in CI through that target; a mini "
        "2-host tree keeps the subprocess+HTTP plumbing in the fast lane)",
    )
    config.addinivalue_line(
        "markers",
        "transport: the quantized sync transport layer (ops/quantize.py — "
        "blockwise int8/fp16 wire codecs, the fused_sync quantized wire, "
        "overlapped-cycle compressed gathers, the int8 fleet view encoding) "
        "with its error-bound property suite and exact-mode bit-identity "
        "pins; select with -m transport, or run the lane via "
        "`make test-transport`",
    )
    config.addinivalue_line(
        "markers",
        "coldstart: the serving cold-start layer (serving/warmup.py — AOT "
        "warmup engine, executable dispatch tables, the persistent compile "
        "cache behind METRICS_TPU_COMPILE_CACHE_DIR) plus the warmed-sweep "
        "audit budget; select with -m coldstart, or run the lane via "
        "`make test-coldstart` (the subprocess warm-restart acceptance — a "
        "second process compiling 0 graphs — is additionally marked slow "
        "and runs in CI through that target)",
    )
    config.addinivalue_line(
        "markers",
        "drift: the online drift-detection workload (obs/drift.py — reference "
        "windows, KS/PSI/churn/cardinality scoring, episode-gated alerting, "
        "ServeLoop(drift_monitors=...) cadence checks, fleet federation of "
        "per-host scores); select with -m drift, or run the lane via "
        "`make test-drift` (which also runs the examples/drift_monitor.py "
        "subprocess acceptance — additionally marked slow)",
    )
    config.addinivalue_line(
        "markers",
        "overlap: the chunked collective/compute overlap + delta-publishing "
        "layer (parallel/sync.py chunked fused_sync schedules + the "
        "run_gather_jobs pipeline, METRICS_TPU_SYNC_CHUNKS resolution, "
        "graph_audit logical-vs-physical collective counting, fleet delta "
        "publishing with re-base chaos coverage); select with -m overlap, "
        "or run the lane via `make test-overlap`",
    )
    config.addinivalue_line(
        "markers",
        "async_sync: the overlapped async sync layer (parallel/async_sync.py "
        "scheduler, Metric(sync_mode='overlapped'), pure.py::"
        "overlapped_functionalize) — double-buffered zero-collective-latency "
        "reads, staleness/degradation contracts, blocking-vs-overlapped value "
        "parity; select with -m async_sync, or run the directory via "
        "`make test-async`",
    )
    config.addinivalue_line(
        "markers",
        "sliced: the sliced multi-tenant metrics engine (sliced/ SlicedMetric "
        "segment-reduce rings, pure.py::sliced_functionalize incl. sharded-K, "
        "quarantine/discard routing, per-slice scrape cap, warmup/fleet-delta "
        "ride-alongs); select with -m sliced, or run the lane via "
        "`make test-sliced`",
    )
