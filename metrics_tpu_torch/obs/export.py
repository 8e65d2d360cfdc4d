"""Scrapeable exporters (counterpart of ``metrics_tpu/obs/export.py``):
Prometheus text format and JSON over health and self-telemetry.

One render joins ``health_report()`` / ``ServeLoop.health()`` (degradation
events, serving counters, sync lag, drift scores, fault counters) with the
self-telemetry registry (``obs/runtime_metrics.py``), under the JAX
package's metric names and labels, so one dashboard reads both packages:

- :func:`prometheus_text`: counters as ``*_total``, histograms as
  summaries with ``quantile`` labels plus ``_count``/``_sum``, gauges for
  depths, lags, staleness and drift scores;
- :func:`json_text`: the same content as one JSON document;
- :class:`TelemetryExporter`: a standard-library HTTP endpoint
  (``/metrics``, ``/metrics.json``) on a daemon thread.

The fleet lines render whatever a health dict holds under ``fleet``; the
port has no fleet tier yet (ROADMAP Queue 1, item 16), so they print
nothing until it lands. A histogram's quantiles read its sketch back once
per scrape; the light counts need no device.
"""
import http.server
import json
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from metrics_tpu_torch.obs.runtime_metrics import DEFAULT_QUANTILES, RuntimeMetrics
from metrics_tpu_torch.obs.runtime_metrics import registry as _default_registry

__all__ = ["prometheus_text", "json_text", "TelemetryExporter"]

_PREFIX = "metrics_tpu"


def _escape_label(value: Any) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(value: Any) -> str:
    if value is None:
        return "NaN"
    if isinstance(value, bool):
        return "1" if value else "0"
    return repr(float(value)) if isinstance(value, float) else str(value)


def _line(name: str, value: Any, **labels: Any) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


def _runtime_lines(runtime: RuntimeMetrics, qs: Sequence[float]) -> List[str]:
    lines: List[str] = []
    for name, value in sorted(runtime.counters().items()):
        metric = f"{_PREFIX}_{name}"
        lines.append(f"# TYPE {metric} counter")
        lines.append(_line(metric, value))
    for name, value in sorted(runtime.gauges().items()):
        metric = f"{_PREFIX}_{name}"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(_line(metric, value))
    for name, hist in sorted(runtime.histograms().items()):
        if hist.count == 0:
            continue
        metric = f"{_PREFIX}_{name}"
        # units ride the metric name (*_ms / *_bytes): the histogram layer
        # is unit-agnostic since fleet_publish_bytes joined the registry
        lines.append(f"# HELP {metric} summary (QuantileSketch, rank error <= eps*n, eps={hist.eps:g})")
        lines.append(f"# TYPE {metric} summary")
        quantiles = hist.quantiles(qs)
        if quantiles is not None:  # None: a card-resident sketch under host_only_reads()
            for q in qs:
                lines.append(_line(metric, quantiles[q], quantile=f"{q:g}"))
        lines.append(_line(f"{metric}_count", hist.count))
        lines.append(_line(f"{metric}_sum", hist.sum_ms))
    return lines


def _health_lines(health: Dict[str, Any]) -> List[str]:
    lines: List[str] = []
    lines.append(f"# TYPE {_PREFIX}_health_degraded gauge")
    lines.append(_line(f"{_PREFIX}_health_degraded", bool(health.get("degraded"))))
    counts = health.get("event_counts") or {}
    if counts:
        lines.append(f"# TYPE {_PREFIX}_health_events_total counter")
        for kind, n in sorted(counts.items()):
            lines.append(_line(f"{_PREFIX}_health_events_total", n, kind=kind))
    serving = health.get("serving")
    if serving:
        for key in ("offered", "accepted", "shed", "processed", "failed"):
            if key in serving:
                metric = f"{_PREFIX}_serve_{key}_total"
                lines.append(f"# TYPE {metric} counter")
                lines.append(_line(metric, serving[key]))
        for key, gauge in (
            ("queue_depth", "serve_queue_depth"),
            ("queue_capacity", "serve_queue_capacity"),
            ("workers", "serve_workers"),
            ("dead_workers", "serve_dead_workers"),
            ("report_staleness_s", "serve_report_staleness_seconds"),
        ):
            if serving.get(key) is not None:
                metric = f"{_PREFIX}_{gauge}"
                lines.append(f"# TYPE {metric} gauge")
                lines.append(_line(metric, serving[key]))
        sync = serving.get("sync") or {}
        for key, gauge in (
            ("sync_lag_steps", "serve_sync_lag_steps"),
            ("sync_lag_s", "serve_sync_lag_seconds"),
        ):
            if sync.get(key) is not None:
                metric = f"{_PREFIX}_{gauge}"
                lines.append(f"# TYPE {metric} gauge")
                lines.append(_line(metric, sync[key]))
    drift = health.get("drift")
    if drift:
        # the drift-monitor surface (obs/drift.py): continuous scores as
        # labeled gauges — None scores (no reference / thin bucket) are
        # skipped, the episode flag and window/check counters always render
        score_lines: Dict[str, List[str]] = {}
        flag_lines: List[str] = []
        window_lines: List[str] = []
        check_lines: List[str] = []
        for name, st in sorted(drift.items()):
            for score, value in (st.get("scores") or {}).items():
                if value is not None:
                    score_lines.setdefault(score, []).append(
                        _line(f"{_PREFIX}_drift_{score}", value, monitor=name)
                    )
            flag_lines.append(
                _line(f"{_PREFIX}_drift_active", bool(st.get("active")), monitor=name)
            )
            if st.get("windows") is not None:
                window_lines.append(
                    _line(f"{_PREFIX}_drift_windows_total", st["windows"], monitor=name)
                )
            if st.get("checks") is not None:
                check_lines.append(
                    _line(f"{_PREFIX}_drift_checks_total", st["checks"], monitor=name)
                )
        for score in sorted(score_lines):
            lines.append(f"# TYPE {_PREFIX}_drift_{score} gauge")
            lines.extend(score_lines[score])
        lines.append(f"# TYPE {_PREFIX}_drift_active gauge")
        lines.extend(flag_lines)
        if window_lines:
            lines.append(f"# TYPE {_PREFIX}_drift_windows_total counter")
            lines.extend(window_lines)
        if check_lines:
            lines.append(f"# TYPE {_PREFIX}_drift_checks_total counter")
            lines.extend(check_lines)
    slices = health.get("slices")
    if slices:
        # the per-cohort surface (sliced/): only the top-N-by-traffic rows
        # per SlicedMetric ever reach the wire (hard label-cardinality cap,
        # METRICS_TPU_SLICES_MAX_LABELS) — the tail folds into one `other`
        # row, so scrape cardinality is bounded no matter how large K grows
        value_lines: List[str] = []
        row_lines: List[str] = []
        other_lines: List[str] = []
        quar_lines: List[str] = []
        disc_lines: List[str] = []
        for name, sc in sorted(slices.items()):
            if "error" in sc:
                continue
            for row in sc.get("top") or ():
                sid = row.get("slice")
                row_lines.append(
                    _line(f"{_PREFIX}_slice_rows", row.get("rows"), metric=name, slice=sid)
                )
                for path, value in sorted((row.get("values") or {}).items()):
                    value_lines.append(
                        _line(
                            f"{_PREFIX}_slice_value",
                            value,
                            metric=name,
                            slice=sid,
                            path=path,
                        )
                    )
            other = sc.get("other") or {}
            if other.get("slices"):
                other_lines.append(
                    _line(f"{_PREFIX}_slice_other_rows", other.get("rows"), metric=name)
                )
            if sc.get("quarantined_rows") is not None:
                quar_lines.append(
                    _line(
                        f"{_PREFIX}_slice_quarantined_rows_total",
                        sc["quarantined_rows"],
                        metric=name,
                    )
                )
            if sc.get("discarded_rows") is not None:
                disc_lines.append(
                    _line(
                        f"{_PREFIX}_slice_discarded_rows_total",
                        sc["discarded_rows"],
                        metric=name,
                    )
                )
        if value_lines:
            lines.append(f"# TYPE {_PREFIX}_slice_value gauge")
            lines.extend(value_lines)
        if row_lines:
            lines.append(f"# TYPE {_PREFIX}_slice_rows gauge")
            lines.extend(row_lines)
        if other_lines:
            lines.append(f"# TYPE {_PREFIX}_slice_other_rows gauge")
            lines.extend(other_lines)
        if quar_lines:
            lines.append(f"# TYPE {_PREFIX}_slice_quarantined_rows_total counter")
            lines.extend(quar_lines)
        if disc_lines:
            lines.append(f"# TYPE {_PREFIX}_slice_discarded_rows_total counter")
            lines.extend(disc_lines)
    fleet = health.get("fleet")
    if fleet:
        # the federated surface: one scrape at the global aggregator shows
        # every host below it — per-host staleness is the "loudly stale"
        # contract made scrapeable
        node = fleet.get("node_id", "global")
        for key, gauge in (
            ("hosts_total", "fleet_hosts"),
            ("hosts_stale", "fleet_hosts_stale"),
            ("downstream_stale", "fleet_downstream_stale"),
            ("stale_after_s", "fleet_stale_after_seconds"),
        ):
            if fleet.get(key) is not None:
                metric = f"{_PREFIX}_{gauge}"
                lines.append(f"# TYPE {metric} gauge")
                lines.append(_line(metric, fleet[key], node=node))
        for key in ("accepted", "duplicates", "rejected"):
            if fleet.get(key) is not None:
                metric = f"{_PREFIX}_fleet_views_{key}_total"
                lines.append(f"# TYPE {metric} counter")
                lines.append(_line(metric, fleet[key], node=node))
        hosts = fleet.get("hosts")
        downstream = fleet.get("downstream")
        stale_host_lines: List[str] = []
        flag_lines: List[str] = []
        update_lines: List[str] = []
        # per-host drift scores federated through the wire-header extra
        # (obs/drift.py fleet_scores): the global aggregator's one scrape
        # names WHICH host is drifting, per monitor
        host_drift_lines: Dict[str, List[str]] = {}
        host_drift_flags: List[str] = []

        def _drift_host_lines(host: str, entry: Dict[str, Any], **extra_labels: Any) -> None:
            for monitor, sc in sorted((entry.get("drift") or {}).items()):
                for score, value in sorted((sc or {}).items()):
                    if score in ("active", "windows") or value is None:
                        continue
                    host_drift_lines.setdefault(score, []).append(
                        _line(
                            f"{_PREFIX}_fleet_host_drift_{score}",
                            value,
                            host=host,
                            monitor=monitor,
                            node=node,
                            **extra_labels,
                        )
                    )
                host_drift_flags.append(
                    _line(
                        f"{_PREFIX}_fleet_host_drift_active",
                        bool((sc or {}).get("active")),
                        host=host,
                        monitor=monitor,
                        node=node,
                        **extra_labels,
                    )
                )

        if isinstance(hosts, dict):
            for host, entry in sorted(hosts.items()):
                if entry.get("staleness_s") is not None:
                    stale_host_lines.append(
                        _line(f"{_PREFIX}_fleet_host_staleness_seconds", entry["staleness_s"], host=host, node=node)
                    )
                flag_lines.append(
                    _line(f"{_PREFIX}_fleet_host_stale", bool(entry.get("stale")), host=host, node=node)
                )
                if entry.get("updates") is not None:
                    update_lines.append(
                        _line(f"{_PREFIX}_fleet_host_updates", entry["updates"], host=host, node=node)
                    )
                _drift_host_lines(host, entry)
        if isinstance(downstream, dict):
            # hosts observed through a child node (pod-forwarded staleness):
            # the `via` label names the reporting child, so one global scrape
            # names a dead LEAF host, not just its dead pod
            for host, entry in sorted(downstream.items()):
                if host in (hosts or {}):
                    continue
                if entry.get("staleness_s") is not None:
                    stale_host_lines.append(
                        _line(
                            f"{_PREFIX}_fleet_host_staleness_seconds",
                            entry["staleness_s"],
                            host=host,
                            node=node,
                            via=entry.get("via", ""),
                        )
                    )
                flag_lines.append(
                    _line(
                        f"{_PREFIX}_fleet_host_stale",
                        bool(entry.get("stale")),
                        host=host,
                        node=node,
                        via=entry.get("via", ""),
                    )
                )
                _drift_host_lines(host, entry, via=entry.get("via", ""))
        if stale_host_lines:
            lines.append(f"# TYPE {_PREFIX}_fleet_host_staleness_seconds gauge")
            lines.extend(stale_host_lines)
        if flag_lines:
            lines.append(f"# TYPE {_PREFIX}_fleet_host_stale gauge")
            lines.extend(flag_lines)
        if update_lines:
            lines.append(f"# TYPE {_PREFIX}_fleet_host_updates gauge")
            lines.extend(update_lines)
        for score in sorted(host_drift_lines):
            lines.append(f"# TYPE {_PREFIX}_fleet_host_drift_{score} gauge")
            lines.extend(host_drift_lines[score])
        if host_drift_flags:
            lines.append(f"# TYPE {_PREFIX}_fleet_host_drift_active gauge")
            lines.extend(host_drift_flags)
    metrics = health.get("metrics") or {}
    fault_lines: List[str] = []
    lag_lines: List[str] = []
    stale_lines: List[str] = []
    for name, entry in sorted(metrics.items()):
        for cls, n in sorted((entry.get("faults") or {}).items()):
            fault_lines.append(
                _line(f"{_PREFIX}_metric_faults_total", n, metric=name, fault_class=cls)
            )
        if entry.get("sync_lag_steps") is not None:
            lag_lines.append(_line(f"{_PREFIX}_metric_sync_lag_steps", entry["sync_lag_steps"], metric=name))
        if entry.get("staleness_s") is not None:
            stale_lines.append(_line(f"{_PREFIX}_metric_staleness_seconds", entry["staleness_s"], metric=name))
    if fault_lines:
        lines.append(f"# TYPE {_PREFIX}_metric_faults_total counter")
        lines.extend(fault_lines)
    if lag_lines:
        lines.append(f"# TYPE {_PREFIX}_metric_sync_lag_steps gauge")
        lines.extend(lag_lines)
    if stale_lines:
        lines.append(f"# TYPE {_PREFIX}_metric_staleness_seconds gauge")
        lines.extend(stale_lines)
    return lines


def prometheus_text(
    health: Optional[Dict[str, Any]] = None,
    runtime: Optional[RuntimeMetrics] = None,
    qs: Sequence[float] = DEFAULT_QUANTILES,
) -> str:
    """One Prometheus text-format scrape over the given health report and
    runtime registry (defaults: the process-wide registry; no health)."""
    lines = _runtime_lines(runtime if runtime is not None else _default_registry, qs)
    if health is not None:
        lines.extend(_health_lines(health))
    return "\n".join(lines) + "\n"


def json_text(
    health: Optional[Dict[str, Any]] = None,
    runtime: Optional[RuntimeMetrics] = None,
    qs: Sequence[float] = DEFAULT_QUANTILES,
) -> str:
    """The same scrape as one JSON document (``runtime`` + ``health``)."""
    doc: Dict[str, Any] = {
        "runtime": (runtime if runtime is not None else _default_registry).snapshot(qs)
    }
    if health is not None:
        doc["health"] = health
    return json.dumps(doc, default=str)


class TelemetryExporter:
    """Scrapeable HTTP endpoint over the process telemetry.

    ``GET /metrics`` serves the Prometheus text format, ``GET
    /metrics.json`` the JSON document; anything else is 404. ``health_fn``
    (e.g. ``loop.health`` or ``metrics_tpu_torch.health_report``) is called per
    scrape so every response reflects live state. ``port=0`` binds an
    ephemeral port (read :attr:`port` / :attr:`url`); the server runs on a
    daemon thread and ``close()`` (or the context manager) shuts it down.
    """

    def __init__(
        self,
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        runtime: Optional[RuntimeMetrics] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        qs: Sequence[float] = DEFAULT_QUANTILES,
    ) -> None:
        exporter = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — http.server API
                try:
                    health = exporter.health_fn() if exporter.health_fn is not None else None
                    if self.path.split("?")[0] == "/metrics":
                        body = prometheus_text(health, exporter.runtime, exporter.qs).encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif self.path.split("?")[0] == "/metrics.json":
                        body = json_text(health, exporter.runtime, exporter.qs).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as err:  # noqa: BLE001 — a scrape must answer, not kill the server
                    self.send_error(500, explain=f"{type(err).__name__}: {err}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:  # silence per-scrape stderr
                pass

        self.health_fn = health_fn
        self.runtime = runtime
        self.qs = qs
        self._server = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="metrics-tpu-exporter"
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host = self._server.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self, timeout_s: float = 5.0) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=timeout_s)

    def __enter__(self) -> "TelemetryExporter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
