"""HTTP transport for the fleet tree (counterpart of
``metrics_tpu/fleet/transport.py``): ingest endpoint + view channel.

The tree's hops run over plain HTTP with stdlib-only machinery, mirroring
``obs/export.py``'s ``TelemetryExporter``:

- :class:`FleetServer` — one aggregator node's wire endpoint: ``POST
  /publish`` ingests a view blob (200 accepted/duplicate, 400 refused with
  the refusal message — corrupt payloads are rejected server-side and
  recorded there), ``GET /metrics`` / ``/metrics.json`` serve the node's
  federated scrape (the whole-fleet Prometheus surface at the global
  node), ``GET /report`` the JSON fold report, ``GET /trace.json`` the
  merged fleet Perfetto trace (every publishing host's shipped timeline
  folded onto one timebase).
- :class:`HttpViewChannel` — the publisher-side channel: POST one blob,
  raise on anything but 200 (the :class:`~metrics_tpu_torch.parallel.retry.
  RetryPolicy` wrapping it owns the retry/breaker budget; this callable
  stays policy-free so fault-injection fakes swap in transparently).

Timeout note: the channel passes its own socket timeout to ``urlopen`` as
a second bound under the policy's deadline, so an abandoned attempt's
daemon thread also dies promptly instead of holding a socket forever.

The JAX package marks the channel's blocking call for its lock witness
(``note_blocking``); the witness is ROADMAP Queue 1, item 18, and the port
marks nothing yet.
"""
import http.server
import json
import threading
import urllib.error
import urllib.request
from typing import Any

from metrics_tpu_torch.fleet.aggregator import Aggregator
from metrics_tpu_torch.fleet.wire import WireError

__all__ = ["FleetServer", "HttpViewChannel"]

_MAX_BLOB_BYTES = 256 * 1024 * 1024  # refuse absurd Content-Length before reading


class HttpViewChannel:
    """``(blob) -> response bytes`` over ``POST url``; raises on non-200."""

    def __init__(self, url: str, timeout_s: float = 10.0) -> None:
        self.url = url
        self.timeout_s = timeout_s

    def __call__(self, blob: bytes) -> bytes:
        req = urllib.request.Request(
            self.url,
            data=blob,
            method="POST",
            headers={"Content-Type": "application/octet-stream"},
        )
        # urlopen raises URLError (refused/unreachable) or HTTPError (4xx/5xx,
        # e.g. a server-side wire refusal) — exactly the signals the retry
        # policy and breaker consume
        # the JAX package's lock-witness seam (note_blocking) stands here:
        # item 18 of ROADMAP Queue 1
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read()

    def __repr__(self) -> str:
        return f"HttpViewChannel({self.url!r})"


class FleetServer:
    """One aggregator node's HTTP endpoint (ingest + federated scrape).

    ``port=0`` binds an ephemeral port (read :attr:`port` / :attr:`url` /
    :attr:`publish_url`); the server runs threaded on a daemon thread and
    ``close()`` (or the context manager) shuts it down. A refused view
    answers 400 with the refusal message in the body — the publishing side
    sees a loud, typed failure, never a silent drop.
    """

    def __init__(self, aggregator: Aggregator, host: str = "127.0.0.1", port: int = 0) -> None:
        server = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self) -> None:  # noqa: N802 — http.server API
                if self.path.split("?")[0] != "/publish":
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self.send_error(411)
                    return
                if not (0 < length <= _MAX_BLOB_BYTES):
                    self.send_error(413 if length > _MAX_BLOB_BYTES else 411)
                    return
                blob = self.rfile.read(length)
                try:
                    status = server.aggregator.ingest(blob, source=self.client_address[0])
                except WireError as err:
                    # refusal: already recorded as fleet_payload_rejected on
                    # the aggregator; answer 400 so the publisher's retry
                    # budget sees a typed failure
                    self._answer(400, str(err).encode(), "text/plain; charset=utf-8")
                    return
                except Exception as err:  # noqa: BLE001 — an ingest bug must not kill the server
                    self.send_error(500, explain=f"{type(err).__name__}: {err}")
                    return
                self._answer(200, status.encode(), "text/plain; charset=utf-8")

            def do_GET(self) -> None:  # noqa: N802 — http.server API
                path = self.path.split("?")[0]
                try:
                    if path == "/metrics":
                        body = server.aggregator.scrape("prometheus").encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path == "/metrics.json":
                        body = server.aggregator.scrape("json").encode()
                        ctype = "application/json"
                    elif path == "/report":
                        body = json.dumps(server.aggregator.report(), default=str).encode()
                        ctype = "application/json"
                    elif path == "/trace.json":
                        # the merged fleet timeline (aggregator.fleet_trace):
                        # one Perfetto-loadable document covering every host
                        # below this node — save it and load at
                        # ui.perfetto.dev / chrome://tracing
                        body = json.dumps(server.aggregator.fleet_trace(), default=str).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as err:  # noqa: BLE001 — a scrape must answer, not kill the server
                    self.send_error(500, explain=f"{type(err).__name__}: {err}")
                    return
                self._answer(200, body, ctype)

            def _answer(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:  # silence per-request stderr
                pass

        self.aggregator = aggregator
        self._server = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            daemon=True,
            name=f"metrics-tpu-fleet-server-{aggregator.node_id}",
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host = self._server.server_address[0]
        return f"http://{host}:{self.port}"

    @property
    def publish_url(self) -> str:
        return f"{self.url}/publish"

    def channel(self, timeout_s: float = 10.0) -> HttpViewChannel:
        """A ready publisher channel pointed at this node's ingest."""
        return HttpViewChannel(self.publish_url, timeout_s=timeout_s)

    def close(self, timeout_s: float = 5.0) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=timeout_s)

    def __enter__(self) -> "FleetServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
