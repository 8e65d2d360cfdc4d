"""Fleet aggregation tier (counterpart of ``metrics_tpu/fleet/``): a
fault-tolerant multi-hop reduction tree over published host views, the
cross-process scale-out of the in-process ``ServeLoop`` reduce.

Topology (a multi-hop all-reduce at the service level, over HTTP)::

    ServeLoop host ──FleetPublisher──▶ pod Aggregator ──FleetPublisher──▶ global Aggregator
        (×N per pod)                       (×pods)                            (scrape()
                                                                              = one /metrics
                                                                              for the fleet)

Four pieces, each reusing an existing subsystem's discipline:

- ``fleet/wire.py`` — the versioned, per-leaf-sha256 view format
  (``resilience/snapshot.py``'s integrity walk, applied to an in-memory
  publish); corrupt views are refused naming host and leaf.
- ``fleet/aggregator.py`` — :class:`Aggregator` folds host views through
  the framework's merge protocol (``_reduce_states`` / ``sketch_merge`` /
  FaultCounters sum / count-weighted means — the ServeLoop fold, across
  processes), idempotent per host (views are cumulative state keyed by
  ``(host_id, seq)``; folds are last-write-wins, re-delivery folds once).
- ``fleet/publisher.py`` — :class:`FleetPublisher` pushes views on a
  cadence through the shared :class:`~metrics_tpu_torch.parallel.retry.
  RetryPolicy` budget with a per-destination breaker; a dead aggregator
  degrades this host to loudly-stale (``fleet_publish_error`` /
  ``fleet_host_stale`` events), never blocks serving.
- ``fleet/transport.py`` — the stdlib HTTP hop (:class:`FleetServer`
  ingest + federated scrape endpoint, :class:`HttpViewChannel` push).

The whole tier is host-side python over snapshot payloads: it adds no
collective. Its wire format is the JAX package's, so ports and JAX hosts
publish into one tree.
"""
from metrics_tpu_torch.fleet.aggregator import Aggregator
from metrics_tpu_torch.fleet.publisher import FleetPublisher
from metrics_tpu_torch.fleet.transport import FleetServer, HttpViewChannel
from metrics_tpu_torch.fleet.wire import (
    WireCorruptionError,
    WireError,
    WireSchemaError,
    decode_view,
    encode_view,
)
from metrics_tpu_torch.fleet._env import reset_fleet_env_state

__all__ = [
    "Aggregator",
    "FleetPublisher",
    "FleetServer",
    "HttpViewChannel",
    "WireCorruptionError",
    "WireError",
    "WireSchemaError",
    "decode_view",
    "encode_view",
    "reset_fleet_env_state",
]
