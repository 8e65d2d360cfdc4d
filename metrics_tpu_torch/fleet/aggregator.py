"""Fault-tolerant aggregation node (counterpart of
``metrics_tpu/fleet/aggregator.py``): fold published host views, stay serving.

One :class:`Aggregator` is one node of the fleet's multi-hop reduction
tree (host → pod aggregator → global, a multi-hop all-reduce at the
service level over HTTP). It ingests wire-format view blobs (``fleet/wire.py``), refuses
anything that fails verification, and folds the accepted views through the
framework's existing merge protocol — the same ``_reduce_states`` /
``sketch_merge`` / FaultCounters-sum / count-weighted-mean fold
``ServeLoop`` uses for its worker replicas — into one reported value.

**Idempotent by construction.** Every view is a host's *cumulative* state
named by ``(host_id, seq)``; the fold is last-write-wins per host, never
an accumulation of deltas. Re-delivered, duplicated, or reordered blobs
fold at most once (an older or equal ``seq`` is ignored), and a pod
aggregator re-publishing its whole merged view upward each cadence is
likewise replace-not-add at the global node — no hop can double-count.
(The corollary contract: a host must publish to exactly one pod; moving a
live host between pods without restarting its identity would fold its
stream twice, once per pod that remembers it.)

**Degradation model** (the ``RetryingGather`` stance, service-level): a
dead or flapping host simply stops refreshing its view — the aggregator
keeps serving the last accepted view, marks the host **loudly stale**
(``fleet_host_stale`` health event once per episode, per-host
``staleness_s`` in every report and scrape) and never blocks. A corrupt
or config-mismatched view is refused with a ``fleet_payload_rejected``
event naming the host and leaf; the previous intact view keeps serving.
A recovered host's next accepted view clears its staleness episode.

**The prototype decides the device.** :meth:`Aggregator.ingest` loads each
accepted view into a clone of the prototype, and the fold clones it again
and merges every host's states there, in the hosts' sorted order (the JAX
package's order, so sketch states come out bit-equal to its fold of the
same views). With a CUDA prototype every held view lives in device memory
and a quantile sketch's merge is one launch of kernel K3
(``csrc/compactor_fold.cu``); with ``device="cpu"`` the plain merge runs.

Everything here is host-side python over snapshot payloads: the fleet tier
adds no collective. ``threading.Lock`` stands where the JAX package uses
``named_lock``, the lock witness (ROADMAP Queue 1, item 18).
"""
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, Optional

from metrics_tpu_torch.fleet.wire import (
    WireError,
    apply_delta,
    decode_view,
    encode_view,
    is_delta_payload,
    next_seq,
)
from metrics_tpu_torch.fleet._env import resolve_fleet_knob
from metrics_tpu_torch.obs import trace as _obs_trace
from metrics_tpu_torch.resilience.health import health_report, record_degradation
from metrics_tpu_torch.serving.loop import _clone, _fold_snapshot, _members, _snapshot_of
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError

__all__ = ["Aggregator"]

# per-host timeline retention (events accumulated from wire trace sections)
# and the cap on events a pod forwards per host when re-publishing upward
_TRACE_EVENTS_PER_HOST = 4096
_TRACE_EVENTS_FORWARDED = 512


def _trace_event_key(ev: Any) -> Any:
    """Identity of one Chrome event for ingest dedup. Span/instant/flow
    rows are identified by (phase, name, thread, start µs, duration, flow
    id); metadata (``ph='M'``) rows carry their payload in ``args``, so two
    metadata rows differ only if their args do."""
    if not isinstance(ev, dict):
        return repr(ev)
    key = (
        ev.get("ph"),
        ev.get("name"),
        ev.get("tid"),
        ev.get("ts"),
        ev.get("dur"),
        ev.get("id"),
    )
    if ev.get("ph") == "M":
        key += (repr(sorted((ev.get("args") or {}).items(), key=repr)),)
    return key


class Aggregator:
    """Fold wire-format host views into one served value.

    Example (one pod node)::

        agg = Aggregator(Accuracy(num_classes=10), node_id="pod-0")
        status = agg.ingest(blob)        # "accepted" | "duplicate:<seq>" | "rebase:<seq|none>"
        rep = agg.report()               # value + per-host staleness
        text = agg.scrape()              # Prometheus text for the whole subtree

    ``metric`` is the pristine prototype (Metric or MetricCollection) every
    published view must structurally match — a mismatched view is refused
    at ingest, before it can poison the fold. Multi-hop composition:
    :meth:`view_blob` encodes this node's merged view under its own
    ``node_id``, ready to push to the next hop (``FleetPublisher(agg, ...)``
    does exactly that on a cadence).
    """

    def __init__(
        self,
        metric: Any,
        node_id: str = "global",
        stale_after_s: Optional[float] = None,
    ) -> None:
        if not node_id:
            raise MetricsTPUUserError("`node_id` must be a non-empty string")
        self.node_id = node_id
        self.stale_after_s = resolve_fleet_knob("stale_after_s", stale_after_s)
        self._proto = metric
        self._lock = threading.Lock()
        # host_id -> {"seq", "snap", "updates", "published_unix",
        #             "received_unix", "received_mono", "stale_reported"}
        self._views: Dict[str, Dict[str, Any]] = {}
        self._accepted = 0
        self._duplicates = 0
        self._rejected: Dict[str, int] = {}
        self._downstream_reported: Dict[str, bool] = {}  # stale-episode state
        # (fold version, reporter): the version moves when a held view's
        # states change, so an idle host's publishes re-fold nothing
        self._fold_cache: Optional[Any] = None
        self._fold_version = 0
        self._view_cache: Optional[Any] = None  # (reporter, its snapshot_state payload)
        self._seq = 0  # this node's own publish sequence (multi-hop)
        # (payload, seq) pairing order
        self._publish_lock = threading.Lock()
        # per-host timeline sections accumulated from wire header trace
        # extras: host_id -> {"clock", "events" (bounded), "offset_s"} —
        # what fleet_trace() merges into ONE Perfetto document
        self._trace_sections: Dict[str, Dict[str, Any]] = {}
        # the newest accepted view's publish-span context: the fold span
        # links to it (the cross-process leg of the causal chain)
        self._last_trace_ctx: Optional[_obs_trace.TraceContext] = None

    # -- ingest ---------------------------------------------------------

    def ingest(self, blob: bytes, source: Optional[str] = None) -> str:
        """Decode-validate-or-refuse one published view blob.

        Returns ``"accepted"`` (the host's view advanced),
        ``"duplicate:<held_seq>"`` (re-delivered/reordered blob with a
        known or older ``seq`` — folded once by construction, so this is a
        no-op, not an error; the held seq lets a publisher detect a
        persistent seq regression and jump past it), or
        ``"rebase:<held_seq|none>"`` (a DELTA blob whose ``base_seq`` does
        not match the seq this node holds for the host — after an
        aggregator restart, or when the base publish never landed here; an
        answer, not an error: the held view keeps serving and the
        publisher re-ships a full view next pass).
        Raises :class:`~metrics_tpu_torch.fleet.wire.WireError` when the
        blob fails checksum/schema verification or does not match the
        aggregator's metric configuration — recorded as a
        ``fleet_payload_rejected`` health event naming the host (or
        ``source``, e.g. the peer address, when the header itself is
        unreadable) and the offending leaf.
        """
        try:
            header, payload = decode_view(blob)
        except WireError as err:
            self._reject(source or "<unknown>", str(err))
            raise
        host = header["host_id"]
        with self._lock:
            current_seq = (self._views.get(host) or {}).get("seq")
        if current_seq is not None and header["seq"] <= current_seq:
            # cheap pre-check: an at-least-once transport re-delivers whole
            # blobs (the publisher's designed retry_timeouts path), and a
            # known-or-older seq will be discarded anyway — skip the
            # deepcopy + transactional load. The store below re-checks under
            # the lock, so a racing fresher ingest still wins. The answer
            # carries the seq the fold currently holds: a publisher seeing
            # "duplicate" repeatedly (a restarted host whose wall clock
            # stepped BACKWARD, so next_seq floors below the pre-restart
            # seq) reads it and jumps its sequence past the regression —
            # without it the host would be silently dropped for the whole
            # skew duration while both ends report healthy.
            with self._lock:
                self._duplicates += 1
            # the trace section still folds: a duplicate VIEW seq (seq
            # regression after a host restart, retry re-delivery) can carry
            # a FRESH timeline delta — the publisher treats the duplicate
            # answer as delivered and advances its cursor, so dropping the
            # section here would hole the merged trace for the whole
            # regression window (ingest dedup makes re-folds idempotent)
            self._ingest_trace(host, header)
            return f"duplicate:{current_seq}"
        same_snap = None
        if is_delta_payload(payload):
            # a delta folds onto the EXACT view named by its base_seq: the
            # publisher commits a base only after this node answered
            # "accepted", so held_seq != base_seq means this node missed
            # that publish (restart, never reached) — answer rebase and
            # keep serving the held view; the publisher re-ships full
            with self._lock:
                held = self._views.get(host)
                base_payload = held.get("payload") if held else None
                held_seq = held["seq"] if held else None
            if base_payload is None or held_seq != payload["base_seq"]:
                return f"rebase:{held_seq if held_seq is not None else 'none'}"
            if not payload["changed"]:
                # every leaf is the held view's (an idle host): its checked
                # snapshot is reused, with no clone and no copy to the device
                same_snap = held["snap"]
            try:
                payload = apply_delta(base_payload, payload)
            except WireError as err:
                # seq matched but a changed path is absent from the base:
                # corruption or a structural diff the publisher must never
                # ship — refuse loudly, exactly like a checksum failure
                msg = f"delta view from host {host!r} refused: {err}"
                self._reject(host, msg)
                raise WireError(f"{self.node_id}: {msg}")
        # structural validation against the prototype: load_snapshot_state
        # is transactional and refuses unknown states/children/shapes naming
        # the offender — a checksum-intact view from a mis-configured host
        # must be refused here, not crash the fold later
        if same_snap is None:
            scratch = _clone(self._proto)
            try:
                scratch.load_snapshot_state(payload)
            except Exception as err:  # noqa: BLE001 — refusal path, always loud
                msg = f"view from host {host!r} does not match this aggregator's metric config: {err}"
                self._reject(host, msg)
                raise WireError(f"{self.node_id}: {msg}")
            same_snap = _snapshot_of(scratch)
        entry = {
            "seq": header["seq"],
            "snap": same_snap,
            # the decoded FULL payload (delta blobs store their rebuilt
            # view): the base the next delta from this host folds onto
            "payload": payload,
            "updates": header.get("updates"),
            "published_unix": header.get("published_unix"),
            "received_unix": time.time(),
            "received_mono": time.monotonic(),
            "stale_reported": False,
            # staleness table the publishing node observed for ITS children
            # (a pod forwarding its hosts): the federation channel that lets
            # the global scrape name a dead leaf host, not just a dead pod
            "downstream": (header.get("extra") or {}).get("hosts") or {},
            # the publisher's drift scores (ServeLoop.fleet_extra →
            # obs/drift.py fleet_scores): per-monitor score/episode dicts,
            # so the global scrape names the drifting HOST, not just "some
            # host below this node is drifting"
            "drift": (header.get("extra") or {}).get("drift") or {},
        }
        with self._lock:
            current = self._views.get(host)
            if current is not None and header["seq"] <= current["seq"]:
                self._duplicates += 1
                duplicate_seq = current["seq"]
            else:
                if current is None or current["snap"] is not entry["snap"]:
                    self._fold_version += 1  # the fold's inputs changed
                self._views[host] = entry
                self._accepted += 1
                duplicate_seq = None
        self._ingest_trace(host, header)  # idempotent; see the pre-check note
        if duplicate_seq is not None:
            return f"duplicate:{duplicate_seq}"
        return "accepted"

    def _ingest_trace(self, host: str, header: Dict[str, Any]) -> None:
        """Fold the wire header's timeline section (and any pod-forwarded
        child sections) into the per-host accumulators behind
        :meth:`fleet_trace`; remembers the publish span's context so the
        next fold links to it. Absent sections (tracing off at the host)
        cost nothing."""
        extra = header.get("extra") or {}
        sections: Dict[str, Any] = {}
        section = extra.get("trace")
        if isinstance(section, dict):
            sections[host] = section
        children = extra.get("trace_children")
        if isinstance(children, dict):
            for child, child_section in children.items():
                if isinstance(child_section, dict):
                    sections.setdefault(str(child), child_section)
        if not sections:
            return
        # one-way clock-offset estimate (receive wall - publish wall):
        # contaminated by network latency, so it is REPORTED per process in
        # the merged trace, never silently applied to timestamps
        offset = None
        if isinstance(header.get("published_unix"), float):
            offset = time.time() - header["published_unix"]
        with self._lock:
            for name, sec in sections.items():
                acc = self._trace_sections.get(name)
                if acc is None:
                    acc = self._trace_sections[name] = {
                        "clock": None,
                        "events": deque(maxlen=_TRACE_EVENTS_PER_HOST),
                        "offset_s": None,
                        # bounded seen-key window: re-delivered deltas (a
                        # publisher re-ships after a failed pass) and
                        # pod-re-forwarded child timelines (children send
                        # their last-N on EVERY cadence) must fold once —
                        # blind extend() would stack every span N times and
                        # evict the real history from the bounded deque
                        "seen": OrderedDict(),
                    }
                if sec.get("clock"):
                    acc["clock"] = sec["clock"]
                if offset is not None and name == host:
                    acc["offset_s"] = offset
                seen = acc["seen"]
                for ev in sec.get("events") or []:
                    key = _trace_event_key(ev)
                    if key in seen:
                        continue
                    seen[key] = None
                    if len(seen) > 2 * _TRACE_EVENTS_PER_HOST:
                        seen.popitem(last=False)
                    acc["events"].append(ev)
            ctx = section.get("ctx") if isinstance(section, dict) else None
            if ctx and ctx.get("trace_id") is not None:
                self._last_trace_ctx = _obs_trace.TraceContext(ctx["trace_id"], ctx["span_id"])

    def _reject(self, host: str, message: str) -> None:
        with self._lock:
            self._rejected[host] = self._rejected.get(host, 0) + 1
        record_degradation(
            "fleet_payload_rejected",
            f"aggregator {self.node_id}: {message}",
            node_id=self.node_id,
            host=host,
        )

    # -- staleness ------------------------------------------------------

    def _sweep_staleness(self) -> Dict[str, Dict[str, Any]]:
        """Per-host staleness snapshot; records ``fleet_host_stale`` once
        per episode (a fresh accepted view resets the episode). Ages are
        measured on this node's monotonic clock from receipt — publisher
        clocks are display-only, so cross-process skew cannot mark a live
        host stale."""
        now_mono = time.monotonic()
        stale_events = []
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for host, v in self._views.items():
                age = max(0.0, now_mono - v["received_mono"])
                stale = age > self.stale_after_s
                if stale and not v["stale_reported"]:
                    v["stale_reported"] = True
                    stale_events.append((host, age, v["seq"]))
                out[host] = {
                    "seq": v["seq"],
                    "updates": v["updates"],
                    "published_unix": v["published_unix"],
                    "received_unix": v["received_unix"],
                    "staleness_s": age,
                    "stale": stale,
                }
                if v.get("drift"):
                    out[host]["drift"] = v["drift"]
        for host, age, seq in stale_events:
            record_degradation(
                "fleet_host_stale",
                f"aggregator {self.node_id}: host {host!r} has published nothing for "
                f"{age:.1f}s (> {self.stale_after_s:g}s); its last view (seq {seq}) is "
                "serving loudly stale",
                node_id=self.node_id,
                host=host,
                staleness_s=age,
            )
        return out

    def _downstream(self) -> Dict[str, Dict[str, Any]]:
        """Hosts visible THROUGH this node's children (pod-forwarded
        staleness tables), ages advanced by each child view's own age —
        a killed pod's hosts keep aging here and cross the threshold even
        though the pod can no longer report them. Stale transitions record
        ``fleet_host_stale`` once per episode, in THIS process's registry:
        in a multi-process tree the reporting pod's registry is elsewhere,
        so the root must carry the event for its own scrape."""
        now_mono = time.monotonic()
        out: Dict[str, Dict[str, Any]] = {}
        stale_events = []
        with self._lock:
            for via, v in self._views.items():
                view_age = max(0.0, now_mono - v["received_mono"])
                for name, d in (v.get("downstream") or {}).items():
                    # staleness VERDICT: while the child view is fresh, the
                    # child's own judgment stands (it watches the leaf
                    # directly; re-thresholding the compounded leaf+transit
                    # age here would spuriously flag healthy leaves whenever
                    # cadences approach stale_after_s). Only once the child
                    # ITSELF goes silent do its unobservable leaves go stale
                    # locally. The reported age stays the honest compound.
                    out[name] = {
                        "staleness_s": float(d.get("staleness_s") or 0.0) + view_age,
                        "stale": bool(d.get("stale")) or view_age > self.stale_after_s,
                        "via": via,
                    }
                    if d.get("drift"):
                        # leaf drift forwarded by the pod: scores pass
                        # through verbatim (they describe the LEAF's window)
                        out[name]["drift"] = d["drift"]
            for name, e in out.items():
                if e["stale"] and not self._downstream_reported.get(name):
                    self._downstream_reported[name] = True
                    stale_events.append((name, e["via"], e["staleness_s"]))
                elif not e["stale"]:
                    self._downstream_reported[name] = False  # episode over
        for name, via, age in stale_events:
            record_degradation(
                "fleet_host_stale",
                f"aggregator {self.node_id}: downstream host {name!r} (via {via!r}) is "
                f"loudly stale ({age:.1f}s > {self.stale_after_s:g}s, or reported stale "
                "by its aggregator)",
                node_id=self.node_id,
                host=name,
                via=via,
                staleness_s=age,
            )
        return out

    # -- fold / report --------------------------------------------------

    def _fold(self) -> Any:
        """One clone+fold pass over the current views (the ServeLoop
        reduce, across processes instead of worker threads), cached on the
        fold version: scrape/report/publish cadences between ingests
        re-read the same folded reporter instead of re-paying deepcopy + N
        folds + compute per call, while any accepted view that changes a
        held state invalidates the cache (the JAX package keys it on every
        accepted view; an idle host's delta changes nothing) — scrape-only
        deployments still see live fold state. (A reporter, once cached, is
        never mutated again — concurrent readers at worst recompute the
        identical value.)"""
        with self._lock:
            key = self._fold_version
            cached = self._fold_cache
            if cached is not None and cached[0] == key:
                return cached[1]
            snaps = [self._views[h]["snap"] for h in sorted(self._views)]
            link = self._last_trace_ctx
        # the fold span links to the newest accepted view's publish span —
        # the final hop of the causal chain (offer → worker-update → reduce
        # → publish → THIS fold), drawn as one flow line in the merged trace
        with _obs_trace.span("fleet.fold", link_to=link, node=self.node_id, hosts=len(snaps)):
            reporter = _clone(self._proto)
            for snap in snaps:
                _fold_snapshot(reporter, snap)
        with self._lock:
            # racing folds both computed from >= this key's views; keep the
            # newer key (another ingest may have landed mid-fold, in which
            # case the next reader re-folds)
            if self._fold_cache is None or self._fold_cache[0] <= key:
                self._fold_cache = (key, reporter)
        return reporter

    def report(self) -> Dict[str, Any]:
        """The folded fleet value plus per-host staleness — never blocks on
        a dead host (its last view serves, marked stale)."""
        hosts = self._sweep_staleness()
        downstream = self._downstream()
        reporter = self._fold()
        updates = sum(m._update_count for _, m in _members(reporter))
        faults = {}
        for name, m in _members(reporter):
            fc = getattr(m, "fault_counts", None)
            if fc:
                faults[name or type(m).__name__] = fc
        with self._lock:
            rejected = dict(self._rejected)
        return {
            "value": reporter.compute() if updates else None,
            "updates": updates,
            "node_id": self.node_id,
            "hosts": hosts,
            "hosts_stale": sum(1 for h in hosts.values() if h["stale"]),
            "downstream_stale": sum(1 for h in downstream.values() if h["stale"]),
            "downstream": downstream,
            # same shapes as health()["fleet"]: int total + per-host dict —
            # a consumer alerting on one surface reads the other identically
            "rejected": sum(rejected.values()),
            "rejected_by_host": rejected,
            "faults": faults,
            "computed_unix": time.time(),
        }

    # -- multi-hop ------------------------------------------------------

    def fleet_view(self) -> Optional[Dict[str, Any]]:
        """This node's merged view as a ``snapshot_state`` payload (None
        until the first host view lands) — the publisher-source hook, same
        surface as ``ServeLoop.fleet_view``."""
        with self._lock:
            empty = not self._views
        if empty:
            return None
        return self._view_of(self._fold())

    def _view_of(self, reporter: Any) -> Dict[str, Any]:
        """``reporter.snapshot_state()``, read back once per folded reporter
        (it is never mutated): an unchanged fold publishes with no device
        read. The payload is shared; its readers never write it."""
        cached = self._view_cache
        if cached is not None and cached[0] is reporter:
            return cached[1]
        payload = reporter.snapshot_state()
        self._view_cache = (reporter, payload)
        return payload

    def fleet_extra(self) -> Optional[Dict[str, Any]]:
        """Header extra for this node's upward publishes: the per-host
        staleness table (direct children + anything they forwarded) plus
        each host's drift scores, so staleness AND drift federate to the
        root along with the values. ``FleetPublisher`` calls this per
        publish when the source defines it — the staleness sweep therefore
        runs on the publish cadence, which is exactly when a dead child
        must be noticed."""

        def row(e: Dict[str, Any]) -> Dict[str, Any]:
            out = {"staleness_s": e["staleness_s"], "stale": e["stale"]}
            if e.get("drift"):
                out["drift"] = e["drift"]
            return out

        table = {name: row(e) for name, e in self._sweep_staleness().items()}
        for name, e in self._downstream().items():
            table.setdefault(name, row(e))
        out: Dict[str, Any] = {"hosts": table} if table else {}
        # forward the children's timelines up the tree (bounded per host):
        # the publisher adds THIS process's own ring as extra["trace"], so
        # with this the global node merges leaf hosts it never met directly
        with self._lock:
            children = {
                name: {
                    "clock": acc["clock"],
                    "events": list(acc["events"])[-_TRACE_EVENTS_FORWARDED:],
                }
                for name, acc in self._trace_sections.items()
                if acc["clock"] is not None or acc["events"]
            }
        if children:
            out["trace_children"] = children
        return out or None

    def view_blob(self) -> Optional[bytes]:
        """Encode the merged view under this node's identity for the next
        hop up the tree (the in-process form of what ``FleetPublisher``
        does on a cadence). Seq increases per call (wall-clock floored so a
        restarted node never re-publishes under an already-folded seq)."""
        # fold-then-seq under ONE lock (the publish_now pairing rule): two
        # concurrent view_blob calls folding and seq-assigning in opposite
        # orders would hand the downstream fold an older payload under a
        # newer seq, pinning stale state until the next publish. Payload and
        # updates also come from ONE fold result, so a racing ingest cannot
        # pair a fresh payload with a stale update count.
        with self._publish_lock:
            with self._lock:
                if not self._views:
                    return None
            reporter = self._fold()
            payload = self._view_of(reporter)
            updates = sum(m._update_count for _, m in _members(reporter))
            extra = self.fleet_extra()
            with self._lock:
                self._seq = next_seq(self._seq)
                seq = self._seq
        return encode_view(
            payload,
            host_id=self.node_id,
            seq=seq,
            updates=updates,
            extra=extra,
        )

    # -- observability --------------------------------------------------

    def fleet_trace(self) -> Dict[str, Any]:
        """ONE merged Perfetto-loadable trace document for the whole
        subtree under this node: every host's shipped timeline section
        (span events + causal flow arrows, rebased from each host's
        monotonic clock onto its wall clock via the shipped
        ``clock_sync()`` pairing) plus this process's own ring — load it
        at ui.perfetto.dev and a request's chain reads host offer →
        worker-update → serve reduce → fleet publish → this node's fold,
        with each process a named track (``FleetServer`` serves it at
        ``GET /trace.json``). Per-host ``clock_offset_estimate_s``
        (receive-publish wall delta, latency-contaminated) rides each
        process's metadata for skew diagnosis."""
        with self._lock:
            sections = [
                {
                    "host_id": name,
                    "clock": acc["clock"],
                    "events": list(acc["events"]),
                    "clock_offset_estimate": acc["offset_s"],
                }
                for name, acc in sorted(self._trace_sections.items())
            ]
        own = {
            "host_id": f"aggregator:{self.node_id}",
            "clock": _obs_trace.clock_sync(),
            "events": _obs_trace.chrome_trace_events(host_id=f"aggregator:{self.node_id}"),
        }
        return _obs_trace.merge_chrome_sections([own] + sections)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hosts": len(self._views),
                "accepted": self._accepted,
                "duplicates": self._duplicates,
                "rejected": sum(self._rejected.values()),
            }

    def health(self) -> Dict[str, Any]:
        """``health_report()`` over the folded view plus the fleet section
        (per-host staleness, accept/duplicate/reject accounting) —
        federated: one report covers every host below this node."""
        # sweep BEFORE building the report: a host crossing the staleness
        # threshold right now must show in THIS scrape's event counts
        hosts = self._sweep_staleness()
        downstream = self._downstream()
        # fold NOW, not whenever report() last ran: a deployment whose only
        # reader is the Prometheus scraper must still see live fold fault
        # counters, never a stale (or absent) reporter
        with self._lock:
            has_views = bool(self._views)
        rep = health_report(self._fold()) if has_views else health_report()
        stats = self.stats()
        with self._lock:
            rejected = dict(self._rejected)
        rep["fleet"] = {
            "node_id": self.node_id,
            "stale_after_s": self.stale_after_s,
            "hosts": hosts,
            "hosts_total": stats["hosts"],
            "hosts_stale": sum(1 for h in hosts.values() if h["stale"]),
            # summary gauge for the leaves too: a dead host behind a HEALTHY
            # pod never flips hosts_stale (the pod is fresh), so an operator
            # alerting on one aggregate number at the global must have this
            "downstream_stale": sum(1 for h in downstream.values() if h["stale"]),
            "downstream": downstream,
            "accepted": stats["accepted"],
            "duplicates": stats["duplicates"],
            "rejected": stats["rejected"],
            "rejected_by_host": rejected,
        }
        return rep

    def scrape(self, fmt: str = "prometheus") -> str:
        """One exporter scrape for the whole subtree under this node: the
        federated :meth:`health` (per-host staleness gauges, event-kind
        counts, fold fault counters) through the existing ``obs/export``
        renderers. Serve it over HTTP with
        :class:`~metrics_tpu_torch.fleet.transport.FleetServer` (which exposes
        ``/metrics`` + ``/metrics.json`` next to the ``/publish`` ingest
        endpoint) or :class:`metrics_tpu_torch.obs.TelemetryExporter`
        (``TelemetryExporter(health_fn=agg.health)``)."""
        from metrics_tpu_torch.obs.export import json_text, prometheus_text

        if fmt == "prometheus":
            return prometheus_text(health=self.health())
        if fmt == "json":
            return json_text(health=self.health())
        raise MetricsTPUUserError(f"`fmt` must be 'prometheus' or 'json', got {fmt!r}")
