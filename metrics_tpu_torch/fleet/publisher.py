"""Cadenced host-side view publisher (counterpart of
``metrics_tpu/fleet/publisher.py``): push, retry, breaker, loudly-stale.

``FleetPublisher`` is the host end of the fleet tree: on a cadence it
snapshots its source's reduced view (a ``ServeLoop``, an ``Aggregator``
re-publishing upward, or any ``Metric``/``MetricCollection``), encodes it
with this host's identity + an increasing sequence (``fleet/wire.py``),
and pushes the blob to every configured destination through a
:class:`~metrics_tpu_torch.parallel.retry.RetryPolicy` — the same
timeout/backoff/breaker budget ``RetryingGather`` runs, with
``retry_timeouts=True`` because a view push is idempotent (last-write-wins
per host at the aggregator), so re-sending after a timeout can at worst
deliver the same view twice, which folds once.

Degradation contract (the breaker stance, publish-side): a dead or
flapping aggregator NEVER blocks serving — the publisher runs on its own
daemon thread, each attempt is deadline-bounded, and once a destination's
budget is exhausted its breaker opens so subsequent cadences skip it
cheaply. Failures surface as ``fleet_publish_error`` health events; when a
destination has accepted nothing for ``stale_after_s`` the host records
``fleet_host_stale`` once per episode — this host KNOWS the aggregator's
view of it is now stale (the aggregator marks the same staleness from its
side, so the gap is visible from both ends of the broken link). A
successful push closes the breaker and ends the episode.

Destinations are plain callables ``(blob: bytes) -> Any`` —
``fleet.transport.HttpViewChannel`` in production, injectable fakes in
tests.

A ``ServeLoop`` source's ``fleet_view()`` reads the reporter's states back
from the card once per reduce, on this publisher's thread, never on the
request path. ``threading.Lock`` stands where the JAX package uses
``named_lock``, the lock witness (ROADMAP Queue 1, item 18).
"""
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

from metrics_tpu_torch.fleet.wire import delta_changes, encode_delta_view, encode_view, next_seq
from metrics_tpu_torch.fleet._env import resolve_fleet_delta, resolve_fleet_knob
from metrics_tpu_torch.obs import trace as _obs_trace
from metrics_tpu_torch.parallel.retry import CircuitOpenError, RetryBudgetExceededError, RetryPolicy
from metrics_tpu_torch.resilience.health import record_degradation
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError

# spans shipped per publish (the incremental timeline export): bounds the
# wire cost of a busy host's ring delta to a few hundred KB worst case
_TRACE_EVENTS_PER_PUBLISH = 2048

__all__ = ["FleetPublisher"]

Channel = Callable[[bytes], Any]


def _metric_token(name: str) -> str:
    """A destination name as a metric-name-safe token (the per-destination
    histogram suffix: ``fleet_publish_ms_<token>``)."""
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _payload_updates(payload: Dict[str, Any]) -> int:
    """Total update count of a snapshot payload (collection members sum;
    child metrics are part of their parent's tree, not extra updates)."""
    if "members" in payload and "states" not in payload:
        return sum(_payload_updates(p) for p in payload["members"].values())
    return int(payload.get("update_count", 0))


class FleetPublisher:
    """Publish a source's reduced view to aggregator destination(s).

    Example::

        loop = ServeLoop(metric, workers=4)
        pub = FleetPublisher(
            loop,
            destinations={"pod-0": HttpViewChannel(url)},
            host_id="host-17",
            publish_every_s=0.5,
        )
        ...
        pub.stop()

    ``source`` must expose ``fleet_view() -> payload | None``
    (``ServeLoop``, ``Aggregator``) or ``snapshot_state() -> payload``
    (any Metric/MetricCollection). **Thread contract for bare metric
    sources:** the cadence thread calls ``snapshot_state()``, which on a
    blocking-mode metric is NOT synchronized against a concurrent
    ``update()`` — a torn view could pair state N with count N+1. Either
    update and publish from one thread (``start=False`` +
    :meth:`publish_now`), construct the metric with
    ``sync_mode='overlapped'`` (whose swap guard makes snapshots
    consistent), or — the production pattern — serve it through a
    ``ServeLoop``, whose ``fleet_view()`` reads an immutable reduced
    reporter and is race-free by construction. ``destinations`` is one channel or a
    ``{name: channel}`` mapping — each destination gets its OWN retry
    policy and breaker, so one dead pod aggregator cannot starve pushes
    to a healthy one. Knobs resolve programmatic > ``METRICS_TPU_FLEET_*``
    env > default (``fleet/_env.py``). ``start=False`` defers the cadence
    thread — call :meth:`start` later, or drive :meth:`publish_now`
    manually (note: :meth:`request` only wakes a RUNNING cadence thread).
    """

    def __init__(
        self,
        source: Any,
        destinations: Union[Channel, Mapping[str, Channel]],
        host_id: str,
        publish_every_s: Optional[float] = None,
        deadline_s: Optional[float] = None,
        max_retries: int = 1,
        backoff_s: float = 0.25,
        breaker_cooldown_s: Optional[float] = None,
        stale_after_s: Optional[float] = None,
        start: bool = True,
        encoding: Optional[str] = None,
        delta: Optional[bool] = None,
    ) -> None:
        if not host_id:
            raise MetricsTPUUserError("`host_id` must be a non-empty string")
        # quantized fleet payloads (fleet/wire.py): `encoding=` opts this
        # publisher into blockwise-int8 + zlib view blobs ("int8"); None
        # resolves METRICS_TPU_FLEET_ENCODING > pickle-v1 per publish. A
        # programmatic typo raises here (code, not deployment config).
        if encoding is not None:
            from metrics_tpu_torch.fleet.wire import resolve_fleet_encoding

            resolve_fleet_encoding(encoding)  # validate eagerly
        self._encoding = encoding
        # delta publishing: tri-state kept as given; each pass
        # resolves programmatic > METRICS_TPU_FLEET_DELTA > off, so the env
        # knob can flip a running fleet without reconstruction. The commit
        # protocol is the trace cursor's: `_delta_base` holds the
        # (per-leaf digest table, seq) of the last view EVERY attempted
        # destination ACCEPTED; a pass with a valid base ships only dirty
        # leaves, and any reject / non-accept / seq jump / `rebase:` answer
        # clears the base so the next pass re-ships a full view.
        self._delta = delta
        self._delta_base: Optional[Tuple[Dict[str, str], int]] = None
        self._last_full_bytes: Optional[int] = None
        if hasattr(source, "fleet_view"):
            self._view_fn = source.fleet_view
        elif hasattr(source, "snapshot_state"):
            self._view_fn = source.snapshot_state
        else:
            raise MetricsTPUUserError(
                f"`source` ({type(source).__name__}) exposes neither fleet_view() nor "
                "snapshot_state(); pass a ServeLoop, Aggregator, Metric, or MetricCollection"
            )
        # optional source hook: header extra per publish (an Aggregator
        # forwards its per-host staleness table up the tree through this)
        self._extra_fn = getattr(source, "fleet_extra", None)
        # optional causal hook (obs/trace.py): the trace context of the
        # reduce that built the published view (ServeLoop/Aggregator), so
        # the publish span links back to it and the aggregator's fold can
        # link forward — one unbroken chain from host offer to global fold
        self._trace_ctx_fn = getattr(source, "fleet_trace_context", None)
        # incremental timeline-export watermark (TraceRecord.seq of the
        # newest record delivered to EVERY attempted destination): a pass
        # with any failed destination re-ships its delta next cadence, so
        # no destination's merged fleet trace is left with a hole (the
        # aggregator dedups re-delivered events, so re-sends fold once)
        self._trace_shipped_seq = 0
        self.host_id = host_id
        self.publish_every_s = resolve_fleet_knob("publish_every_s", publish_every_s)
        self.stale_after_s = resolve_fleet_knob("stale_after_s", stale_after_s)
        deadline = resolve_fleet_knob("deadline_s", deadline_s)
        cooldown = resolve_fleet_knob("breaker_cooldown_s", breaker_cooldown_s)
        if not isinstance(destinations, Mapping):
            destinations = {"default": destinations}
        if not destinations:
            raise MetricsTPUUserError("`destinations` must name at least one channel")
        self._channels: Dict[str, Channel] = dict(destinations)
        # per-destination budget: one breaker each, so a dead pod opens ITS
        # circuit only and healthy destinations keep receiving every cadence
        self._policies: Dict[str, RetryPolicy] = {
            name: RetryPolicy(
                timeout_s=deadline,
                max_retries=max_retries,
                backoff_s=backoff_s,
                cooldown_s=cooldown,
                retry_timeouts=True,  # idempotent push: re-delivery folds once
                name=f"fleet publish {host_id}->{name}",
                thread_name=f"metrics-tpu-fleet-publish-{name}",
            )
            for name in self._channels
        }
        self._stats: Dict[str, Dict[str, int]] = {
            name: {"published": 0, "failed": 0, "skipped_open": 0, "skipped_inflight": 0}
            for name in self._channels
        }
        # at most ONE push runs per destination at any time (the policies
        # are not thread-safe, and a second push behind a wedged one buys
        # nothing — the next cadence carries a fresher view anyway)
        self._inflight: Dict[str, Optional[threading.Thread]] = {
            name: None for name in self._channels
        }
        self._last_ok_mono: Dict[str, Optional[float]] = {name: None for name in self._channels}
        self._started_mono = time.monotonic()
        self._stale_reported: Dict[str, bool] = {name: False for name in self._channels}
        # one `fleet_delta_rebase` event per episode per destination: a
        # flapping destination re-basing every cadence must not wheel the
        # bounded health ring (the stale-episode stance); an accepted
        # publish to that destination re-arms it
        self._rebase_reported: Dict[str, bool] = {name: False for name in self._channels}
        self._encode_error_reported = False  # snapshot/encode failure episode
        self._dup_streak: Dict[str, int] = {name: 0 for name in self._channels}
        self._seq = 0
        self._lock = threading.Lock()
        # (payload, seq) pairing order
        self._snapshot_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"metrics-tpu-fleet-publisher-{host_id}"
        )
        if start:
            self._thread.start()

    def start(self) -> None:
        """Start the cadence thread for a publisher constructed with
        ``start=False`` (e.g. after warmup, or tests driving
        :meth:`publish_now` manually first). Idempotent; raises after
        :meth:`stop`."""
        if self._stop_evt.is_set():
            raise MetricsTPUUserError("FleetPublisher.start called after stop()")
        if not self._thread.is_alive():
            # re-stamp the staleness baseline: construction-to-start warmup
            # is not a publish outage, so the first failure after a deferred
            # start must not instantly fire a spurious stale episode
            self._started_mono = time.monotonic()
            try:
                self._thread.start()
            except RuntimeError:  # already started and exited between checks
                pass

    # -- publishing -----------------------------------------------------

    def _next_seq(self) -> int:
        # wall-clock floored (wire.next_seq): a restarted host (fresh
        # publisher, same host_id) keeps seq monotonic, so the aggregator's
        # last-write-wins fold never discards its post-restart views as "old"
        with self._lock:
            self._seq = next_seq(self._seq)
            return self._seq

    def publish_now(self, wait: bool = True) -> Dict[str, str]:
        """One publish pass: snapshot the source, push to every destination.

        Pushes run on one worker thread per destination — each destination
        owns its policy/breaker, so a slow or blackholed endpoint burning
        its full retry budget never delays delivery to healthy ones — and a
        destination whose PREVIOUS push is still in flight is skipped
        (``"skipped:inflight"``): the policies are not thread-safe, and the
        next pass carries a fresher view anyway. With ``wait=True``
        (default: tests, shutdown flush) the pass joins its spawned pushes,
        bounded by the slowest per-destination budget; the cadence loop
        passes ``wait=False`` and never blocks on any channel, so a dead
        destination's breaker re-probe cannot stall healthy cadences.

        Returns per-destination outcomes (``"ok"``, ``"skipped:empty"``,
        ``"skipped:circuit_open"``, ``"skipped:inflight"``, ``"spawned"``
        when ``wait=False``, or ``"failed:<error>"``). Never raises on
        channel failure — failures degrade to events and staleness.
        """
        # classify destinations FIRST: when every destination is in flight
        # or breaker-open (the common single-destination outage), the pass
        # must be genuinely cheap — no snapshot, no pickle, no per-leaf
        # sha256 walk of the whole state tree just to throw the blob away
        outcomes: Dict[str, str] = {}
        to_push = []
        for name, channel in self._channels.items():
            with self._lock:
                prev = self._inflight[name]
                if prev is not None and prev.is_alive():
                    self._stats[name]["skipped_inflight"] += 1
                    outcomes[name] = "skipped:inflight"
                    continue
            if self._policies[name].open:
                with self._lock:
                    self._stats[name]["skipped_open"] += 1
                outcomes[name] = "skipped:circuit_open"
                self._check_stale(name)
                continue
            to_push.append((name, channel))
        if not to_push:
            return outcomes
        # the publish span links the shipped view back to the reduce that
        # built it (its ctx rides the wire header, so the aggregator's fold
        # links forward — the cross-process leg of the causal chain)
        link = self._trace_ctx_fn() if self._trace_ctx_fn is not None else None
        with _obs_trace.span("fleet.publish", link_to=link, host=self.host_id):
            # snapshot and seq are taken under ONE lock: two concurrent passes
            # snapshotting then seq-assigning in opposite orders would pair an
            # OLDER payload with a NEWER seq, and the aggregator's last-write-
            # wins fold would then pin the stale view until the next cadence
            with self._snapshot_lock:
                payload = self._view_fn()
                if payload is None:
                    for name, _channel in to_push:
                        outcomes[name] = "skipped:empty"
                    return outcomes
                seq = self._next_seq()
                extra = self._extra_fn() if self._extra_fn is not None else None
                # under the same lock: the watermark read below must pair
                # with exactly one delta per pass — two concurrent passes
                # reading the same watermark would ship one batch twice
                extra, trace_mark = self._trace_extra(extra)
                # delta decision under the SAME lock: the diff must pair
                # with this pass's (payload, seq) and the CURRENT committed
                # base — a base committed/cleared mid-decision would ship a
                # delta against a view some destination no longer holds
                delta_mark: Optional[Tuple[Dict[str, Any], int]] = None
                delta_changed: Optional[Dict[str, Any]] = None
                delta_base_seq: Optional[int] = None
                if resolve_fleet_delta(self._delta):
                    base = self._delta_base
                    changed, digests = delta_changes(payload, base[0] if base else {})
                    delta_mark = (digests, seq)  # the next base, if all accept
                    # ship a delta only when it can WIN: with every leaf
                    # dirty it is the full payload plus path-key overhead,
                    # so a full view is strictly smaller (and commits the
                    # same base on accept)
                    if base is not None and changed is not None and len(changed) < len(digests):
                        delta_changed, delta_base_seq = changed, base[1]
            if delta_changed is not None:
                blob = encode_delta_view(
                    delta_changed,
                    base_seq=delta_base_seq,
                    host_id=self.host_id,
                    seq=seq,
                    updates=_payload_updates(payload),
                    extra=extra,
                    encoding=self._encoding,
                )
            else:
                blob = encode_view(
                    payload,
                    host_id=self.host_id,
                    seq=seq,
                    updates=_payload_updates(payload),
                    extra=extra,
                    encoding=self._encoding,
                )
            # payload-size distribution: once per ENCODE (the quantized-
            # transport tuning reads blob sizes — observing per destination
            # would weight quantiles by fan-out and failure rate instead);
            # the per-attempt on-wire total stays in the fleet_blob_bytes
            # counter inside _push
            from metrics_tpu_torch.obs.runtime_metrics import registry as _obs_registry

            _obs_registry.histogram("fleet_publish_bytes").observe(float(len(blob)))
            # the delta win and every re-base in one scrape: full vs delta
            # encode counters, plus this blob's size relative to the last
            # full view (1.0 while full views ship; well under 1 in the
            # steady state of a large view)
            if delta_changed is not None:
                _obs_registry.counter("fleet_publish_delta_total").inc()
            else:
                _obs_registry.counter("fleet_publish_full_total").inc()
                with self._lock:
                    self._last_full_bytes = len(blob)
            with self._lock:
                full_bytes = self._last_full_bytes
            _obs_registry.gauge("fleet_delta_ratio").set(
                len(blob) / full_bytes if full_bytes else 1.0
            )
        with self._lock:
            self._encode_error_reported = False  # snapshot+encode healthy again
        workers: Dict[str, threading.Thread] = {}
        # the trace watermark commits only when EVERY attempted destination
        # accepted this pass's blob: committing on the first success would
        # leave each failed destination permanently missing this delta
        # (the next pass starts past it); the full re-ship after a partial
        # failure folds once at the destinations that already accepted
        # (the aggregator's ingest dedup). The delta base rides the same
        # pass-completion machinery but with a STRICTER bar: `all_ok`
        # tolerates "duplicate" answers (the view is held either way),
        # `accepted_all` does not — a duplicate answer means the aggregator
        # kept its OLD entry, so the next delta must diff against that, and
        # the only safe move is to drop the base and re-ship a full view.
        pass_state = {"left": 0, "all_ok": True, "accepted_all": True, "spawning": True}

        def _finish_pass(ok: bool, accepted: bool) -> None:
            """Pass completion — called OUTSIDE self._lock (it takes
            _snapshot_lock, and the snapshot block above takes the locks in
            the opposite order): commit the marks or clear the base."""
            if ok:
                self._commit_trace_mark(trace_mark)
            if delta_mark is None:
                return
            with self._snapshot_lock:
                if ok and accepted:
                    # newest-seq-wins: two passes completing out of order
                    # must leave the base at the NEWER shipped view — the
                    # aggregator's last-write-wins fold holds that one
                    if self._delta_base is None or self._delta_base[1] <= delta_mark[1]:
                        self._delta_base = delta_mark
                elif self._delta_base is not None and self._delta_base[1] <= delta_mark[1]:
                    # some destination did not accept this pass: it may hold
                    # an older view than the committed base, so the next
                    # pass must re-base to a full ship (clearing is cheap —
                    # one full view — and always safe). A NEWER committed
                    # base (a later pass already landed everywhere) stays.
                    self._delta_base = None

        def _finish_push(out: str, accepted: bool) -> None:
            with self._lock:
                pass_state["left"] -= 1
                pass_state["all_ok"] = pass_state["all_ok"] and out == "ok"
                pass_state["accepted_all"] = pass_state["accepted_all"] and accepted
                done = not pass_state["spawning"] and pass_state["left"] == 0
                ok, acc = pass_state["all_ok"], pass_state["accepted_all"]
            if done:
                _finish_pass(ok, acc)

        for name, channel in to_push:
            with self._lock:
                prev = self._inflight[name]
                if prev is not None and prev.is_alive():
                    # re-checked under the lock: a concurrent pass may have
                    # spawned for this destination since classification
                    self._stats[name]["skipped_inflight"] += 1
                    outcomes[name] = "skipped:inflight"
                    continue

                def run(name: str = name, channel: Channel = channel) -> None:
                    out, accepted = self._push(name, channel, blob)
                    outcomes[name] = out
                    _finish_push(out, accepted)

                t = threading.Thread(
                    target=run, daemon=True, name=f"metrics-tpu-fleet-push-{name}"
                )
                self._inflight[name] = t
                workers[name] = t
                outcomes[name] = "spawned"
                pass_state["left"] += 1  # under self._lock
                # started INSIDE the lock: a not-yet-started thread reads
                # is_alive() False, so starting outside would let a racing
                # publish_now slip a second push past the in-flight guard
                # onto the same (not thread-safe) policy
                t.start()
        with self._lock:
            pass_state["spawning"] = False
            done = bool(workers) and pass_state["left"] == 0
            ok, acc = pass_state["all_ok"], pass_state["accepted_all"]
        if done:
            # every push already finished (fast channels) before spawning
            # closed — _finish_push deferred pass completion to here
            _finish_pass(ok, acc)
        if wait:
            for t in workers.values():
                t.join()
        return outcomes

    def _trace_extra(
        self, extra: Optional[Dict[str, Any]]
    ) -> Tuple[Optional[Dict[str, Any]], Optional[int]]:
        """Attach the causal/timeline section to the wire header extra
        (only while tracing is on — a fleet with tracing off ships not one
        extra byte): the ACTIVE trace context (the publish span — what the
        aggregator's fold links to), a ``clock_sync()`` pairing so the
        aggregator can rebase this host's span timestamps onto the shared
        wall-clock timebase, and the ring's NEW records since the last
        DELIVERED publish as ready Chrome events (append-seq watermarked,
        capped per publish — the merged fleet trace at ``GET /trace.json``
        is these sections folded together). Returns ``(extra, mark)``:
        the caller commits ``mark`` via :meth:`_commit_trace_mark` once a
        destination accepts the blob (must run under ``_snapshot_lock`` so
        concurrent passes never ship one batch twice)."""
        if not _obs_trace.tracing_enabled():
            return extra, None
        ctx = _obs_trace.current_context()
        # OLDEST cap records first: the committed cursor stays contiguous,
        # so a >cap burst drains over subsequent cadences instead of the
        # over-cap tail being skipped forever (sustained overload is
        # bounded by ring eviction, same as before the cursor existed)
        records = _obs_trace.records_since(self._trace_shipped_seq)[:_TRACE_EVENTS_PER_PUBLISH]
        mark = records[-1].seq if records else None
        section: Dict[str, Any] = {
            "ctx": {"trace_id": ctx.trace_id, "span_id": ctx.span_id} if ctx else None,
            "clock": _obs_trace.clock_sync(),
            "events": _obs_trace.chrome_events_for(records, host_id=self.host_id),
        }
        out = dict(extra) if extra else {}
        out["trace"] = section
        return out, mark

    def _commit_trace_mark(self, mark: Optional[int]) -> None:
        """Advance the timeline watermark after a successful push (max() —
        two passes completing out of order keep the newest mark)."""
        if mark is None:
            return
        with self._snapshot_lock:
            self._trace_shipped_seq = max(self._trace_shipped_seq, mark)

    def _note_duplicate(self, name: str, result: Any) -> None:
        """Watch the aggregator's answers for a persistent seq regression.

        A benign re-delivery (the idempotent retry path) answers
        ``duplicate`` once and the next publish is accepted; a host
        restarted after a BACKWARD wall-clock step answers ``duplicate``
        on every publish — both ends look healthy while the fold silently
        drops this host for the whole skew duration. After 3 consecutive
        duplicates the publisher jumps its sequence past the seq the
        aggregator reports holding and says so, loudly.
        """
        text = (
            result.decode("utf-8", "replace")
            if isinstance(result, (bytes, bytearray))
            else result
            if isinstance(result, str)
            else None
        )
        if not (isinstance(text, str) and text.startswith("duplicate")):
            with self._lock:
                self._dup_streak[name] = 0
            return
        held = None
        if ":" in text:
            try:
                held = int(text.split(":", 1)[1].strip())
            except ValueError:
                held = None
        with self._lock:
            self._dup_streak[name] += 1
            streak = self._dup_streak[name]
            # STRICT >: held == ours is the benign idempotent-retry case (a
            # timed-out first attempt the server already folded — the retry
            # answers duplicate with OUR seq); only a held seq ahead of ours
            # is a genuine regression worth jumping and alerting on
            jump = streak >= 3 and held is not None and held > self._seq
            if jump:
                self._seq = held  # the next publish issues next_seq(held) > held
                self._dup_streak[name] = 0
        if jump:
            # the aggregator holds a FUTURE seq for us (pre-restart views):
            # any delta base we committed describes a view it may not hold
            # anymore — drop it so the next publish re-ships a full view
            # under the jumped sequence
            with self._snapshot_lock:
                self._delta_base = None
            record_degradation(
                "fleet_seq_regression",
                f"host {self.host_id}: {streak} consecutive publishes answered "
                f"'duplicate' by {name!r} holding seq {held} > ours — jumping the "
                "sequence past it (host restarted after a backward clock step?)",
                host=self.host_id,
                destination=name,
                held_seq=held,
            )

    def _note_rebase(self, name: str, text: str) -> None:
        """An aggregator answered ``rebase:<held|none>`` to a delta blob: it
        holds no base (restarted, or never saw our full view) so it refused
        to fold the delta. Not an error — the pass reports it, the base
        clears, and the next cadence ships a full view — but a destination
        stuck re-basing every cadence is a real degradation (delta savings
        gone), so it is surfaced once per episode like staleness."""
        with self._lock:
            due = not self._rebase_reported[name]
            self._rebase_reported[name] = True
        if due:
            record_degradation(
                "fleet_delta_rebase",
                f"host {self.host_id}: {name!r} answered {text!r} to a delta publish "
                "(no matching base view held — aggregator restart?); re-basing to a "
                "full view next pass (reported once per episode)",
                host=self.host_id,
                destination=name,
            )

    def _push(self, name: str, channel: Channel, blob: bytes) -> Tuple[str, bool]:
        """One destination push. Returns ``(outcome, accepted)`` where
        ``accepted`` means the destination POSITIVELY answered
        ``"accepted"`` — the only answer that lets this pass commit a delta
        base for it (a duplicate/rebase answer or a silent fake channel
        proves nothing about what the destination now holds)."""
        from metrics_tpu_torch.obs.runtime_metrics import registry as _obs_registry

        def send() -> Any:
            # per-transport byte accounting (obs): counted per CHANNEL
            # ATTEMPT, inside the policy, so retries count each re-send, a
            # 3-destination publisher reports 3x len(blob) per pass, and a
            # breaker-open skip counts nothing — the fleet twin of
            # `sync_payload_bytes`, which also counts actual on-wire bytes
            _obs_registry.counter("fleet_blob_bytes").inc(len(blob))
            return channel(blob)

        # publisher self-metrics (always on — the publish path runs per
        # cadence, never per request): per-destination publish wall time
        # covering the full retry/timeout budget of one push. Observed for
        # ATTEMPTED pushes only — a breaker-open skip sent nothing, so it
        # must not thin the distributions with zeros (the payload-size
        # histogram is fed once per encode, at the publish-pass site)
        t0 = time.perf_counter()

        def _observe_push() -> None:
            dur_ms = (time.perf_counter() - t0) * 1e3
            _obs_registry.histogram("fleet_publish_ms").observe(dur_ms)
            _obs_registry.histogram(f"fleet_publish_ms_{_metric_token(name)}").observe(dur_ms)

        policy = self._policies[name]
        try:
            result = policy.call(send)
        except CircuitOpenError:
            # the breaker-opening pass already recorded the event; skipping
            # is the cheap degraded path, not a new degradation
            with self._lock:
                self._stats[name]["skipped_open"] += 1
            self._check_stale(name)
            return "skipped:circuit_open", False
        except RetryBudgetExceededError as err:
            _observe_push()
            with self._lock:
                self._stats[name]["failed"] += 1
            record_degradation(
                "fleet_publish_error",
                f"host {self.host_id}: publish to {name!r} failed after "
                f"{err.attempts} attempt(s): {err.cause}",
                host=self.host_id,
                destination=name,
                attempts=err.attempts,
            )
            self._check_stale(name)
            return f"failed:{type(err.cause).__name__}", False
        _observe_push()
        self._note_duplicate(name, result)
        text = (
            result.decode("utf-8", "replace")
            if isinstance(result, (bytes, bytearray))
            else result
            if isinstance(result, str)
            else None
        )
        accepted = text == "accepted"
        if isinstance(text, str) and text.startswith("rebase:"):
            self._note_rebase(name, text)
        with self._lock:
            self._stats[name]["published"] += 1
            self._last_ok_mono[name] = time.monotonic()
            was_stale = self._stale_reported[name]
            self._stale_reported[name] = False
            if accepted:
                self._rebase_reported[name] = False  # re-base episode over
        if was_stale:
            record_degradation(
                "fleet_publish_recovered",
                f"host {self.host_id}: publish to {name!r} succeeded again after a "
                "stale episode; the aggregator's view of this host is fresh",
                host=self.host_id,
                destination=name,
            )
        return "ok", accepted

    def _record_encode_error(self, err: BaseException, during: str = "view snapshot/encode") -> None:
        """Episode-gated like every other failure path: a persistently
        failing snapshot on a fast cadence must not wheel the bounded
        health-event ring and evict every other degradation — one event per
        episode; the next successful encode re-arms it."""
        with self._lock:
            due = not self._encode_error_reported
            self._encode_error_reported = True
        if due:
            record_degradation(
                "fleet_publish_error",
                f"host {self.host_id}: {during} raised {type(err).__name__}: {err} "
                "(reported once per episode; the cadence keeps retrying)",
                host=self.host_id,
            )

    def _check_stale(self, name: str) -> None:
        with self._lock:
            last_ok = self._last_ok_mono[name]
            base = last_ok if last_ok is not None else self._started_mono
            age = time.monotonic() - base
            due = age > self.stale_after_s and not self._stale_reported[name]
            if due:
                self._stale_reported[name] = True
        if due:
            record_degradation(
                "fleet_host_stale",
                f"host {self.host_id}: no successful publish to {name!r} for {age:.1f}s "
                f"(> {self.stale_after_s:g}s); this host is loudly stale in that "
                "aggregator's view",
                host=self.host_id,
                destination=name,
                staleness_s=age,
            )

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            woke = self._wake.wait(timeout=self.publish_every_s)
            if woke:
                self._wake.clear()
            if self._stop_evt.is_set():
                return
            try:
                # wait=False: the cadence thread never blocks on a channel —
                # a dead destination's budget runs on ITS worker while every
                # healthy destination keeps receiving on every tick
                self.publish_now(wait=False)
            except Exception as err:  # noqa: BLE001 — a bad snapshot degrades, never kills the cadence
                self._record_encode_error(err)

    # -- observability / lifecycle --------------------------------------

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-destination accounting: published / failed / skipped_open,
        plus seconds since the last successful push (None before the
        first)."""
        now = time.monotonic()
        with self._lock:
            out = {}
            for name, counters in self._stats.items():
                last_ok = self._last_ok_mono[name]
                out[name] = {
                    **counters,
                    "since_last_ok_s": None if last_ok is None else max(0.0, now - last_ok),
                    "circuit_open": self._policies[name].open,
                }
            return out

    def request(self) -> None:
        """Ask for an immediate publish pass (cadence-independent)."""
        self._wake.set()

    def stop(self, flush: bool = True, timeout_s: float = 10.0) -> None:
        """Stop the cadence thread; ``flush=True`` runs one final publish
        so the aggregators hold this host's last view — bounded by the
        per-destination budgets, and destinations whose cadence push is
        still in flight are skipped rather than raced (their in-flight
        push already carries a current view), so a dead aggregator cannot
        hang shutdown."""
        self._stop_evt.set()
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout_s)
        if flush:
            try:
                self.publish_now()
            except Exception as err:  # noqa: BLE001 — shutdown flush degrades, never raises
                self._record_encode_error(err, during="shutdown flush")

    def __enter__(self) -> "FleetPublisher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()
