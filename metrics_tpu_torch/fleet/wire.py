"""Versioned, per-leaf-checksummed wire format for published host views
(counterpart of ``metrics_tpu/fleet/wire.py``).

**The format is the JAX package's**: the same magic, schema version, header
keys, per-leaf sha256 (the snapshot layer's ``_checksum_tree``), zlib and
pickle protocol, and numpy trees only, never a torch tensor. A blob that
either package encodes decodes and folds in the other, riding the payload
interop of ``Metric.snapshot_state`` (fault counters are int64 here and
uint32 in JAX, D11; a sketch travels as its primitives). The int8 coding is
the port's host codec (``ops/quantize.py``), bit-identical to JAX's numpy
twins.

The fleet tier moves metric state between *processes* (host → pod
aggregator → global) over HTTP, so every payload crosses a boundary
where truncation, bit rot, or a half-written proxy buffer can silently
corrupt state that will be folded into the global view of the whole fleet.
The disk snapshot layer (``resilience/snapshot.py``) already solved this
for files: magic + schema version + one sha256 digest per state leaf
(header fields digested too), verified before anything loads, failing
loudly and naming the offender. This module is the same discipline applied
to an in-memory publish instead of a file:

- :func:`encode_view` wraps any :meth:`Metric.snapshot_state` /
  ``MetricCollection.snapshot_state`` payload with a header carrying the
  publishing node's identity (``host_id``) and a monotonically increasing
  ``seq`` — the two fields the aggregator's idempotent last-write-wins
  fold keys on — and the full per-leaf checksum tree (reusing the snapshot
  layer's ``_checksum_tree`` walk verbatim, so the two formats cannot
  drift).
- :func:`decode_view` verifies magic, schema version, and every checksum
  before returning; a torn or bit-flipped blob raises
  :class:`WireCorruptionError` naming the publishing host (when the header
  survived) and the first bad leaf — the aggregator refuses it and the
  payload never touches the fold.

Blobs are Python pickles of numpy trees, the same **trusted** transport
model as the snapshot files (your own hosts, your own aggregators — the
checksums defend against corruption, not adversaries). The format is
deliberately payload-opaque and versioned: the reserved ``encoding`` token
now carries three implementations —

- ``pickle-v1`` (the default): raw numpy leaves, bit-exact.
- ``int8-zlib-v1``: the blockwise-int8 compressed transport.
  Floating leaves of at least :data:`QUANTIZE_MIN_SIZE` lanes are encoded
  blockwise-int8 (``ops/quantize.py``: per-block f32 dequantization scales
  carried in the leaf header, NaN/±inf passthrough codes, worst-case error
  ``absmax_block / 252`` per lane) with the code bytes zlib-compressed;
  integer leaves — counters, CountMin counts, HLL registers, sketch level
  counts, ``n_seen`` — and small floating leaves ship raw, so every
  lossless path stays lossless and a sketch's rank contract extends to
  ``eps_total = eps_sketch + eps_transport`` exactly as in the in-graph
  wire. Per-leaf checksums are computed over the **encoded** payload, so a
  corrupt blob is refused (naming host + leaf) before any dequantization
  runs, and a build that doesn't know the token refuses it loudly —
  listing the encodings it does support — instead of mis-decoding bytes.

- ``delta-v1``: a per-leaf DIFF against the last view every
  destination accepted, not a full tree — :func:`encode_delta_view` ships
  only the dirty leaves (``delta_changes``' ``_checksum_tree``-keyed
  paths), :func:`apply_delta` folds them onto the aggregator's held base
  bit-equal to the full view they replace, and the changed leaves carry an
  ``inner`` coding token (``pickle-v1``/``int8-zlib-v1``) so delta × int8
  makes the steady-state wire near-constant in state size. Riding the
  ``encoding`` header means pre-delta aggregators refuse delta blobs
  loudly instead of folding a partial tree as a full view.

Which encoding a publisher ships resolves programmatic ``encoding=`` >
``METRICS_TPU_FLEET_ENCODING`` (``exact``/``pickle`` | ``int8``) >
``pickle-v1``; a malformed env value warns once and falls back — a bad env
var degrades bytes, never correctness. Decoding is token-driven per blob,
so a mixed-version / mixed-encoding fleet (one int8 host among exact
hosts) folds correctly as long as the aggregator build knows each token.

Module import performs python work only (stdlib + numpy via the snapshot
helpers; the quantizer imports lazily at the first int8 encode/decode, and
imports torch but touches no device).
"""
import pickle
import time
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce
from metrics_tpu_torch.resilience.snapshot import _checksum_tree, _iter_leaves

__all__ = [
    "MAGIC",
    "SCHEMA_VERSION",
    "ENCODING",
    "ENCODING_INT8",
    "ENCODING_DELTA",
    "SUPPORTED_ENCODINGS",
    "QUANTIZE_MIN_SIZE",
    "WireError",
    "WireCorruptionError",
    "WireSchemaError",
    "encode_view",
    "encode_delta_view",
    "decode_view",
    "delta_changes",
    "is_delta_payload",
    "apply_delta",
    "next_seq",
    "resolve_fleet_encoding",
    "reset_wire_env_state",
]

MAGIC = "metrics-tpu-fleet-view"
SCHEMA_VERSION = 1
# the payload encodings this schema version ships; an unknown token is
# refused loudly (listing these) instead of mis-decoding bytes
ENCODING = "pickle-v1"
ENCODING_INT8 = "int8-zlib-v1"
# delta-v1: the payload is a per-leaf diff against the last view
# every destination accepted, NOT a full tree. It rides the same `encoding`
# header token precisely so a build that predates deltas refuses the blob
# loudly (naming its SUPPORTED_ENCODINGS) instead of folding a partial tree
# as a full view. It is deliberately NOT an _ENCODING_ALIASES member:
# METRICS_TPU_FLEET_ENCODING selects how full views encode; delta shipping
# is a separate publisher mode (METRICS_TPU_FLEET_DELTA, fleet/_env.py).
ENCODING_DELTA = "delta-v1"
SUPPORTED_ENCODINGS = (ENCODING, ENCODING_INT8, ENCODING_DELTA)
# floating leaves smaller than this ship raw even under int8: no byte win,
# and scalar aggregates (a MeanMetric value) keep full width
QUANTIZE_MIN_SIZE = 16
# the sentinel key marking an encoded leaf inside the payload tree; state
# names are python identifiers, so it can never collide with real state
_QKEY = "__quantized__"
# the sentinel key marking a decoded DELTA payload (a per-leaf diff, never
# a full tree — `apply_delta` folds it onto the held base view)
_DELTA_KEY = "__delta__"

_ENCODING_ALIASES = {
    "exact": ENCODING,
    "pickle": ENCODING,
    ENCODING: ENCODING,
    "int8": ENCODING_INT8,
    ENCODING_INT8: ENCODING_INT8,
}

_warn_once = WarnOnce()


def _parse_encoding(raw: str) -> Optional[str]:
    token = _ENCODING_ALIASES.get(raw.strip().lower())
    if token is None:
        _warn_once(
            ("fleet-encoding", raw),
            f"METRICS_TPU_FLEET_ENCODING={raw!r} is not a known encoding "
            f"(have {sorted(set(_ENCODING_ALIASES))}); publishing {ENCODING!r} "
            "— a bad env var degrades bytes, never correctness.",
        )
    return token


_ENV_ENCODING: "EnvParse[Optional[str]]" = EnvParse(
    "METRICS_TPU_FLEET_ENCODING", _parse_encoding, None
)


def resolve_fleet_encoding(programmatic: Optional[str] = None) -> str:
    """Programmatic arg > ``METRICS_TPU_FLEET_ENCODING`` > ``pickle-v1``
    (the dispatch-layer resolution rule). Programmatic typos raise — they
    are code, not deployment config."""
    if programmatic is not None:
        token = _ENCODING_ALIASES.get(str(programmatic).strip().lower())
        if token is None:
            raise WireError(
                f"unknown fleet encoding {programmatic!r}; "
                f"choose from {sorted(set(_ENCODING_ALIASES))}"
            )
        return token
    token = _ENV_ENCODING()
    return token if token is not None else ENCODING


def reset_wire_env_state() -> None:
    """Test hook: forget the memoized env parse and warn-once history."""
    _warn_once.reset()
    _ENV_ENCODING.reset()


def next_seq(prev: int) -> int:
    """The publish-sequence generator both publishing sides share: strictly
    increasing within a process AND floored to wall-clock microseconds, so a
    restarted publisher (fresh counter, same ``host_id``) never re-publishes
    under a seq the aggregator's last-write-wins fold has already passed.
    One definition, because this is the invariant the idempotent fold keys
    on — it must not drift between the publisher and the aggregator's
    multi-hop re-publish."""
    return max(int(prev) + 1, int(time.time() * 1_000_000))


class WireError(RuntimeError):
    """Base class for fleet wire encode/decode failures."""


class WireCorruptionError(WireError):
    """A published view failed integrity verification (truncation, bit
    flip, torn proxy buffer) — refused, never folded."""


class WireSchemaError(WireError):
    """A published view was written by a newer schema/encoding than this
    build understands."""


# --------------------------------------------------------------------------
# int8-zlib-v1 payload coding: a structure-preserving walk that replaces
# large floating leaves with blockwise-int8 records (scales in the leaf
# header) and leaves every lossless leaf untouched
# --------------------------------------------------------------------------


def _encode_leaf_int8(arr: np.ndarray) -> Dict[str, Any]:
    from metrics_tpu_torch.ops.quantize import DEFAULT_BLOCK, blockwise_int8_encode_np

    flat = np.ascontiguousarray(arr, np.float32).reshape(-1)
    codes, scales = blockwise_int8_encode_np(flat, DEFAULT_BLOCK)
    return {
        _QKEY: "int8-block",
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "n": int(flat.shape[0]),
        "block": DEFAULT_BLOCK,
        # the dequantization scales ride the leaf header, bit-exact
        "scales": scales,
        "codes": zlib.compress(codes.tobytes(), 6),
    }


def _decode_leaf_int8(rec: Dict[str, Any]) -> np.ndarray:
    from metrics_tpu_torch.ops.quantize import blockwise_int8_decode_np

    codes = np.frombuffer(zlib.decompress(rec["codes"]), np.int8)
    vals = blockwise_int8_decode_np(codes, rec["scales"], rec["n"], rec["block"])
    return vals.reshape(tuple(rec["shape"])).astype(np.dtype(rec["dtype"]))


def _encode_payload_int8(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _encode_payload_int8(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_encode_payload_int8(v) for v in node)
    if (
        isinstance(node, np.ndarray)
        # f32/f16 only: the codes are f32-based, so an f64 leaf would lose
        # range/precision beyond the documented envelope — it ships raw
        and node.dtype in (np.float32, np.float16)
        and node.size >= QUANTIZE_MIN_SIZE
    ):
        return _encode_leaf_int8(node)
    return node


def _decode_payload_int8(node: Any) -> Any:
    if isinstance(node, dict):
        if node.get(_QKEY) == "int8-block":
            return _decode_leaf_int8(node)
        return {k: _decode_payload_int8(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_decode_payload_int8(v) for v in node)
    return node


def encode_view(
    payload: Dict[str, Any],
    host_id: str,
    seq: int,
    updates: Optional[int] = None,
    extra: Optional[Dict[str, Any]] = None,
    encoding: Optional[str] = None,
) -> bytes:
    """Encode one ``snapshot_state`` payload as a self-verifying blob.

    ``host_id`` names the publishing node (host or pod aggregator) and
    must be stable for its lifetime — the aggregator's last-write-wins
    fold is keyed on it. ``seq`` must increase per publish from that node
    (re-deliveries and reorderings of old blobs are then folded at most
    once). ``updates`` (optional) records the view's total update count
    for observability; ``extra`` is recorded verbatim in the header.
    Two extra keys are conventionally structured (both optional, both
    ignored by builds that predate them): ``"trace"`` — the publisher's
    causal/timeline section (``{"ctx": {trace_id, span_id}, "clock":
    clock_sync(), "events": [chrome events]}``, ``obs/trace.py``) the
    aggregator links its fold to and merges into ``GET /trace.json`` —
    and ``"trace_children"`` — ``{host: {clock, events}}`` sections a pod
    aggregator forwards so leaf timelines reach the global node.
    ``encoding`` picks the payload encoding (module docstring): a token or
    alias (``"exact"``/``"int8"``), ``None`` resolving
    ``METRICS_TPU_FLEET_ENCODING`` > ``pickle-v1``. Checksums always cover
    the payload AS ENCODED, so verification runs before any decode work.
    """
    if not host_id:
        raise WireError("`host_id` must be a non-empty string")
    token = resolve_fleet_encoding(encoding)
    wire_payload = _encode_payload_int8(payload) if token == ENCODING_INT8 else payload
    header = {
        "host_id": str(host_id),
        "seq": int(seq),
        "encoding": token,
        "published_unix": time.time(),
        "updates": None if updates is None else int(updates),
        "extra": dict(extra) if extra else None,
    }
    return pickle.dumps(
        {
            "magic": MAGIC,
            "schema_version": SCHEMA_VERSION,
            "header": header,
            "payload": wire_payload,
            # header covered too: a flipped host_id/seq would re-route the
            # fold (double-count one host, orphan another), not just values
            "checksums": _checksum_tree({"header": header, "payload": wire_payload}),
        },
        protocol=4,
    )


# --------------------------------------------------------------------------
# delta-v1: per-leaf dirty tracking + diff blobs + base folding
# --------------------------------------------------------------------------


def delta_changes(
    payload: Dict[str, Any], base_digests: Dict[str, str]
) -> Tuple[Optional[Dict[str, Any]], Dict[str, str]]:
    """Diff ``payload``'s leaves against a committed base's digest table.

    Returns ``(changed, digests)`` where ``digests`` is the payload's own
    per-leaf digest table (the next base candidate — the snapshot layer's
    ``_checksum_tree`` walk verbatim, so dirty detection can never disagree
    with the wire checksums) and ``changed`` maps each dirty leaf's tree
    path to its CURRENT value. ``changed`` is ``None`` when the leaf path
    set differs from the base (structural change — a list state grew, a
    member appeared): a delta replaces values in an identical structure
    only, so anything structural re-bases to a full view.
    """
    digests = _checksum_tree(payload)
    if set(digests) != set(base_digests):
        return None, digests
    leaves = dict(_iter_leaves(payload))
    changed = {p: leaves[p] for p, d in digests.items() if base_digests[p] != d}
    return changed, digests


def encode_delta_view(
    changed: Dict[str, Any],
    base_seq: int,
    host_id: str,
    seq: int,
    updates: Optional[int] = None,
    extra: Optional[Dict[str, Any]] = None,
    encoding: Optional[str] = None,
) -> bytes:
    """Encode a per-leaf delta against an aggregator-held base view.

    ``changed`` maps leaf tree paths (``delta_changes``' keys) to current
    values; ``base_seq`` names the publish every attempted destination
    ACCEPTED that this delta applies on top of — an aggregator holding any
    other seq for this host answers ``rebase:<held>`` and the publisher's
    next pass ships a full view. The blob's header ``encoding`` token is
    ``delta-v1``, so pre-delta builds refuse it loudly. ``encoding``
    (same resolution as :func:`encode_view`) selects the INNER coding of
    the changed leaves: ``int8`` quantizes large floating leaves
    blockwise — delta × int8, the near-constant steady-state wire.
    Checksums cover the delta payload as encoded, exactly like full views.
    """
    if not host_id:
        raise WireError("`host_id` must be a non-empty string")
    inner = resolve_fleet_encoding(encoding)
    wire_changed = (
        {p: _encode_payload_int8(v) for p, v in changed.items()}
        if inner == ENCODING_INT8
        else dict(changed)
    )
    wire_payload = {
        _DELTA_KEY: 1,
        "base_seq": int(base_seq),
        "inner": inner,
        "changed": wire_changed,
    }
    header = {
        "host_id": str(host_id),
        "seq": int(seq),
        "encoding": ENCODING_DELTA,
        "published_unix": time.time(),
        "updates": None if updates is None else int(updates),
        "extra": dict(extra) if extra else None,
    }
    return pickle.dumps(
        {
            "magic": MAGIC,
            "schema_version": SCHEMA_VERSION,
            "header": header,
            "payload": wire_payload,
            "checksums": _checksum_tree({"header": header, "payload": wire_payload}),
        },
        protocol=4,
    )


def is_delta_payload(payload: Any) -> bool:
    """True when a decoded payload is a delta diff (fold it with
    :func:`apply_delta` onto the held base, never load it as a full view)."""
    return isinstance(payload, dict) and payload.get(_DELTA_KEY) == 1


def apply_delta(base_payload: Dict[str, Any], delta_payload: Dict[str, Any]) -> Dict[str, Any]:
    """Rebuild the full view: the held base tree with every changed leaf
    replaced. Changed leaves arrive verbatim from the publisher's current
    payload (or its deterministic int8 coding), so the folded result is
    bit-equal to the full-view publish the delta replaced. Raises :class:`WireError` when any
    changed path does not exist in the base (the publisher diffed against
    a view this node never held — the caller answers ``rebase``)."""
    changed = delta_payload["changed"]
    unused = set(changed)

    def rebuild(node: Any, path: str) -> Any:
        if isinstance(node, dict):
            return {k: rebuild(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{path}/[{i}]") for i, v in enumerate(node))
        if path in changed:
            unused.discard(path)
            return changed[path]
        return node

    out = rebuild(base_payload, "")
    if unused:
        first = sorted(unused, key=str)[0]
        raise WireError(
            f"delta names {len(unused)} leaf path(s) absent from the held base view "
            f"(first: {first!r}) — base mismatch, re-base to a full view"
        )
    return out


def _header_hint(record: Any) -> str:
    """Best-effort ``host=<id> seq=<n>`` naming for error messages — the
    header may itself be the corrupt part, so this never trusts it beyond
    display."""
    try:
        header = record.get("header") or {}
        return f"host={header.get('host_id')!r} seq={header.get('seq')!r}"
    except Exception:  # noqa: BLE001 — the record can be arbitrarily mangled
        return "host=<unreadable>"


def decode_view(blob: bytes) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Decode + verify one published view → ``(header, payload)``.

    Raises :class:`WireCorruptionError` (unpicklable, bad magic, checksum
    mismatch — naming the publishing host when readable and the first bad
    leaf) or :class:`WireSchemaError` (newer schema or unknown payload
    encoding). A blob this function returns from has every leaf verified.
    """
    try:
        record = pickle.loads(blob)
    except Exception as err:
        raise WireCorruptionError(
            f"fleet view blob is unreadable ({type(err).__name__}: {err}) — "
            "truncated or corrupt payload refused"
        )
    if not isinstance(record, dict) or record.get("magic") != MAGIC:
        raise WireCorruptionError(f"fleet view blob has no {MAGIC!r} magic header; refused")
    version = record.get("schema_version")
    if not isinstance(version, int) or version > SCHEMA_VERSION:
        raise WireSchemaError(
            f"fleet view ({_header_hint(record)}) has schema version {version!r}; this build "
            f"understands <= {SCHEMA_VERSION} — upgrade the aggregator to fold it"
        )
    stored = record.get("checksums")
    if not isinstance(stored, dict):
        # an arbitrarily mangled blob can unpickle with ANY type here; the
        # refusal path must stay typed (WireError) for it, never TypeError
        raise WireCorruptionError(
            f"fleet view ({_header_hint(record)}) carries no checksum manifest — refused"
        )
    try:
        computed = _checksum_tree(
            {"header": record.get("header"), "payload": record.get("payload")}
        )
    except Exception as err:  # noqa: BLE001 — a mangled tree must refuse TYPED
        # an arbitrarily corrupt payload can defeat the walk itself (e.g.
        # mixed-type dict keys break its sorted() traversal) — that is still
        # corruption, and it must surface as WireError, never a raw TypeError
        # escaping the aggregator's refusal handling as an HTTP 500
        raise WireCorruptionError(
            f"fleet view ({_header_hint(record)}) has an unwalkable state tree "
            f"({type(err).__name__}: {err}) — corrupt view refused"
        )
    if stored != computed:
        try:
            bad = sorted(
                set(stored).symmetric_difference(computed)
                | {k for k in stored if k in computed and stored[k] != computed[k]},
                key=str,
            )
        except Exception:  # noqa: BLE001 — naming the leaf is best-effort
            bad = []
        raise WireCorruptionError(
            f"fleet view ({_header_hint(record)}) failed checksum verification at leaf "
            f"{bad[0] if bad else '<manifest>'} — corrupt view refused"
        )
    header = record["header"]
    encoding = header.get("encoding")
    if encoding not in SUPPORTED_ENCODINGS:
        # a mixed-version fleet rollout hits this: the message names every
        # encoding THIS build can fold so the operator knows which side to
        # upgrade (or which METRICS_TPU_FLEET_ENCODING to roll back)
        raise WireSchemaError(
            f"fleet view ({_header_hint(record)}) uses payload encoding "
            f"{encoding!r}; this build decodes {list(SUPPORTED_ENCODINGS)}"
        )
    if not header.get("host_id") or not isinstance(header.get("seq"), int):
        raise WireCorruptionError(
            f"fleet view ({_header_hint(record)}) carries no usable host_id/seq — refused "
            "(the idempotent fold cannot key it)"
        )
    payload = record["payload"]
    if encoding == ENCODING_DELTA:
        if (
            not is_delta_payload(payload)
            or not isinstance(payload.get("base_seq"), int)
            or not isinstance(payload.get("changed"), dict)
            or payload.get("inner") not in (ENCODING, ENCODING_INT8)
        ):
            raise WireCorruptionError(
                f"fleet view ({_header_hint(record)}) claims {ENCODING_DELTA} but carries "
                "no well-formed delta payload (base_seq/changed/inner) — refused"
            )
        if payload["inner"] == ENCODING_INT8:
            try:
                payload = {
                    **payload,
                    "changed": {
                        p: _decode_payload_int8(v) for p, v in payload["changed"].items()
                    },
                }
            except Exception as err:  # noqa: BLE001 — refusals stay typed (WireError)
                raise WireCorruptionError(
                    f"fleet view ({_header_hint(record)}) failed {ENCODING_INT8} delta-leaf "
                    f"decode ({type(err).__name__}: {err}) — refused"
                )
        return header, payload
    if encoding == ENCODING_INT8:
        try:
            payload = _decode_payload_int8(payload)
        except Exception as err:  # noqa: BLE001 — refusals stay typed (WireError)
            # every leaf already passed its checksum, so reaching here means
            # a malformed encode — still refused typed, never a raw
            # zlib.error/KeyError escaping the aggregator as an HTTP 500
            raise WireCorruptionError(
                f"fleet view ({_header_hint(record)}) failed {ENCODING_INT8} payload "
                f"decode ({type(err).__name__}: {err}) — refused"
            )
    return header, payload
