"""Elastic, crash-safe snapshots of metric state (counterpart of
``metrics_tpu/resilience/snapshot.py``).

- **Atomic writes.** Each snapshot is one file written to a ``.tmp``
  sibling, flushed, fsync'd, then ``os.replace``'d into place: a crash
  mid-save leaves the previous snapshot untouched and at worst a stale
  ``.tmp``.
- **Integrity.** Every leaf carries a sha256 over its dtype, shape and
  bytes, the header fields are digested too, and the file has a magic
  string and a schema version. A torn or bit-flipped file fails naming the
  file and the leaf; :meth:`SnapshotManager.restore` falls back to the
  newest intact snapshot and records ``snapshot_fallback``.
- **Elastic topology.** Each rank saves its local state with ``(rank,
  world_size)`` in the header and the file name. A restore at another
  world size partitions the old ranks contiguously over the new ones and
  merges each partition through the states' registered reductions (sum,
  mean, max, min, cat, ``CatBuffer`` union, ``FaultCounters`` sum,
  ``sketch_merge``), in torch on the restoring metric's device; a sketch
  merge is one launch of kernel K3 on the card.

**The file format is the JAX package's**: the same ``MAGIC`` and
``SCHEMA_VERSION``, a pickle at protocol 4 of numpy trees only (never a
torch tensor: a leaf is digested as the numpy array written to the file,
so the same state digests alike from either package), the same header and
per-leaf sha256. A file written by either package restores in the other,
riding the payload interop of ``Metric.snapshot_state`` (fault counters are
int64 here and uint32 in JAX, D11; a sketch is saved as its primitives).

Merge caveats (the JAX package's): ``mean`` states merge as the unweighted
mean of the partials, exact only when the new world size divides the old
one; other elastic hops warn and record ``snapshot_mean_approx``.
``dist_reduce_fx=None`` non-list states have no merge rule and need the
saved world size.

Snapshots are trusted artifacts of your own job (pickle), the trust model
of torch checkpoints.
"""
import hashlib
import os
import pickle
import re
import time
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from metrics_tpu_torch.analysis.lockwitness import note_blocking

MAGIC = "metrics-tpu-snapshot"
SCHEMA_VERSION = 1

_FILE_RE = re.compile(r"^(?P<tag>.+)\.step(?P<step>\d+)\.rank(?P<rank>\d+)\.of(?P<world>\d+)\.snap$")
_TMP_TTL_S = 3600.0

__all__ = [
    "MAGIC",
    "SCHEMA_VERSION",
    "SnapshotCorruptionError",
    "SnapshotError",
    "SnapshotManager",
    "SnapshotSchemaError",
    "atomic_write_bytes",
]


class SnapshotError(RuntimeError):
    """Base class for snapshot load/save failures."""


class SnapshotCorruptionError(SnapshotError):
    """A snapshot file failed integrity verification (torn write, bit flip)."""


class SnapshotSchemaError(SnapshotError):
    """A snapshot was written by a newer schema than this build understands."""


# --------------------------------------------------------------------------
# integrity: per-leaf digests over a deterministic walk of the payload tree
# --------------------------------------------------------------------------


def _iter_leaves(node: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _iter_leaves(node[k], f"{path}/{k}")
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            yield from _iter_leaves(x, f"{path}/[{i}]")
    else:
        yield path, node


def _leaf_digest(leaf: Any) -> str:
    h = hashlib.sha256()
    if isinstance(leaf, np.ndarray) or hasattr(leaf, "dtype"):
        arr = np.ascontiguousarray(np.asarray(leaf))
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    else:
        h.update(repr(leaf).encode())
    return h.hexdigest()


def _checksum_tree(payload: Any) -> Dict[str, str]:
    return {path: _leaf_digest(leaf) for path, leaf in _iter_leaves(payload)}


def atomic_write_bytes(path: str, blob: bytes) -> None:
    """The tmp-fsync-replace write: write to a pid-suffixed ``.tmp``
    sibling, flush, fsync, ``os.replace`` into place, fsync the directory.
    A crash mid-write leaves the previous file untouched and at worst a
    stale tmp. Shared by the snapshot writer, the trace export and the
    flight recorder."""
    # fsync is a blocking seam: the lock witness flags reaching it while a
    # hot lock is held
    note_blocking("fsync", path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic on POSIX: readers see old or new, never torn
    try:
        dir_fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError:  # pragma: no cover - platform-dependent (no directory fsync)
        pass


# --------------------------------------------------------------------------
# elastic merge: per-rank payloads -> one payload, through the registered
# reductions of the live target, on its device
# --------------------------------------------------------------------------


def _tensor(value: Any, device: Any) -> Any:
    import torch

    return torch.from_numpy(np.array(np.asarray(value))).to(device)


def _host(t: Any) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def _merge_state_values(values: List[Any], fx: Any, default: Any, key: str, owner: str, device: Any) -> Any:
    """Merge one state's per-rank serialized values as ``Metric._sync_dist``
    reduces them (sum/mean/max/min/cat), in torch on ``device``; returns
    numpy (the payload form)."""
    import torch

    from metrics_tpu_torch.utilities.guard import FaultCounters
    from metrics_tpu_torch.utilities.ringbuffer import CatBuffer

    if len(values) == 1 and not isinstance(default, CatBuffer):
        return values[0]
    if getattr(type(default), "is_sketch_state", False):
        # per-rank sketches re-merge through their own associative union,
        # the path a live sync runs (one K3 launch per merge on the card)
        states = [type(default).from_primitives(v, like=default) for v in values]
        merged = states[0]
        for s in states[1:]:
            merged = merged.sketch_merge(s)
        return {k: _host(v) for k, v in merged.to_primitives().items()}
    if isinstance(default, FaultCounters):
        n = max(np.asarray(v).reshape(-1).shape[0] for v in values)
        total = torch.zeros((n,), dtype=torch.int64, device=device)
        for v in values:
            arr = _tensor(np.asarray(v).reshape(-1).astype(np.int64), device)
            total[: arr.shape[0]] += arr
        return _host(total)
    if isinstance(default, CatBuffer):
        # union and compact: the valid rows of every rank in (rank, slot)
        # order, packed at the front of a buffer whose capacity is the sum
        # of the partials' capacities
        rows, caps, dropped = [], 0, 0
        for v in values:
            data = _tensor(v["data"], device)
            mask = _tensor(np.asarray(v["mask"], bool), device)
            rows.append(data[mask])
            caps += data.shape[0]
            if v.get("dropped") is not None:
                dropped += int(np.asarray(v["dropped"]).astype(np.int64))
        packed = torch.cat(rows, dim=0)
        data = torch.zeros((caps,) + tuple(packed.shape[1:]), dtype=packed.dtype, device=device)
        data[: packed.shape[0]] = packed
        mask = torch.zeros((caps,), dtype=torch.bool, device=device)
        mask[: packed.shape[0]] = True
        dropped_dtype = np.asarray(values[0].get("dropped", np.zeros((), np.int32))).dtype
        return {"data": _host(data), "mask": _host(mask), "dropped": np.asarray(dropped, dropped_dtype)}
    if isinstance(default, list):
        merged: List[Any] = []
        for v in values:
            merged.extend(list(v))
        return merged
    stacked = torch.stack([_tensor(v, device) for v in values], dim=0)
    if fx == "sum":
        return _host(torch.sum(stacked, dim=0))
    if fx == "mean":
        return _host(torch.mean(stacked, dim=0))
    if fx == "max":
        return _host(torch.amax(stacked, dim=0))
    if fx == "min":
        return _host(torch.amin(stacked, dim=0))
    if fx == "cat":
        return _host(torch.cat([torch.atleast_1d(v) for v in stacked], dim=0))
    raise SnapshotError(
        f"{owner}: state {key!r} has dist_reduce_fx={fx!r}, which has no elastic merge rule — "
        "restore this snapshot at its original world size"
    )


def _merge_metric_payloads(metric: Any, payloads: List[Dict[str, Any]]) -> Dict[str, Any]:
    # the load path refuses states the target does not register; the merge
    # path refuses the same, or a mismatched restore would lose state
    unknown = sorted({k for p in payloads for k in p.get("states", {})} - set(metric._reductions))
    if unknown:
        raise ValueError(
            f"{type(metric).__name__}: snapshot carries unknown state {unknown[0]!r}; "
            "refusing to merge (metric config mismatch?)"
        )
    states: Dict[str, Any] = {}
    for key, fx in metric._reductions.items():
        values = [p["states"][key] for p in payloads if key in p.get("states", {})]
        if values:
            states[key] = _merge_state_values(
                values, fx, metric._defaults[key], key, type(metric).__name__, metric.device
            )
    out: Dict[str, Any] = {
        "states": states,
        "update_count": sum(int(p.get("update_count", 0)) for p in payloads),
    }
    clocks = [p["last_update_unix"] for p in payloads if p.get("last_update_unix") is not None]
    if clocks:
        out["last_update_unix"] = max(clocks)  # the freshest rank wins
    attrs: Dict[str, Any] = {}
    for p in payloads:  # data-inferred attributes are rank-invariant: the first wins
        for k, v in p.get("attrs", {}).items():
            attrs.setdefault(k, v)
    if attrs:
        out["attrs"] = attrs
    children = {}
    mine = dict(metric._named_child_metrics())
    unknown_children = sorted({k for p in payloads for k in p.get("children", {})} - set(mine))
    if unknown_children:
        raise ValueError(
            f"{type(metric).__name__}: snapshot carries child metric {unknown_children[0]!r} "
            "this instance does not have; refusing to merge"
        )
    for name in mine:
        child_payloads = [p["children"][name] for p in payloads if name in p.get("children", {})]
        if child_payloads:
            children[name] = _merge_metric_payloads(mine[name], child_payloads)
    if children:
        out["children"] = children
    return out


def _merge_payloads(obj: Any, payloads: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-rank payloads through ``obj``'s reduction tags (``obj`` is
    the live restore target, a Metric or a MetricCollection)."""
    if _is_collection(obj):
        members: Dict[str, Any] = {}
        modules = dict(obj._modules)
        unknown = sorted({k for p in payloads for k in p.get("members", {})} - set(modules))
        if unknown:
            raise ValueError(
                f"MetricCollection: snapshot carries member {unknown[0]!r} this collection "
                f"does not have (members: {list(modules)}); refusing to merge"
            )
        for name, member in modules.items():
            member_payloads = [p["members"][name] for p in payloads if name in p.get("members", {})]
            if member_payloads:
                members[name] = _merge_metric_payloads(member, member_payloads)
        return {"members": members}
    return _merge_metric_payloads(obj, payloads)


def _is_collection(obj: Any) -> bool:
    return hasattr(obj, "_modules") and hasattr(obj, "snapshot_state")


def _has_mean_state(obj: Any) -> bool:
    """Whether any state (recursively) merges by unweighted mean."""
    if _is_collection(obj):
        return any(_has_mean_state(m) for m in obj._modules.values())
    if any(fx == "mean" for fx in obj._reductions.values()):
        return True
    return any(_has_mean_state(child) for _name, child in obj._named_child_metrics())


# --------------------------------------------------------------------------
# the manager
# --------------------------------------------------------------------------


class SnapshotManager:
    """Rolling, checksummed, topology-aware snapshots in one directory.

    Example::

        mgr = SnapshotManager("/ckpt/metrics", keep=3)
        mgr.save(collection, step=epoch)            # atomic, pruned to 3
        info = mgr.restore(collection)              # the newest intact one

    Every rank saves its local state with ``save(obj, step, rank=r,
    world_size=W)``; a resumed job at any world size ``W'`` restores with
    ``restore(obj, rank=r', world_size=W')``, each new rank merging its
    contiguous share of the old partials. ``group_verification="full"``
    (the default) has every restoring rank checksum every file of a group,
    so all ranks make the same fallback decision; ``"assigned"`` verifies
    only the rank's own share (and old rank 0's header) and checks the rest
    are present and non-empty.

    :attr:`last_save_timings` holds the seconds of the newest save, split
    into ``read_back_s`` (the states to host numpy), ``digest_s``,
    ``pickle_s`` and ``write_s`` (the write, its fsyncs and the rename).
    """

    def __init__(
        self,
        directory: str,
        tag: str = "metrics",
        keep: int = 3,
        group_verification: str = "full",
    ) -> None:
        if keep < 1:
            raise ValueError(f"`keep` must be >= 1, got {keep}")
        if group_verification not in ("full", "assigned"):
            raise ValueError(f"`group_verification` must be 'full' or 'assigned', got {group_verification!r}")
        self.directory = str(directory)
        self.tag = tag
        self.keep = keep
        self.group_verification = group_verification
        self.last_save_timings: Dict[str, float] = {}
        os.makedirs(self.directory, exist_ok=True)

    # -- naming ---------------------------------------------------------

    def _filename(self, step: int, rank: int, world_size: int) -> str:
        return f"{self.tag}.step{step:010d}.rank{rank:05d}.of{world_size:05d}.snap"

    def _scan(self) -> Dict[Tuple[int, int], Dict[int, str]]:
        """{(step, world): {rank: path}} for this manager's tag."""
        groups: Dict[Tuple[int, int], Dict[int, str]] = {}
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return groups
        for name in names:
            m = _FILE_RE.match(name)
            if m is None or m.group("tag") != self.tag:
                continue
            key = (int(m.group("step")), int(m.group("world")))
            groups.setdefault(key, {})[int(m.group("rank"))] = os.path.join(self.directory, name)
        return groups

    def steps(self) -> List[int]:
        """Steps with at least one snapshot file, ascending."""
        return sorted({step for (step, _world) in self._scan()})

    # -- save -----------------------------------------------------------

    def save(
        self,
        obj: Any,
        step: int,
        rank: int = 0,
        world_size: int = 1,
        reduced: bool = False,
        mesh_axes: Optional[Dict[str, int]] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Write one atomic snapshot of ``obj``'s full state; returns its
        path. ``reduced=True`` marks state already globally reduced (saved
        after a sync, with ``world_size=1``): a restore loads it on rank 0
        only and resets the others. ``mesh_axes`` and ``extra`` go into the
        header as they are."""
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} outside world of size {world_size}")
        if reduced and world_size != 1:
            raise ValueError("reduced=True snapshots are global state — save them with world_size=1")
        from metrics_tpu_torch import __version__
        from metrics_tpu_torch.obs import trace as _obs_trace

        with _obs_trace.span("snapshot.save", step=int(step), rank=int(rank)):
            t0 = time.perf_counter()
            payload = obj.snapshot_state()  # numpy leaves: the states' one read back
            t1 = time.perf_counter()
            header = {
                "step": int(step),
                "rank": int(rank),
                "world_size": int(world_size),
                "reduced": bool(reduced),
                "mesh_axes": dict(mesh_axes) if mesh_axes else None,
                "created_unix": time.time(),
                "library_version": __version__,
                "extra": dict(extra) if extra else None,
            }
            # the header is covered too: a flipped `reduced`/`world_size`
            # would change restore semantics, not just values
            checksums = _checksum_tree({"header": header, "payload": payload})
            t2 = time.perf_counter()
            blob = pickle.dumps(
                {
                    "magic": MAGIC,
                    "schema_version": SCHEMA_VERSION,
                    "header": header,
                    "payload": payload,
                    "checksums": checksums,
                },
                protocol=4,
            )
            t3 = time.perf_counter()
            final = os.path.join(self.directory, self._filename(step, rank, world_size))
            atomic_write_bytes(final, blob)
            t4 = time.perf_counter()
            self.last_save_timings = {
                "read_back_s": t1 - t0,
                "digest_s": t2 - t1,
                "pickle_s": t3 - t2,
                "write_s": t4 - t3,
                "bytes": len(blob),
            }
            self._prune(rank)
            return final

    def _prune(self, rank: int) -> None:
        """Keep the newest ``keep`` steps of THIS rank's files (each rank
        prunes only what it wrote) and clear stale tmp files of crashed
        writers."""
        mine: Dict[int, List[str]] = {}
        for (step, _world), files in self._scan().items():
            if rank in files:
                mine.setdefault(step, []).append(files[rank])
        for step in sorted(mine)[: -self.keep] if len(mine) > self.keep else []:
            for path in mine[step]:
                try:
                    os.unlink(path)
                except OSError:  # pragma: no cover - racing prune from another run
                    pass
        now = time.time()
        for name in os.listdir(self.directory):
            if ".snap.tmp." in name and name.startswith(self.tag + "."):
                path = os.path.join(self.directory, name)
                try:
                    if now - os.path.getmtime(path) > _TMP_TTL_S:
                        os.unlink(path)
                except OSError:  # pragma: no cover
                    pass

    # -- load -----------------------------------------------------------

    def load_file(self, path: str, verify: bool = True) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Read and verify one snapshot file: ``(header, payload)``. Raises
        :class:`SnapshotCorruptionError` or :class:`SnapshotSchemaError`,
        naming the file."""
        try:
            with open(path, "rb") as f:
                record = pickle.load(f)
        except FileNotFoundError:
            raise SnapshotError(f"snapshot {path} does not exist")
        except Exception as err:
            raise SnapshotCorruptionError(
                f"snapshot {path} is unreadable ({type(err).__name__}: {err}) — torn write or corruption"
            )
        if not isinstance(record, dict) or record.get("magic") != MAGIC:
            raise SnapshotCorruptionError(f"snapshot {path} has no {MAGIC!r} magic header")
        version = record.get("schema_version")
        if not isinstance(version, int) or version > SCHEMA_VERSION:
            raise SnapshotSchemaError(
                f"snapshot {path} has schema version {version!r}; this build understands <= "
                f"{SCHEMA_VERSION} — upgrade metrics_tpu_torch to restore it"
            )
        if verify:
            stored = record.get("checksums")
            computed = _checksum_tree({"header": record.get("header"), "payload": record.get("payload")})
            if stored != computed:
                bad = sorted(
                    set(stored or {}).symmetric_difference(computed)
                    | {k for k in (stored or {}) if k in computed and stored[k] != computed[k]}
                )
                raise SnapshotCorruptionError(
                    f"snapshot {path} failed checksum verification at leaf "
                    f"{bad[0] if bad else '<manifest>'} — corrupt state refused"
                )
        return record["header"], record["payload"]

    def latest_intact(self) -> Optional[Tuple[int, int]]:
        """Newest ``(step, world_size)`` whose group is complete and
        verifies, or None."""
        for (step, world), files in sorted(self._scan().items(), reverse=True):
            try:
                self._verify_group(step, world, files, keep=frozenset(), force_full=True)
            except SnapshotError:
                continue
            return step, world
        return None

    def _verify_group(
        self, step: int, world: int, files: Dict[int, str], keep: Any, force_full: bool = False
    ) -> Tuple[Dict[int, Dict[str, Any]], Dict[int, Dict[str, Any]]]:
        """Check a group: ``(headers, payloads)`` by old rank, payloads kept
        for the ``keep`` ranks only."""
        missing = sorted(set(range(world)) - set(files))
        if missing:
            raise SnapshotError(f"snapshot step {step} incomplete: missing rank file(s) {missing} of world {world}")
        full = force_full or self.group_verification == "full"
        headers: Dict[int, Dict[str, Any]] = {}
        payloads: Dict[int, Dict[str, Any]] = {}
        for r in range(world):
            # old rank 0's header always loads: it carries the reduced flag
            if full or r in keep or r == 0:
                header, payload = self.load_file(files[r])
                headers[r] = header
                if r in keep:
                    payloads[r] = payload
            elif os.path.getsize(files[r]) == 0:
                raise SnapshotCorruptionError(f"snapshot {files[r]} is empty — torn write")
        return headers, payloads

    def restore(self, obj: Any, rank: int = 0, world_size: int = 1) -> Dict[str, Any]:
        """Restore ``obj`` from the newest intact snapshot group.

        Corrupt or incomplete groups are skipped (a warning and a
        ``snapshot_fallback`` event) for the next older intact group; when
        none remains, the newest group's error is raised. Returns ``{"step",
        "old_world", "world_size", "merged_ranks", "reduced",
        "fallbacks"}``. A restore loads new tensors: a captured update's
        graphs are dropped at the next update."""
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} outside world of size {world_size}")
        from metrics_tpu_torch.obs import trace as _obs_trace

        with _obs_trace.span("snapshot.restore", rank=int(rank)):
            return self._restore_newest(obj, rank, world_size)

    def _restore_newest(self, obj: Any, rank: int, world_size: int) -> Dict[str, Any]:
        first_err: Optional[SnapshotError] = None
        fallbacks = 0
        for (step, world), files in sorted(self._scan().items(), reverse=True):
            assigned = [o for o in range(world) if (o * world_size) // world == rank]
            try:
                headers, payloads = self._verify_group(step, world, files, keep=set(assigned))
            except SnapshotError as err:
                if first_err is None:
                    first_err = err
                fallbacks += 1
                warnings.warn(
                    f"SnapshotManager: skipping snapshot step {step} ({err}); falling back to the next older snapshot",
                    UserWarning,
                )
                from metrics_tpu_torch.resilience.health import record_degradation

                record_degradation("snapshot_fallback", str(err), step=step, directory=self.directory)
                continue
            info = self._restore_group(obj, step, world, headers, payloads, assigned, rank, world_size)
            info["fallbacks"] = fallbacks
            return info
        if first_err is not None:
            raise first_err
        raise SnapshotError(f"no {self.tag!r} snapshots found under {self.directory}")

    def _restore_group(
        self,
        obj: Any,
        step: int,
        old_world: int,
        headers: Dict[int, Dict[str, Any]],
        payloads: Dict[int, Dict[str, Any]],
        assigned: List[int],
        rank: int,
        world_size: int,
    ) -> Dict[str, Any]:
        reduced = bool(headers[0].get("reduced"))
        info = {"step": step, "old_world": old_world, "world_size": world_size, "reduced": reduced, "merged_ranks": []}
        if reduced:
            # globally reduced state: rank 0 carries it, every other rank is
            # the reduction's identity, so the next sync reproduces it
            if rank == 0:
                obj.load_snapshot_state(payloads[0])
                info["merged_ranks"] = [0]
            else:
                obj.reset()
            return info
        # old rank o -> new rank floor(o * world_size / old_world)
        info["merged_ranks"] = assigned
        # a world that does not divide the old one breaks the unweighted
        # mean globally, so every rank warns (a grown world included)
        if old_world % world_size != 0 and _has_mean_state(obj):
            warnings.warn(
                f"SnapshotManager: restoring 'mean'-reduced state from world {old_world} onto "
                f"world {world_size}: merged means are approximate (exact only when the new "
                "world size divides the saved one). Prefer sum+count states over 'mean' for "
                "elastic jobs.",
                UserWarning,
            )
            from metrics_tpu_torch.resilience.health import record_degradation

            record_degradation(
                "snapshot_mean_approx",
                f"elastic restore {old_world}->{world_size} with 'mean'-reduced state",
                step=step,
            )
        if not assigned:
            obj.reset()  # a grown world: this new rank starts from defaults
        elif len(assigned) == 1 and old_world == world_size:
            obj.load_snapshot_state(payloads[assigned[0]])  # the bit-identical path
        else:
            obj.load_snapshot_state(_merge_payloads(obj, [payloads[o] for o in assigned]))
        return info
