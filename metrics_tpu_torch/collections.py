"""``MetricCollection`` with automatic compute groups (counterpart of
``metrics_tpu/collections.py``).

Compute groups: after the first ``update`` the members whose states are
equal (tensors, lists, rings and sketch states alike) form a group, and from then on only the group's first member (its
head) runs ``update``. The other members' states point at the head's
tensors, which the head updates in place. ``items``/``values``/``[]`` hand
out copies by default, so a caller cannot write into a shared state by
accident; loaded states stand until the next update.

In a ``torch.distributed`` world of more than one process, ``compute()``
syncs the whole collection once, in one
:func:`~metrics_tpu_torch.parallel.sync.fused_sync` of every member's
states: one ``all_reduce`` per (reduction, dtype) bucket, and one gather
per list or ring state of each compute group (a group gathers once when
every rank has formed it). Every member then computes from the synced
states without syncing itself, and gets its local state back.
:meth:`MetricCollection.sync_states` is the same sync without the restore.
``forward`` never syncs.

Members with ``sync_mode="overlapped"`` share one scheduler
(``parallel/async_sync.py``), a single issuer of collectives: each cycle
clones every overlapped member's state and syncs them all in one
``fused_sync``, under ``gather_sequence_lock``, and each member reads its
own entry of the view. Its cadence is the strictest of its members'.
``compute(fresh=True)`` is forwarded to every member: all of them then sync
in the blocking collection sync. ``reset``, ``clone`` and pickling drop the
scheduler and its thread.
"""
import contextlib
from collections import OrderedDict
from copy import deepcopy
from typing import Any, Dict, Hashable, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.metric import (
    CompositionalMetric,
    Metric,
    _clone,
    _cycle_error_recorder,
    _is_tuple_state,
    _on_stream,
    _use_on_current_stream,
)
from metrics_tpu_torch.ops.quantize import resolve_codec
from metrics_tpu_torch.parallel.sync import distributed_available, fused_sync
from metrics_tpu_torch.utilities.data import _flatten_dict


class MetricCollection:
    """Chain metrics with the same call pattern.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricCollection
        >>> coll = MetricCollection({"acc": Accuracy(device="cpu"), "macro": Accuracy(num_classes=3, average="macro", device="cpu")})
        >>> out = coll(torch.tensor([2, 1, 2, 0]), torch.tensor([0, 2, 0, 2]))
        >>> {k: round(float(v), 4) for k, v in out.items()}
        {'acc': 0.0, 'macro': 0.0}
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
    ) -> None:
        self._modules: "OrderedDict[str, Metric]" = OrderedDict()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked = False
        self._state_is_copy = False
        self._groups: Dict[int, List[str]] = {}

        self.add_metrics(metrics, *additional_metrics)

    # ------------------------------------------------------------------
    # call surface
    # ------------------------------------------------------------------

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Every member's forward; kwargs filtered per update signature."""
        self._ensure_overlap_scheduler()
        res = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in self.items(keep_base=True, copy_state=False)}
        res = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the group heads only, once groups have formed."""
        self._ensure_overlap_scheduler()
        if self._groups_checked:
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                m0.update(*args, **m0._filter_kwargs(**kwargs))
                for name in cg[1:]:
                    self._modules[name]._update_count = m0._update_count
                    self._modules[name]._update_called = True
                    self._modules[name]._computed = None
            self._state_is_copy = False
        else:
            for _, m in self.items(keep_base=True, copy_state=False):
                m.update(*args, **m._filter_kwargs(**kwargs))
            if self._enable_compute_groups:
                self._merge_compute_groups()
                self._compute_groups_create_state_ref()
                self._groups_checked = True

    def compute(self, fresh: bool = False) -> Dict[str, Any]:
        """Every member's value; in a world of more than one process from
        one fused sync of the members that do not read an overlapped view
        (every member with ``fresh=True``) and do not opt out with
        ``sync_on_compute=False`` (those compute their local values)."""
        self._compute_groups_create_state_ref()
        self._ensure_overlap_scheduler()
        readers = set() if fresh else {k for k, m in self._modules.items() if m.sync_mode == "overlapped"}
        blocking = [k for k in self._modules if k not in readers]
        synced = [k for k in blocking if self._modules[k].sync_on_compute]
        res = {}
        if distributed_available() and any(self._modules[k]._computed is None for k in synced):
            units, local = self._sync_members(None, synced)
            try:
                for m in units:
                    m._to_sync = False  # the states are synced already
                try:
                    res.update({k: self._modules[k].compute() for k in synced})
                finally:
                    for m in units:
                        m._to_sync = True
            finally:
                for m, state in zip(units, local):
                    object.__setattr__(m, "_state", state)
        res.update({k: self._modules[k].compute() for k in blocking if k not in res})
        res.update({k: self._modules[k].compute() for k in readers})
        res = _flatten_dict({k: res[k] for k in self._modules})
        return {self._set_name(k): v for k, v in res.items()}

    def sync_states(self, group: Optional[Any] = None) -> None:
        """Replace every member's state with its synced value, from one
        :func:`~metrics_tpu_torch.parallel.sync.fused_sync` over ``group``
        (by default the members' ``process_group``); the members of a
        compute group point at their head's synced state."""
        self._compute_groups_create_state_ref()
        self._sync_members(group)
        for cg in self._groups.values():
            head = self._modules[cg[0]]
            for name in cg[1:]:
                for k in head._defaults:
                    self._modules[name]._state[k] = head._state[k]

    def _sync_members(self, group: Optional[Any], names: Optional[List[str]] = None) -> Tuple[List[Metric], List[Dict[str, Any]]]:
        """Every state under ``names`` replaced by its synced value, from one
        fused sync; returns the metrics synced and their local states, which
        the sync left untouched.

        Every member goes into the sync, since compute groups form from each
        rank's own data (a rank without a batch forms none) and every rank
        must send the same collectives. A member that shares its head's
        tensors says so (``same_as``): its gathered states then come from
        the head's gather when every rank agrees. A
        :class:`~metrics_tpu_torch.metric.CompositionalMetric` holds no state:
        its operands go into the same sync, each once (stated difference
        D23)."""
        names = list(self._modules) if names is None else names
        plain = [n for n in names if not isinstance(self._modules[n], CompositionalMetric)]
        units: List[Metric] = [self._modules[n] for n in plain]
        for n in names:
            m = self._modules[n]
            if isinstance(m, CompositionalMetric):
                units.extend(x for x in m.operand_leaves() if not any(x is u for u in units))
        same_as = self._same_as(plain) + [None] * (len(units) - len(plain))
        group = units[0].process_group if group is None and units else group
        synced = fused_sync(
            [m._state_for_sync(m._state) for m in units],
            [m._reductions for m in units],
            group,
            [m._sync_defaults() for m in units],
            comm=units[0].dist_sync_fn if units else None,
            same_as=same_as,
            transport="exact",
        )
        local = [m._state for m in units]
        for m, s in zip(units, synced):
            object.__setattr__(m, "_state", s)
        return units, local

    def _same_as(self, names: List[str]) -> List[Optional[int]]:
        """For each of ``names``, the index among them of the group head
        whose tensors it holds on this rank, or None."""
        index = {name: i for i, name in enumerate(names)}
        same_as: List[Optional[int]] = [None] * len(names)
        for cg in self._groups.values():
            head = self._modules[cg[0]]
            for name in cg[1:]:
                if cg[0] in index and name in index and all(
                    self._modules[name]._state[k] is head._state[k] for k in head._defaults
                ):
                    same_as[index[name]] = index[cg[0]]
        return same_as

    # ------------------------------------------------------------------
    # the overlapped sync
    # ------------------------------------------------------------------

    def _ensure_overlap_scheduler(self) -> None:
        """One scheduler for every overlapped member, set on each of them
        before it updates, so no member starts a scheduler of its own."""
        names = [k for k, m in self._modules.items() if m.sync_mode == "overlapped"]
        if not names:
            return
        sched = self.__dict__.get("_overlap_sched")
        if sched is None or sched.stopped:
            from metrics_tpu_torch.parallel.async_sync import AsyncSyncScheduler

            members = [self._modules[k] for k in names]
            transports = {m.sync_transport for m in members}
            if len(transports) > 1:
                raise ValueError(f"the overlapped members of a collection sync in one cycle; they ask for transports {transports}")
            label = f"collection({'+'.join(type(m).__name__ for m in members)})"
            every_n = [m.sync_every_n for m in members if m.sync_every_n is not None]
            every_s = [m.sync_every_s for m in members if m.sync_every_s is not None]
            sched = AsyncSyncScheduler(
                self._overlap_snapshot,
                self._overlap_reduce,
                sync_every_n=min(every_n) if every_n else None,
                sync_every_s=min(every_s) if every_s else None,
                on_error=_cycle_error_recorder(label),
                name=label,
            )
            self.__dict__["_overlap_sched"] = sched
            self.__dict__["_overlap_names"] = names
        for k in names:
            m = self._modules[k]
            old = m.__dict__.get("_sync_scheduler")
            if old is not None and old is not sched:
                old.stop(final=False, timeout_s=5.0)
            object.__setattr__(m, "_sync_scheduler", sched)
            object.__setattr__(m, "_sync_view_key", k)

    def _overlap_snapshot(self):
        """Every overlapped member's state cloned, under all their locks (a
        group's members hold its head's tensors): ``(entries, same_as),
        None`` with an entry ``(name, state, event, steps)`` each."""
        names = self.__dict__["_overlap_names"]
        members = [self._modules[k] for k in names]
        with contextlib.ExitStack() as stack:
            for m in members:
                stack.enter_context(m._state_swap_guard())
            # an update rebinds some of a head's states (``self._faults =
            # ...``): point its members at them again before the clone
            if not self._state_is_copy:
                for cg in self._groups.values():
                    head = self._modules[cg[0]]
                    for name in cg[1:]:
                        self._modules[name]._state.update({k: head._state[k] for k in head._defaults})
            same_as = self._same_as(names)
            # a group member's count follows its head's, which the
            # collection sets after the head's update: the head's is the one
            # its state holds now
            head_of = {name: cg[0] for cg in self._groups.values() for name in cg}
            entries = []
            for k, m in zip(names, members):
                (state, event), steps = m._overlap_snapshot()
                entries.append((k, state, event, self._modules[head_of.get(k, k)]._update_count))
        return (entries, same_as), None

    def _overlap_reduce(self, payload):
        """One sync of every member's clone: ``({name: (state, steps)},
        event)``."""
        entries, same_as = payload
        members = [self._modules[k] for k, _, _, _ in entries]
        head = members[0]
        side = head._cycle_stream()
        with _on_stream(side):
            for (_, state, event, _) in entries:
                _use_on_current_stream(state, event)
            synced = [state for _, state, _, _ in entries]
            if distributed_available():
                synced = fused_sync(
                    synced,
                    [m._reductions for m in members],
                    head.process_group,
                    [m._sync_defaults() for m in members],
                    comm=head.dist_sync_fn,
                    same_as=same_as,
                    transport="exact",
                    host_codec=resolve_codec(head.sync_transport),
                )
            done = None if side is None else side.record_event()
        return {k: (state, steps) for (k, _, _, steps), state in zip(entries, synced)}, done

    def reset(self) -> None:
        sched = self.__dict__.pop("_overlap_sched", None)
        if sched is not None:
            sched.stop(final=False, timeout_s=5.0)
        for _, m in self.items(keep_base=True, copy_state=False):
            m.reset()
        if self._enable_compute_groups and self._groups_checked:
            self._compute_groups_create_state_ref()

    def __getstate__(self) -> Dict[str, Any]:
        # the scheduler's thread never travels: the copy builds its own
        return {k: v for k, v in self.__dict__.items() if k not in ("_overlap_sched", "_overlap_names")}

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for _, m in self.items(keep_base=True, copy_state=False):
            m.persistent(mode)

    def state_dict(self) -> Dict[str, Any]:
        """Per-member state dicts keyed by base name."""
        return {k: m.state_dict() for k, m in self.items(keep_base=True, copy_state=True)}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        for k, m in self._modules.items():
            if k in state_dict:
                m.load_state_dict(state_dict[k])
        # loaded states override group aliasing until the next update
        self._state_is_copy = True

    def snapshot_state(self) -> Dict[str, Any]:
        """Every member's :meth:`~metrics_tpu_torch.metric.Metric.snapshot_state`,
        keyed by base name."""
        return {"members": {k: m.snapshot_state() for k, m in self.items(keep_base=True, copy_state=True)}}

    def load_snapshot_state(self, payload: Dict[str, Any]) -> None:
        """Restore a :meth:`snapshot_state` payload (this package's or the
        JAX package's). Every member's payload is validated before any
        member commits, so a refused snapshot leaves the whole collection
        as it was; a member the collection lacks is refused by name."""
        members = payload.get("members", {})
        for name in members:
            if name not in self._modules:
                raise ValueError(
                    f"MetricCollection.load_snapshot_state: snapshot carries member {name!r} "
                    f"this collection does not have (members: {list(self._modules)})"
                )
        prepared = {name: self._modules[name]._prepare_snapshot_state(sub) for name, sub in members.items()}
        for name, sub in prepared.items():
            self._modules[name]._commit_snapshot_state(sub)
        # loaded states override group aliasing until the next update
        self._state_is_copy = True

    # ------------------------------------------------------------------
    # compute groups
    # ------------------------------------------------------------------

    def _merge_compute_groups(self) -> None:
        """Pairwise state-equality merge of groups."""
        n_groups = len(self._groups)
        while True:
            for cg_idx1, cg_members1 in list(self._groups.items()):
                merged = False
                for cg_idx2, cg_members2 in list(self._groups.items()):
                    if cg_idx1 == cg_idx2 or cg_idx2 not in self._groups:
                        continue
                    metric1 = self._modules[cg_members1[0]]
                    metric2 = self._modules[cg_members2[0]]
                    if self._equal_metric_states(metric1, metric2):
                        self._groups[cg_idx1].extend(self._groups.pop(cg_idx2))
                        merged = True
                        break
                if merged:
                    break
            if len(self._groups) == n_groups:
                break
            n_groups = len(self._groups)
        self._groups = {i: v for i, v in enumerate(self._groups.values())}

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """Shape and value equality of two metrics' states."""
        if len(metric1._defaults) == 0 or len(metric2._defaults) == 0:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        for key in metric1._defaults:
            state1 = metric1._state[key]
            state2 = metric2._state[key]
            if type(state1) is not type(state2):
                return False
            if _is_tuple_state(state1):
                # a sketch or a ring: field by field, each of the same shape
                # and equal values
                if not all(
                    s1.shape == s2.shape and s1.device == s2.device and torch.equal(s1, s2)
                    for s1, s2 in zip(state1, state2)
                ):
                    return False
            elif isinstance(state1, list):
                if len(state1) != len(state2):
                    return False
                if not all(s1.shape == s2.shape and torch.allclose(s1, s2) for s1, s2 in zip(state1, state2)):
                    return False
            elif state1.shape != state2.shape or state1.device != state2.device or not torch.allclose(state1, state2):
                return False
        return True

    def _compute_groups_create_state_ref(self, copy: bool = False) -> None:
        """Point member states at their group head's states (copies with
        ``copy=True``). Skipped while loaded or handed-out copies stand."""
        if not self._state_is_copy:
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                for name in cg[1:]:
                    mi = self._modules[name]
                    for state in m0._defaults:
                        m0_state = m0._state[state]
                        if copy:
                            m0_state = _clone(m0_state)
                        mi._state[state] = m0_state
                    mi._computed = None
        self._state_is_copy = copy

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    # ------------------------------------------------------------------
    # container surface
    # ------------------------------------------------------------------

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence) and not isinstance(metrics, dict):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                raise ValueError(f"Received extra arguments {remain} that are not metrics.")
        elif additional_metrics:
            raise ValueError(
                f"Received extra arguments {additional_metrics} that are not compatible"
                " with first passed dictionary."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of"
                        " `metrics_tpu_torch.Metric` or `metrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[f"{name}_{k}"] = v
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of"
                        " `metrics_tpu_torch.Metric` or `metrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    name = type(metric).__name__
                    if name in self._modules:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[k] = v
        else:
            raise ValueError("Unknown input to MetricCollection.")

        self._groups_checked = False
        if self._enable_compute_groups:
            self._init_compute_groups()
        else:
            self._groups = {}

    def _init_compute_groups(self) -> None:
        if isinstance(self._enable_compute_groups, list):
            self._groups = {i: k for i, k in enumerate(self._enable_compute_groups)}
            for v in self._groups.values():
                for metric in v:
                    if metric not in self._modules:
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the collection."
                            f" Please make sure that {self._enable_compute_groups} matches {list(self._modules)}"
                        )
            self._groups_checked = True
        else:
            self._groups = {i: [str(k)] for i, k in enumerate(self._modules)}

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def _to_renamed_ordered_dict(self) -> "OrderedDict[str, Metric]":
        od: "OrderedDict[str, Metric]" = OrderedDict()
        for k, v in self._modules.items():
            od[self._set_name(k)] = v
        return od

    def keys(self, keep_base: bool = False) -> Iterable[Hashable]:
        if keep_base:
            return self._modules.keys()
        return self._to_renamed_ordered_dict().keys()

    def items(self, keep_base: bool = False, copy_state: bool = True) -> Iterable[Tuple[str, Metric]]:
        self._compute_groups_create_state_ref(copy_state)
        if keep_base:
            return self._modules.items()
        return self._to_renamed_ordered_dict().items()

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        self._compute_groups_create_state_ref(copy_state)
        return self._modules.values()

    def __getitem__(self, key: str, copy_state: bool = True) -> Metric:
        self._compute_groups_create_state_ref(copy_state)
        return self._modules[key]

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self.keys())

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "("
        for k, v in self._modules.items():
            repr_str += f"\n  {k}: {v!r}"
        if self.prefix:
            repr_str += f",\n  prefix={self.prefix}"
        if self.postfix:
            repr_str += f",\n  postfix={self.postfix}"
        return repr_str + "\n)" if len(self._modules) else repr_str + ")"
