"""Counterpart of ``metrics_tpu/utilities/guard.py``: the fault channel,
its row validators, the ``on_invalid`` policies and the ``FaultCounters``
state.

- **Validators are tensor ops.** :func:`batch_fault_masks` turns a
  ``(preds, target)`` batch into per-row boolean fault masks and a
  :class:`FaultCounters` increment with ``isnan``/range compares and row
  reductions on the batch's device: nothing is read back to the host.
- **Counters are metric state.** ``FaultCounters`` holds one
  ``(NUM_FAULT_CLASSES,)`` int64 tensor, registered with
  ``dist_reduce_fx="sum"``, so it merges in ``forward``, saves in
  ``state_dict`` and syncs in the int64 sum bucket of
  :func:`~metrics_tpu_torch.parallel.sync.fused_sync`, beside the CountMin
  counters.
- **Policies.** ``on_invalid="drop"`` masks offending rows (through a
  ``valid`` row mask where the update takes one, through the update's own
  masking for the aggregators and sketches, else by boolean indexing, which
  reads the mask back); ``"warn"``/``"error"`` count and act at
  ``compute()`` from the synced counts; ``"ignore"`` leaves the update
  unguarded.

The JAX package counts in uint32; the port counts in int64 and holds the
same values below ``2**32``, where JAX wraps.
"""
import inspect
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.utilities.data import _tensor_leaves

Tensor = torch.Tensor

# Fault classes, in counter-vector order; appends only, so that a saved
# vector keeps loading.
FAULT_CLASSES: Tuple[str, ...] = (
    "nonfinite_preds",  # non-finite values in a float preds/value row
    "nonfinite_target",  # non-finite values in a float target row
    "prob_out_of_range",  # probability input outside [0, 1]
    "label_out_of_range",  # integer label < 0 or >= num_classes
    "nonfinite_state",  # NaN found in an accumulated state (at compute)
    "dropped_rows",  # rows masked out of the accumulators by the drop policy
    "padded_rows",  # ladder pad rows masked out by `valid`
)
NUM_FAULT_CLASSES = len(FAULT_CLASSES)
_IDX = {name: i for i, name in enumerate(FAULT_CLASSES)}

# classes that record intended operation rather than damaged input: they
# ride the counter vector but never trip the warn/error policies
INFORMATIONAL_FAULT_CLASSES: Tuple[str, ...] = ("padded_rows",)

VALID_POLICIES = ("error", "warn", "drop", "ignore")


def actionable_fault_total(counts: Any) -> int:
    """The total count without the informational classes: the number the
    warn and error policies act on (concrete counts; reads them back)."""
    c = np.asarray(counts.cpu() if isinstance(counts, Tensor) else counts).astype(np.int64).reshape(-1)
    total = int(c.sum())
    for name in INFORMATIONAL_FAULT_CLASSES:
        if _IDX[name] < c.shape[0]:
            total -= int(c[_IDX[name]])
    return total


def _scalar(value: Any, device: Optional[torch.device]) -> Tensor:
    return torch.as_tensor(value, device=device).to(torch.int64).reshape(())


class FaultCounters(NamedTuple):
    """Per-class fault counts as one ``(NUM_FAULT_CLASSES,)`` int64 tensor."""

    counts: Tensor

    @classmethod
    def zeros(cls, device: Union[str, torch.device, None] = None) -> "FaultCounters":
        return cls(counts=torch.zeros((NUM_FAULT_CLASSES,), dtype=torch.int64, device=device))

    @classmethod
    def single(cls, device: Union[str, torch.device, None] = None, **named: Any) -> "FaultCounters":
        """Counters with the named classes set (tensors or numbers)."""
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return cls(counts=torch.stack([_scalar(named[n], device) if n in named else zero for n in FAULT_CLASSES]))

    # a NamedTuple's ``+`` concatenates; counters add elementwise, so the
    # plain ``g + b`` merge of a sum state works on them
    def __add__(self, other: "FaultCounters") -> "FaultCounters":  # type: ignore[override]
        return FaultCounters(counts=self.counts + other.counts)

    def __radd__(self, other: Any) -> "FaultCounters":
        if isinstance(other, int) and other == 0:  # sum([...]) over counters
            return self
        return self.__add__(other)

    def get(self, name: str) -> Tensor:
        return self.counts[_IDX[name]]

    def total(self) -> Tensor:
        return self.counts.sum()

    def as_dict(self) -> Dict[str, int]:
        """The counts by class name (reads them back)."""
        host = self.counts.cpu().tolist()
        return {name: int(host[i]) for i, name in enumerate(FAULT_CLASSES)}


# --------------------------------------------------------------------------
# row validators: tensor ops on the batch's device
# --------------------------------------------------------------------------


def _rows(x: Tensor) -> Tensor:
    """``x`` as ``(N, -1)``, also when a row holds no element."""
    return x.reshape(x.shape[0], -1) if x.shape[0] else x.reshape(0, 1)


def nonfinite_rows(x: Tensor, nan_only: bool = False) -> Tensor:
    """Bool ``(N,)``: rows with a NaN (or any non-finite value unless
    ``nan_only``). All False for integer tensors."""
    x = torch.atleast_1d(torch.as_tensor(x))
    if not x.is_floating_point():
        return torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
    bad = torch.isnan(x) if nan_only else ~torch.isfinite(x)
    return _rows(bad).any(dim=-1)


def prob_out_of_range_rows(p: Tensor) -> Tensor:
    """Bool ``(N,)``: rows with a finite probability outside ``[0, 1]``
    (non-finite entries are :func:`nonfinite_rows`' to count)."""
    p = torch.atleast_1d(torch.as_tensor(p))
    bad = torch.isfinite(p) & ((p < 0.0) | (p > 1.0))
    return _rows(bad).any(dim=-1)


def label_out_of_range_rows(target: Tensor, num_classes: int, ignore_index: Optional[int] = None) -> Tensor:
    """Bool ``(N,)``: rows with an integer label ``< 0`` or
    ``>= num_classes`` (a label equal to ``ignore_index`` is exempt)."""
    t = torch.atleast_1d(torch.as_tensor(target))
    bad = (t < 0) | (t >= num_classes)
    if ignore_index is not None:
        bad = bad & (t != ignore_index)
    return _rows(bad).any(dim=-1)


def nan_state_leaves(state: Dict[str, Any]) -> int:
    """Number of state tensors holding a NaN: the ``nonfinite_state`` check
    at compute (reads each float state's answer back). ``inf`` is not a
    fault here: it is the identity of the max and min reductions."""
    return sum(
        1 for v in state.values() for t in _tensor_leaves(v) if t.is_floating_point() and bool(torch.isnan(t).any())
    )


def batch_fault_masks(
    preds: Optional[Tensor],
    target: Optional[Tensor],
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    check_probs: bool = False,
    nan_only: bool = False,
) -> Tuple[FaultCounters, Optional[Tensor]]:
    """Validate one ``(preds, target)`` batch: the counter increment and the
    bool ``(N,)`` union of the rows' faults (None when no row-aligned check
    applies). Tensor ops only; nothing is read back."""
    named: Dict[str, Tensor] = {}
    bad: Optional[Tensor] = None
    device = None

    def union(mask: Tensor, existing: Optional[Tensor]) -> Tensor:
        return mask if existing is None else (existing | mask)

    n_rows = None
    if preds is not None:
        device = preds.device
        n_rows = torch.atleast_1d(preds).shape[0]
        p_bad = nonfinite_rows(preds, nan_only=nan_only)
        named["nonfinite_preds"] = p_bad.sum()
        bad = union(p_bad, bad)
        if check_probs and preds.is_floating_point():
            r_bad = prob_out_of_range_rows(preds)
            named["prob_out_of_range"] = r_bad.sum()
            bad = union(r_bad, bad)

    if target is not None:
        # a target made from a Python number lies on the CPU
        t = torch.atleast_1d(target if device is None else target.to(device))
        device = t.device
        t_bad = nonfinite_rows(t, nan_only=nan_only)
        named["nonfinite_target"] = t_bad.sum()
        if not t.is_floating_point() and t.dtype != torch.bool and num_classes is not None:
            l_bad = label_out_of_range_rows(t, num_classes, ignore_index)
            named["label_out_of_range"] = l_bad.sum()
            t_bad = t_bad | l_bad
        # a target that is not row-aligned with preds (a broadcast scalar)
        # is counted but takes no part in dropping rows
        if n_rows is None or t.shape[0] == n_rows:
            bad = union(t_bad, bad)

    return FaultCounters.single(device=device, **named), bad


# --------------------------------------------------------------------------
# the update guard (used by Metric._maybe_guard)
# --------------------------------------------------------------------------


def resolve_guard_config(metric: Any, preds: Optional[Tensor], target: Optional[Tensor]) -> Dict[str, Any]:
    """The metric's guard settings, read at call time (a subclass sets
    ``num_classes`` and ``threshold`` after ``Metric.__init__``)."""
    num_classes = getattr(metric, "num_classes", None)
    if not isinstance(num_classes, int) or isinstance(num_classes, bool):
        num_classes = None
    if (
        num_classes is None
        and preds is not None
        and target is not None
        and preds.ndim >= 2
        and preds.ndim == target.ndim + 1
        and preds.is_floating_point()
    ):
        num_classes = preds.shape[1]  # the implied (N, C, ...) class axis
    # the probability-range check is opt-in (``metric._guard_probs = True``):
    # float preds are thresholded without a [0, 1] constraint, so scores
    # and logits are legal input; when opted in, it applies where
    # thresholding does, to float preds of the target's rank
    check_probs = (
        bool(getattr(metric, "_guard_probs", False))
        and getattr(metric, "threshold", None) is not None
        and preds is not None
        and target is not None
        and preds.ndim == target.ndim
    )
    return {
        "num_classes": num_classes,
        "ignore_index": getattr(metric, "ignore_index", None),
        "check_probs": bool(check_probs),
        "nan_only": bool(getattr(metric, "_guard_nan_only", False)),
    }


def _as_checkable(a: Any) -> Optional[Tensor]:
    """An update argument as a numeric tensor, or None when it is not one
    (strings, dicts, bools, None: the guard skips those)."""
    if isinstance(a, Tensor):
        arr = a
    elif isinstance(a, np.ndarray):
        arr = torch.from_numpy(a)
    elif isinstance(a, (bool, str)) or a is None:
        return None
    elif isinstance(a, (int, float)):
        arr = torch.as_tensor(a)
    elif isinstance(a, (list, tuple)):
        try:
            arr = torch.as_tensor(a)
        except (ValueError, TypeError, RuntimeError):
            return None
    else:
        return None
    if arr.dtype == torch.bool or arr.is_complex():
        return None
    return arr


def _body_neutralizes(metric: Any) -> Tuple[bool, bool]:
    """``(masks, imputes)``: how a ``_guard_handles_drop`` metric's own
    update neutralises invalid values, by masking rows (the ``"warn"`` and
    ``"ignore"`` NaN strategies) or by imputing a value (a float strategy).
    Either way the guard rewrites no argument."""
    if not getattr(metric, "_guard_handles_drop", False):
        return False, False
    strategy = getattr(metric, "nan_strategy", None)
    masks = strategy in ("warn", "ignore")
    imputes = isinstance(strategy, (int, float)) and not isinstance(strategy, bool)
    return masks, imputes


def _consumes_valid_mask(metric: Any) -> bool:
    """The update takes a ``valid`` row mask and uses it: a ring metric
    (``capacity``), a class whose ``_valid_mask_always`` holds (the
    stat-scores family, whose update zeroes a masked row's counts), or a
    wrapper whose update passes its keyword arguments on to such a
    ``wrapped`` metric (the streaming wrappers, which also count their
    window quota from the mask). The one predicate of the drop guard, of
    :func:`can_drop_traced` and of the padding ladder
    (``ops/padding.py::supports_row_mask``)."""
    sig = getattr(metric, "_update_signature", None)
    if sig is None:
        return False
    params = sig.parameters
    if "valid" in params:
        return getattr(metric, "capacity", None) is not None or bool(getattr(metric, "_valid_mask_always", False))
    wrapped = getattr(metric, "wrapped", None)
    if wrapped is not None and any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return _consumes_valid_mask(wrapped)
    return False


def can_drop_traced(metric: Any) -> bool:
    """Whether ``on_invalid="drop"`` needs no boolean indexing, which reads
    the row count back: the metric's own body neutralises invalid values
    (the aggregators' NaN masking or imputation), or its update consumes a
    ``valid`` row mask (:func:`_consumes_valid_mask`). The pure layer
    refuses ``"drop"`` on any other metric, as the JAX package's does
    inside compiled code."""
    return any(_body_neutralizes(metric)) or _consumes_valid_mask(metric)


def _normalize_call(metric: Any, args: tuple, kwargs: dict) -> Optional[Dict[str, Any]]:
    """The call bound to the update's signature, ``{param: value}`` in
    declaration order, or None when it cannot be bound (the update then
    raises its own error) or the signature takes ``*args``."""
    sig = metric._update_signature
    if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in sig.parameters.values()):
        return None
    try:
        bound = sig.bind(*args, **kwargs)
    except TypeError:
        return None
    norm: Dict[str, Any] = {}
    for name, param in sig.parameters.items():
        if name not in bound.arguments:
            continue
        if param.kind == inspect.Parameter.VAR_KEYWORD:
            norm.update(bound.arguments[name])
        else:
            norm[name] = bound.arguments[name]
    return norm


def guard_update_args(metric: Any, args: tuple, kwargs: dict) -> Tuple[tuple, dict, FaultCounters]:
    """Apply the metric's ``on_invalid`` policy to one update call: the
    (possibly masked) ``(args, kwargs)`` and the counter increment.

    Only the drop policy on an update without a ``valid`` mask and without
    its own masking reads anything back: it boolean-indexes every
    row-aligned argument, as the JAX package does on its eager path."""
    norm = _normalize_call(metric, args, kwargs)
    if norm is None:
        names = [f"__arg{i}" for i in range(len(args))]
        norm = dict(zip(names, args))
        norm.update(kwargs)
        param_names = names
        positional = True
    else:
        param_names = [n for n in norm if n != "valid"]
        positional = False

    first_two = param_names[:2]
    preds = _as_checkable(norm[first_two[0]]) if len(first_two) > 0 else None
    target = _as_checkable(norm[first_two[1]]) if len(first_two) > 1 else None
    cfg = resolve_guard_config(metric, preds, target)
    counters, bad = batch_fault_masks(
        preds,
        target,
        num_classes=cfg["num_classes"],
        ignore_index=cfg["ignore_index"],
        check_probs=cfg["check_probs"],
        nan_only=cfg["nan_only"],
    )
    device = counters.counts.device

    def rebuild(norm: Dict[str, Any]) -> Tuple[tuple, dict]:
        if positional:
            n_pos = sum(1 for k in norm if k.startswith("__arg"))
            return tuple(norm[f"__arg{i}"] for i in range(n_pos)), {
                k: v for k, v in norm.items() if not k.startswith("__arg")
            }
        return (), dict(norm)

    # aggregators and sketches neutralise invalid values in their own
    # update: the guard only counts what their masking drops
    body_masks, body_imputes = _body_neutralizes(metric)
    if (body_masks or body_imputes) and bad is not None:
        if body_masks:
            counters = counters + FaultCounters.single(device=device, dropped_rows=bad.sum())
        a, k = rebuild(norm)
        return a, k, counters

    if metric.on_invalid != "drop" or bad is None:
        a, k = rebuild(norm)
        return a, k, counters

    counters = counters + FaultCounters.single(device=device, dropped_rows=bad.sum())
    good = ~bad
    if _consumes_valid_mask(metric):
        prior = norm.get("valid")
        norm = dict(norm)
        norm["valid"] = good if prior is None else (torch.as_tensor(prior, device=good.device).to(torch.bool) & good)
        a, k = rebuild(norm)
        return a, k, counters

    # boolean-index every row-aligned argument (reads the mask back)
    n = good.shape[0]
    masked = {}
    for name, v in norm.items():
        arr = _as_checkable(v)
        masked[name] = arr[good.to(arr.device)] if arr is not None and arr.ndim >= 1 and arr.shape[0] == n else v
    a, k = rebuild(masked)
    return a, k, counters


def format_fault_report(counts: Any, owner: str) -> str:
    """A summary of the non-zero fault classes."""
    c = np.asarray(counts.cpu() if isinstance(counts, Tensor) else counts).reshape(-1)
    parts = [f"{name}={int(c[i])}" for i, name in enumerate(FAULT_CLASSES) if i < c.shape[0] and int(c[i]) > 0]
    return (
        f"{owner}: input/state faults detected in the update "
        f"({', '.join(parts)}). Counts are cumulative since the last report and, after a "
        "distributed sync, global across ranks. Use on_invalid='drop' to mask offending "
        "rows, or 'ignore' to silence this channel."
    )
