"""Carry a JAX metric's state into its port.

The JAX package keeps a metric's state as a dict of arrays
(``metric_state``); a collection's members are keyed by name. Given those
arrays as numpy (``{k: np.asarray(v) for k, v in jax_metric.metric_state.items()}``),
:func:`load_jax_state` loads them into the port's metric or collection with
``load_state_dict``'s checks, on the metric's device and in its state dtypes.
A stream can then start in JAX and go on in the port.

A sketch state (``QuantileSketch``, ``CountMinSketch``, ``HyperLogLog``)
may be given as the JAX state itself (a NamedTuple of arrays), as its
``to_primitives()`` mapping, or as either with its arrays turned to numpy;
it loads through the port state's ``from_primitives``, which refuses
another geometry. A ``CatBuffer`` ring (the curve metrics with
``capacity=``) may be given as the JAX ``CatBuffer`` or as a ``{"data",
"mask", "dropped"}`` mapping, at any capacity; a ``cat`` list state as a
list of arrays. A JAX curve metric's state then carries over, and both
packages compute the same value from it.

The fault counters of a guarded metric (``_faults``) may be given as the
JAX ``FaultCounters`` or as its uint32 counts vector; the port holds them
as int64 of the same values. The aggregators' states (``MeanMetric``'s
value and weight, a ring ``CatMetric``) carry over like any other.

A ``WindowedMetric``'s bucket rings (``win__<state>``, the fault ring
``win___faults`` as uint32 counts) and cursor (``win__head``,
``win__fill``, ``win__n_updates``, ``win__rows``), and a
``DecayedMetric``'s float32 sums (``dec__<state>``, ``dec__n_updates``),
load like any other state, and the window or the decay goes on from them.
An overlapped metric (``sync_mode="overlapped"``) loads its live state; its
view is not carried, and the next cycle builds it.

The classification states carry the same way: a confusion matrix
(``confmat``, int32), a calibration error's lists or bins, a hinge or KL
sum, a KL ring (``capacity=``), the ranking sums.

The retrieval metrics carry the same way: their ``cat`` lists of ids,
scores and targets, or, with ``capacity=``, their three rings. A
``SlicedMetric``'s ``(K + 2)``-leading rings (``sl__<state>``, the fault
ring ``sl___faults`` given as the JAX package's uint32 counts, which the
port holds as int64) and its row counts (``sl__rows``) load like any other
state, and the slices go on from them.

The image metrics carry the same way: FID's and KID's real and fake
feature lists, or with ``capacity=`` their two rings (``real_features``,
``fake_features``); InceptionScore's logits list or ring (``features``);
the accumulate mode's image lists (``preds``, ``target``); the streaming
mode's float32 sums (``value_sum``, ``n_elements``); PSNR's sum, int32
count and target extremes; LPIPS's two sums. A JAX ``capacity=`` FID state
loads into the port and computes the same value. The nets' weights are not
states: they carry over through ``nets/*.py::load_jax_variables``.

A pure state (``pure.py``) carries both ways, in every layout: a
``MetricDef`` state dict, a wrapper's list of per-node dicts, a
collection's dict of those, the overlapped ``{live, reduced, steps,
covered}``, a bootstrap's stacked state and a sliced state (the
wrapper's rings and its metric's state, or a collection of those). :func:`load_jax_pure_state`
reads the JAX package's state into the layout of a port state of the same
definition (``mdef.init()`` as the template: each leaf takes the
template's device and dtype, a ring its own capacity);
:func:`to_jax_pure_state` writes a port state as numpy leaves in the layout
and dtypes of a JAX state (``jax_mdef.init()``), with the JAX package's
classes of its rings, fault counters and sketches taken from it, which
the JAX functions accept as they are.

States only: an attribute that a metric infers from its first batch, such
as ``Accuracy.mode``, is set again by the port's next ``update``. A whole
metric, its update count, inferred attributes and child metrics included,
carries over as a snapshot: ``Metric.load_snapshot_state`` (and the
collection's) reads the JAX package's ``snapshot_state()`` payload as it
is, and the JAX package reads the port's.
"""
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric, _is_sketch_state
from metrics_tpu_torch.utilities.guard import FaultCounters
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer


def _to_tensors(metric: Metric, state: Mapping[str, Any], where: str) -> Dict[str, Any]:
    unknown = sorted(set(state) - set(metric._defaults))
    if unknown:
        raise ValueError(f"{where}: the JAX state has {unknown}, which {type(metric).__name__} does not keep")
    out: Dict[str, Any] = {}
    for key, value in state.items():
        if _is_sketch_state(metric._defaults[key]):
            out[key] = value  # from_primitives takes the JAX forms as they are
        elif isinstance(metric._defaults[key], FaultCounters):
            out[key] = np.array(getattr(value, "counts", value))
        elif isinstance(metric._defaults[key], CatBuffer):
            fields = value if isinstance(value, Mapping) else {f: getattr(value, f, None) for f in CatBuffer._fields}
            out[key] = {f: torch.from_numpy(np.array(v)) for f, v in fields.items() if v is not None}
        elif isinstance(value, (list, tuple)):
            out[key] = [torch.from_numpy(np.array(v)) for v in value]
        else:
            out[key] = torch.from_numpy(np.array(value))
    return out


def load_jax_state(
    target: Union[Metric, MetricCollection],
    state: Mapping[str, Any],
) -> None:
    """Load numpy arrays of a JAX metric's ``metric_state`` into ``target``.

    For a bare metric ``state`` maps state names to arrays; for a collection
    it maps member names to such dicts. Shapes and dtypes are checked as
    :meth:`Metric.load_state_dict` checks them.
    """
    if isinstance(target, MetricCollection):
        members = dict(target.items(keep_base=True, copy_state=False))
        missing = sorted(set(state) - set(members))
        if missing:
            raise ValueError(f"load_jax_state: the collection has no member {missing}")
        target.load_state_dict(
            {name: _to_tensors(members[name], sub, f"load_jax_state[{name!r}]") for name, sub in state.items()}
        )
    elif isinstance(target, Metric):
        target.load_state_dict(_to_tensors(target, state, "load_jax_state"))
    else:
        raise TypeError(f"load_jax_state loads into a Metric or a MetricCollection, got {type(target).__name__}")


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def load_jax_pure_state(template: Any, jax_state: Any) -> Any:
    """A JAX pure state as the port's: ``template`` is a port state of the
    same definition (its ``init()``), whose layout, NamedTuple classes,
    devices and dtypes the result takes; the values are the JAX state's."""
    if isinstance(template, dict):
        if set(jax_state) != set(template):
            raise ValueError(f"load_jax_pure_state: the JAX state has keys {sorted(jax_state)}, the port's {sorted(template)}")
        return {k: load_jax_pure_state(v, jax_state[k]) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        get = jax_state.get if isinstance(jax_state, Mapping) else (lambda f: getattr(jax_state, f))
        return type(template)(*(load_jax_pure_state(v, get(f)) for f, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        if len(jax_state) != len(template):
            raise ValueError(f"load_jax_pure_state: the JAX state has {len(jax_state)} nodes, the port's {len(template)}")
        return [load_jax_pure_state(v, j) for v, j in zip(template, jax_state)]
    arr = np.array(jax_state).astype(_numpy_dtype(template.dtype))
    return torch.from_numpy(arr).to(template.device)


def to_jax_pure_state(state: Any, like: Any) -> Any:
    """A port pure state as numpy leaves in the layout and dtypes of the JAX
    state ``like`` (the JAX definition's ``init()``)."""
    if isinstance(like, dict):
        return {k: to_jax_pure_state(state[k], v) for k, v in like.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        # a ring, the fault counters, a sketch: the JAX class, by field name
        return type(like)(**{f: to_jax_pure_state(getattr(state, f), getattr(like, f)) for f in state._fields})
    if isinstance(like, (list, tuple)):
        return [to_jax_pure_state(s, v) for s, v in zip(state, like)]
    return state.detach().to("cpu", copy=True).numpy().astype(np.asarray(like).dtype)
