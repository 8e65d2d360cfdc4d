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
