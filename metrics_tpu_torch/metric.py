"""The ``Metric`` runtime (counterpart of ``metrics_tpu/metric.py``).

A metric holds named state tensors on one device, registered with
:meth:`Metric.add_state`. ``update`` accumulates a batch into them,
``compute`` turns them into a value, and ``forward`` does both, returning the
batch's own value. Updates run eagerly; there is no compiled update.

The device is explicit: ``Metric(device=None)`` means ``"cuda"`` and raises
where there is no CUDA device, so a metric never runs on the CPU unless the
caller asks for ``device="cpu"``.

Subclass code may update states in place (``self.tp += tp``). The runtime
therefore clones wherever it keeps a state for later: defaults on reset, the
saved state in ``forward``, ``state_dict``.

A state is a tensor, a list of tensors (a ``cat`` state), or a sketch state
(``streaming/sketches.py``): a NamedTuple of tensors whose class sets
``is_sketch_state``. A sketch state merges through its own ``sketch_merge``
and is saved and loaded through ``to_primitives``/``from_primitives``.

Not in this module yet: the fault channel (``on_invalid``), ``CatBuffer``
rings, overlapped sync, snapshots, ``CompositionalMetric`` and the
multi-process sync. In a ``torch.distributed`` world larger than one process
``compute()`` raises rather than return a value that covers one rank only.
"""
import functools
import inspect
from copy import deepcopy
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.utilities.data import _squeeze_if_scalar
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor
Reduction = Union[str, Callable, None]

# attributes rebuilt per instance, never copied or pickled
_BOUND = ("update", "compute", "_original_update", "_original_compute", "_update_signature")


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means CUDA; asking for CUDA where there is none raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MetricsTPUUserError(
            "This metric runs on CUDA by default, and no CUDA device is available. "
            "Pass device='cpu' to run it on the CPU."
        )
    return device


def _distributed_world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _is_sketch_state(value: Any) -> bool:
    return getattr(type(value), "is_sketch_state", False)


def _map_state(fn: Callable[[Tensor], Tensor], value: Any) -> Any:
    """``fn`` over every tensor of a state: a tensor, a list, or a sketch state."""
    if isinstance(value, list):
        return [fn(v) for v in value]
    if _is_sketch_state(value):
        return type(value)(*(fn(v) for v in value))
    return fn(value)


def _clone(value: Any) -> Any:
    return _map_state(torch.Tensor.clone, value)


class Metric:
    """Base class for all metrics."""

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self, device: Union[str, torch.device, None] = None, on_overflow: str = "warn", **kwargs: Any
    ) -> None:
        object.__setattr__(self, "_state", {})
        object.__setattr__(self, "_defaults", {})
        object.__setattr__(self, "_reductions", {})
        object.__setattr__(self, "_persistent", {})
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {list(kwargs)}")
        self.device = resolve_device(device)
        if on_overflow not in ("warn", "error", "ignore"):
            raise ValueError(f"`on_overflow` must be 'warn', 'error' or 'ignore', got {on_overflow!r}")
        # what compute() does when a state has run past its capacity
        # (see _check_cat_overflow)
        self.on_overflow = on_overflow

        self._update_count = 0
        self._update_called = False
        self._computed: Any = None
        self._forward_cache: Any = None
        # False only inside forward: its batch value is local by design
        self._to_sync = True

        self._wrap_methods()

    def _wrap_methods(self) -> None:
        object.__setattr__(self, "_original_update", type(self).update.__get__(self))
        object.__setattr__(self, "_original_compute", type(self).compute.__get__(self))
        object.__setattr__(self, "update", self._wrap_update(self._original_update))
        object.__setattr__(self, "compute", self._wrap_compute(self._original_compute))
        self._update_signature = inspect.signature(self._original_update)

    # ------------------------------------------------------------------
    # state registry
    # ------------------------------------------------------------------

    def add_state(
        self,
        name: str,
        default: Any,
        dist_reduce_fx: Reduction = None,
        persistent: bool = False,
    ) -> None:
        """Register a named state: a tensor (fixed-shape accumulator), an
        empty list (a ``cat`` state, batches appended) or a sketch state."""
        if isinstance(default, list):
            if default:
                raise ValueError("a list state's default must be an empty list")
        elif _is_sketch_state(default):
            default = _map_state(lambda t: t.to(self.device), default)
        elif isinstance(default, (Tensor, np.ndarray, int, float)):
            default = torch.as_tensor(default).to(self.device)
        else:
            raise ValueError("state variable must be a tensor, a sketch state or an empty list (any value)")
        if dist_reduce_fx not in ("sum", "mean", "cat", "max", "min", None) and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        self._defaults[name] = default
        self._reductions[name] = dist_reduce_fx
        self._persistent[name] = persistent
        self._state[name] = _clone(default)

    # attribute routing so subclass code can write ``self.tp += x``
    def __setattr__(self, name: str, value: Any) -> None:
        defaults = self.__dict__.get("_defaults")
        if defaults is not None and name in defaults:
            self.__dict__["_state"][name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name: str) -> Any:
        # only called when normal lookup fails
        defaults = self.__dict__.get("_defaults")
        if defaults is not None and name in defaults:
            return self.__dict__["_state"][name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    @property
    def metric_state(self) -> Dict[str, Any]:
        """The current states (the live tensors, not copies)."""
        return dict(self._state)

    @property
    def update_called(self) -> bool:
        return self._update_called

    @property
    def update_count(self) -> int:
        return self._update_count

    # ------------------------------------------------------------------
    # update / compute wrapping
    # ------------------------------------------------------------------

    def _to_device(self, x: Any) -> Any:
        if isinstance(x, Tensor):
            return x.to(self.device)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(self.device)
        return x

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            self._run_update(update, args, kwargs)

        return wrapped_func

    def _run_update(self, update: Callable, args: tuple, kwargs: dict) -> None:
        self._computed = None
        self._update_count += 1
        self._update_called = True
        args = tuple(self._to_device(a) for a in args)
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        update(*args, **kwargs)

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if not self._update_called:
                rank_zero_warn(
                    f"The ``compute`` method of metric {type(self).__name__} was called before the ``update`` "
                    "method which may lead to errors, as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                return self._computed
            if self._to_sync and _distributed_world_size() > 1:
                raise MetricsTPUUserError(
                    f"{type(self).__name__}.compute() in a torch.distributed world of "
                    f"{_distributed_world_size()} processes needs the multi-process state sync, "
                    "which is not ported yet (it comes with the port of parallel/sync.py); "
                    "a value from this rank alone would be wrong."
                )
            value = compute(*args, **kwargs)
            self._check_cat_overflow()
            self._computed = _squeeze_if_scalar(value)
            return self._computed

        return wrapped_func

    # ------------------------------------------------------------------
    # forward protocol
    # ------------------------------------------------------------------

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate into the global state AND return the batch's own value,
        kept in ``_forward_cache`` until the next ``reset``."""
        if self.full_state_update:
            batch_val = self._forward_full_state_update(*args, **kwargs)
        else:
            batch_val = self._forward_reduce_state_update(*args, **kwargs)
        self._forward_cache = batch_val
        return batch_val

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two updates: one into the global state, one into a fresh state that
        gives the batch value."""
        self.update(*args, **kwargs)
        saved = self._copy_state(), self._update_count
        self._to_sync = False
        self._restore_defaults()
        self._update_count = 0
        self.update(*args, **kwargs)
        try:
            batch_val = self.compute()
        finally:
            # the accumulated state survives a compute that raises
            object.__setattr__(self, "_state", saved[0])
            self._update_count = saved[1]
            self._to_sync = True
            self._computed = None
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """One update on a fresh state, then a merge into the global state."""
        global_state, global_count = self._copy_state(), self._update_count
        self._restore_defaults()
        self._update_count = 0
        self.update(*args, **kwargs)
        self._to_sync = False
        try:
            batch_val = self.compute()
        finally:
            # the batch is merged even when compute raises
            object.__setattr__(self, "_state", self._reduce_states(global_state, self._state, global_count))
            self._update_count = global_count + 1
            self._to_sync = True
            self._computed = None
        return batch_val

    def _reduce_states(
        self,
        global_state: Dict[str, Any],
        batch_state: Dict[str, Any],
        global_count: int,
        batch_count: int = 1,
    ) -> Dict[str, Any]:
        """Merge a batch's states into the global ones, by reduction tag."""
        merged: Dict[str, Any] = {}
        for name, reduce_fn in self._reductions.items():
            g, b = global_state[name], batch_state[name]
            if _is_sketch_state(g):
                # a sketch merges by its own associative and commutative
                # union; the reduction tag is documentary
                merged[name] = g.sketch_merge(b)
            elif reduce_fn == "sum":
                merged[name] = g + b
            elif reduce_fn == "mean":
                if global_count == 0:
                    merged[name] = b
                else:
                    merged[name] = (g * global_count + b * batch_count) / (global_count + batch_count)
            elif reduce_fn == "max":
                merged[name] = torch.maximum(g, b)
            elif reduce_fn == "min":
                merged[name] = torch.minimum(g, b)
            elif reduce_fn == "cat" or (reduce_fn is None and isinstance(g, list)):
                merged[name] = list(g) + list(b)
            elif callable(reduce_fn):
                merged[name] = reduce_fn(torch.stack([g, b]))
            else:
                raise MetricsTPUUserError(
                    f"State {name!r} has dist_reduce_fx={reduce_fn!r} which has no forward merge rule; "
                    f"set class attribute ``full_state_update = True`` for {type(self).__name__}."
                )
        return merged

    def _copy_state(self) -> Dict[str, Any]:
        return {k: _clone(v) for k, v in self._state.items()}

    def _restore_defaults(self) -> None:
        object.__setattr__(self, "_state", {k: _clone(v) for k, v in self._defaults.items()})

    # ------------------------------------------------------------------
    # abstract interface
    # ------------------------------------------------------------------

    def update(self, *args: Any, **kwargs: Any) -> None:  # pragma: no cover - abstract
        """Override to update state with batch data."""
        raise NotImplementedError

    def _check_cat_overflow(self) -> None:
        """Called by ``compute`` after the value is computed: a metric whose
        state can run past its capacity warns or raises here, as
        ``on_overflow`` says. No state of this base class can."""

    def compute(self) -> Any:  # pragma: no cover - abstract
        """Override to compute the final value from state."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # reset / clone / persistence
    # ------------------------------------------------------------------

    def reset(self) -> None:
        """Restore the default state."""
        self._update_count = 0
        self._update_called = False
        self._computed = None
        self._forward_cache = None
        self._restore_defaults()

    def clone(self) -> "Metric":
        return deepcopy(self)

    def persistent(self, mode: bool = False) -> None:
        """Set the persistence flag of every state."""
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(self, prefix: str = "") -> Dict[str, Any]:
        """Copies of the persistent states: tensors, lists of tensors, and a
        sketch state as its ``to_primitives()`` mapping."""
        out: Dict[str, Any] = {}
        for key in self._defaults:
            if self._persistent[key]:
                value = self._state[key]
                out[prefix + key] = value.to_primitives() if _is_sketch_state(value) else _clone(value)
        return out

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "") -> None:
        """Restore states saved by :meth:`state_dict`.

        Every value is checked against the registered default's shape and
        dtype before any state changes: a mismatched checkpoint raises a
        ``ValueError`` naming the state and leaves the metric untouched.
        """
        loaded = {
            key: self._validated_state_value(key, state_dict[prefix + key])
            for key in self._defaults
            if prefix + key in state_dict
        }
        if loaded:
            self._state.update(loaded)
            self._update_called = True
            self._computed = None

    def _validated_state_value(self, key: str, v: Any) -> Any:
        """One loaded value, checked against ``self._defaults[key]`` and moved
        to the metric's device in the default's dtype."""
        default = self._defaults[key]

        def fail(why: str) -> None:
            raise ValueError(
                f"{type(self).__name__}.load_state_dict: state {key!r} {why}; refusing to load a corrupt checkpoint."
            )

        def as_tensor(value: Any) -> Tensor:
            if not isinstance(value, Tensor):
                arr = np.asarray(value)
                if arr.dtype == object:
                    fail(f"is not a numeric array (got {type(value).__name__})")
                value = torch.tensor(arr)
            return value

        if _is_sketch_state(default):
            try:
                return type(default).from_primitives(v, like=default)
            except ValueError as err:
                fail(f"failed sketch-state validation: {err}")
        if isinstance(default, list):
            if not isinstance(v, (list, tuple)):
                fail(f"is a list ('cat') state and must load from a list (got {type(v).__name__})")
            return [as_tensor(x).to(self.device) for x in v]
        value = as_tensor(v)
        if tuple(value.shape) != tuple(default.shape):
            fail(f"has shape {tuple(value.shape)}, expected {tuple(default.shape)}")
        if not torch.can_cast(value.dtype, default.dtype):
            fail(f"has dtype {value.dtype}, incompatible with expected {default.dtype}")
        return value.to(device=self.device, dtype=default.dtype)

    def __getstate__(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if k not in _BOUND}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._wrap_methods()

    def __deepcopy__(self, memo: dict) -> "Metric":
        cls = type(self)
        new = cls.__new__(cls)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k not in _BOUND:
                object.__setattr__(new, k, deepcopy(v, memo))
        new._wrap_methods()
        return new

    # ------------------------------------------------------------------
    # misc
    # ------------------------------------------------------------------

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep the kwargs that the update signature takes."""
        _params = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        _sign_params = self._update_signature.parameters
        filtered_kwargs = {
            k: v for k, v in kwargs.items() if (k in _sign_params and _sign_params[k].kind not in _params)
        }
        if any(v.kind == inspect.Parameter.VAR_KEYWORD for v in _sign_params.values()):
            filtered_kwargs = kwargs
        return filtered_kwargs

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"

