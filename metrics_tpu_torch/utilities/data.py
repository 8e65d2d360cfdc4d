"""Shared tensor utilities (counterpart of ``metrics_tpu/utilities/data.py``)."""
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.ops.bucketed_rank import flush_denormals
from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.ops.histogram import histogram

Tensor = torch.Tensor

METRIC_EPS = 1e-6


def dim_zero_cat(x: Union[Tensor, List[Tensor], Tuple[Tensor, ...]]) -> Tensor:
    """Concatenate a (list of) tensor(s) along dim 0."""
    if isinstance(x, (list, tuple)):
        if len(x) == 0:
            raise ValueError("No samples to concatenate")
        x = [torch.atleast_1d(v) for v in x]
        return torch.cat(x, dim=0) if len(x) > 1 else x[0]
    return torch.atleast_1d(x)


def dim_zero_sum(x: Tensor) -> Tensor:
    return torch.sum(x, dim=0)


def dim_zero_mean(x: Tensor) -> Tensor:
    return torch.mean(x, dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.amax(x, dim=0)


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.amin(x, dim=0)


def _flatten(x: Sequence) -> list:
    """Flatten a list of lists one level."""
    return [item for sublist in x for item in sublist]


def _flatten_dict(x: Dict) -> Dict:
    """Flatten a dict of dicts one level."""
    new_dict = {}
    for key, value in x.items():
        if isinstance(value, dict):
            for k, v in value.items():
                new_dict[k] = v
        else:
            new_dict[key] = value
    return new_dict


def apply_to_collection(
    data: Any,
    dtype: Union[type, tuple],
    function: Callable,
    *args: Any,
    wrong_dtype: Optional[Union[type, tuple]] = None,
    **kwargs: Any,
) -> Any:
    """``function`` applied to every element of type ``dtype`` in nested
    dicts, lists, tuples and NamedTuples (the structure is kept)."""
    if isinstance(data, dtype) and (wrong_dtype is None or not isinstance(data, wrong_dtype)):
        return function(data, *args, **kwargs)
    if isinstance(data, dict):
        return {k: apply_to_collection(v, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for k, v in data.items()}
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # a NamedTuple
        return type(data)(*(apply_to_collection(d, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for d in data))
    if isinstance(data, (list, tuple)):
        return type(data)(apply_to_collection(d, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for d in data)
    return data


def _tensor_leaves(value: Any) -> Iterator[Tensor]:
    """Every tensor of a state: a tensor, or a list or NamedTuple of them
    (a ``cat`` list, a ring, a sketch state, the fault counters)."""
    if isinstance(value, Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensor_leaves(v)


def _host_float32(x: Union[Tensor, np.ndarray]) -> np.ndarray:
    """A tensor (read back from its device) or an array as float32 numpy:
    the host boundary of the audio metrics that score on the host."""
    if isinstance(x, Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze single-element tensors to 0-d, through lists, tuples,
    NamedTuples and dicts."""
    if isinstance(data, Tensor):
        return data.reshape(()) if data.numel() == 1 and data.ndim > 0 else data
    if isinstance(data, dict):
        return {k: _squeeze_if_scalar(v) for k, v in data.items()}
    if isinstance(data, tuple) and hasattr(data, "_fields"):
        return type(data)(*(_squeeze_if_scalar(v) for v in data))
    if isinstance(data, (list, tuple)):
        return type(data)(_squeeze_if_scalar(v) for v in data)
    return data


def to_onehot(label_tensor: Tensor, num_classes: Optional[int] = None) -> Tensor:
    """Integer labels ``(N, ...)`` to a dense int32 one-hot ``(N, C, ...)``,
    by comparison against a class axis (no scatter)."""
    labels = torch.as_tensor(label_tensor)
    if num_classes is None:
        num_classes = int(labels.max()) + 1
    iota = torch.arange(num_classes, dtype=labels.dtype, device=labels.device)
    iota = iota.reshape((1, num_classes) + (1,) * (labels.ndim - 1))
    return (labels.unsqueeze(1) == iota).to(torch.int32)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """Int32 mask of the top-k entries along ``dim``.

    Ties go to the lower index, as ``jax.lax.top_k`` and ``jnp.argmax`` break
    them: ``argmax`` returns the first maximum, and a stable descending sort
    keeps equal scores in index order (``torch.topk`` promises no order).
    """
    x = torch.as_tensor(prob_tensor)
    if topk == 1:
        # XLA's argmax compares float32 denormals as zero; its top_k does not
        idx = torch.argmax(flush_denormals(x), dim=dim, keepdim=True)
    else:
        idx = torch.sort(x, dim=dim, descending=True, stable=True).indices.narrow(dim, 0, topk)
    # zeros_like, so that under ``torch.func.vmap`` the scatter writes into
    # a batched tensor (the pure layer's bootstrap, the sliced metrics'
    # per-row deltas); out of place, which ``vmap`` batches (its in-place
    # form runs once per batch entry)
    return torch.zeros_like(x, dtype=torch.int32).scatter(dim, idx, 1)


def to_categorical(x: Tensor, argmax_dim: int = 1) -> Tensor:
    """Probabilities or one-hot rows to integer labels by argmax (the first
    maximum wins, as ``jnp.argmax``); denormals compare as zero, as XLA's
    do."""
    return torch.argmax(flush_denormals(x), dim=argmax_dim)


def jax_linspace(start: float, stop: float, num: int, device: Union[str, torch.device, None] = None) -> Tensor:
    """float32 ``jnp.linspace(start, stop, num)``, bit for bit.

    ``torch.linspace`` rounds differently (at ``num=1000`` a hundred values
    differ), and a score equal to a threshold then lands in another bin.
    JAX evaluates ``start*(1-step) + stop*step`` with ``step = iota/div`` in
    float32 and appends ``stop``; XLA compiles the division by the constant
    ``div`` as a multiplication by its float32 reciprocal, which is what
    fixes the bits.
    """
    if num < 0:
        raise ValueError(f"Number of samples, {num}, must be non-negative.")
    f32 = dict(dtype=torch.float32, device=device)
    start_t = torch.tensor(start, **f32)
    stop_t = torch.tensor(stop, **f32)
    if num == 0:
        return torch.empty((0,), **f32)
    if num == 1:
        return start_t.reshape(1)
    div = num - 1
    recip = torch.tensor(1.0, **f32) / torch.tensor(float(div), **f32)
    step = torch.arange(div, **f32) * recip
    return torch.cat([start_t * (1 - step) + stop_t * step, stop_t.reshape(1)])


def _bincount(x: Tensor, minlength: int) -> Tensor:
    """int32 counts of the integer values of ``x`` over ``[0, minlength)``;
    values outside that range are not counted (a plain ``bincount`` would
    refuse negatives and grow past ``minlength``).

    On a CUDA tensor the counts come from the histogram kernel (K2,
    ``ops/histogram.py``), which reads nothing back to the host, where
    ``torch.bincount`` reads the input's minimum and maximum; values are
    first narrowed to int32 with those out of range sent to -1, so no wide
    value wraps into range. Under ``torch.func.vmap`` (a sliced confusion
    matrix, a bootstrap) every device takes that path too, and the kernel's
    lane route counts each lane: its lane-batched form on the card, its
    plain version on the CPU. An unbatched CPU tensor keeps the plain
    ``bincount``.
    """
    x = x.reshape(-1)
    if x.device.type == "cuda" or _build.batched(x):
        if x.dtype != torch.int32:
            x = torch.where((x >= 0) & (x < minlength), x, -1).to(torch.int32)
        return histogram(x, minlength)
    x = x.to(torch.int64)
    safe = torch.where((x >= 0) & (x < minlength), x, minlength)
    return torch.bincount(safe, minlength=minlength + 1)[:minlength].to(torch.int32)


def get_group_indexes(indexes: Any) -> List[np.ndarray]:
    """The positions of each query id, in the order the ids first appear
    (a host-side helper kept for the reference's API; the retrieval metrics
    group on the device)."""
    if isinstance(indexes, Tensor):
        indexes = indexes.detach().cpu().numpy()
    idx = np.asarray(indexes).reshape(-1)
    groups: Dict[int, List[int]] = {}
    for i, v in enumerate(idx.tolist()):
        groups.setdefault(v, []).append(i)
    return [np.asarray(g, dtype=np.int64) for g in groups.values()]
