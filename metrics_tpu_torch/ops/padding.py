"""The padding ladder (counterpart of ``metrics_tpu/ops/padding.py``).

A batch pads up to one of a fixed ladder of row counts, so ragged traffic
meets a bounded set of shapes: the bound that a compiled update, a CUDA
graph capture or a warmup needs to stay finite.

Ladder resolution, with the JAX package's variable and contract:

- ``METRICS_TPU_PAD_LADDER`` unset or empty: the pow-2 ladder, tier
  ``next_pow2(n)``;
- ``METRICS_TPU_PAD_LADDER="64,256,1024"``: the smallest tier ``>= n``; a
  batch above the top tier warns once and pads to ``next_pow2(n)``;
- a malformed value warns once and falls back to the pow-2 ladder.

The variable is read at each call, its parse memoized.

Pad rows stay invisible through the ``valid`` row mask: every padded call
carries one (real rows True, pad rows False), the update consumes it
(:func:`supports_row_mask`), and the metric counts the pad rows in the
fault channel's informational ``padded_rows`` class. Pad values are zeros,
clean under the validators, so the guard counts real faults only.

Where the padding happens. The JAX package pads on the host in numpy (its
compiled update then meets ladder shapes only). The port pads on the
tensor's own device with zero rows and reads nothing back: a batch on the
card stays there. A numpy array pads on the host, as in the JAX package.
"""
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce

__all__ = [
    "pad_ladder",
    "next_pow2",
    "tier_for",
    "ladder_tiers",
    "leading_rows",
    "pad_rows",
    "pad_update_args",
    "supports_row_mask",
    "reset_padding_state",
    "SLICE_STATE_PREFIX",
]

Tensor = torch.Tensor

_ENV_VAR = "METRICS_TPU_PAD_LADDER"

# the name prefix of the sliced metrics' (K + 2)-leading ring states
# (``metrics_tpu_torch/sliced``), defined at this lowest layer that must
# know it, so that :func:`leading_rows` can tell a slice axis from a tier
SLICE_STATE_PREFIX = "sl__"

_warn_once = WarnOnce()


def _parse_ladder(raw: str) -> Optional[Tuple[int, ...]]:
    try:
        tiers = sorted({int(tok.strip()) for tok in raw.split(",") if tok.strip()})
        if not tiers or any(t < 1 for t in tiers):
            raise ValueError("tiers must be positive integers")
        return tuple(tiers)
    except ValueError:
        _warn_once(
            ("env-malformed", raw),
            f"{_ENV_VAR}={raw!r} is malformed (expected comma-separated positive "
            "integers, e.g. '64,256,1024'); falling back to the pow-2 ladder",
        )
        return None


_ladder_env: "EnvParse[Optional[Tuple[int, ...]]]" = EnvParse(_ENV_VAR, _parse_ladder, None)


def pad_ladder() -> Optional[Tuple[int, ...]]:
    """The configured ladder (ascending, without duplicates), or ``None``
    for the pow-2 ladder."""
    return _ladder_env()


def next_pow2(n: int) -> int:
    """The smallest power of two ``>= n`` (1 for ``n <= 1``)."""
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def tier_for(n: int, ladder: Optional[Sequence[int]] = None) -> int:
    """The padded row count of an ``n``-row batch. ``ladder=None`` reads
    :func:`pad_ladder`; a batch above the top tier warns once and pads to
    the next power of two."""
    if n < 1:
        raise ValueError(f"batch must have at least one row, got {n}")
    lad = pad_ladder() if ladder is None else tuple(ladder)
    if lad:
        for t in lad:
            if t >= n:
                return t
        _warn_once(
            ("above-ladder", lad[-1]),
            f"batch of {n} rows exceeds the top padding tier {lad[-1]} "
            f"(ladder {lad}); padding to the next power of two instead — "
            "each distinct oversize pow-2 tier compiles one extra graph",
        )
    return next_pow2(n)


def ladder_tiers(max_rows: int, ladder: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """Every tier that batches of ``1..max_rows`` rows can land on,
    ascending, as :func:`tier_for` resolves them (the overflow tiers above
    an explicit ladder's top included)."""
    if max_rows < 1:
        raise ValueError(f"max_rows must be >= 1, got {max_rows}")
    lad = pad_ladder() if ladder is None else tuple(sorted(set(ladder)))
    tiers = []
    if lad:
        prev = 0
        for t in lad:
            if prev < max_rows:
                tiers.append(t)
            prev = t
        start = lad[-1] + 1
    else:
        start = 1
    if start <= max_rows:
        t = next_pow2(start)
        while True:
            tiers.append(t)
            if t >= max_rows:
                break
            t = next_pow2(t + 1)
    return tuple(tiers)


def leading_rows(tree: Any) -> Optional[int]:
    """The leading dimension of the first array leaf of ``tree`` (dicts,
    lists, tuples), skipping every leaf reached through a mapping key that
    holds :data:`SLICE_STATE_PREFIX`: a sliced ring leads with its slice
    axis, not with a tier."""

    def walk(node: Any) -> Optional[int]:
        if isinstance(node, dict):
            for k, v in node.items():
                if SLICE_STATE_PREFIX in str(k):
                    continue
                found = walk(v)
                if found is not None:
                    return found
            return None
        if isinstance(node, (list, tuple)):
            for v in node:
                found = walk(v)
                if found is not None:
                    return found
            return None
        shape = getattr(node, "shape", None)
        if shape is not None and len(shape) >= 1:
            return int(shape[0])
        return None

    return walk(tree)


def _row_count(value: Any) -> Optional[int]:
    shape = getattr(value, "shape", None)
    if shape is None or len(shape) < 1:
        return None
    return int(shape[0])


def _pad(a: Any, n: int, tier: int) -> Any:
    """``a`` with ``tier - n`` zero rows appended, on its own device (a
    numpy array on the host)."""
    if isinstance(a, Tensor):
        return torch.cat([a, a.new_zeros((tier - n,) + tuple(a.shape[1:]))])
    arr = np.asarray(a)
    out = np.zeros((tier,) + arr.shape[1:], arr.dtype)
    out[:n] = arr
    return out


def _mask(n: int, tier: int, valid: Optional[Any], like: Any) -> Tensor:
    """The ``(tier,)`` bool row mask: ``valid`` (or True) on the real rows,
    False on the pad rows, on the device of ``like`` (a tensor) or the
    host."""
    device = like.device if isinstance(like, Tensor) else None
    if valid is None:
        real = torch.ones(n, dtype=torch.bool, device=device)
    else:
        real = torch.as_tensor(valid, device=device).to(torch.bool).reshape(-1)
    return torch.cat([real, torch.zeros(tier - n, dtype=torch.bool, device=real.device)])


def pad_rows(
    arrays: Sequence[Any],
    valid: Optional[Any] = None,
    ladder: Optional[Sequence[int]] = None,
) -> Tuple[Tuple[Any, ...], Tensor]:
    """Every array's leading axis padded up to its tier with zero rows,
    and the ``(tier,)`` bool row mask (``valid``, or True, on the real
    rows). All arrays share one leading length. For the pure layer::

        (p, t), mask = pad_rows((preds, target))
        state = mdef.update(state, p, t, valid=mask)
    """
    ns = {_row_count(a) for a in arrays}
    ns.discard(None)
    if len(ns) != 1:
        raise ValueError(f"pad_rows needs row-aligned arrays, got leading lengths {sorted(ns)}")
    n = ns.pop()
    tier = tier_for(n, ladder)
    mask = _mask(n, tier, valid, arrays[0])
    if tier == n:
        return tuple(arrays), mask
    return tuple(_pad(a, n, tier) for a in arrays), mask


def supports_row_mask(metric: Any) -> bool:
    """Whether the metric's update hides pad rows: it consumes a ``valid``
    row mask (capacity mode, ``_valid_mask_always``), or it is a wrapper
    that passes its keyword arguments on to such a metric. The drop guard's
    predicate (``utilities/guard.py::_consumes_valid_mask``)."""
    from metrics_tpu_torch.utilities.guard import _consumes_valid_mask

    return _consumes_valid_mask(metric)


def pad_update_args(metric: Any, args: tuple, kwargs: dict) -> Tuple[tuple, dict, int]:
    """The ladder applied to one update call: every row-aligned array
    argument padded up to the tier, the pad mask folded into the ``valid``
    keyword (and-ed with the caller's), and the number of pad rows.
    Refuses a metric that cannot consume a row mask: its pad rows would
    reach its accumulators."""
    from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError

    n = None
    for v in list(args) + [v for k, v in kwargs.items() if k != "valid"]:
        n = _row_count(v)
        if n is not None:
            break
    if n is None or n < 1:
        return args, kwargs, 0
    # an exact-tier batch still gets its (all-True) mask: one call form per tier
    if not supports_row_mask(metric):
        raise MetricsTPUUserError(
            f"{type(metric).__name__}(pad_batches=True): this metric's update cannot "
            "consume a `valid` row mask, so padded rows could not be provably masked "
            "out of its accumulators. Use a capacity-mode metric, a stat-scores-family "
            "metric, or disable pad_batches."
        )
    row_args = [i for i, v in enumerate(args) if _row_count(v) == n]
    row_kwargs = [k for k, v in kwargs.items() if k != "valid" and _row_count(v) == n]
    padded, mask = pad_rows([args[i] for i in row_args] + [kwargs[k] for k in row_kwargs], valid=kwargs.get("valid"))
    new_args = list(args)
    for i, v in zip(row_args, padded):
        new_args[i] = v
    new_kwargs: Dict[str, Any] = dict(kwargs)
    for k, v in zip(row_kwargs, padded[len(row_args):]):
        new_kwargs[k] = v
    new_kwargs["valid"] = mask
    return tuple(new_args), new_kwargs, int(mask.shape[0]) - n


def reset_padding_state() -> None:
    """Forget the warnings given and the memoized parse (for tests)."""
    _warn_once.reset()
    _ladder_env.reset()
