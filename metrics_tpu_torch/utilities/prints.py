"""Rank-zero-gated printing (counterpart of ``metrics_tpu/utilities/prints.py``).

The rank comes from ``torch.distributed`` when a process group is
initialised, and is 0 otherwise.
"""
import logging
import warnings
from functools import wraps
from typing import Any, Callable

import torch

log = logging.getLogger("metrics_tpu_torch")


def _get_rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Run ``fn`` only on process 0."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _get_rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, *args: Any, **kwargs: Any) -> None:
    kwargs.setdefault("stacklevel", 5)
    warnings.warn(message, *args, **kwargs)


@rank_zero_only
def rank_zero_info(*args: Any, **kwargs: Any) -> None:
    log.info(*args, **kwargs)


@rank_zero_only
def rank_zero_debug(*args: Any, **kwargs: Any) -> None:
    log.debug(*args, **kwargs)
