"""Warn-once and memoized environment-variable parsing for the port's knobs
(counterpart of ``metrics_tpu/ops/_envtools.py``).

Every ``METRICS_TPU_*`` knob of the port shares one contract with the JAX
package: the variable is read when the knob is resolved, a malformed value
warns once and keeps the default (a bad variable degrades speed or bytes,
never correctness), and tests reset the warn-once memory and the memoized
parse between cases. The variable names are those of the JAX package.

The module imports the standard library and the port's rank-zero printing
only.
"""
import os
from typing import Any, Callable, Generic, Tuple, TypeVar

from metrics_tpu_torch.utilities.prints import rank_zero_warn

__all__ = ["WarnOnce", "EnvParse", "bool_token"]

T = TypeVar("T")


def bool_token(raw: str) -> Any:
    """One boolean token (``1/0/true/false/on/off/yes/no``, any case), or
    ``None`` for anything else: the caller owns its warning and default."""
    low = raw.lower()
    if low in ("1", "true", "on", "yes"):
        return True
    if low in ("0", "false", "off", "no"):
        return False
    return None


class WarnOnce:
    """Keyed warn-once registry: the first call for a key warns, later ones
    are silent until :meth:`reset`."""

    def __init__(self) -> None:
        self._seen: set = set()

    def __call__(self, key: Tuple[Any, ...], msg: str) -> None:
        if key in self._seen:
            return
        self._seen.add(key)
        rank_zero_warn(msg, UserWarning)

    def reset(self) -> None:
        self._seen.clear()


class EnvParse(Generic[T]):
    """The memoized parse of one variable: ``parse(raw)`` runs only when the
    raw string changes; an unset or empty variable gives ``empty`` without
    parsing. ``parse`` handles a malformed value itself (warn once, return
    a default), so its warning fires once for each raw value."""

    def __init__(self, var: str, parse: Callable[[str], T], empty: T) -> None:
        self.var = var
        self._parse = parse
        self._empty = empty
        self._cache: Tuple[str, T] = ("", empty)

    def __call__(self) -> T:
        raw = os.environ.get(self.var, "").strip()
        if not raw:
            return self._empty
        if raw == self._cache[0]:
            return self._cache[1]
        value = self._parse(raw)
        self._cache = (raw, value)
        return value

    def reset(self) -> None:
        self._cache = ("", self._empty)
