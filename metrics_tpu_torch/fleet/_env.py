"""The ``METRICS_TPU_FLEET_*`` environment knobs (counterpart of
``metrics_tpu/fleet/_env.py``), under the shared ``ops/_envtools.py`` contract.

Same contract as every other knob family (``ops/_envtools.py``): resolution
at call time, programmatic argument > env var > built-in default, malformed
values **warn once and fall back** — a bad env var may cost publish
freshness or failure-budget tuning, never correctness (views are
idempotent last-write-wins; a wrong cadence just changes staleness).

| Variable | Meaning | Default |
|---|---|---|
| ``METRICS_TPU_FLEET_PUBLISH_EVERY_S`` | publisher cadence (seconds) | 1.0 |
| ``METRICS_TPU_FLEET_DEADLINE_S`` | per-publish-attempt deadline | 10.0 |
| ``METRICS_TPU_FLEET_BREAKER_COOLDOWN_S`` | breaker open time after an exhausted budget | 30.0 |
| ``METRICS_TPU_FLEET_STALE_AFTER_S`` | age past which a host view / publish channel is loudly stale | 10.0 |
| ``METRICS_TPU_FLEET_DELTA`` | ship per-leaf delta views between all-accepted full views | off |
"""
import math
from typing import Optional

from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce, bool_token

__all__ = [
    "DEFAULT_PUBLISH_EVERY_S",
    "DEFAULT_DEADLINE_S",
    "DEFAULT_BREAKER_COOLDOWN_S",
    "DEFAULT_STALE_AFTER_S",
    "resolve_fleet_knob",
    "resolve_fleet_delta",
    "reset_fleet_env_state",
]

DEFAULT_PUBLISH_EVERY_S = 1.0
DEFAULT_DEADLINE_S = 10.0
DEFAULT_BREAKER_COOLDOWN_S = 30.0
DEFAULT_STALE_AFTER_S = 10.0

_warn_once = WarnOnce()


def _positive_float_parser(var: str):
    def parse(raw: str) -> Optional[float]:
        try:
            s = float(raw)
            # finite required: NaN slips every <= comparison, so a NaN
            # staleness threshold would silently never mark anything stale
            if not math.isfinite(s) or s <= 0:
                raise ValueError(raw)
            return s
        except ValueError:
            _warn_once(
                (var, raw),
                f"{var}={raw!r} is not a positive number; falling back to the default.",
            )
            return None

    return parse


_ENV = {
    "publish_every_s": EnvParse(
        "METRICS_TPU_FLEET_PUBLISH_EVERY_S",
        _positive_float_parser("METRICS_TPU_FLEET_PUBLISH_EVERY_S"),
        None,
    ),
    "deadline_s": EnvParse(
        "METRICS_TPU_FLEET_DEADLINE_S",
        _positive_float_parser("METRICS_TPU_FLEET_DEADLINE_S"),
        None,
    ),
    "breaker_cooldown_s": EnvParse(
        "METRICS_TPU_FLEET_BREAKER_COOLDOWN_S",
        _positive_float_parser("METRICS_TPU_FLEET_BREAKER_COOLDOWN_S"),
        None,
    ),
    "stale_after_s": EnvParse(
        "METRICS_TPU_FLEET_STALE_AFTER_S",
        _positive_float_parser("METRICS_TPU_FLEET_STALE_AFTER_S"),
        None,
    ),
}

_DEFAULTS = {
    "publish_every_s": DEFAULT_PUBLISH_EVERY_S,
    "deadline_s": DEFAULT_DEADLINE_S,
    "breaker_cooldown_s": DEFAULT_BREAKER_COOLDOWN_S,
    "stale_after_s": DEFAULT_STALE_AFTER_S,
}


def resolve_fleet_knob(name: str, programmatic: Optional[float]) -> float:
    """Programmatic arg > env var > default (the dispatch-layer rule)."""
    if programmatic is not None:
        if not math.isfinite(programmatic) or programmatic <= 0:
            raise ValueError(f"fleet knob {name!r} must be a finite value > 0, got {programmatic}")
        return float(programmatic)
    from_env = _ENV[name]()
    return from_env if from_env is not None else _DEFAULTS[name]


def _parse_delta(raw: str) -> Optional[bool]:
    token = bool_token(raw)
    if token is None:
        _warn_once(
            ("METRICS_TPU_FLEET_DELTA", raw),
            f"METRICS_TPU_FLEET_DELTA={raw!r} is not a boolean token "
            "(1/0/true/false/on/off/yes/no); delta publishing stays OFF — "
            "a bad env var costs bytes, never correctness.",
        )
    return token


_ENV_DELTA: "EnvParse[Optional[bool]]" = EnvParse("METRICS_TPU_FLEET_DELTA", _parse_delta, None)


def resolve_fleet_delta(programmatic: Optional[bool] = None) -> bool:
    """Whether the publisher ships per-leaf deltas between all-accepted
    full views: programmatic arg > ``METRICS_TPU_FLEET_DELTA`` >
    off. Off by default — deltas change bytes and answer traffic, and a
    fleet with pre-delta aggregators would re-base every cadence."""
    if programmatic is not None:
        return bool(programmatic)
    token = _ENV_DELTA()
    return False if token is None else token


def reset_fleet_env_state() -> None:
    """Test hook: forget memoized env parses and warn-once history."""
    _warn_once.reset()
    for env in _ENV.values():
        env.reset()
    _ENV_DELTA.reset()
