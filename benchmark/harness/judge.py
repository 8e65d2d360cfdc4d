"""The comparison that decides ``correct``.

The configuration's reference gives the values that every ``compute()`` of
the window must return, by group (``acc``, ``ap``, ``prf``, ``iou``,
``counts``, ...); the number compared for a group is the widest absolute gap,
over every epoch of the window, between the program's values and the
reference's, and the cell's limits file gives each ``<group>_gap`` its
limit. An epoch fails where a gap passes its limit.
"""
from typing import Any, Dict, List, Tuple

import numpy as np

from benchmark.reference.common import gap


def gaps(expected: Dict[str, np.ndarray], observed: Dict[str, np.ndarray]) -> Dict[str, float]:
    out = {}
    for group in sorted(set(expected) | set(observed)):
        if group not in expected or group not in observed:
            out[f"{group}_gap"] = float("inf")
        else:
            out[f"{group}_gap"] = gap(observed[group], expected[group])
    return out


def judge(expected: Dict[str, np.ndarray], observed: List[Dict[str, np.ndarray]], limits: Dict[str, float]) -> Tuple[bool, int, Dict[str, Dict[str, float]]]:
    """``(correct, epochs failed, {number: {"value", "limit"}})`` over the
    window's epochs. A number that has no limit, or a window with no epoch,
    is not correct."""
    worst: Dict[str, float] = {}
    failed = 0
    for values in observed:
        got = gaps(expected, values)
        failed += any(v > limits.get(k, -1.0) for k, v in got.items())
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    checks = {k: {"value": worst[k], "limit": limits[k] if k in limits else float("nan")} for k in sorted(worst)}
    correct = bool(observed) and failed == 0 and all(k in limits for k in worst)
    return correct, failed, checks


def check_lines(checks: Dict[str, Dict[str, Any]]) -> List[str]:
    return [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
