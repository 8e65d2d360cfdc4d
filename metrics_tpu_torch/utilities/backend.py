"""CUDA bootstrap: a deadline-bounded probe of CUDA's initialisation, and
the CPU escape hatch (counterpart of ``metrics_tpu/utilities/backend.py``).

``import metrics_tpu_torch`` never initialises CUDA: importing torch does
not, and nothing in the package touches the device at import. Three guards
serve the first real touch, as in the JAX package:

1. ``METRICS_TPU_FORCE_CPU=1``, honoured at ``import metrics_tpu_torch``:
   it records ``forced_cpu`` and CUDA is never touched by the bootstrap.
2. :func:`ensure_backend` probes CUDA in a **throwaway interpreter** under
   a hard deadline (a hang in CUDA's initialisation cannot be cancelled in
   process; a process group can be killed), records a ``backend_probe_*``
   health event when it fails or hangs, and says what it found.
3. :func:`backend_is_initialized` (``torch.cuda.is_initialized()``) lets a
   caller branch without starting initialisation as a side effect.

**No fallback hides the device** (stated difference D53). JAX's
``ensure_backend(fallback_cpu=True)`` re-points JAX at the CPU, so its
metrics then compute there. The port moves nothing: ``Metric(device=None)``
still means CUDA, and after a failed probe or under the hatch it raises,
naming the probe's failure or the hatch (:func:`device_refusal`). Only an
explicit ``device="cpu"`` runs on the CPU. So ``fallback_cpu`` defaults to
False here (a failed probe raises :class:`BackendProbeError`); with
``fallback_cpu=True`` a failed probe warns and returns ``"cpu"``, the
platform the caller may then ask for explicitly. ``force_cpu_backend`` has
no counterpart: torch has no process-wide platform to re-point, and the
package exports no such name.
"""
import os
import signal
import subprocess
import sys
import time
import warnings
from typing import Any, Dict, Optional

FORCE_CPU_ENV = "METRICS_TPU_FORCE_CPU"
PROBE_DEADLINE_ENV = "METRICS_TPU_PROBE_DEADLINE_S"
PROBE_CMD_ENV = "METRICS_TPU_PROBE_CMD"  # test hook: another `python -c` probe source

# the device's name, then the platform on the last line
_PROBE_SRC = "import torch; torch.cuda.init(); print(torch.cuda.get_device_name(0)); print('cuda')"
_DEFAULT_DEADLINE_S = 60.0

__all__ = [
    "BackendProbeError",
    "FORCE_CPU_ENV",
    "apply_force_cpu_escape_hatch",
    "backend_is_initialized",
    "backend_status",
    "current_platform",
    "device_refusal",
    "ensure_backend",
    "force_cpu_env_set",
    "probe_backend",
]

_forced_cpu = False
_probe_result: Optional[Dict[str, Any]] = None
_ensured_platform: Optional[str] = None


class BackendProbeError(RuntimeError):
    """CUDA failed its bootstrap probe (and ``fallback_cpu`` was False)."""


def backend_is_initialized() -> bool:
    """Whether CUDA is initialised in this process; never starts it."""
    try:
        import torch

        return bool(torch.cuda.is_initialized())
    except Exception:  # noqa: BLE001 - a broken install reads as not initialised
        return False


def current_platform() -> Optional[str]:
    """``"cuda"`` once CUDA is initialised here, else None (this function
    never initialises it)."""
    return "cuda" if backend_is_initialized() else None


def force_cpu_env_set() -> bool:
    """Whether the ``METRICS_TPU_FORCE_CPU`` escape hatch is set."""
    return os.environ.get(FORCE_CPU_ENV, "").strip().lower() not in ("", "0", "false", "no")


def apply_force_cpu_escape_hatch() -> bool:
    """Honour ``METRICS_TPU_FORCE_CPU=1`` (called at ``import
    metrics_tpu_torch``): record ``forced_cpu`` once. It touches no device
    and moves no metric; True when the hatch is set."""
    global _forced_cpu
    if not force_cpu_env_set():
        return False
    if _forced_cpu:
        return True
    _forced_cpu = True
    from metrics_tpu_torch.resilience.health import record_degradation

    record_degradation(
        "forced_cpu",
        f"{FORCE_CPU_ENV} is set: CUDA is not initialised by the bootstrap; metrics run only where "
        "they are asked to (device='cpu')",
    )
    return True


def device_refusal() -> Optional[str]:
    """Why ``device=None`` (CUDA) must not be used in this process, or None:
    the hatch, or a failed probe. ``Metric`` raises with this message."""
    if force_cpu_env_set():
        return (
            f"{FORCE_CPU_ENV} is set, so CUDA is not used by default; pass device='cpu' to run this "
            "metric on the CPU, or unset the variable"
        )
    if _probe_result is not None and not _probe_result.get("ok"):
        return (
            f"CUDA failed its bootstrap probe ({_probe_result.get('reason')}); pass device='cpu' to run "
            "this metric on the CPU"
        )
    return None


def _deadline_from_env() -> float:
    raw = os.environ.get(PROBE_DEADLINE_ENV)
    if raw is None:
        return _DEFAULT_DEADLINE_S
    try:
        return float(raw)
    except ValueError:
        # the bootstrap must survive its own knob being mistyped ("1m"):
        # this code runs exactly when the environment is broken
        warnings.warn(
            f"metrics_tpu_torch: ignoring malformed {PROBE_DEADLINE_ENV}={raw!r} "
            f"(not a number of seconds); using the {_DEFAULT_DEADLINE_S:.0f}s default",
            UserWarning,
        )
        return _DEFAULT_DEADLINE_S


def probe_backend(deadline_s: Optional[float] = None) -> Dict[str, Any]:
    """Probe CUDA in a fresh interpreter that imports torch, initialises
    CUDA and prints the device's name, under a hard ``deadline_s`` (default
    60, or ``METRICS_TPU_PROBE_DEADLINE_S``). The probe runs in its own
    process group; at the deadline the whole group is killed, so the
    caller never blocks past it. Returns ``{"ok", "platform", "device",
    "reason", "elapsed_s", "deadline_s", "timed_out"}``.
    ``METRICS_TPU_PROBE_CMD`` substitutes the probe's source (a test
    hook)."""
    if deadline_s is None:
        deadline_s = _deadline_from_env()
    src = os.environ.get(PROBE_CMD_ENV) or _PROBE_SRC
    t0 = time.monotonic()
    # not subprocess.run(timeout=...): on timeout it kills only the direct
    # child, then waits on the pipes with no timeout, and a grandchild that
    # inherited them and hangs would block us; a process group of its own + killpg
    proc = subprocess.Popen(
        [sys.executable, "-c", src],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=deadline_s)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):  # pragma: no cover
            proc.kill()
        try:
            proc.communicate(timeout=5.0)
        except subprocess.TimeoutExpired:  # pragma: no cover - pipes held by an unkillable reader
            pass
        return {
            "ok": False,
            "platform": None,
            "device": None,
            "reason": f"probe exceeded its {deadline_s:.0f}s deadline (CUDA initialisation hung?)",
            "elapsed_s": round(time.monotonic() - t0, 3),
            "deadline_s": deadline_s,
            "timed_out": True,
        }
    elapsed = round(time.monotonic() - t0, 3)
    lines = out.strip().splitlines()
    if proc.returncode == 0 and lines:
        # library chatter may precede the two lines
        return {
            "ok": True,
            "platform": lines[-1].strip(),
            "device": lines[-2].strip() if len(lines) > 1 else None,
            "reason": None,
            "elapsed_s": elapsed,
            "deadline_s": deadline_s,
            "timed_out": False,
        }
    return {
        "ok": False,
        "platform": None,
        "device": None,
        "reason": f"probe exited rc={proc.returncode}: {err.strip()[-400:]}",
        "elapsed_s": elapsed,
        "deadline_s": deadline_s,
        "timed_out": False,
    }


def ensure_backend(
    deadline_s: Optional[float] = None,
    fallback_cpu: bool = False,
    refresh: bool = False,
) -> str:
    """A bounded-time answer to "can this process use CUDA?"; returns the
    platform, ``"cuda"`` or ``"cpu"``.

    - ``METRICS_TPU_FORCE_CPU=1``: ``"cpu"`` at once, no probe.
    - CUDA already initialised here: ``"cuda"`` (a probe adds nothing).
    - Otherwise CUDA is probed in a throwaway interpreter under
      ``deadline_s``. On success: ``"cuda"``. On a hang or failure: a loud
      warning and a ``backend_probe_timeout``/``backend_probe_failed``
      event; then :class:`BackendProbeError` (``fallback_cpu=False``, the
      default here) or ``"cpu"`` (``fallback_cpu=True``).

    Nothing moves to the CPU either way (D53): after a failure,
    ``Metric(device=None)`` raises naming it. The answer is cached per
    process; ``refresh=True`` probes again (and a success clears the
    refusal).
    """
    global _probe_result, _ensured_platform
    if apply_force_cpu_escape_hatch():
        _ensured_platform = "cpu"
        return "cpu"
    if _ensured_platform is not None and not refresh:
        return _ensured_platform
    live = current_platform()
    if live is not None:
        _ensured_platform = live
        return live
    result = probe_backend(deadline_s)
    _probe_result = result
    if result["ok"]:
        _ensured_platform = result["platform"]
        return _ensured_platform
    from metrics_tpu_torch.resilience.health import record_degradation

    kind = "backend_probe_timeout" if result.get("timed_out") else "backend_probe_failed"
    record_degradation(kind, result["reason"], **{k: result[k] for k in ("elapsed_s", "deadline_s")})
    if not fallback_cpu:
        raise BackendProbeError(f"CUDA failed its bootstrap probe ({result['reason']}) and fallback_cpu=False")
    warnings.warn(
        f"metrics_tpu_torch: CUDA failed its bootstrap probe ({result['reason']}). Metrics created "
        "without a device will refuse to run; pass device='cpu' to compute on the host, or set "
        f"{FORCE_CPU_ENV}=1 to skip the probe.",
        UserWarning,
    )
    _ensured_platform = "cpu"
    return "cpu"


def backend_status() -> Dict[str, Any]:
    """Bootstrap state for ``health_report()``; never initialises CUDA."""
    return {
        "initialized": backend_is_initialized(),
        "platform": current_platform(),
        "forced_cpu": _forced_cpu,
        "force_cpu_env": force_cpu_env_set(),
        "probe": dict(_probe_result) if _probe_result else None,
    }


def reset_backend_state() -> None:
    """Test hook: forget the probe, the cached platform and the hatch's
    record."""
    global _forced_cpu, _probe_result, _ensured_platform
    _forced_cpu = False
    _probe_result = None
    _ensured_platform = None
