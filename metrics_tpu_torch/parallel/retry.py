"""Timeout, retry, exponential backoff and a circuit breaker
(counterpart of ``metrics_tpu/parallel/retry.py``).

One failure budget for a call that may hang or fail:

- every attempt runs on a **daemon** thread bounded by ``timeout_s``, so a
  wedged callable costs bounded time, and the abandoned thread cannot
  block the interpreter's exit;
- an exception retries up to ``max_retries`` times, sleeping
  ``backoff_s * 2**k`` between attempts;
- a timeout does not retry unless ``retry_timeouts=True``: a collective
  that timed out may still complete on slow peers, so issuing it again
  would pair with their next collective;
- after a call has used its whole budget the breaker opens for
  ``cooldown_s``: :meth:`RetryPolicy.call` then raises
  :class:`CircuitOpenError` at once. A success closes it.

A policy is not thread-safe for concurrent calls: each consumer owns one
policy per destination. The module imports the standard library only.
"""
import queue
import threading
import time
from typing import Any, Callable, Optional, Type

__all__ = [
    "CallTimeoutError",
    "CircuitOpenError",
    "RetryBudgetExceededError",
    "RetryPolicy",
]


class CallTimeoutError(RuntimeError):
    """A deadline-bounded call did not complete within its timeout."""


class CircuitOpenError(RuntimeError):
    """The breaker is open: a recent call used the whole failure budget, and
    this call was refused without running the callable."""

    def __init__(self, message: str, retry_in_s: float) -> None:
        super().__init__(message)
        self.retry_in_s = retry_in_s


class RetryBudgetExceededError(RuntimeError):
    """Every permitted attempt failed, and the breaker is now open.

    ``cause`` is the last attempt's exception; ``attempts`` the attempts
    that ran (a timeout that is not retried counts 1).
    """

    def __init__(self, message: str, cause: BaseException, attempts: int) -> None:
        super().__init__(message)
        self.cause = cause
        self.attempts = attempts


class RetryPolicy:
    """One destination's failure budget: deadline, retries, backoff, breaker.

    ``timeout_error`` is the exception raised when an attempt misses its
    deadline (built from one message string); ``name`` labels the
    messages.
    """

    def __init__(
        self,
        timeout_s: float = 120.0,
        max_retries: int = 2,
        backoff_s: float = 1.0,
        cooldown_s: float = 60.0,
        retry_timeouts: bool = False,
        timeout_error: Type[BaseException] = CallTimeoutError,
        name: str = "call",
        thread_name: Optional[str] = None,
    ) -> None:
        if timeout_s <= 0:
            raise ValueError(f"`timeout_s` must be > 0, got {timeout_s}")
        if max_retries < 0:
            raise ValueError(f"`max_retries` must be >= 0, got {max_retries}")
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.cooldown_s = cooldown_s
        self.retry_timeouts = retry_timeouts
        self.timeout_error = timeout_error
        self.name = name
        self.thread_name = thread_name or f"metrics-tpu-retry-{name}"
        self._open_until = 0.0

    # -- breaker --------------------------------------------------------

    @property
    def open(self) -> bool:
        return time.monotonic() < self._open_until

    def open_for_s(self) -> float:
        """Seconds until the breaker lets the next attempt through."""
        return max(0.0, self._open_until - time.monotonic())

    def trip(self) -> None:
        self._open_until = time.monotonic() + self.cooldown_s

    def close(self) -> None:
        self._open_until = 0.0

    # -- calls ----------------------------------------------------------

    def attempt(self, fn: Callable[[], Any]) -> Any:
        """One deadline-bounded attempt, no retry, the breaker untouched. The
        callable runs on a daemon thread and is abandoned on a timeout: it
        cannot be cancelled."""
        box: "queue.Queue" = queue.Queue(maxsize=1)

        def run() -> None:
            try:
                box.put(("ok", fn()))
            except BaseException as err:  # noqa: BLE001 — relayed to the caller
                box.put(("err", err))

        worker = threading.Thread(target=run, daemon=True, name=self.thread_name)
        worker.start()
        try:
            kind, payload = box.get(timeout=self.timeout_s)
        except queue.Empty:
            raise self.timeout_error(f"{self.name} exceeded {self.timeout_s}s (peer process down or wedged?)")
        if kind == "err":
            raise payload
        return payload

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` under the whole budget. Returns its result, or raises
        :class:`CircuitOpenError` (the breaker is open; nothing ran) or
        :class:`RetryBudgetExceededError` (the budget is spent and the
        breaker now open; ``cause`` holds the last attempt's exception)."""
        if self.open:
            raise CircuitOpenError(
                f"{self.name} circuit open for {self.open_for_s():.0f}s more after repeated failures",
                self.open_for_s(),
            )
        last_err: Optional[BaseException] = None
        attempts = 0
        for attempt in range(self.max_retries + 1):
            attempts += 1
            try:
                out = self.attempt(fn)
                self.close()
                return out
            except self.timeout_error as err:
                last_err = err
                if not self.retry_timeouts:
                    break
                if attempt < self.max_retries:
                    time.sleep(self.backoff_s * (2**attempt))
            except Exception as err:  # noqa: BLE001 — faults of any kind retry
                last_err = err
                if attempt < self.max_retries:
                    time.sleep(self.backoff_s * (2**attempt))
        self.trip()
        raise RetryBudgetExceededError(
            f"{self.name} failed after {attempts} attempt(s): {last_err}",
            cause=last_err,
            attempts=attempts,
        )
