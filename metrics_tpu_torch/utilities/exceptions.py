"""Error types (counterpart of ``metrics_tpu/utilities/exceptions.py``).

The names are kept, so code that catches the JAX package's errors catches the
port's too.
"""


class MetricsTPUUserError(Exception):
    """Error raised on wrong usage of the metric lifecycle (update/compute/sync)."""


class MetricsTPUUserWarning(UserWarning):
    """Warning category for misuse that does not prevent computation."""
