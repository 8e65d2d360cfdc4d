"""``compute_ms``: the mean time of a ``compute()`` in the window, from the
call until its values are on the host, the queue drained before. Host
clock."""


def read(record):
    times = record["compute_s"]
    return 1e3 * sum(times) / len(times) if times else None
