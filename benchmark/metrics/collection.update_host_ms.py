"""``collection.update_host_ms``: the host's time in one
``MetricCollection.update()`` call, the mean over every call of the traced
run's window (the harness's span around each call)."""


def read(record):
    spans = record.get("host_update_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
