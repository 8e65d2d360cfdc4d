"""``rows_per_s``: every row handed to ``update()`` in the window, over the
window's whole wall time (each epoch's ``compute()``, host read and
``reset()`` included). Host clock."""


def read(record):
    return record["rows"] / record["window_s"] if record["window_s"] > 0 else None
