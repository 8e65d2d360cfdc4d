"""``update_p95_ms``: the 95th percentile, over every update of the window,
of the span on the card's stream between the CUDA events recorded just
before and just after the ``update()`` call (NumPy's linear
interpolation)."""
import numpy as np


def read(record):
    spans = record["update_ms"]
    return float(np.percentile(np.asarray(spans, dtype=np.float64), 95)) if spans else None
