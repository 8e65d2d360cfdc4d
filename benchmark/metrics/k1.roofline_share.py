"""``k1.roofline_share``: the time that K1's work in the traced updates
needs at the card's memory rate (``kernels/k1.py``: each input once, as
handed, and the state cells that the batch reaches, summed over every
traced update of the members that state K1 work), over the card's whole
time in the ``binned_counters*`` kernels in the same profiled segments."""
from benchmark.harness.roofline import share


def read(record):
    prof = record.get("profile")
    if not prof:
        return None
    return share((record.get("work") or {}).get("k1"), prof["kernel_s"].get("k1"), record["device_name"])
