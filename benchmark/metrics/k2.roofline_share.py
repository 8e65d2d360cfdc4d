"""``k2.roofline_share``: the time that K2's work in the traced updates
needs at the card's memory rate (``kernels/k2.py``: one bin id a row at the
narrowest width of the bins, and the bins reached, summed over every traced
update of the members that state K2 work), over the card's whole time in
the ``histogram*`` kernels in the same profiled segments."""
from benchmark.harness.roofline import share


def read(record):
    prof = record.get("profile")
    if not prof:
        return None
    return share((record.get("work") or {}).get("k2"), prof["kernel_s"].get("k2"), record["device_name"])
