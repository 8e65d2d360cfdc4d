"""``device.idle_share``: the share of the profiled segments' wall time in
which no operation ran on the card."""


def read(record):
    prof = record.get("profile")
    if not prof or not prof["window_s"] or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
