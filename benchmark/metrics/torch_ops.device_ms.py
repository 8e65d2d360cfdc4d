"""``torch_ops.device_ms``: the card's time, per update, of every operation
that is not one of the port's kernels (K1-K3) and that starts between an
epoch's first traced update and the end of its drain, from the profiled
segments."""


def read(record):
    prof = record.get("profile")
    if not prof or not prof["updates"] or not prof["busy_s"]:
        return None
    return 1e3 * prof["torch_ops_s"] / prof["updates"]
