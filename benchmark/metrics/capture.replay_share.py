"""``capture.replay_share``: the share of the members' updates in the traced
window that a CUDA-graph replay served, from the members' ``UpdateGraphs``
counters (``replays``) over the updates they ran (``update_count`` of each
compute group's first member before each ``reset()``)."""


def read(record):
    total = record.get("member_updates") or 0
    return 100.0 * record["replays"] / total if total else None
