"""``query_roofline``: the least time the card's memory could serve the
traced queries (the bytes each query needs, ``work/<kind>.py``, at the
published bandwidth, ``peaks.py``), as a percentage of the time the device
was busy with them."""


def read(run):
    if run.trace is None or run.hbm_bytes_per_s is None or run.trace.busy_s <= 0:
        return None
    bound_s = sum(run.bytes_needed) / run.hbm_bytes_per_s
    return 100.0 * bound_s / run.trace.busy_s
