"""``device_idle_frac``: the percentage of the traced window's wall time in
which no kernel, memset or copy ran on the device."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
