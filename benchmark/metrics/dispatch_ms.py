"""``dispatch_ms``: host milliseconds inside the operator call, the mean over
the traced run's queries that the profiler did not slow (the harness's own
clock around the call; host reads inside the call included)."""


def read(run):
    if not run.calls_s:
        return None
    return 1e3 * sum(run.calls_s) / len(run.calls_s)
