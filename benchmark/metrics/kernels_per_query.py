"""``kernels_per_query``: kernels and memsets in the device trace, over the
traced queries."""

from benchmark.devtrace import LAUNCH_CATS


def read(run):
    if run.trace is None:
        return None
    n = sum(1 for *_, cat in run.trace.device if cat in LAUNCH_CATS)
    if n == 0:
        return None
    return n / len(run.trace.queries)
