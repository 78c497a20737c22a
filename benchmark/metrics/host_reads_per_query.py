"""``host_reads_per_query``: host calls inside the operator call that wait
for the device (a read back to the host ends in one), over the traced
queries."""


def read(run):
    if run.trace is None:
        return None
    return len(run.trace.blocking) / len(run.trace.queries)
