"""``host_rows_per_s``: ``rows_per_s`` of the traced run's window before its
profiled stretch: the rows of every query dealt there over its wall time
(the harness's time between queries included), none of it profiled."""


def read(run):
    if run.host_rows <= 0 or run.host_s <= 0:
        return None
    return run.host_rows / run.host_s
