"""``wrapper_host_ms``: host milliseconds a traced query inside the union of
the port's ``kernel.*`` spans, its kernel wrappers from their checks to
their launches (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    sp = spans.of_run(run)
    return None if sp is None else spans.wrapper_host_ms(sp)
