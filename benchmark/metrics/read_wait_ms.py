"""``read_wait_ms``: host milliseconds a traced query inside the port's
``read.*`` spans (``ops/trace.read``): how long the operator sits blocked on
the card before it can queue its next phase (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    sp = spans.of_run(run)
    return None if sp is None else spans.read_wait_ms(sp)
