"""``join_build_ms``: the device ms a traced query spends in the kernels
and memsets launched from inside the port's ``build_dense`` spans (the
dense CSR join's build: its histogram, positions, id sort and layouts;
``benchmark/spans.py``). ``device_ms`` reads any operator span the same
way (``join_probe_ms`` reads ``probe_dense``). It reads nothing where no
such span launched anything."""

import bisect

from benchmark import devtrace, spans

SPAN = "build_dense"


def device_ms(run, name: str):
    sp = spans.of_run(run)
    if sp is None:
        return None
    inside = devtrace._merge([(a, b) for a, b, n in sp.spans if n == name])
    starts = [a for a, _ in inside]
    busy_us = 0.0
    for (a, b, _, cat), t in zip(sp.trace.device, sp.launched_at):
        if cat not in devtrace.LAUNCH_CATS or t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < inside[i][1]:
            busy_us += b - a
    if busy_us <= 0:
        return None
    return busy_us * 1e-3 / sp.n


def read(run):
    return device_ms(run, SPAN)
