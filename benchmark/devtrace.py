"""Reads the profiler's trace of a traced stretch of the window.

The harness marks each profiled query with two spans of its own
(``torch.profiler.record_function``): ``bm.dispatch`` around the operator
call and ``bm.sync`` around ``torch.cuda.synchronize``. Both, the device's
kernels, memsets and copies, and the host's blocking runtime calls come
from one Chrome trace on one clock (microseconds).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

DISPATCH = "bm.dispatch"
SYNC = "bm.sync"
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
LAUNCH_CATS = ("kernel", "gpu_memset")  # what a query launches on the device
# host calls that wait for the device: each read back to the host ends in one
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
            "cuCtxSynchronize", "cuMemcpyDtoH_v2")

Span = Tuple[float, float]


@dataclass
class Trace:
    queries: List[Tuple[Span, Span]]  # (dispatch, sync) of each query read
    device: List[Tuple[float, float, str, str]]  # (start, end, name, cat)
    blocking: List[Span]  # blocking host calls inside a dispatch span
    busy: List[Span]  # the device's merged busy intervals in the window

    @property
    def window(self) -> Span:
        return self.queries[0][0][0], self.queries[-1][1][1]

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6


def _merge(spans: List[Span]) -> List[Span]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def parse(events: List[dict], skip: int = 0) -> Trace:
    """The trace of the profiled queries after the first ``skip``."""
    spans = defaultdict(list)
    device, blocking = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        span = (a, a + float(e["dur"]))
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name in (DISPATCH, SYNC):
            spans[name].append(span)
        elif cat in DEVICE_CATS:
            device.append((span[0], span[1], name, cat))
        elif cat in ("cuda_runtime", "cuda_driver") and name in BLOCKING:
            blocking.append(span)
    dispatch, sync = sorted(spans[DISPATCH]), sorted(spans[SYNC])
    if len(dispatch) != len(sync):
        raise ValueError(f"{len(dispatch)} dispatch spans, {len(sync)} sync")
    queries = list(zip(dispatch, sync))[skip:]
    if not queries:
        raise ValueError("no profiled query in the trace")
    lo, hi = queries[0][0][0], queries[-1][1][1]
    device = sorted((max(a, lo), min(b, hi), n, c) for a, b, n, c in device
                    if b > lo and a < hi)
    starts = [d[0] for d, _ in queries]
    inside = []
    for a, b in blocking:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < queries[i][0][1]:
            inside.append((a, b))
    busy = _merge([(a, b) for a, b, _, _ in device])
    return Trace(queries, device, sorted(inside), busy)


def load(path: str, skip: int = 0) -> Trace:
    with open(path) as f:
        return parse(json.load(f)["traceEvents"], skip)


def _overlap(spans: List[Span], starts: List[float], a: float,
             b: float) -> float:
    """Length of [a, b] that the sorted, disjoint ``spans`` (which start at
    ``starts``) cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(spans) and spans[i][0] < b:
        total += max(0.0, min(b, spans[i][1]) - max(a, spans[i][0]))
        i += 1
    return total


def idle_by_host_span(trace: Trace) -> Dict[str, float]:
    """Seconds the device sat idle in the window, by what the host was doing:
    a blocking read inside the operator call (``host_read``), the rest of
    the call (``dispatch``), the harness's synchronize (``sync``), or the
    harness between queries (``harness``)."""
    lo, hi = trace.window
    gaps, t = [], lo
    for a, b in trace.busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    dispatch = [d for d, _ in trace.queries]
    sync = [s for _, s in trace.queries]
    reads = _merge(trace.blocking)
    lists = [(x, [a for a, _ in x]) for x in (reads, dispatch, sync)]
    out = defaultdict(float)
    for a, b in gaps:
        r, d, s = (_overlap(x, starts, a, b) for x, starts in lists)
        out["host_read"] += r * 1e-6
        out["dispatch"] += (d - r) * 1e-6
        out["sync"] += s * 1e-6
        out["harness"] += (b - a - d - s) * 1e-6
    return dict(out)


def breakdown(trace: Trace, top: int = 10) -> dict:
    ops = defaultdict(float)
    for a, b, name, _ in trace.device:
        ops[name[:160]] += (b - a) * 1e-6
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(idle_by_host_span(trace).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k, v] for k, v in idle[:top]]}
