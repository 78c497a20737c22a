"""Reads the port's own spans in a traced run's profiler trace.

The port opens ``torch.profiler.record_function`` spans inside its
operators while a profiler records (``dwarf_bench_tpu_torch/ops/trace.py``):
the operator call (``sort_auto``, ``filter_sparse``), its phases
(``sort_auto.histogram``, ``filter_sparse.phase_b``, ...), each read back to
the host (``read.<site>``) and each kernel wrapper (``kernel.<name>``). They
share the harness's ``bm.dispatch`` span as their root, and the clock of the
device's kernels, memsets and copies.

``parse`` reads the same events as ``devtrace.parse`` (whose ``Trace`` it
keeps, unchanged) and adds two fields:

  * ``spans``: (start, end, name) of every ``user_annotation`` event other
    than the harness's ``bm.*``, cropped to the window like the device's;
  * ``launched_at``: for each event of ``trace.device``, the start of the
    host runtime call that launched it (the events' ``args.correlation``),
    None where the trace holds no such call.

``account`` puts each traced query's host time, the device's idle time, and
the kernels to the innermost span open on the host, and ``lines`` prints
that table. The per-layer readers ``read_wait_ms``, ``wrapper_host_ms`` and
``eager_kernels_per_query`` (``metrics/``) read ``of_run``: the spans of the
profiler that the harness holds while its readers run, read once a run,
whose table goes to standard error then. They read nothing, and print
nothing, where the program opened no span (a program without them).
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import devtrace
from benchmark.harness import TRACE_SKIP

READ = "read."
KERNEL = "kernel."
HARNESS = "bm."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")

Span = Tuple[float, float, str]


@dataclass
class Spans:
    trace: devtrace.Trace  # the harness's reading of the same events
    spans: List[Span]  # the program's spans in the window
    launched_at: List[Optional[float]]  # of each event of trace.device

    @property
    def n(self) -> int:
        return len(self.trace.queries)

    def named(self, prefix: str) -> List[Span]:
        return [s for s in self.spans if s[2].startswith(prefix)]


def parse(events: List[dict], skip: int = 0) -> Spans:
    """The program's spans and the device's launches of the profiled
    queries after the first ``skip``."""
    trace = devtrace.parse(events, skip)
    lo, hi = trace.window
    launch: Dict[int, float] = {}
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = e.get("args", {}).get("correlation")
        if cat in RUNTIME_CATS and corr is not None:
            launch[corr] = min(a, launch.get(corr, a))
        elif cat in devtrace.DEVICE_CATS and b > lo and a < hi:
            device.append(((max(a, lo), min(b, hi), name, cat), corr))
        elif (cat == "user_annotation" and not name.startswith(HARNESS)
              and b > lo and a < hi):
            spans.append((max(a, lo), min(b, hi), name))
    # the order of ``trace.device``: a stable sort on the same tuples
    device.sort(key=lambda d: d[0])
    launched_at = [launch.get(c) for _, c in device]
    # by start, a parent before the child that opens with it
    return Spans(trace, sorted(spans, key=lambda s: (s[0], -s[1])),
                 launched_at)


def _union_us(spans: List[Span]) -> float:
    return sum(b - a for a, b in devtrace._merge([(a, b) for a, b, _ in spans]))


def read_wait_ms(sp: Spans) -> Optional[float]:
    """Host ms a query inside ``read.*`` spans."""
    reads = sp.named(READ)
    if not reads:
        return None
    return sum(b - a for a, b, _ in reads) * 1e-3 / sp.n


def wrapper_host_ms(sp: Spans) -> Optional[float]:
    """Host ms a query inside the union of ``kernel.*`` spans."""
    wrappers = sp.named(KERNEL)
    if not wrappers:
        return None
    return _union_us(wrappers) * 1e-3 / sp.n


def launched_by_wrappers(sp: Spans) -> List[bool]:
    """For each event of ``trace.device``: launched from inside a
    ``kernel.*`` span."""
    inside = devtrace._merge([(a, b) for a, b, _ in sp.named(KERNEL)])
    starts = [a for a, _ in inside]
    out = []
    for t in sp.launched_at:
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        out.append(i >= 0 and t < inside[i][1])
    return out


def eager_kernels_per_query(sp: Spans) -> Optional[float]:
    """Kernels and memsets a query launched from outside every ``kernel.*``
    span (or whose launch the trace lacks): the eager torch ops'."""
    if not sp.named(KERNEL):
        return None
    eager = sum(1 for (*_, cat), wrapped in zip(sp.trace.device,
                                               launched_by_wrappers(sp))
                if cat in devtrace.LAUNCH_CATS and not wrapped)
    return eager / sp.n


def innermost(sp: Spans) -> List[Span]:
    """The host's time in the queries' ``bm.dispatch`` spans, cut into
    disjoint (start, end, name) pieces, each named by the innermost span
    open on the single host thread."""
    tree = [(a, b, devtrace.DISPATCH) for (a, b), _ in sp.trace.queries]
    tree = sorted(tree + sp.spans, key=lambda s: (s[0], -s[1]))
    pieces: List[Span] = []
    stack: List[Span] = []
    t = None

    def close_until(x):
        nonlocal t
        while stack and stack[-1][1] <= x:
            a, b, name = stack.pop()
            if b > t:
                pieces.append((t, b, name))
                t = b

    for a, b, name in tree:
        if stack:
            close_until(a)
        if stack and a > t:
            pieces.append((t, a, stack[-1][2]))
        t = a if t is None else max(t, a)
        if stack:  # a child ends by its parent's end
            b = min(b, stack[-1][1])
        stack.append((a, b, name))
    if stack:
        close_until(float("inf"))
    return pieces


def _gaps(trace: devtrace.Trace) -> List[Tuple[float, float]]:
    """The window's intervals with no device work, less the host's
    blocking reads (``devtrace.idle_by_host_span``'s ``host_read``)."""
    lo, hi = trace.window
    gaps, t = [], lo
    for a, b in trace.busy + [(hi, hi)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    out = []
    reads = devtrace._merge(trace.blocking)
    ends = [rb for _, rb in reads]
    for a, b in gaps:
        i = bisect.bisect_right(ends, a)  # the first read ending after a
        while i < len(reads) and reads[i][0] < b:
            ra, rb = reads[i]
            if ra > a:
                out.append((a, ra))
            a = max(a, rb)
            i += 1
        if b > a:
            out.append((a, b))
    return out


@dataclass
class Phase:
    self_ms: float = 0.0  # host ms with this span the innermost one open
    idle_ms: float = 0.0  # device idle ms then (blocking reads apart)
    device_ms: float = 0.0  # of the kernels, memsets, copies launched then
    kernels: float = 0.0  # kernels and memsets launched then


def account(sp: Spans) -> Dict[str, Phase]:
    """Per traced query, by the innermost span open on the host
    (``bm.dispatch`` where the call is in none of the program's): its self
    host time, the device's idle time then, and the device time and number
    of the kernels launched then. The idle column sums to
    ``idle_by_host_span``'s ``dispatch``; a launch outside every dispatch
    span (none, in the harness's queries) goes under ``(outside)``."""
    pieces = innermost(sp)
    starts = [a for a, _, _ in pieces]
    out: Dict[str, Phase] = defaultdict(Phase)
    for a, b, name in pieces:
        out[name].self_ms += b - a
    for a, b in _gaps(sp.trace):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            pa, pb, name = pieces[i]
            out[name].idle_ms += max(0.0, min(b, pb) - max(a, pa))
            i += 1
    for (a, b, _, cat), t in zip(sp.trace.device, sp.launched_at):
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        name = pieces[i][2] if i >= 0 and t < pieces[i][1] else "(outside)"
        out[name].device_ms += b - a
        if cat in devtrace.LAUNCH_CATS:
            out[name].kernels += 1
    for p in out.values():  # µs in the window -> ms (kernels: count) a query
        p.self_ms *= 1e-3 / sp.n
        p.idle_ms *= 1e-3 / sp.n
        p.device_ms *= 1e-3 / sp.n
        p.kernels /= sp.n
    return dict(out)


def lines(sp: Spans) -> List[str]:
    """One line a span name, in the order the spans first open, then the
    idle time outside the call (``devtrace.idle_by_host_span``), per
    traced query."""
    phases = account(sp)
    first = {devtrace.DISPATCH: -1}  # each name's place in sp.spans
    for i, (_, _, name) in enumerate(sp.spans):
        first.setdefault(name, i)
    names = sorted(phases, key=lambda k: first.get(k, len(sp.spans)))
    out = [f"span {k}: self_ms {p.self_ms:.4f} idle_ms {p.idle_ms:.4f} "
           f"device_ms {p.device_ms:.4f} kernels {p.kernels:.2f}"
           for k, p in ((k, phases[k]) for k in names)]
    idle = devtrace.idle_by_host_span(sp.trace)
    for k in ("host_read", "sync", "harness"):
        out.append(f"span ({k}): idle_ms {idle.get(k, 0.0) * 1e3 / sp.n:.4f}")
    return out


# -- a traced run ------------------------------------------------------------

def kineto_events(prof) -> List[dict]:
    """The events of a stopped ``torch.profiler.profile`` as Chrome trace
    events (``cat``, ``name``, ``ts`` and ``dur`` in µs, ``args.correlation``
    of the device's events and the runtime calls). The harness has saved
    the profiler's trace once, and a trace is saved only once; its events
    stay readable."""
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    out = []
    for e in results.events():
        name = e.name()
        cuda = "CUDA" in str(e.device_type())
        if e.is_user_annotation():
            cat = "gpu_user_annotation" if cuda else "user_annotation"
        elif cuda:
            cat = ("gpu_memset" if name.startswith("Memset") else
                   "gpu_memcpy" if name.startswith("Memcpy") else "kernel")
        elif name.startswith("cuda"):
            cat = "cuda_runtime"
        elif name.startswith("cu") and name[2:3].isupper():
            cat = "cuda_driver"
        else:
            cat = "cpu_op"
        out.append({"ph": "X", "cat": cat, "name": name,
                    "ts": (e.start_ns() - t0) * 1e-3,
                    "dur": e.duration_ns() * 1e-3,
                    "args": {"correlation": e.correlation_id()}})
    return out


def _profiler_of_callers():
    """The stopped profiler a caller holds: the harness's, while its
    readers run inside ``run_cell``."""
    frame = sys._getframe(1)
    while frame is not None:
        for v in frame.f_locals.values():
            if isinstance(v, torch.profiler.profile) and getattr(
                    v.profiler, "kineto_results", None) is not None:
                return v
        frame = frame.f_back
    return None


_LAST: list = [None, None]  # (run, its Spans): one reading a run


def of_run(run) -> Optional[Spans]:
    """The program's spans of a traced run (``harness.TracedRun``), None
    without a device trace or a program span; the first reading of a run
    prints ``lines`` to standard error."""
    if run.trace is None:
        return None
    if _LAST[0] is run:
        return _LAST[1]
    prof = _profiler_of_callers()
    sp = None
    if prof is not None:
        sp = parse(kineto_events(prof), TRACE_SKIP)
        if not sp.spans:
            sp = None
    _LAST[:] = [run, sp]
    if sp is not None:
        for line in lines(sp):
            print(line, file=sys.stderr)
    return sp
