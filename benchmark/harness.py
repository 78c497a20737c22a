"""Runs one cell of the benchmark: the query kind's inputs made from the
seed, the warm-up of every shape the traffic uses, the measured window of
queries from one client in a closed loop, the profiled stretch of a traced
run, and the comparison of the window's own outputs with the plain
reference. The harness keeps the loop, the clock, the sample and the trace;
the query kind (``queries/<kind>.py``) owns its inputs, the arguments of
each call, the comparison and the byte count.

A query is timed on the host clock from the operator call until
``torch.cuda.synchronize()`` returns, every host read inside the call
included. The comparison covers a sample of the window's queries drawn
from the seed (a reservoir, so every unprofiled query of the window is as
likely to be in it), whose outputs are held until the window has closed.
"""

from __future__ import annotations

import gc
import math
import os
import random
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from benchmark import devtrace, loadgen, peaks
from benchmark.spec import Cell, base, metric_reader

TRACE_QUERIES = 200  # most queries the profiler records in a traced run
TRACE_SECONDS = 1.0  # most seconds of the window it records
TRACE_SKIP = 10  # recorded queries left out of the trace's reading
GIB = 2**30


@dataclass
class TracedRun:
    """What a per-layer metric's reader reads (``metrics/<name>.py``)."""

    trace: Optional[devtrace.Trace]  # None where the device was not traced
    calls_s: List[float]  # host seconds in the call, queries before the trace
    bytes_needed: List[int]  # of each query the trace reads
    hbm_bytes_per_s: Optional[float]
    # the window before the profiled stretch: rows of its queries, wall seconds
    host_rows: int = 0
    host_s: float = 0.0


def _parts(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


class Reservoir:
    """Copies of the outputs of a sample of the window's queries, drawn from
    the seed so that every query offered is as likely to be kept (reservoir
    sampling). The copies go to buffers made in set-up, shaped
    like ``like`` (the output of the largest query), so the window allocates
    nothing for them: an operator's output may not outgrow its largest
    query's (the port's outputs have a capacity fixed by the input)."""

    def __init__(self, like, k: int, seed: int):
        self.bufs = [tuple(torch.empty(t.numel(), dtype=t.dtype,
                                       device=t.device) for t in _parts(like))
                     for _ in range(k)]
        self.kept: list = []  # (query, shapes, tuple?) of each buffer
        self.seen = 0
        self.rng = random.Random(seed)

    def offer(self, query, out) -> bool:
        """Keep ``out`` with a chance of k / (queries offered); True when it
        was copied (the copy is queued on the device)."""
        self.seen += 1
        if len(self.kept) < len(self.bufs):
            j = len(self.kept)
            self.kept.append(None)
        else:
            j = self.rng.randrange(self.seen)
            if j >= len(self.bufs):
                return False
        parts = _parts(out)
        for buf, t in zip(self.bufs[j], parts):
            buf[:t.numel()].copy_(t.reshape(-1))
        self.kept[j] = (query, [t.shape for t in parts],
                        isinstance(out, (tuple, list)))
        return True

    def items(self):
        """(query, output) of each kept query."""
        for (query, shapes, tup), bufs in zip(self.kept, self.bufs):
            parts = tuple(b[:math.prod(s)].view(s) for b, s in zip(bufs, shapes))
            yield query, (parts if tup else parts[0])


def _allocated(device: torch.device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def _sync(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def warm_up(fn, kind, inputs: dict, traffic: dict, cols: int, rows: int,
            sync):
    """Every length the mix sends, twice; returns an output of the largest."""
    for n in sorted(set(loadgen.lengths(traffic, rows))):
        for c in range(2):
            out = fn(*kind.args(inputs, (c % cols, 0, n)))
        sync()
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, program: Optional[Callable] = None,
             t_start: Optional[float] = None):
    """One run of ``cell``: the result line's object and the first errors
    that queries raised. ``program`` replaces the port's operator (the
    tests' faults, the controls)."""
    clock = time.perf_counter
    t_start = clock() if t_start is None else t_start
    kind, traffic = cell.kind, cell.traffic
    params = traffic.get("params", {})
    fn = kind.program(params) if program is None else program
    sync = _sync(device)
    cuda = device.type == "cuda"

    before = _allocated(device)
    inputs = kind.make_inputs(cell.config, seed, device)
    sync()
    resident = _allocated(device) - before
    # the traffic ranges over the configuration's ``table``
    cols, rows = (int(cell.config["table"][k]) for k in ("columns", "rows"))
    queries = loadgen.deal(traffic, cols, rows, seed)
    like = warm_up(fn, kind, inputs, traffic, cols, rows, sync)
    sample = Reservoir(like, int(traffic["checked"]), seed)
    del like
    sync()
    # what the program keeps between calls (scratch, caches)
    held_by_program = _allocated(device) - before - resident
    if cuda:
        held_by_program -= sum(b.numel() * b.element_size()
                               for bufs in sample.bufs for b in bufs)

    # a traced run profiles the window's last stretch, and its host readings
    # come from the queries before it: queries after a profiled stretch have
    # run slower than an untraced run's, and a profiler's first start takes
    # seconds
    prof = done = None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    trace_at = max(seconds - TRACE_SECONDS, 0.0) if trace else None
    lat: List[float] = []
    calls_s: List[float] = []  # unprofiled queries before the trace
    written: list = []  # profiled queries: (query, rows written)
    rows_done = failed = 0
    rows_free = t_free = t_traced = None  # see the profiled stretch below
    errors: List[str] = []
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    at_open = _allocated(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = clock() - t_start
    gc.collect()
    gc.freeze()
    t_open = clock()
    while True:
        if trace_at is not None and clock() - t_open >= trace_at:
            trace_at = None
            rows_free, t_free = rows_done, clock()  # the unprofiled part ends
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            t_traced = clock()  # the profiler's own start is not recorded
        q = next(queries)
        n = q[2]
        args = kind.args(inputs, q)
        traced = prof is not None
        out = None
        t0 = clock()
        try:
            if traced:
                with torch.profiler.record_function(devtrace.DISPATCH):
                    out = fn(*args)
                t1 = clock()
                with torch.profiler.record_function(devtrace.SYNC):
                    sync()
            else:
                out = fn(*args)
                t1 = clock()
                sync()
        except Exception as e:  # a query that raises is a failed query
            failed += 1
            t1 = clock()
            if len(errors) < 3:
                errors.append(f"{type(e).__name__}: {e}")
        t2 = clock()
        lat.append(t2 - t0)
        rows_done += n
        if traced:
            if out is not None:
                written.append((q, kind.written(out)))
        else:
            if done is None:  # none after the profiled stretch
                calls_s.append(t1 - t0)
            # the profiled stretch keeps nothing, so its trace holds only the
            # queries' own device work
            if out is not None and sample.offer(q, out):
                sync()  # the copy finishes outside the next query's time
        del out, args
        if traced and (len(written) >= TRACE_QUERIES + TRACE_SKIP
                       or t2 - t_traced >= TRACE_SECONDS):
            prof.stop()
            prof, done = None, prof
        # a traced run's window closes once its stretch has been recorded
        if (clock() - t_open >= seconds and trace_at is None
                and prof is None):
            break
    window_s = clock() - t_open
    gc.unfreeze()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    memory_peak = max(setup_peak, window_peak)
    query_mem = max(window_peak - at_open, 0) + held_by_program

    # the comparison, after the window, of the sampled queries' own outputs
    numbers = {name: 0 for name in kind.LIMITS}
    sample_n = len(sample.kept)
    for q, out in sample.items():
        for name, v in kind.compare(out, kind.args(inputs, q),
                                    params).items():
            numbers[name] += v
    del sample
    # a query that raised fails the run besides the numbers compared
    correct = bool(sample_n) and failed == 0 and all(
        numbers[k] <= lim for k, lim in kind.LIMITS.items())
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in kind.LIMITS.items()}

    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": int(memory_peak),
    }
    result = {"correct": correct, "attempted": len(lat), "failed": failed,
              "metrics": {}, "device": device_info}
    if not trace:
        values = {
            "rows_per_s": rows_done / window_s,
            "query_ms_p95": float(np.percentile(lat, 95)) * 1e3,
            "query_mem_gib": query_mem / GIB,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[base(m["name"])],
                                            "unit": m["unit"]}
    else:
        tr = _read_trace(done) if device.type == "cuda" else None
        n_read = len(tr.queries) if tr is not None else 0
        run = TracedRun(
            trace=tr,
            calls_s=calls_s,
            bytes_needed=[kind.work.bytes_needed(kind.args(inputs, q), int(w))
                          for q, w in written[TRACE_SKIP:TRACE_SKIP + n_read]],
            hbm_bytes_per_s=peaks.hbm_bytes_per_s(device_info["kind"]),
        )
        if t_free is not None:
            run.host_rows, run.host_s = rows_free, t_free - t_open
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(run)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v),
                                                "unit": m["unit"]}
        if tr is not None:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            result["breakdown"] = devtrace.breakdown(tr)
    result["checks"] = checks
    return result, errors


def _read_trace(prof) -> devtrace.Trace:
    """The profiler's trace, written to and read from a scratch directory
    under ``TMPDIR``."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return devtrace.load(path, TRACE_SKIP)
