"""The reader of the port's own spans (``benchmark/spans.py``) and its three
per-layer metrics, on a trace worked by hand (microseconds), and once on
the CPU through a real profiler that the caller holds, as the harness does."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import bm_util  # noqa: F401  (the repository's root on the import path)
from benchmark import devtrace, spans, spec
from benchmark.harness import TRACE_SKIP, TracedRun


def ev(cat, name, ts, end, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, name="cudaLaunchKernel"):
    return ev("cuda_runtime", name, ts, ts + 1, corr)


HARNESS_EVENTS = [
    # query 0, left out of the reading
    ev("user_annotation", "bm.dispatch", 0, 10),
    ev("user_annotation", "bm.sync", 10, 20),
    launch(1, 1),
    ev("kernel", "k0", 2, 8, 1),
    # query 1
    ev("user_annotation", "bm.dispatch", 100, 150),
    ev("cpu_op", "aten::min", 101, 104),
    launch(102, 10),
    ev("kernel", "min", 105, 115, 10),
    launch(116, 11, "cudaMemcpyAsync"),
    ev("gpu_memcpy", "Memcpy DtoH", 118, 119, 11),
    ev("cuda_runtime", "cudaStreamSynchronize", 117, 124, 15),
    launch(135, 12),
    ev("kernel", "hist", 152, 190, 12),
    launch(141, 13, "cudaMemsetAsync"),
    ev("gpu_memset", "Memset (Device)", 191, 195, 13),
    launch(144, 14),
    ev("kernel", "cumsum", 195, 198, 14),
    ev("user_annotation", "bm.sync", 150, 200),
    ev("cuda_runtime", "cudaDeviceSynchronize", 150, 199, 16),
    # query 2
    ev("user_annotation", "bm.dispatch", 210, 240),
    launch(216, 20),
    ev("kernel", "hist", 220, 290, 20),
    ev("user_annotation", "bm.sync", 240, 300),
]
PROGRAM_SPANS = [
    ev("user_annotation", "sort_auto", 101, 149),
    ev("user_annotation", "sort_auto.span", 101, 126),
    ev("user_annotation", "read.sort_auto.max", 115, 125),
    ev("user_annotation", "sort_auto.histogram", 133, 140),
    ev("user_annotation", "kernel.histogram", 134, 139),
    ev("user_annotation", "sort_auto.expand", 140, 148.5),
    ev("user_annotation", "kernel.cumsum", 143, 148),
    ev("gpu_user_annotation", "sort_auto", 105, 198),
    ev("user_annotation", "sort_auto", 211, 239),
    ev("user_annotation", "kernel.histogram", 215, 220),
    ev("gpu_user_annotation", "kernel.histogram", 220, 290),
]
EVENTS = HARNESS_EVENTS + PROGRAM_SPANS


def parsed():
    return spans.parse(EVENTS, skip=1)


def test_existing_readers_unchanged_by_program_spans():
    plain = devtrace.parse(HARNESS_EVENTS, skip=1)
    traced = devtrace.parse(EVENTS, skip=1)
    assert traced == plain == parsed().trace
    assert devtrace.breakdown(traced) == devtrace.breakdown(plain)
    assert devtrace.idle_by_host_span(traced) == \
        devtrace.idle_by_host_span(plain)
    for m in spec.load_spec()["per_layer"]:
        if m["source"] == "program_span":
            continue
        runs = [TracedRun(trace=t, calls_s=[0.001], bytes_needed=[10, 10],
                          hbm_bytes_per_s=1e12) for t in (plain, traced)]
        a, b = (spec.metric_reader(m["name"]).read(r) for r in runs)
        assert a == b, m["name"]


def test_spans_cropped_and_launches_joined():
    sp = parsed()
    assert sp.spans[0] == (101, 149, "sort_auto")
    assert {n for *_, n in sp.spans} == {
        "sort_auto", "sort_auto.span", "read.sort_auto.max",
        "sort_auto.histogram", "kernel.histogram", "sort_auto.expand",
        "kernel.cumsum"}  # no bm.*, no gpu_user_annotation
    names = [d[2] for d in sp.trace.device]
    assert names == ["min", "Memcpy DtoH", "hist", "Memset (Device)",
                     "cumsum", "hist"]
    assert sp.launched_at == [102, 116, 135, 141, 144, 216]


def test_new_readers():
    sp = parsed()
    assert spans.read_wait_ms(sp) == pytest.approx(10e-3 / 2)
    assert spans.wrapper_host_ms(sp) == pytest.approx(15e-3 / 2)
    # min and the memset outside every kernel.* span; 5 kernels and memsets
    assert spans.eager_kernels_per_query(sp) == pytest.approx(1.0)
    wrapped = sum(w for w, (*_, c) in zip(spans.launched_by_wrappers(sp),
                                          sp.trace.device)
                  if c in devtrace.LAUNCH_CATS)
    run = TracedRun(trace=sp.trace, calls_s=[], bytes_needed=[],
                    hbm_bytes_per_s=None)
    assert spans.eager_kernels_per_query(sp) + wrapped / sp.n == \
        spec.metric_reader("kernels_per_query").read(run)


def test_per_phase_idle_accounts_for_the_window():
    sp = parsed()
    phases = spans.account(sp)
    idle = devtrace.idle_by_host_span(sp.trace)
    per_query_ms = {k: v.idle_ms for k, v in phases.items()}
    assert per_query_ms == pytest.approx({
        "bm.dispatch": 3e-3 / 2, "sort_auto.span": 5e-3 / 2,
        "read.sort_auto.max": 3e-3 / 2, "sort_auto": 11.5e-3 / 2,
        "sort_auto.histogram": 2e-3 / 2, "kernel.histogram": 10e-3 / 2,
        "sort_auto.expand": 3.5e-3 / 2, "kernel.cumsum": 5e-3 / 2})
    assert sum(per_query_ms.values()) * sp.n * 1e-3 == pytest.approx(
        idle["dispatch"])
    total = sum(per_query_ms.values()) * sp.n * 1e-3 + idle["host_read"] \
        + idle["sync"] + idle["harness"]
    assert total == pytest.approx(sp.trace.window_s - sp.trace.busy_s)
    # self host time partitions the dispatch spans
    assert sum(p.self_ms for p in phases.values()) == pytest.approx(
        (50 + 30) * 1e-3 / 2)
    assert phases["sort_auto"].self_ms == pytest.approx(30.5e-3 / 2)
    # launches by the innermost span open at the runtime call
    assert phases["kernel.histogram"].device_ms == pytest.approx(
        (38 + 70) * 1e-3 / 2)
    assert phases["kernel.histogram"].kernels == pytest.approx(1.0)
    assert phases["read.sort_auto.max"].kernels == 0  # a copy
    assert phases["read.sort_auto.max"].device_ms == pytest.approx(0.5e-3)
    assert sum(p.kernels for p in phases.values()) == pytest.approx(2.5)


def test_lines_one_a_span_then_the_other_buckets():
    out = spans.lines(parsed())
    names = [line.split(":")[0][len("span "):] for line in out]
    assert names[:3] == ["bm.dispatch", "sort_auto", "sort_auto.span"]
    assert names[-3:] == ["(host_read)", "(sync)", "(harness)"]
    assert len(names) == 8 + 3


def test_nothing_read_without_program_spans():
    sp = spans.parse(HARNESS_EVENTS, skip=1)
    assert sp.spans == []
    assert spans.read_wait_ms(sp) is None
    assert spans.wrapper_host_ms(sp) is None
    assert spans.eager_kernels_per_query(sp) is None


def test_innermost_nests_and_clamps():
    sp = spans.Spans(
        trace=devtrace.parse([ev("user_annotation", "bm.dispatch", 0, 100),
                              ev("user_annotation", "bm.sync", 100, 110)]),
        spans=[(0, 100, "op"), (10, 20, "a"), (30, 50, "b"),
               (35, 51, "c")],  # c ends past b: clamped to b's end
        launched_at=[])
    assert spans.innermost(sp) == [
        (0, 10, "op"), (10, 20, "a"), (20, 30, "op"), (30, 35, "b"),
        (35, 50, "c"), (50, 100, "op")]


class _Event:
    def __init__(self, name, device, ua, start, dur, corr):
        self._v = (name, device, ua, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def is_user_annotation(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def test_kineto_events_categories():
    class Results:
        def trace_start_ns(self):
            return 1000

        def events(self):
            cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"
            return [_Event("bm.dispatch", cpu, True, 1000, 5000, 1),
                    _Event("kernel.cumsum", cuda, True, 2000, 500, 2),
                    _Event("aten::min", cpu, False, 1500, 100, 3),
                    _Event("cudaLaunchKernel", cpu, False, 1600, 50, 7),
                    _Event("cuStreamSynchronize", cpu, False, 1700, 50, 8),
                    _Event("Memset (Device)", cuda, False, 2000, 10, 9),
                    _Event("Memcpy DtoH (Device -> Pinned)", cuda, False,
                           2100, 10, 10),
                    _Event("void k<int>()", cuda, False, 2200, 10, 7)]

    class Prof:
        class profiler:
            kineto_results = Results()

    out = spans.kineto_events(Prof)
    assert [e["cat"] for e in out] == [
        "user_annotation", "gpu_user_annotation", "cpu_op", "cuda_runtime",
        "cuda_driver", "gpu_memset", "gpu_memcpy", "kernel"]
    assert out[0]["ts"] == 0 and out[0]["dur"] == 5
    assert out[-1]["args"] == {"correlation": 7}


def _profiled(call, queries):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    for _ in range(queries):
        with record_function(devtrace.DISPATCH):
            call()
        with record_function(devtrace.SYNC):
            pass
    prof.stop()
    return prof


def _read_all(prof):
    """The three readers, as the harness calls them: inside a function
    that holds the stopped profiler."""
    run = TracedRun(trace=devtrace.parse(spans.kineto_events(prof),
                                         TRACE_SKIP),
                    calls_s=[], bytes_needed=[], hbm_bytes_per_s=None)
    return {name: spec.metric_reader(name).read(run)
            for name in ("read_wait_ms", "wrapper_host_ms",
                         "eager_kernels_per_query")}


def test_readers_find_the_profiler_their_caller_holds(capsys):
    from dwarf_bench_tpu_torch.ops import sort

    x = torch.randint(1, 10001, (4096,), dtype=torch.int32)
    prof = _profiled(lambda: sort.sort_auto(x), TRACE_SKIP + 3)
    got = _read_all(prof)
    assert got["read_wait_ms"] > 0 and got["wrapper_host_ms"] > 0
    assert got["eager_kernels_per_query"] == 0  # no device in a CPU trace
    err = capsys.readouterr().err.splitlines()
    assert err[0].startswith("span bm.dispatch: self_ms ")
    assert {"span sort_auto", "span sort_auto.span", "span read.sort_auto.max",
            "span kernel.histogram", "span kernel.cumsum"} <= {
        line.split(":")[0] for line in err}


def test_readers_silent_on_a_program_without_spans(capsys):
    x = torch.randint(1, 10001, (4096,), dtype=torch.int32)
    prof = _profiled(lambda: torch.sort(x), TRACE_SKIP + 3)
    assert _read_all(prof) == {"read_wait_ms": None, "wrapper_host_ms": None,
                               "eager_kernels_per_query": None}
    assert capsys.readouterr().err == ""
