"""The trace reader and the per-layer metrics' readers on a trace worked by
hand (microseconds)."""

from __future__ import annotations

import pytest

import bm_util  # noqa: F401  (the repository's root on the import path)
from benchmark import devtrace, spec
from benchmark.harness import TracedRun


def ev(cat, name, ts, end):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts}


EVENTS = [
    # query 0, left out of the reading
    ev("user_annotation", "bm.dispatch", 0, 10),
    ev("user_annotation", "bm.sync", 10, 20),
    ev("kernel", "k0", 2, 8),
    # query 1
    ev("user_annotation", "bm.dispatch", 100, 150),
    ev("cpu_op", "aten::min", 101, 104),
    ev("kernel", "min", 105, 130),
    ev("cuda_runtime", "cudaStreamSynchronize", 115, 131),
    ev("gpu_memcpy", "Memcpy DtoH", 130, 130.5),
    ev("cuda_runtime", "cudaLaunchKernel", 140, 141),
    ev("user_annotation", "bm.sync", 150, 200),
    ev("cuda_runtime", "cudaDeviceSynchronize", 150, 199),
    ev("kernel", "hist", 152, 190),
    ev("gpu_memset", "Memset (Device)", 191, 195),
    ev("gpu_user_annotation", "bm.dispatch", 100, 150),
    # query 2
    ev("user_annotation", "bm.dispatch", 210, 240),
    ev("user_annotation", "bm.sync", 240, 300),
    ev("kernel", "hist", 220, 290),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 250},
]


def trace():
    return devtrace.parse(EVENTS, skip=1)


def test_window_busy_and_reads():
    tr = trace()
    assert tr.window == (100, 300)
    assert tr.window_s == pytest.approx(200e-6)
    # min 105-130 and the copy 130-130.5 touch; hist 152-190; memset; hist
    assert tr.busy_s == pytest.approx((25 + 0.5 + 38 + 4 + 70) * 1e-6)
    assert tr.blocking == [(115, 131)]  # the harness's sync is not a read


def test_idle_by_host_span():
    idle = devtrace.idle_by_host_span(trace())
    # gaps: 100-105 dispatch; 130.5-152 (read 130.5-131, dispatch to 150,
    # sync to 152); 190-191 sync; 195-220 (sync 5, harness 10, dispatch 10);
    # 290-300 sync
    assert idle["host_read"] == pytest.approx(0.5e-6)
    assert idle["dispatch"] == pytest.approx((5 + 19 + 10) * 1e-6)
    assert idle["sync"] == pytest.approx((2 + 1 + 5 + 10) * 1e-6)
    assert idle["harness"] == pytest.approx(10e-6)
    assert sum(idle.values()) == pytest.approx(
        trace().window_s - trace().busy_s)


def test_breakdown_shape():
    b = devtrace.breakdown(trace())
    assert [n for n, _ in b["device_ops"]] == ["hist", "min",
                                               "Memset (Device)",
                                               "Memcpy DtoH"]
    assert b["device_ops"][0][1] == pytest.approx(108e-6)
    assert len(b["idle_gaps"]) <= 10


def read(name, run):
    return spec.metric_reader(name).read(run)


def test_readers():
    run = TracedRun(trace=trace(), calls_s=[0.001, 0.003],
                    bytes_needed=[1000, 1000], hbm_bytes_per_s=1e12)
    assert read("dispatch_ms", run) == pytest.approx(2.0)
    assert read("host_reads_per_query", run) == pytest.approx(0.5)
    assert read("kernels_per_query", run) == pytest.approx(2.0)
    busy = (25 + 0.5 + 38 + 4 + 70) * 1e-6
    assert read("query_roofline", run) == pytest.approx(100 * 2e-9 / busy)
    assert read("device_idle_frac", run) == pytest.approx(
        100 * (1 - busy / 200e-6))


def test_readers_find_nothing_without_a_trace():
    run = TracedRun(trace=None, calls_s=[], bytes_needed=[],
                    hbm_bytes_per_s=None)
    for m in spec.load_spec()["per_layer"]:
        assert read(m["name"], run) is None


def test_unequal_spans_raise():
    with pytest.raises(ValueError):
        devtrace.parse(EVENTS[:2] + [ev("user_annotation", "bm.sync", 30, 40)])
    with pytest.raises(ValueError):
        devtrace.parse(EVENTS[:2], skip=1)
