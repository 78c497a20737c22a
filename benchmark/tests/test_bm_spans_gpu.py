"""On the card (``-m gpu``; skipped without one): the port's spans in each
cell's traced run, at a column of 2^22 rows. The eager kernels and those
launched from the kernel wrappers' spans make ``kernels_per_query``; each
read back to the host lies in a ``read.*`` span; the wrappers' kernels are
those ``_build.LAUNCHES`` counts; and ``run.py --trace 1`` prints the new
metrics and the span lines before its checks.

    python -m pytest benchmark/tests/test_bm_spans_gpu.py -m gpu -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bm_util import ROOT, WORKLOADS, small_cell
from benchmark import devtrace, harness, spans

pytestmark = pytest.mark.gpu

NEW = ("read_wait_ms", "wrapper_host_ms", "eager_kernels_per_query")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_spans_account_for_every_kernel_and_read(card, workload):
    cell = small_cell(workload, rows=1 << 22, columns=2)
    result, errors = harness.run_cell(cell, 2**31 + 11, 2.5, True, card)
    assert errors == [] and result["correct"] is True
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(NEW) <= set(m)
    sp = spans._LAST[1]
    assert sp is not None and spans._LAST[0] is not None
    # the profiler's events, read again, are the trace the harness read
    kernels = sum(1 for *_, c in sp.trace.device if c in devtrace.LAUNCH_CATS)
    assert kernels / sp.n == pytest.approx(m["kernels_per_query"])
    assert len(sp.trace.blocking) / sp.n == pytest.approx(
        m["host_reads_per_query"])
    assert all(t is not None for t in sp.launched_at)
    wrapped = sum(w for w, (*_, c) in zip(spans.launched_by_wrappers(sp),
                                          sp.trace.device)
                  if c in devtrace.LAUNCH_CATS)
    assert m["eager_kernels_per_query"] + wrapped / sp.n == pytest.approx(
        m["kernels_per_query"])
    assert len(sp.named(spans.READ)) / sp.n == pytest.approx(
        m["host_reads_per_query"])
    assert m["read_wait_ms"] > 0 and m["wrapper_host_ms"] > 0


@pytest.mark.parametrize("op", ["filter_sparse", "sort_auto"])
def test_wrapper_kernels_are_the_launches_counted(card, op):
    from dwarf_bench_tpu_torch.ops import _build, scan, sort

    g = torch.Generator(device=card)
    g.manual_seed(5)
    x = torch.randint(1, 10001, (1 << 22,), dtype=torch.int32, device=card,
                      generator=g)
    fn = scan.filter_sparse if op == "filter_sparse" else sort.sort_auto
    fn(x)
    torch.cuda.synchronize()
    _build.reset_launches()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    for _ in range(4):
        with record_function(devtrace.DISPATCH):
            fn(x)
        with record_function(devtrace.SYNC):
            torch.cuda.synchronize()
    prof.stop()
    sp = spans.parse(spans.kineto_events(prof))
    wrapped = sum(w for w, (*_, c) in zip(spans.launched_by_wrappers(sp),
                                          sp.trace.device)
                  if c in devtrace.LAUNCH_CATS)
    assert wrapped == sum(_build.LAUNCHES.values())
    assert spans.eager_kernels_per_query(sp) > 0


def test_run_py_prints_the_spans(card):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "dplscan_u10k.lt5000_2p20", "--seed", "3000000021", "--seconds",
         "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and set(NEW) <= set(line["metrics"])
    err = proc.stderr.strip().splitlines()
    first_check = next(i for i, s in enumerate(err) if s.startswith("check "))
    assert all(s.startswith("check ") for s in err[first_check:])
    names = {s.split(":")[0] for s in err[:first_check]
             if s.startswith("span ")}
    assert {"span bm.dispatch", "span filter_sparse",
            "span filter_sparse.phase_a", "span filter_sparse.caps",
            "span read.filter_sparse.caps", "span filter_sparse.general",
            "span kernel.filter", "span (host_read)"} <= names
