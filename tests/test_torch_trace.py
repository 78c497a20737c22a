"""The operators' tracing (``dwarf_bench_tpu_torch/ops/trace.py``) on the
CPU: no span is entered while no profiler records; under a profiler each
branch of ``sort_auto``, ``filter_sparse`` and ``groupby_sum``, and the
dense join's ``build_dense`` and ``probe_dense``, opens its phases' spans,
the reads' and the kernel wrappers' nested inside its operator's span (on
the CPU a wrapper's span holds its plain twin); ``READS`` counts each read
back to the host and ``TAKEN`` each branch and each CSR index built; and
the outputs are the same with the profiler on and off. The file imports no
JAX, so it also runs where torch is not the CPU build's:

    python -m pytest tests/test_torch_trace.py --noconftest -q
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from dwarf_bench_tpu_torch.ops import (  # noqa: E402
    csr_join, groupby, hist_cuda, scan, sort, trace)

ROOT = "bm.dispatch"  # the benchmark's span around an operator call


def _column(lo: int, hi: int, n: int = 4096) -> torch.Tensor:
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(lo, hi, n, dtype=np.int32))


def _keys_vals(groups: int, n: int = 4096):
    rng = np.random.default_rng(11)
    keys = rng.integers(0, groups, n, dtype=np.int32)
    vals = rng.integers(1, 10001, n, dtype=np.int32)
    return torch.from_numpy(keys), torch.from_numpy(vals)


def _groupby(groups: int, **kw):
    return lambda: groupby.groupby_sum(*_keys_vals(groups), groups, **kw)


def _dense_join():
    """The join cells' call: (found, pos, counts, id_buffer)."""
    t = csr_join.build_dense(_column(1, 10001))
    r = csr_join.probe_dense(t, _column(1, 12001, 2048), hi_rows=128)
    return r.found, r.pos, r.counts, t.id_buffer


# each branch: (call, spans it opens with each one's parent)
SORT_COUNTING = {
    "sort_auto": ROOT,
    "sort_auto.span": "sort_auto",
    "read.sort_auto.max": "sort_auto.span",
    "read.sort_auto.min": "sort_auto.span",
    "sort_auto.histogram": "sort_auto",
    "kernel.histogram": "sort_auto.histogram",
    "sort_auto.expand": "sort_auto",
    "kernel.expand_runs": "sort_auto.expand",
}
PHASE_A_TAIL_CAPS = {
    "filter_sparse": ROOT,
    "filter_sparse.phase_a": "filter_sparse",
    # on the CPU the plain phase A: no ``kernel.cumsum`` inside (the card's
    # chunk_stats launches cumsum's wrapper)
    "kernel.chunk_stats": "filter_sparse.phase_a",
    "filter_sparse.tail": "filter_sparse",
    "kernel.scan_tail_streams": "filter_sparse.tail",
    "filter_sparse.caps": "filter_sparse",
    "read.filter_sparse.caps": "filter_sparse.caps",
}
BRANCHES = {
    "sort_hi80": (lambda: sort.sort_auto(_column(1, 10001)), SORT_COUNTING),
    "sort_hi128": (lambda: sort.sort_auto(_column(0, 12000)), SORT_COUNTING),
    "sort_torch.sort": (lambda: sort.sort_auto(_column(0, 1 << 20)), {
        "sort_auto": ROOT,
        "sort_auto.span": "sort_auto",
        "read.sort_auto.max": "sort_auto.span",
        "read.sort_auto.min": "sort_auto.span",
        "sort_auto.torch_sort": "sort_auto",
    }),
    "filter_sparse": (lambda: scan.filter_sparse(_column(1, 10001, 1 << 16)), {
        **PHASE_A_TAIL_CAPS,
        "filter_sparse.phase_b": "filter_sparse",
        "kernel.compact_mask": "filter_sparse.phase_b",
        "filter_sparse.order": "filter_sparse",
        "filter_sparse.emit": "filter_sparse",
        "kernel.emit_prefix": "filter_sparse.emit",
    }),
    # a multi-match chunk with cap_mc = 0: the cap trips after the read
    "filter_cap_tripped": (
        lambda: scan.filter_sparse(torch.arange(1000, dtype=torch.int32), 5,
                                   cap_mc=0), {
            **PHASE_A_TAIL_CAPS,
            "filter_sparse.general": "filter_sparse",
            "kernel.filter": "filter_sparse.general",
        }),
    # not int32: the general engine (``filter_two_pass`` on the CPU) at once
    "filter_int64": (
        lambda: scan.filter_sparse(torch.arange(1000, dtype=torch.int64), 5), {
            "filter_sparse": ROOT,
            "filter_sparse.general": "filter_sparse",
        }),
    "groupby_small": (_groupby(64), {
        "groupby_sum": ROOT,
        "kernel.groupby_small": "groupby_sum",
    }),
    "groupby_2level": (_groupby(1 << 16, vals_below_2p14=True), {
        "groupby_sum": ROOT,
        "kernel.weighted_histogram": "groupby_sum",
    }),
    # eager ops (a sort and cumsum differences): no wrapper's span
    "groupby_sorted": (_groupby(1 << 16), {"groupby_sum": ROOT}),
    # the build's phases, then the probe's eager gathers
    "dense_join": (_dense_join, {
        "build_dense": ROOT,
        "build_dense.histogram": "build_dense",
        "kernel.histogram": "build_dense.histogram",
        "build_dense.positions": "build_dense",
        "build_dense.id_sort": "build_dense",
        "build_dense.layouts": "build_dense",
        "probe_dense": ROOT,
    }),
}
# the round-2 path: the same phases, its own kernels
STATS_PALLAS_PHASES = {"filter_sparse", "filter_sparse.phase_a",
                       "filter_sparse.tail", "filter_sparse.caps",
                       "read.filter_sparse.caps", "filter_sparse.phase_b",
                       "filter_sparse.order", "filter_sparse.emit"}


def _spans(prof, tmp_path) -> dict:
    """{name: set of its parents' names} of the profiler's annotations."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
                   key=lambda s: (s[0], -s[1]))
    parents: dict = {}
    stack: list = []
    for a, b, name in spans:
        while stack and stack[-1][1] <= a:
            stack.pop()
        parents.setdefault(name, set()).add(stack[-1][2] if stack else None)
        stack.append((a, b, name))
    return parents


def _traced(call, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(ROOT):
            out = call()
    return out, _spans(prof, tmp_path)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_branch_opens_its_spans_nested(branch, tmp_path):
    call, expected = BRANCHES[branch]
    _, got = _traced(call, tmp_path)
    got.pop(ROOT)
    assert got == {name: {parent} for name, parent in expected.items()}


@pytest.mark.parametrize("stats_pallas", [False, True])
def test_stats_pallas_path_has_the_same_phases(stats_pallas, tmp_path):
    x = _column(1, 10001, 1 << 16)
    _, got = _traced(lambda: scan.filter_sparse(
        x, stats_pallas=stats_pallas), tmp_path)
    phases = {n for n in got if not n.startswith("kernel.")} - {ROOT}
    assert phases == STATS_PALLAS_PHASES
    assert got["filter_sparse"] == {ROOT}
    assert got["read.filter_sparse.caps"] == {"filter_sparse.caps"}
    assert all(got[p] == {"filter_sparse"} for p in phases
               if p.startswith("filter_sparse."))


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_no_span_is_entered_without_a_profiler(branch, monkeypatch):
    calls = []

    def counting(name):
        calls.append(name)
        return record_function(name)

    monkeypatch.setattr(trace, "record_function", counting)
    BRANCHES[branch][0]()
    assert calls == []
    # the same factory is the one a recording profiler enters
    with profile(activities=[ProfilerActivity.CPU]):
        BRANCHES[branch][0]()
    assert set(calls) == set(BRANCHES[branch][1]) - {ROOT}


def test_both_profiler_entry_points_set_the_flag():
    assert trace.begin("x") is None  # no span, nothing entered
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        sp = trace.begin("x")
        assert isinstance(sp, trace.Spans)
        sp.close()
    finally:
        prof.stop()
    assert trace.begin("x") is None
    with profile(activities=[ProfilerActivity.CPU]):
        sp = trace.begin("x")
        assert isinstance(sp, trace.Spans)
        sp.close()
    assert trace.begin("x") is None


@pytest.mark.parametrize("call, reads", [
    (lambda: sort.sort_auto(_column(1, 10001)),
     {"sort_auto.max": 1, "sort_auto.min": 1}),
    (lambda: sort.sort_auto(_column(0, 1 << 20)),
     {"sort_auto.max": 1, "sort_auto.min": 1}),
    (lambda: sort.sort_auto(torch.empty(0, dtype=torch.int32)), {}),
    (lambda: scan.filter_sparse(_column(1, 10001, 1 << 16)),
     {"filter_sparse.caps": 1}),
    (lambda: scan.filter_sparse(torch.arange(1000, dtype=torch.int32), 5,
                                cap_mc=0), {"filter_sparse.caps": 1}),
    (lambda: scan.filter_sparse(_column(1, 10001, 1 << 16),
                                assume_sparse=True), {}),
    (lambda: scan.filter_sparse(_column(1, 10001), -(2**31) + 100), {}),
    (lambda: scan.filter_sparse(torch.arange(1000, dtype=torch.int64), 5), {}),
    (_groupby(64), {}),
    (_groupby(1 << 16, vals_below_2p14=True), {}),
    (_groupby(1 << 16), {}),
    (_dense_join, {}),
], ids=["sort_hi80", "sort_torch.sort", "sort_empty", "filter_checked",
        "filter_cap_tripped", "filter_assume_sparse", "filter_int32_min",
        "filter_int64", "groupby_small", "groupby_2level", "groupby_sorted",
        "dense_join"])
def test_reads_counted_as_documented(call, reads):
    before = dict(trace.READS)
    call()
    after = {k: v - before.get(k, 0) for k, v in trace.READS.items()
             if v != before.get(k, 0)}
    assert after == reads


def test_read_returns_python_scalars():
    assert trace.read(torch.tensor(7, dtype=torch.int32), "t.int") == 7
    assert type(trace.read(torch.tensor(7, dtype=torch.int32), "t.int")) \
        is int
    assert trace.read(torch.tensor(True), "t.bool") is True


def _flat(out):
    parts = out if isinstance(out, tuple) else (out,)
    return [p.clone() for p in parts]


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_outputs_identical_with_profiler_on_and_off(branch, tmp_path):
    call = BRANCHES[branch][0]
    off = _flat(call())
    on, _ = _traced(call, tmp_path)
    on = _flat(on)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("groups, flag, branch", [
    (64, False, "small"),
    (4096, True, "small"),
    (1 << 16, True, "2level"),
    (1 << 16, False, "sorted"),
    ((1 << 16) + 1, True, "sorted"),
])
def test_groupby_branch_counted(groups, flag, branch):
    before = dict(trace.TAKEN)
    groupby.groupby_sum(*_keys_vals(groups), groups, vals_below_2p14=flag)
    after = {k: v - before.get(k, 0) for k, v in trace.TAKEN.items()
             if v != before.get(k, 0)}
    assert after == {f"groupby_sum:{branch}": 1}


def test_weighted_histogram_span_alone_holds_its_twin(tmp_path):
    """The wrapper opens its span when called outside an operator too."""
    keys, vals = _keys_vals(1 << 16)
    _, got = _traced(lambda: hist_cuda.weighted_histogram(keys, vals, 512),
                     tmp_path)
    got.pop(ROOT)
    assert got == {"kernel.weighted_histogram": {ROOT}}


@pytest.mark.parametrize("index", ["dense", "general"])
def test_csr_join_index_counted_once_a_build(index):
    keys = _column(1, 10001)
    before = dict(trace.TAKEN)
    if index == "dense":
        t = csr_join.build_dense(keys)
        csr_join.probe_dense(t, keys, hi_rows=128)
    else:
        t = csr_join.build(keys, 10000, 20000)
        csr_join.probe(t, keys)
    after = {k: v - before.get(k, 0) for k, v in trace.TAKEN.items()
             if v != before.get(k, 0)}
    assert after == {f"csr_join:{index}": 1}


def test_dense_join_phases_in_order(tmp_path):
    """The build's phases open one after another inside its span, in the
    order of its work, and the probe's span follows the build's."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _dense_join()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    order = [e["name"] for e in sorted(
        (e for e in events if e.get("cat") == "user_annotation"
         and e.get("ph") == "X" and not e["name"].startswith("kernel.")),
        key=lambda e: float(e["ts"]))]
    assert order == ["build_dense", "build_dense.histogram",
                     "build_dense.positions", "build_dense.id_sort",
                     "build_dense.layouts", "probe_dense"]
