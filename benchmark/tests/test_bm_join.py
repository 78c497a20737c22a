"""The ``join`` query kind on the CPU: its plain reference against views
worked by hand, ``compare`` and ``LIMITS`` passing the port and failing the
control and each fault a cell can have planted under the timed path (a
count off by one, a flipped ``found``, two ids swapped across keys, an
``id_buffer`` that is not a permutation), the inputs drawn from the seed,
the bytes a query needs, and the readers ``join_build_ms`` and
``join_probe_ms`` on a trace worked by hand (microseconds)."""

from __future__ import annotations

import pytest
import torch

from bm_util import small_cell
from benchmark import harness, spans, spec
from benchmark.harness import TracedRun
from benchmark.queries import join as qjoin
from benchmark.reference import join as rjoin
from benchmark.work import join as wjoin

CPU = torch.device("cpu")
SEED = 2**31 + 99
CELL = "join_dense_u10k.col_2p27"
# the cell's whole columns, and the 2^20-row ranges at 256-row offsets of
# the port's bench.py join, whose cell is left out while its host-bound p95
# spreads wider than the bound allows
TRAFFIC = ("col_2p27", "rows_2p20")
CLEAN = {k: 0 for k in qjoin.LIMITS}


def t(values):
    return torch.tensor(values, dtype=torch.int32)


def columns(n, seed):
    g = torch.Generator().manual_seed(seed)
    build = torch.randint(1, 10001, (n,), generator=g, dtype=torch.int32)
    probe = torch.randint(1, 10001, (n,), generator=g, dtype=torch.int32)
    return build, probe


def test_reference_by_hand():
    # EMPTY build rows are padding; EMPTY probe rows are never found
    build = t([7, 3, 7, -1, 9, 3, 7])
    probe = t([7, 4, 3, -1, 9, 10, 2])
    found, pos, counts = rjoin.expected(build, probe, {})
    assert found.tolist() == [True, False, True, False, True, False, False]
    assert pos.tolist() == [2, 0, 0, 0, 5, 0, 0]
    assert counts.tolist() == [3, 0, 2, 0, 1, 0, 0]
    assert pos.dtype == counts.dtype == torch.int32
    # keys in uint32 order: -2 (0xFFFFFFFE) sorts after 9, before EMPTY
    assert rjoin.expected(t([-2, 9]), t([-2, 9]), {})[1].tolist() == [1, 0]


def test_id_buffer_faults_by_hand():
    build = t([7, 3, 7, -1, 3])
    assert rjoin.id_buffer_faults(build, t([1, 4, 0, 2, 3])) == (0, 0)
    assert rjoin.id_buffer_faults(build, t([4, 1, 2, 0, 3])) == (0, 0)
    # two ids swapped across keys: 7 before 3 once
    assert rjoin.id_buffer_faults(build, t([1, 0, 4, 2, 3])) == (0, 1)
    # a repeated id, an id out of range, a short buffer
    assert rjoin.id_buffer_faults(build, t([1, 1, 0, 2, 3])) == (1, 0)
    assert rjoin.id_buffer_faults(build, t([5, 1, 4, 0, 2])) == (1, 0)
    assert rjoin.id_buffer_faults(build, t([1, 4, 0, 2])) == (1, 0)


def test_control_rounds_keys_above_256():
    build, probe = t([256, 257, 258, 300]), t([257, 300, 256])
    found, pos, counts, id_buffer = rjoin.control(build, probe, {})
    # bfloat16 keeps 8 bits: 257 -> 256, 258 -> 258, 300 -> 300
    assert counts.tolist() == [2, 1, 2]
    assert found.dtype == torch.bool and id_buffer.dtype == torch.int32


@pytest.mark.parametrize("n", [1 << 16, 1 << 20])
def test_port_passes_and_control_fails_compare(n):
    args = columns(n, 3)
    out = qjoin.program({})(*args)
    assert qjoin.compare(out, args, {}) == CLEAN
    assert set(qjoin.LIMITS.values()) == {0}
    wrong = qjoin.compare(qjoin.control({})(*args), args, {})
    assert wrong["wrong_views"] > 0 and wrong["id_buffer_descents"] > 0


def faults(real):
    """Each fault a cell could hide, planted in the port's outputs."""

    def count_off_by_one(a, b):
        found, pos, counts, ids = real(a, b)
        counts = counts.clone()
        counts[int(torch.nonzero(found)[0])] += 1
        return found, pos, counts, ids

    def flipped_found(a, b):
        found, pos, counts, ids = real(a, b)
        found = found.clone()
        found[0] = ~found[0]
        return found, pos, counts, ids

    def ids_swapped_across_keys(a, b):
        found, pos, counts, ids = real(a, b)
        ids = ids.clone()
        ids[[0, -1]] = ids[[-1, 0]]
        return found, pos, counts, ids

    def not_a_permutation(a, b):
        found, pos, counts, ids = real(a, b)
        ids = ids.clone()
        ids[1] = ids[0]  # one key's run keeps its order, one row is lost
        return found, pos, counts, ids

    def short_views(a, b):
        found, pos, counts, ids = real(a, b)
        return found[:-1], pos[:-1], counts[:-1], ids

    return {"count_off_by_one": (count_off_by_one, "wrong_views"),
            "flipped_found": (flipped_found, "wrong_views"),
            "ids_swapped_across_keys": (ids_swapped_across_keys,
                                        "id_buffer_descents"),
            "not_a_permutation": (not_a_permutation,
                                  "id_buffer_not_permutation"),
            "short_views": (short_views, "length_diff")}


FAULTS = sorted(faults(None))


@pytest.mark.parametrize("fault", FAULTS)
def test_compare_catches_each_fault(fault):
    args = columns(4096, 4)
    faulty, check = faults(qjoin.program({}))[fault]
    got = qjoin.compare(faulty(*args), args, {})
    assert got[check] > 0
    assert all(v == 0 for k, v in got.items() if k != check)


def test_bytes_and_written():
    build, probe = columns(1000, 5)
    out = qjoin.program({})(build, probe[:600])
    assert qjoin.written(out) == 600
    assert wjoin.bytes_needed((build, probe[:600]), 600) == \
        8 * 1000 + 13 * 600


def join_cell(traffic):
    """The join cell cut to size (``small_cell``), under ``traffic``."""
    cell = small_cell(CELL)
    cell.traffic = spec.load_traffic(traffic)
    rows = int(cell.config["table"]["rows"])
    cell.traffic["lengths"] = [n if n == "column" or int(n) <= rows
                               else rows // 4
                               for n in cell.traffic["lengths"]]
    return cell


def test_inputs_from_the_seed():
    cell = small_cell(CELL, rows=4096, columns=2)
    a = qjoin.make_inputs(cell.config, SEED, CPU)
    b = qjoin.make_inputs(cell.config, SEED, CPU)
    c = qjoin.make_inputs(cell.config, SEED + 1, CPU)
    assert a["build"].shape == a["probe"].shape == (2, 4096)
    assert a["build"].dtype == a["probe"].dtype == torch.int32
    for side in ("build", "probe"):
        assert int(a[side].min()) >= 1 and int(a[side].max()) <= 10000
        assert torch.equal(a[side], b[side])
        assert not torch.equal(a[side], c[side])
    # the probe table comes from a stream of its own, not the build's draws
    g = torch.Generator().manual_seed(SEED)
    torch.randint(1, 10001, (2, 4096), generator=g, dtype=torch.int32)
    follow = torch.randint(1, 10001, (2, 4096), generator=g,
                           dtype=torch.int32)
    assert not torch.equal(a["probe"], follow)
    build, probe = qjoin.args(a, (1, 256, 512))
    assert build.numel() == probe.numel() == 512
    assert build.data_ptr() == a["build"][1, 256:].data_ptr()
    assert probe.data_ptr() == a["probe"][1, 256:].data_ptr()


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_port_correct_in_the_harness(traffic):
    cell = join_cell(traffic)
    result, errors = harness.run_cell(cell, SEED, 0.2, False, CPU)
    assert errors == [] and result["correct"] is True
    assert result["checks"] == {k: {"value": 0, "limit": 0}
                                for k in qjoin.LIMITS}


@pytest.mark.parametrize("traffic", TRAFFIC)
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_under_the_timed_path_is_not_correct(traffic, fault):
    cell = join_cell(traffic)
    faulty, check = faults(cell.kind.program({}))[fault]
    result, _ = harness.run_cell(cell, SEED, 0.2, False, CPU, program=faulty)
    assert result["correct"] is False
    assert result["checks"][check]["value"] > 0


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_control_in_the_ports_place_is_not_correct(traffic):
    cell = join_cell(traffic)
    result, _ = harness.run_cell(cell, SEED, 0.2, False, CPU,
                                 program=cell.kind.control({}))
    assert result["correct"] is False
    assert result["checks"]["wrong_views"]["value"] > 0


def ev(cat, name, ts, end, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, name="cudaLaunchKernel"):
    return ev("cuda_runtime", name, ts, ts + 1, corr)


EVENTS = [
    # query 0, left out of the reading
    ev("user_annotation", "bm.dispatch", 0, 10),
    ev("user_annotation", "bm.sync", 10, 20),
    # query 1: two kernels from the build's phases, a memset from the
    # build's own span, one kernel from the probe, one outside both
    ev("user_annotation", "bm.dispatch", 100, 160),
    ev("user_annotation", "build_dense", 101, 140),
    ev("user_annotation", "build_dense.histogram", 101, 120),
    ev("user_annotation", "kernel.histogram", 105, 115),
    launch(110, 1),
    ev("kernel", "histogram_kernel", 112, 130, 1),
    ev("user_annotation", "build_dense.id_sort", 120, 140),
    launch(125, 2),
    ev("kernel", "radix_sort", 130, 170, 2),
    launch(102, 3, "cudaMemsetAsync"),
    ev("gpu_memset", "Memset (Device)", 104, 106, 3),
    ev("user_annotation", "probe_dense", 140, 158),
    launch(145, 4),
    ev("kernel", "gather", 170, 180, 4),
    launch(159, 5),
    ev("kernel", "eager", 180, 185, 5),
    ev("user_annotation", "bm.sync", 160, 200),
    # query 2: the build alone
    ev("user_annotation", "bm.dispatch", 210, 240),
    ev("user_annotation", "build_dense", 211, 239),
    launch(215, 6),
    ev("kernel", "histogram_kernel", 220, 250, 6),
    ev("user_annotation", "bm.sync", 240, 300),
]


@pytest.mark.parametrize("name, want_us", [
    # (18 + 40 + 2) + 30 µs over 2 queries; 10 µs over 2 queries
    ("join_build_ms", 90.0), ("join_probe_ms", 10.0)])
def test_join_readers_on_a_trace_by_hand(name, want_us, monkeypatch):
    reader = spec.metric_reader(name)
    sp = spans.parse(EVENTS, skip=1)
    run = TracedRun(trace=sp.trace, calls_s=[], bytes_needed=[1, 1],
                    hbm_bytes_per_s=None)
    monkeypatch.setattr(spans, "_LAST", [run, sp])
    assert sp.n == 2
    assert reader.read(run) == pytest.approx(want_us * 1e-3 / 2)
    span = reader.SPAN
    without = spans.parse([e for e in EVENTS if e["name"] != span], 1)
    monkeypatch.setattr(spans, "_LAST", [run, without])
    assert reader.read(run) is None
    run.trace = None
    assert reader.read(run) is None
