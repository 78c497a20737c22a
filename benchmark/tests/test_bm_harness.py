"""A run of each cell without the look for a card, on the CPU at a small
size: the last line's shape, the port judged correct, and ``correct`` false
for the control in the port's place and for each fault a cell can have
planted under the timed path. ``run.py`` itself exits non-zero here, with no
card."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest
import torch

from bm_util import ROOT, WORKLOADS, small_cell
from benchmark import harness, spec

CPU = torch.device("cpu")
SEED = 2**31 + 99  # seeds past 32 bits are allowed


def run(cell, program=None, trace=False, seconds=0.2):
    result, errors = harness.run_cell(cell, SEED, seconds, trace, CPU,
                                      program=program)
    return result, errors


def port(cell):
    return cell.kind.program(cell.traffic.get("params", {}))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_line_shape_and_port_correct(workload):
    cell = small_cell(workload)
    result, errors = run(cell)
    assert errors == [] and result["correct"] is True
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {"query_ms_p95", "query_mem_gib", "setup_s"} <= set(
        result["metrics"])
    for name, m in result["metrics"].items():  # a bound's class, one reading
        assert m["value"] == result["metrics"][spec.base(name)]["value"]
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for name, c in result["checks"].items():
        assert c == {"value": 0, "limit": 0}, name
    json.dumps(result)


def test_traced_line_on_the_cpu_reports_no_device_metric():
    result, _ = run(small_cell("radix_u10k.small_grid"), trace=True,
                    seconds=1.5)
    # the host clock's metric only: a CPU run reads no device trace
    assert set(result["metrics"]) == {"dispatch_ms"}
    assert "busy_s" not in result["device"] and "breakdown" not in result
    assert result["correct"] is True


def test_traced_line_reads_the_rate_before_the_profiled_stretch():
    cell = small_cell("dplscan_u10k.lt5000_2p20")
    result, _ = run(cell, trace=True, seconds=1.5)
    assert set(result["metrics"]) == {"dispatch_ms", "host_rows_per_s"}
    assert result["metrics"]["host_rows_per_s"]["value"] > 0
    assert result["correct"] is True
    # a window no longer than the profiled stretch leaves it out
    result, _ = run(cell, trace=True, seconds=0.2)
    assert "host_rows_per_s" not in result["metrics"]


def sort_faults(real):
    def unchanged(x):
        return x.clone()

    def half(x):
        h = x.numel() // 2
        return torch.cat([real(x[:h]), x[h:]])

    def altered(x):
        out = real(x).clone()
        out[out.numel() // 3] += 1
        return out

    return {"unchanged": unchanged, "half": half, "altered": altered}


def filter_faults(real):
    def unchanged(x):
        return x.clone(), torch.tensor(x.numel(), dtype=torch.int32)

    def half(x):
        out, count = real(x[: x.numel() // 2])
        full = torch.zeros(x.numel(), dtype=x.dtype)
        full[:out.numel()] = out
        return full, count

    def altered(x):
        out, count = real(x)
        out = out.clone()
        out[int(count) // 2] += 1
        return out, count

    return {"unchanged": unchanged, "half": half, "altered": altered}


FAULTS = {"sort": sort_faults, "filter": filter_faults}
CASES = [(w, f) for w in WORKLOADS for f in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_under_the_timed_path_is_not_correct(workload, fault):
    cell = small_cell(workload)
    faulty = FAULTS[cell.config["query"]](port(cell))[fault]
    result, _ = run(cell, program=faulty)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_in_the_ports_place_is_not_correct(workload):
    cell = small_cell(workload)
    control = cell.kind.control(cell.traffic.get("params", {}))
    result, _ = run(cell, program=control)
    assert result["correct"] is False


def test_a_query_that_raises_in_the_window_is_failed():
    cell = small_cell("radix_u10k.col_2p27")
    real, calls = port(cell), []

    def broken(x):  # the warm-up's two calls pass, every third call raises
        calls.append(1)
        if len(calls) > 2 and len(calls) % 3 == 0:
            raise RuntimeError("no")
        return real(x)

    result, errors = run(cell, program=broken)
    assert result["correct"] is False and result["failed"] > 0
    assert errors and "RuntimeError" in errors[0]


def test_run_py_exits_non_zero_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "radix_u10k.col_2p27", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def _toy_groupby(monkeypatch):
    """A group-by kind and a skewed distribution, as a later cell would add
    them in files of their own (``queries/toy_groupby.py``,
    ``data/hot_key.py``): a key table and a value table, both resident, and
    a query that sums the values of one range by key."""
    hot = types.ModuleType("benchmark.data.hot_key")

    def draw(spec, g, device):
        shape = (int(spec["columns"]), int(spec["rows"]))
        keys = torch.randint(0, int(spec["keys"]), shape, generator=g,
                             device=device, dtype=torch.int32)
        hot_rows = torch.rand(shape, generator=g, device=device) < spec["hot"]
        return torch.where(hot_rows, torch.zeros_like(keys), keys)

    hot.draw = draw
    kind = types.ModuleType("benchmark.queries.toy_groupby")
    kind.LIMITS = {"wrong_sums": 0}

    def make_inputs(config, seed, device):
        from benchmark import data

        g = data.generator(seed, device)
        return {"keys": data.draw(config["table"], g, device),
                "vals": data.draw(config["values"], g, device)}

    def args(inputs, query):
        col, off, n = query
        return (inputs["keys"][col, off:off + n],
                inputs["vals"][col, off:off + n])

    def program(params):
        g = int(params["groups"])
        return lambda k, v: torch.zeros(g, dtype=torch.int64).index_add_(
            0, k.long(), v.long())

    def compare(out, args, params):
        k, v = args
        ref = [0] * int(params["groups"])
        for key, val in zip(k.tolist(), v.tolist()):
            ref[key] += val
        return {"wrong_sums": sum(a != b for a, b in zip(out.tolist(), ref))}

    kind.make_inputs, kind.args, kind.program = make_inputs, args, program
    kind.compare, kind.written = compare, lambda out: 0
    monkeypatch.setitem(sys.modules, "benchmark.data.hot_key", hot)
    monkeypatch.setitem(sys.modules, "benchmark.queries.toy_groupby", kind)
    config = {"query": "toy_groupby",
              "table": {"dist": "hot_key", "columns": 2, "rows": 4096,
                        "keys": 64, "hot": 0.55},
              "values": {"dist": "uniform", "columns": 2, "rows": 4096,
                         "dtype": "int32", "low": 1, "high": 10000}}
    traffic = {"params": {"groups": 64}, "lengths": [512, "column"],
               "columns": "random", "offset_align": 256, "checked": 8}
    e2e = spec.load_spec()["end_to_end"]
    return spec.Cell(name="toy.skew", chips=1, config=config, traffic=traffic,
                     kind=spec.query_kind("toy_groupby"),
                     end_to_end=[m for m in e2e if "workloads" not in m],
                     per_layer=[])


def test_a_kind_with_two_inputs_and_skewed_keys_needs_no_harness_edit(
        monkeypatch):
    cell = _toy_groupby(monkeypatch)
    result, errors = run(cell)
    assert errors == [] and result["correct"] is True
    assert result["checks"] == {"wrong_sums": {"value": 0, "limit": 0}}
    real = cell.kind.program(cell.traffic["params"])
    result, _ = run(cell, program=lambda k, v: real(k, v) + (k.numel() > 0))
    assert result["correct"] is False
