"""BENCHMARK.json against the benchmark's contract, and every part of a
cell found by its name."""

from __future__ import annotations

import json
import re

import pytest

from bm_util import ROOT, WORKLOADS
from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
SPEC = spec.load_spec()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    files = [w for w in SPEC["command"] if "/" in w]
    assert all(any(f.startswith(p + "/") for p in SPEC["paths"]) for f in files)


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        body = spec.load_config(SPEC, c["name"])
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert (ROOT / body["reference"]).is_file()


def test_workloads():
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert _line(m["layer"])
        layers.setdefault(m["layer"], []).append(m["name"])
        assert (ROOT / "benchmark" / "metrics"
                / f"{spec.base(m['name'])}.py").is_file()
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in WORKLOADS


def test_perf_md_names_every_layer():
    text = (ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert f"| {m['layer']} |" in text


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.chips == 1
    assert hasattr(cell.kind, "program") and hasattr(cell.kind, "compare")
    assert cell.kind.LIMITS and all(v == 0 for v in cell.kind.LIMITS.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert {"query_ms_p95", "query_mem_gib", "setup_s"} <= e2e
    # a per-layer metric moves an end-to-end metric that its cell reports
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (m in cell.end_to_end + cell.per_layer) == (
            workload in m.get("workloads", [workload]))
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    assert int(cell.traffic["checked"]) >= 1


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.load_cell("no_such.cell")
    with pytest.raises(KeyError):
        spec.load_config(SPEC, "no_such_config")
    with pytest.raises(FileNotFoundError):
        spec.load_traffic("no_such_mix")


def test_traffic_files_are_data():
    for w in SPEC["workloads"]:
        path = ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
        body = json.loads(path.read_text())
        assert body["columns"] in ("in_turn", "random")
        assert body["lengths"]


def test_a_bound_class_reads_its_base_quantity():
    assert spec.base("rows_per_s.device_bound") == "rows_per_s"
    assert spec.base("setup_s") == "setup_s"
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for name, m in e2e.items():
        if name != spec.base(name):
            # the same reading as its base, under a bound of its own
            assert spec.base(name) in e2e and m["workloads"]
            assert m["unit"] == e2e[spec.base(name)]["unit"]
            assert m["better"] == e2e[spec.base(name)]["better"]
