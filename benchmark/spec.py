"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
# top-level module names that may not be loaded in the benchmark's process
FORBIDDEN = ("jax", "jaxlib", "flax", "dwarf_bench_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole: ``dwarf_bench_tpu_torch`` is not
    ``dwarf_bench_tpu``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_spec(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(spec: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            return load_json(root / entry["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def query_kind(name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.queries.{name}")


def base(name: str) -> str:
    """The quantity a metric's name reads: the part before the first dot.
    ``rows_per_s.device_bound`` is ``rows_per_s`` under another bound, in
    the cells its ``workloads`` key lists."""
    return name.split(".")[0]


def metric_reader(name: str) -> ModuleType:
    """``metrics/<base>.py``, loaded by its path (a name may hold ``-``)."""
    name = base(name)
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('-', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, workload: str) -> bool:
    """A metric with a ``workloads`` key is reported in those cells only."""
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    kind: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(workload: str, spec: Optional[dict] = None,
              root: pathlib.Path = ROOT) -> Cell:
    spec = load_spec(root) if spec is None else spec
    for w in spec["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = load_config(spec, w["config"], root)
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=load_traffic(w["traffic"]),
        kind=query_kind(config["query"]),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
    )
