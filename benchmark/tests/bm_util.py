"""Helpers of the benchmark's tests: the repository's root on the import
path, and cells cut to a size a CPU test can hold."""

from __future__ import annotations

import copy
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import spec  # noqa: E402

WORKLOADS = [w["name"] for w in spec.load_spec()["workloads"]]


def small_cell(workload: str, rows: int = 1 << 16, columns: int = 3):
    """``workload`` with its table cut to ``columns`` x ``rows`` and every
    length of its mix that does not fit cut to a quarter column."""
    cell = spec.load_cell(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["table"].update(rows=rows, columns=columns)
    lengths = [n if n == "column" or int(n) <= rows else rows // 4
               for n in cell.traffic["lengths"]]
    cell.traffic = dict(cell.traffic, lengths=lengths)
    return cell
