"""On the card (``-m gpu``; skipped without one): the port judged correct
and the control not, for each cell at a column of 2^22 rows, and one short
run of ``run.py`` end to end with its traced line.

    python -m pytest benchmark/tests/test_bm_gpu.py -m gpu -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bm_util import ROOT, WORKLOADS, small_cell
from benchmark import harness

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_correct_and_control_not_on_the_card(card, workload):
    cell = small_cell(workload, rows=1 << 22, columns=2)
    result, errors = harness.run_cell(cell, 2**31 + 5, 0.5, False, card)
    assert errors == [] and result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]["query_mem_gib"]["value"] > 0
    control = cell.kind.control(cell.traffic.get("params", {}))
    result, _ = harness.run_cell(cell, 2**31 + 6, 0.5, False, card,
                                 program=control)
    assert result["correct"] is False


@pytest.mark.parametrize("trace", [0, 1])
def test_run_py_on_the_card(card, trace):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "dplscan_u10k.lt5000_2p20", "--seed", "3000000019", "--seconds",
         "2", "--trace", str(trace)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert set(line["metrics"]) == {
            "dispatch_ms", "host_reads_per_query", "kernels_per_query",
            "query_roofline", "device_idle_frac", "host_rows_per_s"}
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert 0 < line["metrics"]["query_roofline"]["value"] <= 100
        assert line["breakdown"]["device_ops"]
    else:
        assert set(line["metrics"]) == {"query_ms_p95", "query_mem_gib",
                                        "setup_s"}
