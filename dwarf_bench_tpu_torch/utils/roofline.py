"""Per-operator roofline accounting (the port of
``dwarf_bench_tpu/utils/roofline.py``): rows/s per card and the share of
the device-memory bandwidth roofline per operator.

``BYTES_PER_ROW`` is the JAX package's table as is: the least device-memory
traffic an ideal implementation must move a row. The bandwidth comes from
the card's name (``torch.cuda.get_device_name``), from its published
device-memory rate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

# Minimum bytes of device-memory traffic per input row (uint32 columns).
BYTES_PER_ROW: Dict[str, float] = {
    # read the column once; write ≈ selectivity · 4B (≈0 at x<5 over
    # [1,10000], 2B at selectivity 0.5 — use the read-dominated bound)
    "scan": 4.0,
    # 4 LSD radix passes over 32-bit keys: 4 × (read+write) × 4B
    "radix": 32.0,
    # read key+val once; dense output negligible
    "groupby": 8.0,
    # same traffic model at G = 2^16 distinct keys (the BASELINE.json
    # GroupBy config); kept separate so the bench reports both configs
    "groupby_big": 8.0,
    # build: sort of (key,id) ≈ 4 passes × 8B r+w ≈ 64B; probe: read 4B +
    # table traffic ≈ 4B
    "join": 72.0,
    # read once, write scalar
    "reduce": 4.0,
}

# The JAX package's ACHIEVABLE_ROWS_PER_S holds walls measured on a TPU
# v5e (vector-unit, matrix-unit and bandwidth limits of that chip), which
# say nothing about this card. No walls have been derived for the H100 yet,
# so the table is empty and the bench reports no fraction of it.
ACHIEVABLE_ROWS_PER_S: Dict[str, float] = {}

HBM_BW: Dict[str, float] = {  # bytes/s a card, published device-memory rates
    "H100 80GB HBM3": 3.35e12,  # H100 SXM5
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
}

DEFAULT_CPU_BW = 5e10


def hbm_bandwidth(name: str) -> float:
    """Device-memory bytes/s of the card named ``name`` (as
    ``torch.cuda.get_device_name`` gives it). An unknown card raises: a
    roofline share against a guessed rate would be a made-up number."""
    for key, bw in HBM_BW.items():
        if key.lower() in name.lower():
            return bw
    raise ValueError(f"no device-memory bandwidth known for the card "
                     f"{name!r}; add it to utils/roofline.HBM_BW")


def device_bandwidth(device=None) -> float:
    """Bytes/s of ``device``: ``hbm_bandwidth`` of a CUDA card (the current
    one when ``device`` is None), ``DEFAULT_CPU_BW`` for the CPU."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cpu":
        return DEFAULT_CPU_BW
    return hbm_bandwidth(torch.cuda.get_device_name(dev))


@dataclass
class OpReport:
    op: str
    rows: int
    seconds: float
    rows_per_s: float
    bytes_per_row: float
    bw_roofline_rows_per_s: float
    roofline_frac: float

    def as_dict(self) -> dict:
        return {
            "op": self.op,
            "rows": self.rows,
            "seconds": self.seconds,
            "rows_per_s": round(self.rows_per_s),
            "bw_roofline_rows_per_s": round(self.bw_roofline_rows_per_s),
            "roofline_frac": round(self.roofline_frac, 4),
        }


def report(op: str, rows: int, seconds: float,
           device=None, bytes_per_row: Optional[float] = None) -> OpReport:
    bpr = bytes_per_row if bytes_per_row is not None else BYTES_PER_ROW[op]
    bw = device_bandwidth(device)
    rps = rows / seconds if seconds > 0 else float("inf")
    sol = bw / bpr
    return OpReport(op, rows, seconds, rps, bpr, sol, rps / sol)


def scaling_efficiency(rows_per_s_by_n: Dict[int, float]) -> Dict[int, float]:
    """rows/s scaling efficiency relative to the smallest mesh
    (BASELINE.json: ≥80% at 1 chip → N)."""
    base_n = min(rows_per_s_by_n)
    base = rows_per_s_by_n[base_n]
    return {
        n: (v / base) * (base_n / n)
        for n, v in sorted(rows_per_s_by_n.items())
    }
