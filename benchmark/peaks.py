"""Published memory bandwidth of the cards the benchmark knows, by the name
``torch.cuda.get_device_name`` gives (NVIDIA's data sheets, at the full
power limit)."""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM5
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def hbm_bytes_per_s(device_name: str) -> Optional[float]:
    """None for a card not in the table: no roofline is read for it."""
    return HBM_BYTES_PER_S.get(device_name)
