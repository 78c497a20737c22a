"""Distribution ``uniform``: int32 values uniform in [low, high], as the
reference's ``make_random`` draws them, in one call on the card."""

from __future__ import annotations

import torch


def draw(spec: dict, g: torch.Generator, device: torch.device) -> torch.Tensor:
    if spec["dtype"] != "int32":
        raise ValueError(f"table dtype {spec['dtype']!r}")
    return torch.randint(int(spec["low"]), int(spec["high"]) + 1,
                         (int(spec["columns"]), int(spec["rows"])),
                         generator=g, device=device, dtype=torch.int32)
