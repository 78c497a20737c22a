"""Plain reference of the ``sort`` query: an ascending sort of an int32
range, by the library's sort. It imports nothing of the program.

``control`` is the reference with one guarantee of the configuration
broken: it sorts bfloat16 keys, so values above 256 come back rounded. It
stands in the program's place to show that the comparison fails it.
"""

from __future__ import annotations

import torch


def expected(x: torch.Tensor, params: dict) -> torch.Tensor:
    return torch.sort(x).values


def control(x: torch.Tensor, params: dict) -> torch.Tensor:
    return torch.sort(x.to(torch.bfloat16)).values.to(x.dtype)
