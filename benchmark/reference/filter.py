"""Plain reference of the ``filter`` query: the rows of an int32 range
below a threshold, in input order (``std::copy_if``), and their count. It
imports nothing of the program.

``control`` is the reference with one guarantee of the configuration
broken: the kept rows come out ordered by value, as a compaction that skips
its ordering step could leave them, with the right count, in an output of
the program's capacity (the input's rows). It stands in the program's place
to show that the comparison fails it.
"""

from __future__ import annotations

import torch


def expected(x: torch.Tensor, params: dict) -> torch.Tensor:
    return x[x < int(params["threshold"])]


def control(x: torch.Tensor, params: dict):
    kept = torch.sort(expected(x, params), stable=True).values
    out = torch.zeros_like(x)
    out[:kept.numel()] = kept
    return out, torch.tensor(kept.numel(), dtype=torch.int32, device=x.device)
