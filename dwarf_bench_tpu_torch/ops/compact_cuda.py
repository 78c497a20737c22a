"""Mask compaction and the prefix emit: CUDA kernels (``csrc/compact.cu``)
and their plain PyTorch twins.

``compact_mask`` is the contract of ``dwarf_bench_tpu/ops/compact_pallas.py``
``compact_mask_pallas``: copy_if of 1-3 int32 columns by one mask, keeping
order, into ``capacity`` slots (default the column length); returns
``(tuple_of_outs, count)`` with garbage past ``count`` and ``count`` the full
number of selected rows, a 0-d int32 tensor on the columns' device. The mask
is a bool tensor.

``emit_prefix`` is the contract of ``emit_prefix_pallas``: ``vals``
(L <= capacity) in slots [0, L) of a (capacity,) int32 buffer whose other
slots are left uninitialised (garbage past the caller's count).

A wrapper takes the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import _build
from .primitives import compact_multi


def _check_mask(mask: torch.Tensor, n: int, device: torch.device) -> None:
    if not isinstance(mask, torch.Tensor) or mask.dim() != 1:
        raise ValueError("compact_mask: the mask must be a 1-D tensor")
    if mask.numel() != n or mask.device != device:
        raise ValueError(
            f"compact_mask: mask of {mask.numel()} rows on {mask.device}, "
            f"columns of {n} rows on {device}"
        )
    if mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError(f"compact_mask: the mask must be a contiguous bool "
                         f"tensor, got {mask.dtype}")


def _check_cols(cols: Sequence[torch.Tensor]):
    cols = tuple(cols)
    if not 1 <= len(cols) <= 3:
        raise ValueError(f"compact_mask: 1-3 columns, got {len(cols)}")
    device = _build.check_vectors("compact_mask", *cols)
    n = cols[0].numel()
    if any(c.numel() != n for c in cols):
        raise ValueError("compact_mask: columns of different lengths")
    return cols, device, n


def compact_mask_plain(mask: torch.Tensor, cols: Sequence[torch.Tensor],
                       capacity: Optional[int] = None):
    return compact_multi(tuple(cols), mask, capacity)


def compact_mask(mask: torch.Tensor, cols: Sequence[torch.Tensor],
                 capacity: Optional[int] = None):
    cols, device, n = _check_cols(cols)
    _check_mask(mask, n, device)
    cap = _build.check_capacity("compact_mask", capacity, n)
    if device.type == "cpu":
        return compact_mask_plain(mask, cols, cap)
    outs = [torch.empty(cap, dtype=torch.int32, device=device) for _ in cols]
    count = torch.empty(1, dtype=torch.int32, device=device)
    scratch = _build.compact_scratch(n, 1, device)
    col_ptrs = [c.data_ptr() for c in cols] + [None] * (3 - len(cols))
    out_ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(cols))
    _build.launch("dbt_compact_mask", device, mask.data_ptr(), *col_ptrs,
                  len(cols), n, *out_ptrs, cap, count.data_ptr(),
                  scratch.data_ptr())
    _build.LAUNCHES["compact_mask"] += 1
    return tuple(outs), count[0]


def _check_emit(vals: torch.Tensor, capacity: int):
    device = _build.check_vectors("emit_prefix", vals)
    if vals.numel() > capacity:
        raise ValueError(f"emit_prefix: {vals.numel()} values exceed "
                         f"capacity {capacity}")
    return device


def emit_prefix_plain(vals: torch.Tensor, capacity: int) -> torch.Tensor:
    _check_emit(vals, capacity)
    out = torch.zeros(capacity, dtype=torch.int32, device=vals.device)
    out[: vals.numel()] = vals
    return out


def emit_prefix(vals: torch.Tensor, capacity: int) -> torch.Tensor:
    device = _check_emit(vals, capacity)
    if device.type == "cpu":
        return emit_prefix_plain(vals, capacity)
    out = torch.empty(capacity, dtype=torch.int32, device=device)
    _build.launch("dbt_emit_prefix", device, vals.data_ptr(), vals.numel(),
                  out.data_ptr())
    _build.LAUNCHES["emit_prefix"] += 1
    return out
