"""Bitonic merge: CUDA kernel (``csrc/bitonic.cu``) and its plain PyTorch
twin (``ops/bitonic.py``).

The contract of ``dwarf_bench_tpu/ops/bitonic_pallas.py``
``merge_bitonic_pallas``: sort a bitonic sequence of N = 2^k rows of 2-4
int32 bit-pattern columns ascending under the unsigned lexicographic order
of (col0[, col1]); the kernel runs the same network as the twin, so the two
agree bit for bit on every input, ties included. A wrapper takes the twin
only for a CPU tensor; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .bitonic import merge_bitonic as merge_bitonic_plain

__all__ = ["merge_bitonic", "merge_bitonic_plain"]


def _check(cols, num_cmp: int):
    cols = tuple(cols)
    if not 2 <= len(cols) <= 4:
        raise ValueError(f"merge_bitonic: 2-4 columns, got {len(cols)}")
    if num_cmp not in (1, 2):
        raise ValueError(f"merge_bitonic: num_cmp {num_cmp} is not 1 or 2")
    device = _build.check_vectors("merge_bitonic", *cols)
    n = cols[0].numel()
    if any(c.numel() != n for c in cols):
        raise ValueError("merge_bitonic: columns of different lengths")
    if n & (n - 1):
        raise ValueError(f"merge_bitonic: length {n} is not a power of two")
    return cols, device, n


def merge_bitonic(cols, num_cmp: int = 2):
    cols, device, n = _check(cols, num_cmp)
    if device.type == "cpu":
        return merge_bitonic_plain(cols, num_cmp)
    outs = [torch.empty_like(c) for c in cols]
    pad = [None] * (4 - len(cols))
    _build.launch("dbt_merge_bitonic", device,
                  *[c.data_ptr() for c in cols], *pad,
                  *[o.data_ptr() for o in outs], *pad,
                  len(cols), n, num_cmp)
    _build.LAUNCHES["merge_bitonic"] += 1
    return tuple(outs)
