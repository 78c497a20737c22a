"""Bitonic merge: CUDA kernel (``csrc/bitonic.cu``) and its plain PyTorch
twin (``ops/bitonic.py``).

The contract of ``dwarf_bench_tpu/ops/bitonic_pallas.py``
``merge_bitonic_pallas``: sort a bitonic sequence of N = 2^k rows of 2-4
int32 bit-pattern columns ascending under the unsigned lexicographic order
of (col0[, col1]); the kernel runs the same network as the twin, so the two
agree bit for bit on every input, ties included. A wrapper takes the twin
only for a CPU tensor; for a CUDA tensor it launches the kernel or raises.

The kernel runs the network's stages in a few passes over tiles of 2^L rows
(``merge_plan``); each pass is one launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import _build
from .bitonic import merge_bitonic as merge_bitonic_plain

__all__ = ["merge_bitonic", "merge_bitonic_plain", "merge_plan"]

# csrc/bitonic.cu: a thread holds 2^REG_BITS rows, the 32 lanes of a warp are
# a tile's lowest LANE_BITS bits, so a tile has 2^9 to 2^12 rows (one warp to
# 256 threads) and a strided pass's run of consecutive rows is at least 2^5
# (one 128-byte line a column).
REG_BITS = 4
LANE_BITS = 5
MIN_TILE_BITS = LANE_BITS + REG_BITS
# 2^12 rows: 2^25 rows merge in 3 passes (strided passes of up to 7 bits),
# and a tile's 16 KB a column keeps 2-4 blocks of 256 threads on an SM.
TILE_BITS = 12
# The tile's rows of every column pass through shared memory once: 64 KB at
# 2^12 rows and 4 columns.
MAX_SMEM_BYTES = 64 * 1024


class MergePlan(NamedTuple):
    """The passes of one merge: ``passes`` are (lo, hi) ranges of stride
    bits, highest first; every pass but the last (lo = 0) is strided."""
    tile_bits: int
    passes: Tuple[Tuple[int, int], ...]


def merge_plan(n: int, ncols: int) -> MergePlan:
    """The passes of the kernel's merge of ``n`` rows (a power of two) of
    ``ncols`` columns (2-4) over tiles of 2^TILE_BITS rows.

    The last pass takes 2^TILE_BITS consecutive rows and every stride below
    2^TILE_BITS; the strides above are split as evenly as possible into the
    fewest strided passes of at most TILE_BITS - 5 bits each, so that every
    tile keeps a run of at least 32 consecutive rows. A merge of at most one
    tile is one pass over a tile of max(log2 n, 9) bits."""
    return _tiled_plan(n, ncols, TILE_BITS)


@functools.lru_cache(maxsize=256)
def _tiled_plan(n: int, ncols: int, tile_bits: int) -> MergePlan:
    """``merge_plan`` over tiles of at most 2^tile_bits rows; the tests take
    smaller tiles to meet every kind of pass at small n."""
    if not 2 <= ncols <= 4:
        raise ValueError(f"merge_plan: 2-4 columns, got {ncols}")
    if not MIN_TILE_BITS <= tile_bits <= TILE_BITS:
        raise ValueError(f"merge_plan: tile_bits {tile_bits} outside "
                         f"[{MIN_TILE_BITS}, {TILE_BITS}]")
    if n <= 0:
        return MergePlan(tile_bits, ())
    m = n.bit_length() - 1
    if m <= tile_bits:
        return MergePlan(max(m, MIN_TILE_BITS), ((0, m),))
    rest = m - tile_bits
    count = -(-rest // (tile_bits - LANE_BITS))
    passes, hi = [], m
    for i in range(count):
        w = rest // count + (i < rest % count)
        passes.append((hi - w, hi))
        hi -= w
    passes.append((0, tile_bits))
    return MergePlan(tile_bits, tuple(passes))


@functools.lru_cache(maxsize=256)
def _plan_words(plan: MergePlan):
    """The plan's (lo, hi) pairs as the C array ``dbt_merge_bitonic`` reads;
    kept, so a call makes no new one."""
    flat = [b for pair in plan.passes for b in pair]
    return (ctypes.c_int32 * max(len(flat), 1))(*flat)


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


def _launch(cols, device, n: int, num_cmp: int, plan: MergePlan):
    outs = [torch.empty_like(c) for c in cols]
    pad = [None] * (4 - len(cols))
    _build.launch("dbt_merge_bitonic", device,
                  *[c.data_ptr() for c in cols], *pad,
                  *[o.data_ptr() for o in outs], *pad,
                  len(cols), n, num_cmp, plan.tile_bits, len(plan.passes),
                  _plan_words(plan))
    _build.LAUNCHES["merge_bitonic"] += 1
    return tuple(outs)


def merge_bitonic(cols, num_cmp: int = 2):
    cols, device, n = _check(cols, num_cmp)
    if device.type == "cpu":
        return merge_bitonic_plain(cols, num_cmp)
    return _launch(cols, device, n, num_cmp, merge_plan(n, len(cols)))
