"""Batcher's bitonic merge network (``dwarf_bench_tpu/ops/bitonic.py``).

The bulk hash probe merges an already-sorted table with sorted queries:
``merge_bitonic`` sorts a BITONIC input (ascending prefix, descending
suffix) under the lexicographic order of the first ``num_cmp`` columns in
log2(N) compare-exchange stages. Callers must make the suffix monotone in
the composite (key, aux) order, not just in key (bitonic.py:19-25).

This is the plain PyTorch network, the twin of the ``merge_bitonic`` kernel
(``ops/bitonic_cuda.py``). Columns are int32 bit patterns compared as
uint32: the compare columns are XOR-biased once so that signed compares
give the unsigned order, and unbiased at the end.
"""

from __future__ import annotations

import torch

from .primitives import bias_u32


def merge_bitonic(cols, num_cmp: int = 2):
    """Sort a bitonic sequence ascending under the unsigned lexicographic
    order of the first ``num_cmp`` columns (1 or 2). ``cols``: same-length
    (N,) int32 tensors, N a power of two; every column rides the
    exchanges. At each stride rows i and i + s swap iff row i + s is less
    than row i; on equality neither moves. Returns a tuple of new
    tensors."""
    n = cols[0].shape[0]
    if n & (n - 1):
        raise ValueError(f"merge_bitonic: length {n} is not a power of two")
    cols = [bias_u32(c) if k < num_cmp else c.clone()
            for k, c in enumerate(cols)]
    s = n // 2
    while s >= 1:
        shaped = [c.view(-1, 2, s) for c in cols]
        k_lo, k_hi = shaped[0][:, 0], shaped[0][:, 1]
        swap = k_hi < k_lo
        if num_cmp >= 2:
            a_lo, a_hi = shaped[1][:, 0], shaped[1][:, 1]
            swap |= (k_hi == k_lo) & (a_hi < a_lo)
        cols = [
            torch.stack([torch.where(swap, c[:, 1], c[:, 0]),
                         torch.where(swap, c[:, 0], c[:, 1])], 1).reshape(n)
            for c in shaped
        ]
        s //= 2
    return tuple(bias_u32(c) if k < num_cmp else c
                 for k, c in enumerate(cols))
