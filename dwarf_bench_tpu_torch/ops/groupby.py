"""Group-by sum aggregation (the port of ``dwarf_bench_tpu/ops/groupby.py``).

The reference aggregates with a CAS + fetch_add hash table
(groupby/groupby.cpp:58-93); keys are dense in [0, groups_count), so the
observable output is a dense (groups_count,) sum array that wraps mod 2^32.
Sums are uint32 in the JAX package and int32 bit patterns here.

Engines, chosen by ``groupby_sum``:

  * G <= 4096: the shared-memory atomic kernel ``groupby_cuda.groupby_small``
    (the JAX package's ``groupby_small_pallas``).
  * 4096 < G <= 2^16 with values the caller vouches are below 2^14:
    ``groupby_sum_2level``, the weighted histogram kernel
    ``hist_cuda.weighted_histogram`` (the JAX package's
    ``weighted_histogram_i8_swar_pallas`` / ``weighted_histogram_i8_pallas``).
  * anything else: ``groupby_sum_sorted``, a ``torch.sort`` plus cumsum
    differences, where the JAX package uses ``lax.sort``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import groupby_cuda, hist_cuda
from .primitives import sort_by_key, wrap_i32


def _hi_bins_for(num_groups: int) -> int:
    """The JAX package's hi-digit row count for G groups: ceil(G / 128)
    rounded up to a power of two, at least 8."""
    hb = -(-num_groups // 128)
    return max(8, 1 << (hb - 1).bit_length())


def groupby_sum_2level(
    keys: torch.Tensor, vals: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Group sums for 4096 < G <= 2^16 from one weighted histogram of
    _hi_bins_for(G)·128 bins, cut to G."""
    if num_groups > (1 << 16):
        raise ValueError(f"groupby_sum_2level: G = {num_groups} > 2^16")
    sums = hist_cuda.weighted_histogram(
        keys, vals, hi_bins=_hi_bins_for(num_groups)
    )
    return sums[:num_groups]


def groupby_sum_sorted(
    keys: torch.Tensor, vals: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Sort rows by key; each group's sum is the difference of an inclusive
    cumsum (mod 2^32) at its last row and before its first row, written at
    the group's key. Keys outside [0, G) go to a slot past the end."""
    if keys.shape[0] == 0:
        return torch.zeros(num_groups, dtype=torch.int32, device=keys.device)
    # unstable: group sums are order-independent (adds mod 2^32 commute)
    sk, sv = sort_by_key(keys, vals, stable=False)
    cs = torch.cumsum(sv.to(torch.int64), 0)
    change = sk[1:] != sk[:-1]
    one = torch.ones(1, dtype=torch.bool, device=keys.device)
    is_end = torch.cat([change, one])
    is_start = torch.cat([one, change])
    seg_base = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
    in_range = (sk >= 0) & (sk < num_groups)
    spare = torch.full_like(sk, num_groups).to(torch.int64)
    end_at = torch.where(is_end & in_range, sk.to(torch.int64), spare)
    start_at = torch.where(is_start & in_range, sk.to(torch.int64), spare)
    out_end = torch.zeros(num_groups + 1, dtype=torch.int64, device=keys.device)
    out_base = torch.zeros_like(out_end)
    out_end[end_at] = torch.where(is_end, cs, 0)
    out_base[start_at] = torch.where(is_start, seg_base, 0)
    return wrap_i32(out_end[:num_groups] - out_base[:num_groups])


def groupby_sum(
    keys: torch.Tensor,
    vals: torch.Tensor,
    num_groups: int,
    vals_below_2p14: bool = False,
) -> torch.Tensor:
    """Dispatch as the JAX package's ``groupby_sum``. Its G <= 4096 split
    between bf16 value planes (v < 2^14) and f32 one-hot matmuls is a TPU
    precision choice: the card's kernel takes any value, so both take it.
    The weighted-histogram branch keeps the reference's condition, so the
    same inputs take the same branch in both packages."""
    if num_groups <= groupby_cuda.MAX_GROUPS:
        return groupby_cuda.groupby_small(keys, vals, num_groups)
    if num_groups <= (1 << 16) and vals_below_2p14:
        return groupby_sum_2level(keys, vals, num_groups)
    return groupby_sum_sorted(keys, vals, num_groups)


def groupby_oracle(keys, vals, num_groups: int) -> np.ndarray:
    """Dense scalar oracle (groupby/groupby.cpp:8-19) with uint32 wrap."""
    out = np.zeros(num_groups, np.uint32)
    np.add.at(out, np.asarray(keys, np.int64), np.asarray(vals, np.uint32))
    return out
