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

The JAX package's other engine names keep their call sites working:
``groupby_sum_matmul``, ``groupby_sum_matmul_bf16`` and
``groupby_sum_scatter`` compute ``groupby_sum``'s contract by one-hot
matmuls or a scatter-add, TPU formulations of the same sums, so here they
are ``groupby_sum``. ``groupby_sum_packed_sort`` is an engine of its own:
one sort of ``(key << 16) | val``, cumsum differences at the group ends and
a ``compact_mask`` of those ends.
"""

from __future__ import annotations

import numpy as np
import torch

from . import compact_cuda, groupby_cuda, hist_cuda
from .primitives import as_u32, sort_by_key, wrap_i32


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


def groupby_sum_matmul(
    keys: torch.Tensor, vals: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """The JAX package's one-hot f32 matmul engine (any G): keys outside
    [0, G) add nothing, sums wrap mod 2^32. ``groupby_sum``'s engines."""
    return groupby_sum(keys, vals, num_groups)


def groupby_sum_matmul_bf16(
    keys: torch.Tensor, vals: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """The JAX package's bf16 value-plane engine, exact there for values
    below 2^14; every engine here is exact for any value."""
    return groupby_sum(keys, vals, num_groups)


def groupby_sum_scatter(
    keys: torch.Tensor, vals: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """The JAX package's scatter-add engine over keys in [0, G). Keys
    outside it are dropped, as ``groupby_sum_sorted`` drops them (ROADMAP
    queue 3: the JAX scatter wraps negative keys)."""
    return groupby_sum(keys, vals, num_groups)


def groupby_sum_packed_sort(
    keys: torch.Tensor, vals: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """One unstable sort of the packed word ``(key << 16) | val`` (uint32
    arithmetic), then the inclusive cumsum of the values, the group ends
    compacted (kernel ``compact_mask``, ``num_groups`` slots) and each
    group's sum the difference of consecutive ends' cumsums, mod 2^32.
    PRECONDITIONS (the caller's, as in the JAX package): G <= 2^16, keys
    and values below 2^16. Ends of keys at or past G are dropped."""
    if num_groups > (1 << 16):
        raise ValueError(f"groupby_sum_packed_sort: G = {num_groups} > 2^16")
    device = keys.device
    packed = ((as_u32(keys) << 16) | as_u32(vals)) & 0xFFFFFFFF
    sp = torch.sort(packed).values
    k_s = (sp >> 16).to(torch.int32)
    cs = wrap_i32(torch.cumsum(sp & 0xFFFF, 0))
    is_end = torch.ones_like(k_s, dtype=torch.bool)
    is_end[:-1] = k_s[1:] != k_s[:-1]
    (ek, ecs), cnt = compact_cuda.compact_mask(is_end, (k_s, cs), num_groups)
    valid = torch.arange(num_groups, device=device) < cnt
    prev = torch.cat([ecs.new_zeros(1), ecs[:-1]])
    diff = wrap_i32(ecs.to(torch.int64) - prev.to(torch.int64))
    at = torch.where(valid & (ek < num_groups), ek.to(torch.int64),
                     num_groups)
    out = torch.zeros(num_groups + 1, dtype=torch.int32, device=device)
    out[at] = torch.where(valid, diff, 0)
    return out[:num_groups]


def groupby_partials(
    keys: torch.Tensor, vals: torch.Tensor, num_groups: int, executors: int
) -> torch.Tensor:
    """Stage 1 of GroupByLocal (groupby_local.cpp:58-83): an
    (executors, G) int32 of per-executor sums over contiguous row chunks of
    ceil(n / executors) rows, keys outside [0, G) dropped, sums wrapping mod
    2^32. The JAX package computes one-hot f32 matmuls in 1024-row tiles;
    here each row's key is offset by ``executor * G`` and one group-by over
    ``executors * G`` groups sums all chunks at once (the groupby_small
    kernel up to 4096 partial groups, the weighted histogram up to 2^16).
    The card's weighted-histogram kernel is exact for any value, so the
    ``vals_below_2p14`` flag below only picks that route."""
    num_groups, executors = int(num_groups), int(executors)
    if num_groups < 1 or executors < 1:
        raise ValueError(f"groupby_partials: G = {num_groups} and "
                         f"executors = {executors} must be positive")
    total = num_groups * executors
    if total >= 2**31:
        raise ValueError(f"groupby_partials: {total} partial groups "
                         "exceed int32 keys")
    n = keys.shape[0]
    if n == 0:
        return torch.zeros(executors, num_groups, dtype=torch.int32,
                           device=keys.device)
    per = -(-n // executors)
    owner = torch.arange(n, device=keys.device) // per
    ku = as_u32(keys)
    flat = torch.where(ku < num_groups, owner * num_groups + ku, total)
    sums = groupby_sum(flat.to(torch.int32), vals, total,
                       vals_below_2p14=True)
    return sums.view(executors, num_groups)


def groupby_merge(partials: torch.Tensor) -> torch.Tensor:
    """Stage 2 (groupby_local.cpp:87-112): the (G,) sum of the executors'
    partials mod 2^32, as int32 bit patterns (uint32 in the JAX package)."""
    return wrap_i32(partials.sum(0, dtype=torch.int64))


def groupby_oracle(keys, vals, num_groups: int) -> np.ndarray:
    """Dense scalar oracle (groupby/groupby.cpp:8-19) with uint32 wrap."""
    out = np.zeros(num_groups, np.uint32)
    np.add.at(out, np.asarray(keys, np.int64), np.asarray(vals, np.uint32))
    return out
