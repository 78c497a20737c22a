"""Core tensor primitives and the uint32 convention.

Columns the JAX package holds as uint32 are carried here as int32 bit
patterns: on the CPU, torch's uint32 is storage only (no ``<``, ``>>``,
``+``, ``bincount`` or ``index_add_``). Where the reference wraps mod 2^32
(group sums, cumsum carries, packed words), the port computes in int64 and
folds back with ``wrap_i32``; ``as_u32`` reads an int32 bit pattern as its
unsigned value for compares.
"""

from __future__ import annotations

import torch

_U32 = 1 << 32
_I32_MIN = -(1 << 31)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with the value taken mod 2^32 (two's complement)."""
    return (torch.remainder(x + (1 << 31), _U32) - (1 << 31)).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of an int32 bit pattern, as int64."""
    return x.to(torch.int64) & (_U32 - 1)


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive int32 prefix sum (oneDPL exclusive_scan)."""
    return torch.cumsum(x, dim, dtype=torch.int32) - x


def compact_multi(arrays, mask: torch.Tensor, capacity=None, fill: int = 0):
    """copy_if of several same-length columns by one mask, keeping order:
    ``(tuple_of_outs, count)``. Each out has ``capacity`` slots (default:
    the column length); writes at or past ``capacity`` are dropped, and
    ``count`` (a 0-d int32 tensor) is the full number of selected rows. The
    count stays on the tensors' device: nothing is read back to the host."""
    n = mask.shape[0]
    if capacity is None:
        capacity = n
    m = mask.to(torch.int32)
    pos = exclusive_cumsum(m)
    count = (pos[-1] + m[-1]) if n > 0 else torch.zeros(
        (), dtype=torch.int32, device=mask.device)
    # unselected and out-of-capacity rows go to one spare slot past the end
    idx = torch.where((m > 0) & (pos < capacity), pos, capacity).to(torch.int64)
    outs = []
    for a in arrays:
        o = torch.full((capacity + 1,), fill, dtype=a.dtype, device=a.device)
        o[idx] = a
        outs.append(o[:capacity])
    return tuple(outs), count


def compact(values: torch.Tensor, mask: torch.Tensor, capacity=None,
            fill: int = 0):
    """copy_if: ``values[mask]`` to the front of a ``capacity`` buffer,
    keeping order; returns ``(out, count)`` as ``compact_multi`` does."""
    (out,), count = compact_multi((values,), mask, capacity, fill)
    return out, count


def bias_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns XOR 0x80000000: signed order of the result is the
    unsigned order of ``x`` (its own inverse)."""
    return x ^ _I32_MIN


def sort_by_key(keys: torch.Tensor, *values: torch.Tensor, stable: bool = True,
                unsigned: bool = False):
    """Sort a key column with payload columns (the JAX package's
    ``lax.sort`` with ``num_keys=1``). Keys compare as signed int32, or with
    ``unsigned=True`` as the uint32 values of their bit patterns (the JAX
    package's order for uint32 columns). Returns (sorted_keys,
    *sorted_values)."""
    if unsigned:
        sk, order = torch.sort(bias_u32(keys), stable=stable)
        sk = bias_u32(sk)
    else:
        sk, order = torch.sort(keys, stable=stable)
    if not values:
        return sk
    return (sk, *(v[order] for v in values))


def segment_ids_from_sorted(sorted_keys: torch.Tensor) -> torch.Tensor:
    """For a sorted key column, the dense int32 segment id of each row
    (0-based, increasing by 1 at every key change)."""
    n = sorted_keys.shape[0]
    change = torch.zeros(n, dtype=torch.int32, device=sorted_keys.device)
    if n > 1:
        change[1:] = (sorted_keys[1:] != sorted_keys[:-1]).to(torch.int32)
    return torch.cumsum(change, 0, dtype=torch.int32)


def rank_in_segment(segment_ids: torch.Tensor) -> torch.Tensor:
    """int32 rank of each row within its (contiguous) segment: 0, 1, 2, ..."""
    n = segment_ids.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=segment_ids.device)
    is_start = torch.ones(n, dtype=torch.bool, device=segment_ids.device)
    if n > 1:
        is_start[1:] = segment_ids[1:] != segment_ids[:-1]
    start_idx = cummax(torch.where(is_start, idx, 0))
    return idx - start_idx


def cummax(x: torch.Tensor, unsigned: bool = False) -> torch.Tensor:
    """Inclusive running max (``lax.cummax``). int32 columns compare as
    signed, or with ``unsigned=True`` as uint32 bit patterns."""
    if x.shape[0] == 0:
        return x.clone()
    if unsigned:
        return bias_u32(torch.cummax(bias_u32(x), 0).values)
    return torch.cummax(x, 0).values
