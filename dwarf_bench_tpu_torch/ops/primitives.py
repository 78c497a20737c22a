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


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with the value taken mod 2^32 (two's complement)."""
    return (torch.remainder(x + (1 << 31), _U32) - (1 << 31)).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of an int32 bit pattern, as int64."""
    return x.to(torch.int64) & (_U32 - 1)


def sort_by_key(keys: torch.Tensor, *values: torch.Tensor, stable: bool = True):
    """Sort a key column with payload columns (the JAX package's
    ``lax.sort`` with ``num_keys=1``). Keys compare as signed int32; a caller
    with uint32 bit patterns at or above 2^31 biases them first. Returns
    (sorted_keys, *sorted_values)."""
    sk, order = torch.sort(keys, stable=stable)
    if not values:
        return sk
    return (sk, *(v[order] for v in values))
