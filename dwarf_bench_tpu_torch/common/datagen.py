"""Seeded, reproducible data generators.

The same generators as ``dwarf_bench_tpu/common/datagen.py``: both packages
make byte-identical columns from one seed and size.

Functional equivalents of the reference's ``helpers::*`` generators
(common/common.hpp:28-57, common/common.cpp:7-36) with one deliberate
deviation: the reference seeds from ``std::random_device`` (non-deterministic
across runs); exact row parity across runs/hosts is a north-star requirement,
so every generator here takes an explicit seed and uses numpy's PCG64.

Distribution semantics match the reference exactly:
  - make_random(size, lo=1, hi=10000): uniform ints, both bounds inclusive.
  - make_unique_random(size): ``size`` DISTINCT uint32 values in
    [1, size*10], returned SORTED ascending (the reference materializes a
    std::set and copies it out in order, common/common.cpp:7-20).
  - make_random_uniform_binary(size): uniform 0/1 ints.
  - make_random_scalar(): one int in [1, 1000].
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(seed))


def make_random(
    size: int,
    lo: int = 1,
    hi: int = 10000,
    seed: int = 0,
    dtype=np.int32,
) -> np.ndarray:
    """Uniform ints in [lo, hi] inclusive. Reference: common/common.hpp:31-40."""
    return _rng(seed).integers(lo, hi, size=size, endpoint=True).astype(dtype)


def make_unique_random(size: int, seed: int = 0) -> np.ndarray:
    """``size`` distinct uint32 in [1, size*10], sorted ascending.

    Reference: common/common.cpp:7-20 (std::set loop — the set iteration
    order makes the output sorted; values are ``dist(gen) % (size*10)`` with
    dist over [1, min(size*10, UINT32_MAX)], so 0 is possible only when
    size*10 wraps — not at benchmark sizes, and we keep values in [1, 10n]).
    """
    if size == 0:
        return np.empty(0, dtype=np.uint32)
    hi = size * 10
    rng = _rng(seed)
    # Rejection-free top-up loop: draw batches, dedupe, repeat until enough.
    vals = np.empty(0, dtype=np.uint64)
    need = size
    while vals.size < size:
        batch = rng.integers(1, hi, size=max(need + need // 4 + 16, 64),
                             endpoint=True, dtype=np.uint64)
        vals = np.unique(np.concatenate([vals, batch]))
        need = size - vals.size
    # np.unique returns sorted values; take a random subset of the surplus to
    # avoid biasing toward small values, then re-sort (set semantics).
    if vals.size > size:
        keep = rng.choice(vals.size, size=size, replace=False)
        vals = np.sort(vals[keep])
    return vals.astype(np.uint32)


def make_random_uniform_binary(size: int, seed: int = 0) -> np.ndarray:
    """Uniform 0/1. Reference: common/common.cpp:22-29."""
    return _rng(seed).integers(0, 1, size=size, endpoint=True).astype(np.int32)


def make_random_scalar(seed: int = 0) -> int:
    """One int in [1, 1000]. Reference: common/common.cpp:31-36."""
    return int(_rng(seed).integers(1, 1000, endpoint=True))


def check_first(v1, v2, sz: int) -> bool:
    """Prefix equality. Reference: common/common.hpp:49-56."""
    a = np.asarray(v1)[:sz]
    b = np.asarray(v2)[:sz]
    return bool(np.array_equal(a, b))


def derive_seed(base_seed: int, *streams: int) -> int:
    """Derive independent sub-seeds (per size / iteration / column) from the
    RunOptions seed so each data column gets its own stream."""
    mask = 0xFFFFFFFFFFFFFFFF
    h = (int(base_seed) * 0x9E3779B97F4A7C15) & mask
    for s in streams:
        h = ((h ^ int(s)) * 0xBF58476D1CE4E5B9) & mask
    return h & 0x7FFFFFFFFFFFFFFF
