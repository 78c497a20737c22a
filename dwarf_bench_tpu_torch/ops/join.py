"""Hash join (1:1) and nested-loop join (``dwarf_bench_tpu/ops/join.py``).

Reference:
  * ``Join`` (join/join.cpp): build a hash table from table A's unique keys
    and values, probe table B, compact the hits; build and probe times split.
  * ``NestedLoopJoin`` (join/nested_join.cpp): every A row against every B
    row.

The build is the parking construction (``ops/hashtable.py``) with A's values
as payload; the probe is the vectorized chain walk plus a payload gather;
the hits are compacted on the device into a fixed-capacity buffer with a
count. The nested-loop join is a dense (na, nb) compare mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import hashtable
from .hashing import murmur3_32
from .primitives import compact_multi


class JoinResult(NamedTuple):
    keys: torch.Tensor
    a_vals: torch.Tensor
    b_vals: torch.Tensor
    count: torch.Tensor  # 0-d int32: rows of the three columns that hold data


def hash_join_build(a_keys: torch.Tensor, a_vals: torch.Tensor, ht_size: int,
                    hash_seed) -> hashtable.HashTable:
    home = murmur3_32(a_keys, hash_seed, ht_size)
    return hashtable.build(a_keys, home, ht_size, payload=(a_vals,))


def hash_join_probe(table: hashtable.HashTable, b_keys: torch.Tensor,
                    b_vals: torch.Tensor, hash_seed) -> JoinResult:
    home = murmur3_32(b_keys, hash_seed, table.size)
    found, a_val = hashtable.lookup(table, b_keys, home)
    (k, av, bv), count = compact_multi((b_keys, a_val, b_vals), found)
    return JoinResult(k, av, bv, count)


def nested_loop_join(a_keys: torch.Tensor, a_vals: torch.Tensor,
                     b_keys: torch.Tensor, b_vals: torch.Tensor) -> JoinResult:
    """Dense O(n^2) compare (nested_join.cpp:60-70). Output order is A-major
    like the reference's per-A-row emission; for each A row the first
    matching B row, which is the only one for the unique-key 1:1 data."""
    hit = a_keys[:, None] == b_keys[None, :]  # (na, nb)
    found = hit.any(dim=1)
    b_idx = torch.argmax(hit.to(torch.uint8), dim=1)  # first match
    (k, av, bv), count = compact_multi((a_keys, a_vals, b_vals[b_idx]), found)
    return JoinResult(k, av, bv, count)


def seq_join_oracle(a_keys, a_vals, b_keys, b_vals) -> np.ndarray:
    """All (key, a_val, b_val) matches of join_helpers::seq_join
    (join/join_helpers/join_helpers.hpp:86-125) as a lexicographically
    sorted (r, 3) uint64 array. Vectorized: B sorted by key, each A key's
    run of equal B keys found by binary search and expanded with repeat."""
    ak = np.asarray(a_keys).astype(np.uint32)
    av = np.asarray(a_vals).astype(np.uint32)
    bk = np.asarray(b_keys).astype(np.uint32)
    bv = np.asarray(b_vals).astype(np.uint32)
    order = np.argsort(bk, kind="stable")
    bs = bk[order]
    lo = np.searchsorted(bs, ak, side="left")
    cnt = np.searchsorted(bs, ak, side="right") - lo
    ai = np.repeat(np.arange(len(ak)), cnt)
    first = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
    bj = order[first + np.arange(len(ai))]
    rows = np.stack([ak[ai], av[ai], bv[bj]], axis=1).astype(np.uint64)
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows.reshape(0, 3)


def join_rows_sorted(res: JoinResult) -> np.ndarray:
    """A JoinResult as the oracle's sorted (r, 3) uint64 triples."""
    c = int(res.count)
    rows = np.stack(
        [col[:c].cpu().numpy().view(np.uint32).astype(np.uint64)
         for col in (res.keys, res.a_vals, res.b_vals)], axis=1)
    return rows[np.lexsort(rows.T[::-1])] if c else rows


def _u32_column(col) -> np.ndarray:
    """A column as numpy: a tensor is read as uint32 bit patterns."""
    if isinstance(col, torch.Tensor):
        return col.cpu().numpy().view(np.uint32)
    return np.asarray(col)


def columns_to_rows(keys, *value_cols):
    """Column store to row store (join_helpers.hpp to_row_store): a list of
    (key, v1, v2, ...) tuples of ints. A tensor column holds uint32 bit
    patterns and gives their unsigned values."""
    cols = [_u32_column(keys)] + [_u32_column(c) for c in value_cols]
    return list(zip(*[c.tolist() for c in cols]))


def rows_to_columns(rows, n_cols: int):
    """Row store to column store (join_helpers.hpp to_col_store): a tuple of
    ``n_cols`` int32 tensors, the uint32 columns' bit patterns."""
    if not rows:
        return tuple(torch.empty(0, dtype=torch.int32) for _ in range(n_cols))
    arr = np.asarray(rows, dtype=np.uint64)
    return tuple(torch.from_numpy(arr[:, c].astype(np.uint32).view(np.int32))
                 for c in range(n_cols))
