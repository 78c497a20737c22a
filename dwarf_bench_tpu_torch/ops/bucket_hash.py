"""Bucketized hash table, the slab hash (``dwarf_bench_tpu/ops/bucket_hash.py``).

The reference's SlabHash (common/dpcpp/slab_hash.hpp) chains 32-slot slabs
per bucket with a bump allocator and per-bucket locks. The table here is a
dense ``(num_buckets, capacity)`` tile array built by sort: hash keys to
buckets, sort rows by bucket, rank within bucket, and scatter to
``bucket * capacity + rank``. Rows past a bucket's capacity spill to a
sorted overflow column probed by binary search. Keys and values are int32
bit patterns; EMPTY (-1) marks a free slot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .hashing import SLAB_HASH_PRIME, affine_hash
from .hashtable import EMPTY
from .primitives import (
    bias_u32,
    compact_multi,
    rank_in_segment,
    sort_by_key,
    wrap_i32,
)

SLAB_SIZE = 32  # reference slab capacity (slab_hash.hpp:21)


def calculate_buckets_count(input_size: int, mem_util_percent: int = 60) -> int:
    """Buckets so that average occupancy is about mem_util% of one 32-slot
    slab (reference heuristic, slab_hash.hpp:30-58)."""
    target_per_bucket = max(1, SLAB_SIZE * mem_util_percent // 100)
    return max(1, -(-input_size // target_per_bucket))


class BucketTable(NamedTuple):
    keys: torch.Tensor  # (num_buckets, capacity) int32, EMPTY = free
    vals: torch.Tensor  # (num_buckets, capacity)
    overflow_keys: torch.Tensor  # (overflow_cap,) sorted as uint32
    overflow_vals: torch.Tensor
    overflow_count: torch.Tensor  # 0-d int32
    hash_a: int  # affine hash parameters
    hash_b: int
    sorted_keys: torch.Tensor  # (n,) key-sorted copy for the bulk merge
    sorted_vals: torch.Tensor  # probe (ops/merge_lookup; EMPTY pad last)

    @property
    def num_buckets(self) -> int:
        return self.keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]


def build(keys: torch.Tensor, vals: torch.Tensor, num_buckets: int,
          capacity: int = SLAB_SIZE, overflow_cap: Optional[int] = None,
          hash_a: int = 1, hash_b: int = 0) -> BucketTable:
    """Build the table from int32 ``keys`` and ``vals``. The bucket sort is
    stable, as the JAX package's is; the key sort of ``sorted_keys`` is
    stable here (unstable there), so with duplicate keys the order of
    ``sorted_vals`` differs only among equal keys."""
    n = keys.shape[0]
    if overflow_cap is None:
        overflow_cap = n
    b = affine_hash(keys, hash_a, hash_b, SLAB_HASH_PRIME, num_buckets)
    sb, sk, sv = sort_by_key(b, keys, vals)
    rank = rank_in_segment(sb)
    in_main = rank < capacity
    slots = num_buckets * capacity
    safe = torch.where(in_main, sb.to(torch.int64) * capacity + rank, slots)
    tk = torch.full((slots + 1,), EMPTY, dtype=torch.int32, device=keys.device)
    tv = torch.zeros(slots + 1, dtype=vals.dtype, device=keys.device)
    tk[safe] = sk
    tv[safe] = sv
    # spill: overflow rows sorted by key for binary-search probing
    (ok, ov), ocount = compact_multi((sk, sv), ~in_main, capacity=overflow_cap)
    live = torch.arange(overflow_cap, device=keys.device) < ocount
    ok, ov = sort_by_key(torch.where(live, ok, EMPTY), ov, unsigned=True)
    # key-sorted copy for the gather-free bulk probe (merge_lookup)
    gk, gv = sort_by_key(sk, sv, unsigned=True)
    return BucketTable(
        tk[:slots].view(num_buckets, capacity),
        tv[:slots].view(num_buckets, capacity),
        ok, ov, ocount, int(hash_a), int(hash_b), gk, gv,
    )


def find(table: BucketTable, queries: torch.Tensor,
         engine: Optional[str] = None, val_bits: int = 32):
    """Vectorized bucket lookup. Returns (found, value).

    ``engine``:

      * ``"tile"``: gather the query's bucket row, compare across the
        capacity axis, binary-search the overflow column (the lane analog
        of the reference's 32-slot slab scan, slab_hash.hpp:264-294). With
        duplicate table keys it sums a bucket's matching values.
      * ``"merge"``: the bitonic sort-merge probe
        (``merge_lookup.merge_lookup_bitonic``) against the build-sorted
        keys; with duplicate keys it returns one duplicate's value.
        ``val_bits=16`` (every table value below 2^16) drops the third merge
        column.
      * ``"merge_legacy"``: the full-concat-sort probe
        (``merge_lookup.merge_lookup``).
      * ``None``: merge when the queries are on CUDA and number 2^16 or
        more, tile otherwise (the JAX package's accelerator dispatch). The
        engines agree exactly for distinct table keys."""
    if engine is None:
        engine = ("merge" if queries.is_cuda and queries.shape[0] >= (1 << 16)
                  else "tile")
    if engine == "merge":
        from .merge_lookup import merge_lookup_bitonic

        return merge_lookup_bitonic(table.sorted_keys, table.sorted_vals,
                                    queries, val_bits=val_bits)
    if engine == "merge_legacy":
        from .merge_lookup import merge_lookup

        return merge_lookup(table.sorted_keys, table.sorted_vals, queries)
    if engine != "tile":
        raise ValueError(f"find: unknown engine {engine!r}")
    b = affine_hash(queries, table.hash_a, table.hash_b, SLAB_HASH_PRIME,
                    table.num_buckets).to(torch.int64)
    bucket_keys = table.keys[b]  # (nq, capacity) gather of whole tiles
    bucket_vals = table.vals[b]
    hit = bucket_keys == queries[:, None]
    found = hit.any(dim=1)
    val = wrap_i32(torch.where(hit, bucket_vals, 0).sum(dim=1,
                                                       dtype=torch.int64))
    val = val.to(table.vals.dtype)
    # overflow: binary search in the sorted spill column (uint32 order)
    ok = table.overflow_keys
    pos = torch.searchsorted(bias_u32(ok), bias_u32(queries))
    safe = torch.clamp(pos, max=ok.shape[0] - 1)
    o_hit = (pos < table.overflow_count) & (ok[safe] == queries)
    val = torch.where(o_hit & ~found, table.overflow_vals[safe], val)
    return found | o_hit, val
