"""Cuckoo hash table via bulk-synchronous insertion rounds
(``dwarf_bench_tpu/ops/cuckoo.py``; reference
common/dpcpp/cuckoo_hashtable.hpp).

The reference inserts with per-slot spin-locks and bounded eviction chains;
on failure the calling dwarf re-seeds both hashers and rebuilds
(hash/cuckoo_hash_build.cpp:43-93). Here, as in the JAX package, every
unplaced key claims its candidate slot for one of its two hash functions,
one winner per slot is chosen by a scatter-max of rotated priorities,
winners write their key and evict the previous resident, and the evicted
keys flip to their other hash. Three phases (cuckoo.py:101-126): full
rounds while more than ``compact_cap`` keys are unplaced, rounds over a
compacted active set (re-compacted once at a tail cap), and a sequential
eviction-chain walk for the last stragglers.

The JAX package's ``lax.while_loop``s become Python loops over device
tensors, each round reading its exit condition back to the host; the
phase-3 chain walk runs on host scalars with one read and one write of the
device table per step. The table, ``rounds``, ``success`` and
``keys_sorted`` are those of the JAX package bit for bit. Keys are int32
bit patterns; EMPTY (-1) marks a free slot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import compact_cuda
from .hashing import M32, murmur3_32_u32
from .hashtable import EMPTY
from .merge_lookup import merge_lookup_bitonic
from .primitives import sort_by_key

# Bijective key premix for the SECOND hash function (cuckoo.py:35-55): two
# seeds of one murmur give mirrored 2-cycles h1(x) == h2(y), h2(x) == h1(y)
# for any keys with m(x) ^ m(y) == s1 ^ s2; multiplying the key by an odd
# constant first makes the two conditions independent.
_H2_PREMIX = 0x9E3779B9
_CHAIN_CAP = 2048
_BULK = 1 << 16  # queries at or above this on CUDA take the merge probe


def hash1(v, seed, size):
    """First hash (murmur3 mod size) as unsigned values: int64 for a tensor,
    int for an int."""
    return murmur3_32_u32(v, seed, size)


def _hash2(v, seed, size):
    """Second hash: murmur3 of the premixed key, mod size."""
    if isinstance(v, torch.Tensor):
        return murmur3_32_u32((v.to(torch.int64) * _H2_PREMIX) & M32, seed,
                              size)
    return murmur3_32_u32((int(v) * _H2_PREMIX) & M32, seed, size)


class CuckooTable(NamedTuple):
    keys: torch.Tensor  # (size,) int32, EMPTY marks a free slot
    payload: Tuple[torch.Tensor, ...]
    seed1: int  # murmur seeds (cuckoo_hash_build.cpp:43-49)
    seed2: int
    success: bool  # did the build converge
    rounds: int  # rounds taken
    keys_sorted: torch.Tensor  # (n,) sorted inserted keys for bulk ``has``
    vals_sorted: torch.Tensor  # (n,) values in keys_sorted order (zeros
    # when built without values): the bulk ``at`` merge probe's payload

    @property
    def size(self) -> int:
        return self.keys.shape[0]


def _rot_priority(idx: torch.Tensor, it: int) -> torch.Tensor:
    """Per-round rotated claim priority, uint32 values as int64: 1 + idx
    rotated left by ``it & 31`` (bijective, so one winner per slot; the
    rotation reshuffles the order every round and breaks eviction
    cycles, cuckoo.py:74-88)."""
    r = it & 31
    pr = (idx + 1) & M32
    if r == 0:
        return pr
    return ((pr << r) | (pr >> (32 - r))) & M32


def _claim(size: int, cand: torch.Tensor, active: torch.Tensor,
           pr: torch.Tensor) -> torch.Tensor:
    """Winners of one round: for each slot the active lane with the largest
    priority (``claims.at[slot].max(pr)``; inactive lanes write the spare
    slot ``size``)."""
    claims = torch.zeros(size + 1, dtype=torch.int64, device=cand.device)
    claims.scatter_reduce_(0, torch.where(active, cand, size), pr, "amax")
    return active & (claims[cand] == pr)


def _to_i32(v: int) -> int:
    return v - (1 << 32) if v >= (1 << 31) else v


def build(keys: torch.Tensor, size: int, seed1, seed2, max_iters: int,
          values: Optional[torch.Tensor] = None,
          compact_cap: Optional[int] = None) -> CuckooTable:
    """One build attempt over distinct int32 ``keys``. The host rebuild
    loop lives in the dwarf, like the reference (cuckoo_hash_build.cpp)."""
    n = keys.shape[0]
    dev = keys.device
    s1, s2 = int(seed1) & M32, int(seed2) & M32
    h1 = hash1(keys, s1, size)
    h2 = _hash2(keys, s2, size)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    if compact_cap is None:
        compact_cap = max(1024, n >> 3)
    cap = min(compact_cap, n)

    # table with one spare slot past the end for the dropped writes
    table = torch.full((size + 1,), EMPTY, dtype=torch.int32, device=dev)

    # --- phase 1, round 1: every key on h1 from an empty table, so the
    # winners are exactly the resident keys
    pr0 = _rot_priority(idx, 0)
    win1 = _claim(size, h1, torch.ones_like(idx, dtype=torch.bool), pr0)
    table[torch.where(win1, h1, size)] = keys
    slot = torch.where(win1, h1, -1)
    side = torch.zeros(n, dtype=torch.int64, device=dev)
    res = win1
    rounds = 1

    # full-set rounds, only while more than ``cap`` keys are unplaced
    while rounds < max_iters and int((~res).sum()) > cap:
        evicted = (slot >= 0) & ~res
        side = torch.where(evicted, 1 - side, side)
        slot = torch.where(evicted, -1, slot)
        active = ~res
        cand = torch.where(side == 0, h1, h2)
        winner = _claim(size, cand, active, _rot_priority(idx, rounds))
        table[torch.where(winner, cand, size)] = keys
        slot = torch.where(winner, cand, slot)
        res = (slot >= 0) & (table[slot.clamp(min=0)] == keys)
        rounds += 1

    # --- phase 2: compacted active-set rounds, with a tail cap
    def compact_active(mask, k, s, capacity):
        (ck, cs), _ = compact_cuda.compact_mask(
            mask, (k, s.to(torch.int32)), capacity)
        count = int(mask.sum())
        valid = torch.arange(capacity, device=dev) < min(count, capacity)
        return torch.where(valid, ck, EMPTY), cs.to(torch.int64), valid

    def active_rounds(table, ak, aside, avalid, it0, stop_count):
        aidx = torch.arange(ak.shape[0], dtype=torch.int64, device=dev)
        it = it0
        while it < it0 + max_iters:
            live = int(avalid.sum())
            if live == 0 or (stop_count is not None and live <= stop_count):
                break
            cand = torch.where(aside == 0, hash1(ak, s1, size),
                               _hash2(ak, s2, size))
            winner = _claim(size, cand, avalid, _rot_priority(aidx, it))
            old = table[cand]  # the residents before this round's writes
            table[torch.where(winner, cand, size)] = ak
            displaced = torch.where(winner, old, EMPTY)
            # the displaced occupant re-enters the winner's active slot, set
            # to try its OTHER hash next (the eviction-chain step by value)
            ns = (hash1(displaced, s1, size) == cand).to(torch.int64)
            ak = torch.where(winner, displaced, ak)
            aside = torch.where(winner, ns, aside)
            avalid = torch.where(winner, displaced != EMPTY, avalid)
            it += 1
        return ak, aside, avalid, it

    overflow = int((~res).sum()) > cap  # only if max_iters ran out above
    tail_cap = max(1024, n >> 7)
    ak, aside, avalid = compact_active(~res, keys, side, cap)
    ak, aside, avalid, rounds = active_rounds(
        table, ak, aside, avalid, rounds,
        tail_cap if tail_cap < cap else None)
    if tail_cap < cap:
        # survivors past the tail cap would be dropped by the re-compaction
        overflow |= int(avalid.sum()) > tail_cap
        ak, aside, avalid = compact_active(avalid, ak, aside, tail_cap)
        ak, aside, avalid, rounds = active_rounds(
            table, ak, aside, avalid, rounds, None)

    # --- phase 3: the reference's sequential eviction-chain walk
    # (cuckoo_hashtable.hpp:43-63) for the stragglers, by key value, in
    # active-array order; a chain that reaches the cap stops the walk
    keys_left = (ak[avalid].to(torch.int64) & M32).tolist()
    sides_left = aside[avalid].tolist()
    total, stuck, done = 0, False, 0
    for v, s in zip(keys_left, sides_left):
        if total >= _CHAIN_CAP or stuck:
            break
        v1, v2 = hash1(v, s1, size), _hash2(v, s2, size)
        placed = (int(table[v1]) & M32) == v or (int(table[v2]) & M32) == v
        steps = 0
        if not placed:
            while v != M32 and steps < _CHAIN_CAP:
                c = hash1(v, s1, size) if s == 0 else _hash2(v, s2, size)
                old = int(table[c]) & M32
                table[c] = _to_i32(v)
                s = 1 if hash1(old, s1, size) == c else 0
                v = old
                steps += 1
        total += steps
        stuck = steps >= _CHAIN_CAP
        done += 1
    stragglers_left = done < len(keys_left)

    table = table[:size]
    payload: Tuple[torch.Tensor, ...] = ()
    if values is not None:
        # residency by value: chain moves bypass per-key bookkeeping
        at1 = table[h1] == keys
        at2 = table[h2] == keys
        slot = torch.where(at1, h1, torch.where(at2, h2, -1))
        success = bool((slot >= 0).all()) and not overflow
        buf = torch.zeros(size + 1, dtype=values.dtype, device=dev)
        buf[torch.where(slot >= 0, slot, size)] = values
        payload = (buf[:size],)
        keys_sorted, vals_sorted = sort_by_key(keys, values, unsigned=True)
    else:
        # keys-only: success from conservation (cuckoo.py:378-386): every
        # phase moves keys by value and flags every point that can drop one
        success = not stragglers_left and not stuck and not overflow
        keys_sorted = sort_by_key(keys, unsigned=True)
        vals_sorted = torch.zeros_like(keys_sorted)
    return CuckooTable(table, payload, s1, s2, success, rounds, keys_sorted,
                       vals_sorted)


def has(table: CuckooTable, queries: torch.Tensor) -> torch.Tensor:
    """Membership. Small batches (or CPU tensors): the 2-probe lookup
    (cuckoo_hashtable.hpp:29-41). Bulk batches on CUDA: the sort-merge probe
    against the sorted inserted keys. Meaningful only for a table with
    ``success`` (cuckoo.py:402-407)."""
    if queries.is_cuda and queries.shape[0] >= _BULK:
        found, _ = merge_lookup_bitonic(
            table.keys_sorted, torch.zeros_like(table.keys_sorted), queries,
            membership=True)
        return found
    size = table.size
    return ((table.keys[hash1(queries, table.seed1, size)] == queries)
            | (table.keys[_hash2(queries, table.seed2, size)] == queries))


def at(table: CuckooTable, queries: torch.Tensor):
    """Value lookup: (found, value). The 2-probe gather pair, or on CUDA
    for bulk batches the merge probe against the build-sorted (key, value)
    pairs. The ``has`` success contract applies."""
    if queries.is_cuda and queries.shape[0] >= _BULK:
        return merge_lookup_bitonic(table.keys_sorted, table.vals_sorted,
                                    queries)
    size = table.size
    h1 = hash1(queries, table.seed1, size)
    h2 = _hash2(queries, table.seed2, size)
    hit1 = table.keys[h1] == queries
    hit2 = table.keys[h2] == queries
    vals = table.payload[0]
    v = torch.where(hit1, vals[h1], torch.where(hit2, vals[h2], 0))
    return hit1 | hit2, v
