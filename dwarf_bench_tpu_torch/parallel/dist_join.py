"""Distributed one-to-many join over a device mesh (the port of
``dwarf_bench_tpu/parallel/dist_join.py``).

Both tables are hash-partitioned by key across the ranks through the
fixed-capacity all-to-all shuffle (``shuffle.py``), and each rank runs the
single-chip CSR join (``ops/csr_join.py``) over the keys it owns. Row ids
ride the shuffle as payload, so the join references GLOBAL row ids (chip
index x rows_per_chip + local row). Variants: the ring join (no shuffle:
B chunks rotate past every rank's table), the skew-aware join (heavy keys
broadcast, the light tail shuffled), the 1:1 hash join that materialises
(key, a_val, b_val) rows, and the 2-D (dcn, ici) forms.

Counts and totals are int32 and wrap mod 2^32, as the JAX package's do.
"""

from __future__ import annotations

import torch

from ..ops import compact_cuda, csr_join, hashtable
from ..ops.hashing import murmur3_32
from ..ops.hashtable import EMPTY
from ..ops.primitives import compact_multi, sort_by_key, wrap_i32
from .collectives import all_gather, psum, ring_next
from .mesh import DCN_AXIS, ICI_AXIS, ROW_AXIS, axis_size, linear_index
from .shuffle import partition_for_shuffle, partition_for_shuffle_2d


def _global_ids(chip: int, rows_per_chip: int, n: int, device):
    """chip * rows_per_chip + [0, n), as uint32 bit patterns."""
    base = chip * rows_per_chip
    return wrap_i32(base + torch.arange(n, dtype=torch.int64, device=device))


def _matches(res) -> torch.Tensor:
    """(per-row match counts, their int32 sum mod 2^32)."""
    counts = torch.where(res.found, res.counts, 0)
    return counts, wrap_i32(counts.sum(dtype=torch.int64))


def _build(keys, row_ids, distinct_cap, ht_size, dense):
    if dense:
        return csr_join.build_dense(keys, row_ids=row_ids)
    return csr_join.build(keys, distinct_cap, ht_size, row_ids=row_ids)


def _probe(table, queries, dense):
    if dense:
        return csr_join.probe_dense(table, queries)
    return csr_join.probe_merge(table, queries)


def _local_join(keys, row_ids, queries, distinct_cap, ht_size, dense):
    """Per-rank CSR join: dense by key (the histogram build, a table
    lookup) when the caller guarantees the GLOBAL key span fits one 2^14
    window (``csr_join.dense_applicable``), the general sort-merge
    otherwise."""
    table = _build(keys, row_ids, distinct_cap, ht_size, dense)
    return _probe(table, queries, dense)


def dist_csr_join(mesh, rows_per_chip: int, distinct_cap: int, ht_size: int,
                  shuffle_capacity: int, dense: bool = False):
    """Returns fn(a_keys, b_keys) of this rank's row shards -> (match counts
    per received B row (n_chips * shuffle_capacity,), this rank's match
    total, the global total, this rank's shuffle overflow); the totals and
    overflow 0-d int32, the global total the same on every rank. The
    overflow must be 0 for a correct run."""
    group = mesh.get_group(ROW_AXIS)
    n_chips = axis_size(mesh, ROW_AXIS)
    me = mesh.get_local_rank(ROW_AXIS)

    def local(a_keys, b_keys):
        device = a_keys.device
        a_ids = _global_ids(me, rows_per_chip, a_keys.shape[0], device)
        b_ids = _global_ids(me, rows_per_chip, b_keys.shape[0], device)
        rak, rai, _, ov_a = partition_for_shuffle(
            a_keys, a_ids, n_chips, shuffle_capacity, group)
        rbk, _, _, ov_b = partition_for_shuffle(
            b_keys, b_ids, n_chips, shuffle_capacity, group)
        res = _local_join(rak.reshape(-1), rai.reshape(-1), rbk.reshape(-1),
                          distinct_cap, ht_size, dense)
        counts, local_matches = _matches(res)
        return counts, local_matches, psum(local_matches, group), ov_a + ov_b

    return local


def dist_csr_join_ring(mesh, rows_per_chip: int, distinct_cap: int,
                       ht_size: int, dense: bool = False):
    """Ring join, no hash shuffle: each rank builds a CSR table over its
    own A shard (global row ids); the B shards then rotate around the ring,
    each rank probing the visiting chunk and adding its matches to a count
    column that travels with the chunk. After n_chips hops every chunk is
    home with its global counts: any key skew is harmless.

    Returns fn(a_keys, b_keys) -> (global match counts of this rank's B
    rows, in row order; this rank's total; the global total)."""
    group = mesh.get_group(ROW_AXIS)
    n_chips = axis_size(mesh, ROW_AXIS)
    me = mesh.get_local_rank(ROW_AXIS)

    def local(a_keys, b_keys):
        a_ids = _global_ids(me, rows_per_chip, a_keys.shape[0],
                            a_keys.device)
        table = _build(a_keys, a_ids, distinct_cap, ht_size, dense)
        # (chunk, its counts) travel together: one message a hop
        pair = torch.stack([b_keys, torch.zeros_like(b_keys)])
        for _ in range(n_chips):
            pair[1] += _matches(_probe(table, pair[0], dense))[0]
            pair = ring_next(pair, group)
        acc = pair[1]
        local_matches = wrap_i32(acc.sum(dtype=torch.int64))
        return acc, local_matches, psum(local_matches, group)

    return local


def _top_local_keys(keys, candidates):
    """The ``min(candidates, n)`` local keys with the most rows, most
    first, ties in (unsigned) key order; fewer distinct keys pad with key
    0, as the JAX package's sort-based count pads."""
    uniq, counts = torch.unique_consecutive(sort_by_key(keys, unsigned=True),
                                            return_counts=True)
    top = uniq[torch.sort(-counts, stable=True).indices[:candidates]]
    k = min(candidates, keys.shape[0])
    return torch.cat([top, top.new_zeros(k - top.shape[0])])


def dist_csr_join_skew(mesh, rows_per_chip: int, distinct_cap: int,
                       ht_size: int, shuffle_capacity: int,
                       heavy_cap: int = 16, candidates_per_chip: int = 8,
                       heavy_rows_cap=None):
    """Skew-aware join. A hash shuffle sends every row of a key to one
    rank, so a heavy key overflows that rank's slot. Here:

      1. **Detect**: each rank nominates its ``candidates_per_chip`` most
         frequent local keys; the candidates are all-gathered and their
         exact global counts all-reduced; keys whose global count exceeds
         ``shuffle_capacity // 2`` are heavy (at most ``heavy_cap``, the
         heaviest). Every rank derives the same list.
      2. **Broadcast** the heavy keys' A rows (all-gathered with their
         global ids, at most ``heavy_rows_cap`` a rank): every rank builds
         the same small CSR table and probes its heavy B rows locally.
      3. **Shuffle** only the light tail and join as ``dist_csr_join``.

    Returns fn(a_keys, b_keys) -> (match counts per received light B row,
    match counts per local heavy B row in row order, the global total, this
    rank's shuffle overflow). The int32 total wraps mod 2^32: one heavy key
    at p % of both sides yields about (p n)^2 pairs; sum the per-row
    counts on the host in 64 bits for giant totals.

    Where the ranks' candidates number fewer than ``heavy_cap`` (a world
    of one with the defaults), the heavy list pads with EMPTY; the JAX
    package fails on those shapes."""
    group = mesh.get_group(ROW_AXIS)
    n_chips = axis_size(mesh, ROW_AXIS)
    me = mesh.get_local_rank(ROW_AXIS)
    if heavy_rows_cap is None:
        heavy_rows_cap = rows_per_chip
    threshold = max(shuffle_capacity // 2, 1)

    def local(a_keys, b_keys):
        device = a_keys.device
        ak, bk = a_keys, b_keys
        a_ids = _global_ids(me, rows_per_chip, ak.shape[0], device)

        # 1. heavy keys, the same on every rank
        cands = all_gather(_top_local_keys(ak, candidates_per_chip),
                           group).reshape(-1)
        local_counts = (ak[None, :] == cands[:, None]).sum(
            1, dtype=torch.int32)
        global_counts = psum(local_counts, group)
        srt_k, srt_c = sort_by_key(
            cands, torch.where(global_counts > threshold, global_counts, 0),
            unsigned=True)
        first = torch.ones_like(srt_k, dtype=torch.bool)
        first[1:] = srt_k[1:] != srt_k[:-1]
        eff_c = torch.where(first, srt_c, 0)
        neg_c, order = torch.sort(-eff_c, stable=True)
        k = min(heavy_cap, order.shape[0])
        heavy_keys = torch.full((heavy_cap,), EMPTY, dtype=torch.int32,
                                device=device)
        heavy_keys[:k] = torch.where(neg_c[:k] < 0, srt_k[order[:k]], EMPTY)
        heavy_a = (ak[None, :] == heavy_keys[:, None]).any(0)
        heavy_b = (bk[None, :] == heavy_keys[:, None]).any(0)

        # 2. broadcast-join the heavy keys
        (hk, hid), _ = compact_multi((ak, a_ids), heavy_a,
                                     capacity=heavy_rows_cap, fill=EMPTY)
        heavy_table = csr_join.build(
            all_gather(hk, group).reshape(-1), heavy_cap * 4,
            2 * heavy_cap * 4 + 2,
            row_ids=all_gather(hid, group).reshape(-1))
        heavy_counts, heavy_matches = _matches(csr_join.probe_merge(
            heavy_table, torch.where(heavy_b, bk, EMPTY)))

        # 3. hash-shuffle the light tail
        rak, rai, _, ov_a = partition_for_shuffle(
            ak, a_ids, n_chips, shuffle_capacity, group, drop=heavy_a)
        b_ids = _global_ids(me, rows_per_chip, bk.shape[0], device)
        rbk, _, _, ov_b = partition_for_shuffle(
            bk, b_ids, n_chips, shuffle_capacity, group, drop=heavy_b)
        table = csr_join.build(rak.reshape(-1), distinct_cap, ht_size,
                               row_ids=rai.reshape(-1))
        light_counts, light_matches = _matches(
            csr_join.probe_merge(table, rbk.reshape(-1)))
        total = psum(light_matches + heavy_matches, group)
        return light_counts, heavy_counts, total, ov_a + ov_b

    return local


def dist_hash_join_rows(mesh, shuffle_capacity: int, ht_size: int,
                        hash_seed=0x85EBCA6B):
    """Distributed 1:1 hash join returning MATERIALISED (key, a_val, b_val)
    rows, the reference Join dwarf's output (join/join.cpp:80-129): both
    tables hash-partition by key with their values as payload, each rank
    builds the parking hash table over the A rows it owns and probes its B
    rows, and the matches are compacted on the rank (kernel
    ``compact_mask``). The union of the ranks' rows is the join.

    Returns fn(a_keys, a_vals, b_keys, b_vals) -> (keys, a_vals, b_vals,
    each (n_chips * shuffle_capacity,) with garbage past the count; the
    count; this rank's shuffle overflow, which must be 0)."""
    group = mesh.get_group(ROW_AXIS)
    n_chips = axis_size(mesh, ROW_AXIS)

    def local(a_keys, a_vals, b_keys, b_vals):
        rak, (rav,), _, ov_a = partition_for_shuffle(
            a_keys, (a_vals,), n_chips, shuffle_capacity, group)
        rbk, (rbv,), _, ov_b = partition_for_shuffle(
            b_keys, (b_vals,), n_chips, shuffle_capacity, group)
        fak, fav = rak.reshape(-1), rav.reshape(-1)
        fbk, fbv = rbk.reshape(-1), rbv.reshape(-1)
        table = hashtable.build(fak, murmur3_32(fak, hash_seed, ht_size),
                                ht_size, payload=(fav,), valid=fak != EMPTY)
        found, av = hashtable.lookup(table, fbk,
                                     murmur3_32(fbk, hash_seed, ht_size))
        found = found & (fbk != EMPTY)
        (k, a, b), count = compact_cuda.compact_mask(found, (fbk, av, fbv))
        return k, a, b, count, ov_a + ov_b

    return local


def dist_csr_join_2d(mesh, rows_per_chip: int, distinct_cap: int,
                     ht_size: int, cap_ici: int, cap_dcn: int,
                     dense: bool = False):
    """``dist_csr_join`` on a (dcn, ici) mesh with the two-hop shuffle
    (``shuffle.partition_for_shuffle_2d``): rows cross hosts once. Row ids
    are GLOBAL (chip dcn_idx * n_ici + ici_idx).

    Returns fn(a_keys, b_keys) -> (match counts per received B row
    (n_dcn * cap_dcn,), this rank's total, the global total, this rank's
    shuffle overflow)."""
    dcn, ici = mesh.get_group(DCN_AXIS), mesh.get_group(ICI_AXIS)
    n_dcn, n_ici = axis_size(mesh, DCN_AXIS), axis_size(mesh, ICI_AXIS)
    me = linear_index(mesh)

    def local(a_keys, b_keys):
        device = a_keys.device
        a_ids = _global_ids(me, rows_per_chip, a_keys.shape[0], device)
        b_ids = _global_ids(me, rows_per_chip, b_keys.shape[0], device)
        rak, (rai,), _, ov_a = partition_for_shuffle_2d(
            a_keys, (a_ids,), n_dcn, n_ici, cap_ici, cap_dcn, dcn, ici)
        rbk, _, _, ov_b = partition_for_shuffle_2d(
            b_keys, (b_ids,), n_dcn, n_ici, cap_ici, cap_dcn, dcn, ici)
        res = _local_join(rak.reshape(-1), rai.reshape(-1), rbk.reshape(-1),
                          distinct_cap, ht_size, dense)
        counts, local_matches = _matches(res)
        # the mesh spans the world: its group is every dimension at once
        return counts, local_matches, psum(local_matches), ov_a + ov_b

    return local


def dist_csr_join_ring_2d(mesh, rows_per_chip: int, distinct_cap: int,
                          ht_size: int, dense: bool = False):
    """Ring join on a (dcn, ici) mesh: B chunks rotate through the chips of
    a host (n_ici hops), then take ONE hop to the next host, for every host:
    n_dcn crossings between hosts a chunk, where a flat ring takes n_chips.

    Returns fn(a_keys, b_keys) -> (global match counts of this rank's B
    rows, in row order; this rank's total; the global total)."""
    dcn, ici = mesh.get_group(DCN_AXIS), mesh.get_group(ICI_AXIS)
    n_dcn, n_ici = axis_size(mesh, DCN_AXIS), axis_size(mesh, ICI_AXIS)
    me = linear_index(mesh)

    def local(a_keys, b_keys):
        a_ids = _global_ids(me, rows_per_chip, a_keys.shape[0],
                            a_keys.device)
        table = _build(a_keys, a_ids, distinct_cap, ht_size, dense)
        pair = torch.stack([b_keys, torch.zeros_like(b_keys)])
        for _ in range(n_dcn):
            for _ in range(n_ici):
                pair[1] += _matches(_probe(table, pair[0], dense))[0]
                pair = ring_next(pair, ici)
            pair = ring_next(pair, dcn)
        acc = pair[1]
        local_matches = wrap_i32(acc.sum(dtype=torch.int64))
        return acc, local_matches, psum(local_matches)

    return local
