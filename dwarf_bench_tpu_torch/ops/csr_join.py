"""One-to-many CSR join index (the port of ``dwarf_bench_tpu/ops/csr_join.py``).

The reference's OmniSci-style join table (common/dpcpp/omnisci_hashtable.hpp)
keeps per-key counts, exclusive-scan positions and the A row ids grouped by
key (``id_buffer``); a probe returns a (position, count) view per query
(omnisci_hashtable.hpp:80-192).

General path (any keys): ``build`` sorts (key, row id) by key, so the
id_buffer is the sorted id column, and takes the segment starts (distinct
keys, positions, counts) with one compaction (kernel ``compact_mask``); a
parking hash table (``ops/hashtable.py``, SimpleHasher homes) maps key to
segment. Four probes give the same (found, pos, count): ``probe`` walks the
hash chains, ``probe_sorted`` binary-searches the sorted distinct keys,
``probe_merge`` merges them with the queries in one sort and scans, and
``probe_merge_bitonic`` runs the merge through the bitonic merge kernel
(4 columns) and one 3-column ``compact_mask`` on the card.

Dense path: for narrow key ranges (span < 2^14 after a min-shift, the
benchmark's uniform [1, 10000] columns) pos and counts are dense by key: the
build is the histogram kernel plus one pair sort, and the probe is a lookup
into two tables of 2^14 entries.

Keys are uint32 in the JAX package and int32 bit patterns here; EMPTY
(0xFFFFFFFF, padding) is -1. Unsigned order is the signed order of the keys
XOR 0x80000000 (``primitives.bias_u32``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import bitonic_cuda, compact_cuda, hashtable, trace
from .hashing import simple_hash
from .merge_lookup import deltas
from .primitives import as_u32, bias_u32, cummax, sort_by_key, wrap_i32
from .sort import histogram_dispatch

EMPTY = -1  # uint32 0xFFFFFFFF as an int32 bit pattern
_RANGE = 1 << 14
_TAG = -(1 << 31)  # aux bit 31 of the bitonic merge: query row
_M32 = 0xFFFFFFFF


class CsrJoinTable(NamedTuple):
    """The JAX package's ``CsrJoinTable``, field for field."""

    table: hashtable.HashTable  # key -> segment index
    pos: torch.Tensor  # (distinct_cap,) int32 start offset of each segment
    counts: torch.Tensor  # (distinct_cap,) int32 rows per segment
    id_buffer: torch.Tensor  # (n,) int32 A row ids grouped by key
    num_distinct: torch.Tensor  # 0-d int32
    distinct_keys: torch.Tensor  # (distinct_cap,) unsigned asc, EMPTY padding


class DenseCsrTable(NamedTuple):
    """The JAX package's ``DenseCsrTable``, field for field.

    ``packed``/``packed3``/``base128`` and their ``*_ok`` flags are the TPU
    layouts its MXU lookups read; all three lookups return the same (pos,
    count), so the port's probe indexes ``pos`` and ``counts`` directly.
    They are filled in all the same, so that the two packages' tables can be
    compared field by field."""

    minv: torch.Tensor  # int32 scalar: min valid key (uint32 bit pattern)
    counts: torch.Tensor  # (16384,) int32 rows per key
    pos: torch.Tensor  # (16384,) int32 start offset per key
    id_buffer: torch.Tensor  # (n,) int32 A row ids grouped by key
    num_distinct: torch.Tensor  # int32 scalar
    packed: torch.Tensor  # (16384,) int32: (pos << 12) | min(cnt, 4095)
    packed_ok: torch.Tensor  # bool scalar: all counts < 2^12
    base128: torch.Tensor  # (128,) int32 bucket base positions
    packed3: torch.Tensor  # (16384,) int32: (rel << 10) | min(cnt, 1023)
    packed3_ok: torch.Tensor  # bool: all rel < 2^14 and all counts < 2^10


class CsrProbeResult(NamedTuple):
    found: torch.Tensor  # (nb,) bool
    pos: torch.Tensor  # (nb,) int32 start into id_buffer
    counts: torch.Tensor  # (nb,) int32 match count


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def build(a_keys: torch.Tensor, distinct_cap: int, ht_size: int,
          row_ids=None) -> CsrJoinTable:
    """CSR index over any keys. Rows with key EMPTY are padding and are left
    out (they sort last, so the valid rows form a prefix). ``row_ids``
    replaces the local row numbers (the distributed join carries global ids
    through its shuffle). ``distinct_cap`` bounds the distinct keys (the
    reference sizes its table from a host count_distinct,
    join_omnisci.cpp:55-69) and ``ht_size`` is the hash table's slot count.

    The key sort is unstable, as the JAX package's: ids within a key are in
    no particular order (the reference places them with atomic fetch_adds)
    and only the id sets per key are defined. Counted in
    ``trace.TAKEN["csr_join:general"]``."""
    trace.take("csr_join", "general")
    n = a_keys.shape[0]
    device = a_keys.device
    ids = _iota(n, device) if row_ids is None else row_ids
    sk, sid = sort_by_key(a_keys, ids, stable=False, unsigned=True)
    row_valid = sk != EMPTY
    n_eff = row_valid.sum(dtype=torch.int32)
    is_start = torch.ones(n, dtype=torch.bool, device=device)
    if n > 1:
        is_start[1:] = sk[1:] != sk[:-1]
    is_start &= row_valid
    # the segment starts and their keys, in key order
    (starts, dk), num_distinct = compact_cuda.compact_mask(
        is_start, (_iota(n, device), sk), distinct_cap)
    in_cap = _iota(distinct_cap, device) < num_distinct
    # absent segments start at n_eff, so their counts are 0
    starts = torch.where(in_cap, starts, n_eff)
    counts = (torch.cat([starts[1:], n_eff[None]]) - starts).clamp_(min=0)
    distinct_keys = torch.where(in_cap, dk, EMPTY)
    table = hashtable.build(
        distinct_keys, simple_hash(distinct_keys, ht_size), ht_size,
        payload=(_iota(distinct_cap, device),), valid=in_cap)
    return CsrJoinTable(table, starts, counts, sid, num_distinct,
                        distinct_keys)


def _views(t: CsrJoinTable, found: torch.Tensor, seg: torch.Tensor):
    seg = torch.where(found, seg, 0).to(torch.int64)
    return CsrProbeResult(found, torch.where(found, t.pos[seg], 0),
                          torch.where(found, t.counts[seg], 0))


def probe(t: CsrJoinTable, b_keys: torch.Tensor) -> CsrProbeResult:
    """lookup() per B row through the hash table: (found, position, count),
    the reference's JoinOneToMany views (omnisci_hashtable.hpp:149-192)."""
    home = simple_hash(b_keys, t.table.size)
    found, seg = hashtable.lookup(t.table, b_keys, home, default=0)
    # padded queries (EMPTY) never match
    return _views(t, found & (b_keys != EMPTY), seg)


def probe_sorted(t: CsrJoinTable, b_keys: torch.Tensor) -> CsrProbeResult:
    """``probe``'s answers by a binary search of the sorted distinct keys
    (EMPTY padding sorts last)."""
    dk = t.distinct_keys
    cap = dk.shape[0]
    seg = torch.searchsorted(bias_u32(dk), bias_u32(b_keys))
    safe = seg.clamp(max=cap - 1)
    return _views(t, (dk[safe] == b_keys) & (b_keys != EMPTY), safe)


def probe_merge(t: CsrJoinTable, b_keys: torch.Tensor) -> CsrProbeResult:
    """``probe``'s answers without a random gather: one stable sort of
    [distinct keys | queries] (distinct rows first among equal keys), a
    running max that carries each run's (key, start) to the queries after
    it, a reversed running min that brings the next segment's start (the
    count is the difference), and one sort back to query order: the JAX
    package's ``probe_merge``, step for step, with two faults of it
    repaired (ROADMAP queue 3). It carries key + 1, so that "no distinct
    row yet" (0) differs from key 0, where the JAX function finds an absent
    key 0 at position -1; and rows past the last distinct row take the next
    start n_eff (the sum of the counts), where the JAX function takes 2^30
    and miscounts the largest key whenever ``distinct_cap`` equals the
    number of distinct keys (no EMPTY padding row), as its dwarf sets it."""
    nb = b_keys.shape[0]
    cap = t.distinct_keys.shape[0]
    device = b_keys.device
    keys_all = torch.cat([t.distinct_keys, b_keys])
    pos_col = torch.cat([t.pos, torch.zeros(nb, dtype=torch.int32,
                                            device=device)])
    idx_col = torch.cat([torch.full((cap,), -1, dtype=torch.int32,
                                    device=device), _iota(nb, device)])
    sk, sp, si = sort_by_key(keys_all, pos_col, idx_col, unsigned=True)
    isdk = si == -1
    # EMPTY + 1 wraps to 0, "no distinct row yet", which the max absorbs
    carry_key = cummax(torch.where(isdk, sk + 1, 0), unsigned=True)
    carry_pos = cummax(torch.where(isdk, sp, -1))
    nxt = torch.where(isdk, sp, t.counts.sum(dtype=torch.int32))
    npos = torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values, (0,))
    found = ~isdk & (carry_key == sk + 1) & (sk != EMPTY)
    pos = torch.where(found, carry_pos, 0)
    # (cnt, found) ride one column through the unsort
    packed = (torch.where(found, npos - carry_pos, 0) << 1) \
        | found.to(torch.int32)
    # query order back: the distinct rows carry index -1 and sort first
    _, p2, pk2 = sort_by_key(si, pos, packed)
    return CsrProbeResult((pk2[cap:] & 1) == 1, p2[cap:], pk2[cap:] >> 1)


def _probe_merge_bitonic(t: CsrJoinTable,
                         b_keys: torch.Tensor) -> CsrProbeResult:
    """The bitonic engine of ``probe_merge_bitonic`` on any device (the
    kernels on a CUDA tensor, their plain versions on a CPU tensor)."""
    nb = b_keys.shape[0]
    cap = t.distinct_keys.shape[0]
    device = b_keys.device
    if not 0 < nb < (1 << 30):
        raise ValueError(f"probe_merge_bitonic: {nb} queries; the index "
                         "must fit 30 bits")
    # the queries sorted by (key, index) as one int64 key
    packed = torch.sort((bias_u32(b_keys).to(torch.int64) << 32)
                        | torch.arange(nb, device=device)).values
    qs = bias_u32((packed >> 32).to(torch.int32))
    qidx = (packed & _M32).to(torch.int32)

    total = cap + nb
    npad = (1 << (total - 1).bit_length()) - total

    def pad(col, fill):
        return torch.cat([col, torch.full((npad,), fill, dtype=torch.int32,
                                          device=device)])

    zq = torch.zeros(nb, dtype=torch.int32, device=device)
    cols = (
        torch.cat([pad(t.distinct_keys, EMPTY), torch.flip(qs, (0,))]),
        torch.cat([pad(torch.zeros(cap, dtype=torch.int32, device=device),
                       -1), torch.flip(qidx | _TAG, (0,))]),
        # pos and count ride as deltas: their cumsum over the merged order
        # telescopes to the last table row's value
        torch.cat([pad(deltas(t.pos), 0), zq]),
        torch.cat([pad(deltas(t.counts), 0), zq]),
    )
    sk, sa, sp, sc = bitonic_cuda.merge_bitonic(cols, num_cmp=2)
    is_src = (sa & _TAG) == 0
    # EMPTY + 1 wraps to 0, "no table row yet", which the max absorbs
    carry = cummax(torch.where(is_src, sk + 1, 0), unsigned=True)
    found = ~is_src & (carry == sk + 1) & (sk != EMPTY)
    fpos = torch.where(found, torch.cumsum(torch.where(is_src, sp, 0), 0,
                                           dtype=torch.int32), 0)
    fcnt = torch.where(found, torch.cumsum(torch.where(is_src, sc, 0), 0,
                                           dtype=torch.int32), 0)
    qp = sa & 0x7FFFFFFF
    is_real = ~is_src & (qp < nb)
    dest = torch.where(is_real, (qp << 1) | found.to(torch.int32), EMPTY)
    (dest, fpos, fcnt), _ = compact_cuda.compact_mask(
        is_real, (dest, fpos, fcnt), nb)
    # every query appears once, so the nb dests are distinct: unsort
    sd, p2, c2 = sort_by_key(dest, fpos, fcnt, stable=False, unsigned=True)
    fnd = (sd & 1) == 1
    return CsrProbeResult(fnd, torch.where(fnd, p2, 0),
                          torch.where(fnd, c2, 0))


def probe_merge_bitonic(t: CsrJoinTable,
                        b_keys: torch.Tensor) -> CsrProbeResult:
    """``probe_merge``'s answers through a query pair sort, the bitonic
    merge kernel over 4 columns [distinct keys asc | EMPTY pad | queries
    desc] x (key, aux, pos delta, count delta) with ``num_cmp=2``, a running
    max and two cumsums, one 3-column ``compact_mask`` and one unsort.
    Requires nb < 2^30. On the CPU it is ``probe_merge``, as the JAX
    function is there (csr_join.py:209-210)."""
    if b_keys.device.type == "cpu":
        return probe_merge(t, b_keys)
    return _probe_merge_bitonic(t, b_keys)


def join_id_sets(t: CsrJoinTable, res: CsrProbeResult):
    """Per probe row, the set of A row ids of its view, for comparison with
    ``oracle_id_sets`` (join_omnisci.cpp:15-45 builds the same structure on
    the host)."""
    idbuf = t.id_buffer.cpu().numpy()
    return [set(idbuf[p: p + c].tolist()) if c > 0 else set()
            for p, c in zip(res.pos.cpu().tolist(),
                            res.counts.cpu().tolist())]


def build_dense(a_keys: torch.Tensor, row_ids=None) -> DenseCsrTable:
    """One-to-many CSR index: counts from the histogram kernel, pos their
    exclusive cumsum, and one pair sort for the id_buffer. PRECONDITION
    (checked on the host by ``dense_applicable``): valid keys span < 2^14
    as uint32. Rows with key EMPTY are padding and are left out.
    ``row_ids`` (int32 bit patterns) replace the local row numbers in the
    id_buffer: the distributed join carries global ids through its shuffle.

    The sort is stable, so ids keep their row order within a key. That is
    the order the JAX package's packed one-word sort gives for n < 2^18
    without ``row_ids``; otherwise its pair sort is unstable and only the
    id sets per key agree.

    Counted in ``trace.TAKEN["csr_join:dense"]`` (``build`` counts
    ``csr_join:general``). Under a profiler it opens the span
    ``build_dense`` and its phases ``build_dense.histogram`` (the min, the
    shift and the count histogram), ``.positions`` (the exclusive cumsum),
    ``.id_sort`` (the 16-bit keys, the stable pair sort, the id gather) and
    ``.layouts`` (``num_distinct`` and the TPU layouts); nothing is read
    back to the host."""
    trace.take("csr_join", "dense")
    sp = trace.begin("build_dense")
    try:
        if sp:
            sp.next("build_dense.histogram")
        n = a_keys.shape[0]
        device = a_keys.device
        ak = as_u32(a_keys)
        valid = a_keys != EMPTY
        minv = torch.min(torch.where(valid, ak, 0xFFFFFFFE))
        rel_key = ak - minv
        k = torch.where(valid, rel_key, -1).to(torch.int32)
        counts = histogram_dispatch(k)
        if sp:
            sp.next("build_dense.positions")
        pos = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        if sp:
            sp.next("build_dense.id_sort")
        # EMPTY rows take the key 0xFFFF, past every valid (< 2^14) key
        k16 = torch.where(valid, rel_key, 0xFFFF).to(torch.int32)
        ids = torch.arange(n, dtype=torch.int32, device=device) \
            if row_ids is None else row_ids
        _, sid = sort_by_key(k16, ids, stable=True)
        if sp:
            sp.next("build_dense.layouts")
        num_distinct = (counts > 0).sum(dtype=torch.int32)
        # pos of any non-empty key is <= n - cnt; keys with cnt == 0 may
        # wrap in the shift, and the probe masks them through found == False
        pos64 = pos.to(torch.int64)
        packed = wrap_i32((pos64 << 12)
                          | counts.clamp(max=4095).to(torch.int64))
        packed_ok = (counts.max() < 4096) & (n <= (1 << 20))
        bucket_sums = counts.reshape(128, 128).sum(dim=1, dtype=torch.int32)
        base128 = torch.cumsum(bucket_sums, 0, dtype=torch.int32) \
            - bucket_sums
        rel = pos - base128.repeat_interleave(128)
        packed3 = wrap_i32((rel.to(torch.int64) << 10)
                           | counts.clamp(max=1023).to(torch.int64))
        packed3_ok = (
            (rel.max() < (1 << 14)) & (counts.max() < 1024)
            & (n <= (1 << 24))
        )
        return DenseCsrTable(
            wrap_i32(minv), counts, pos, sid, num_distinct, packed,
            packed_ok, base128, packed3, packed3_ok,
        )
    finally:
        if sp:
            sp.close()


def probe_dense(
    t: DenseCsrTable, b_keys: torch.Tensor, hi_rows: int = 128
) -> CsrProbeResult:
    """lookup() per B row against the dense index. ``hi_rows`` < 128 is the
    JAX package's range-aware precondition (both columns' valid keys span
    < hi_rows·128 after the min-shift); queries past it are not found.
    Under a profiler it opens the span ``probe_dense``; nothing is read
    back to the host."""
    sp = trace.begin("probe_dense")
    try:
        q = as_u32(b_keys)
        k = (q - as_u32(t.minv)) & 0xFFFFFFFF
        in_range = (k < hi_rows * 128) & (b_keys != EMPTY)
        ki = torch.where(in_range, k, 0)
        pos = t.pos[ki]
        cnt = t.counts[ki]
        found = in_range & (cnt > 0)
        zero = torch.zeros_like(pos)
        return CsrProbeResult(
            found, torch.where(found, pos, zero),
            torch.where(found, cnt, zero)
        )
    finally:
        if sp:
            sp.close()


def table_from_numpy(fields: Sequence) -> DenseCsrTable:
    """A ``DenseCsrTable`` from the JAX package's table as numpy arrays, in
    field order (``table_from_numpy(jax_table)`` works, since a NamedTuple
    is a sequence), on the CPU. uint32 fields become int32 bit patterns."""
    if len(fields) != len(DenseCsrTable._fields):
        raise ValueError(
            f"table_from_numpy: {len(fields)} fields, expected "
            f"{len(DenseCsrTable._fields)}"
        )
    out = []
    for f in fields:
        a = np.array(f, copy=True)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a))
    return DenseCsrTable(*out)


def dense_hi_rows(a_keys, b_keys) -> int:
    """Host-side: the smallest hi-digit row count (multiple of 8, <= 128)
    covering both columns' valid key span — the ``probe_dense(hi_rows=)``
    precondition helper."""
    ks = np.concatenate(
        [np.asarray(a_keys, np.uint32), np.asarray(b_keys, np.uint32)]
    )
    ks = ks[ks != np.uint32(0xFFFFFFFF)]
    if ks.size == 0:
        return 8
    span = int(ks.max()) - int(ks.min()) + 1
    rows = -(-span // 128)
    return min(128, max(8, (rows + 7) // 8 * 8))


def dense_applicable(a_keys, b_keys) -> bool:
    """Host-side applicability check (the reference sizes its table from
    the same host knowledge, join_omnisci.cpp:55-58): both columns' valid
    keys must live in one < 2^14 uint32 window."""
    ks = np.concatenate(
        [np.asarray(a_keys, np.uint32), np.asarray(b_keys, np.uint32)]
    )
    ks = ks[ks != np.uint32(0xFFFFFFFF)]
    if ks.size == 0:
        return True
    return int(ks.max()) - int(ks.min()) < _RANGE


def oracle_id_sets(a_keys, b_keys):
    """Host oracle: for each B row, the set of A row ids with equal key
    (join_omnisci.cpp:15-45, without the O(n²) scan)."""
    a_keys = np.asarray(a_keys)
    by_key = {}
    for i, k in enumerate(a_keys):
        by_key.setdefault(int(k), set()).add(i)
    return [by_key.get(int(k), set()) for k in np.asarray(b_keys)]
