"""Gather-free bulk hash-table lookup: sort-merge plus a segmented fill
(``dwarf_bench_tpu/ops/merge_lookup.py``).

One merge of [table keys | queries] (table rows first among equal keys), a
forward fill that carries each table row's value to the queries of its run,
and one unsort. The fill of arbitrary values is a DELTA cumsum: each table
row carries the mod-2^32 delta to its predecessor's value, so a running sum
over the merged order telescopes to the last preceding table row's value.

The JAX package picked this engine because random gathers serialize on the
TPU (merge_lookup.py:3-10). That reasoning does not hold on the H100; the
port keeps the dispatch so that the kernels are on the path and the parity
holds (whether the tile engine is faster on the card is a PERF.md open
question).

RESERVED KEY: 0xFFFFFFFF (EMPTY, -1 as int32) is the padding sentinel; a
table key equal to it is unfindable, and queries equal to it return
(False, 0). Keys and values are int32 bit patterns of uint32 columns.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import bitonic_cuda, compact_cuda, merge_fill_cuda
from .primitives import bias_u32, cummax, sort_by_key, wrap_i32

EMPTY = -1  # 0xFFFFFFFF
_TAG = -(1 << 31)  # aux bit 31: query row (table rows clear it)
_M32 = 0xFFFFFFFF


def deltas(tv: torch.Tensor) -> torch.Tensor:
    """dv_i = val_i - val_{i-1} mod 2^32, dv_0 = val_0."""
    if tv.numel() == 0:
        return tv.clone()
    v = tv.to(torch.int64)
    d = v - torch.roll(v, 1)
    d[0] = v[0]
    return wrap_i32(d)


def merge_lookup(sorted_keys, sorted_vals, queries):
    """(found, val) per query, the full-concat-sort engine. ``sorted_keys``
    ascending uint32 with EMPTY padding last; duplicate table keys must be
    pre-aggregated (otherwise the LAST duplicate's value wins)."""
    nt, nq = sorted_keys.shape[0], queries.shape[0]
    dev = queries.device
    keys_all = torch.cat([sorted_keys, queries])
    vals_all = torch.cat([deltas(sorted_vals),
                          torch.zeros(nq, dtype=torch.int32, device=dev)])
    # idx doubles as the class marker (-1 = table row); the STABLE sort
    # keeps table rows (first in the concat) first among equal keys
    idx = torch.cat([torch.full((nt,), -1, dtype=torch.int64, device=dev),
                     torch.arange(nq, dtype=torch.int64, device=dev)])
    sk, sv, si = sort_by_key(keys_all, vals_all, idx, unsigned=True)
    is_src = si < 0
    fv = wrap_i32(torch.cumsum(sv, 0, dtype=torch.int64))
    nsrc = torch.cumsum(is_src.to(torch.int32), 0)
    carry_key = cummax(torch.where(is_src, sk, 0), unsigned=True)
    found = ~is_src & (nsrc > 0) & (carry_key == sk) & (sk != EMPTY)
    val = torch.where(found, fv, 0)
    # restore query order (queries carry si >= 0; table rows sort first)
    _, f2, v2 = sort_by_key(si, found, val)
    return f2[nt:], v2[nt:]


def merge_columns(sorted_keys, sorted_vals, queries, val_bits: int = 32,
                  membership: bool = False):
    """The bitonic input of ``merge_lookup_bitonic`` (merge_lookup.py:
    142-172): (keys, aux[, deltas]) of [table asc | EMPTY pad | queries
    sorted by (key, index), flipped], N = the next power of two of
    nt + nq. Two columns for ``membership`` and ``val_bits=16``, three
    for ``val_bits=32``. Requires 0 < nq < 2^30."""
    nt, nq = sorted_keys.shape[0], queries.shape[0]
    dev = queries.device
    if not 0 < nq < (1 << 30):
        raise ValueError(f"merge_columns: {nq} queries; the index must fit "
                         "30 bits")
    # lax.sort((q, idx), num_keys=2) as one int64 key: the biased key
    # (signed order = unsigned order of q) in the high half, idx below
    qi = torch.arange(nq, dtype=torch.int64, device=dev)
    packed = torch.sort((bias_u32(queries).to(torch.int64) << 32) | qi).values
    qs = bias_u32((packed >> 32).to(torch.int32))
    qidx = (packed & _M32).to(torch.int32)

    total = nt + nq
    npad = (1 << (total - 1).bit_length()) - total
    dv = deltas(sorted_vals)
    aux_t = torch.zeros(nt, dtype=torch.int32, device=dev)
    extra = ()
    if not membership and val_bits == 16:
        aux_t = dv & 0xFFFF
    elif not membership:
        extra = (torch.cat([dv, torch.zeros(npad + nq, dtype=torch.int32,
                                             device=dev)]),)
    keys_all = torch.cat([
        sorted_keys,
        torch.full((npad,), EMPTY, dtype=torch.int32, device=dev),
        torch.flip(qs, (0,)),
    ])
    aux_all = torch.cat([
        aux_t,
        torch.full((npad,), -1, dtype=torch.int32, device=dev),
        torch.flip(qidx | _TAG, (0,)),
    ])
    return (keys_all, aux_all) + extra


def merge_lookup_bitonic(sorted_keys, sorted_vals, queries,
                         val_bits: int = 32, membership: bool = False,
                         compact_first: Optional[bool] = None):
    """``merge_lookup`` semantics through a query pair sort and a bitonic
    merge against the pre-sorted table:

      1. sort the queries by (key, index), one int64 key;
      2. merge [table asc | EMPTY pad peak | flip(queries)] under the
         (key, aux) order (``merge_bitonic``); aux is the table row's value
         delta mod 2^16 (``val_bits=16``) or 0 and bit 31 clear, and
         TAG | index on query rows, so table rows come first among equal
         keys; ``val_bits=32`` adds a third column of deltas;
      3. the fused fill (``merge_fill``);
      4. drop the non-query rows (``compact_mask`` when ``compact_first``,
         the default for a CUDA tensor) and unsort by dest =
         (index << 1) | found.

    For a CUDA tensor the merge, the fill and the compaction are the
    kernels of ``csrc/``; for a CPU tensor their plain twins, which are the
    JAX package's CPU branch. JAX's condition that the merged length be a
    multiple of 8 * 4096 for the fill (merge_lookup.py:186-189) is a TPU
    block constraint: the CUDA fill takes any length.

    Contract of ``merge_lookup``; ``val_bits=16`` is exact iff every table
    value is below 2^16. Requires nq < 2^30."""
    nq = queries.shape[0]
    dev = queries.device
    if nq == 0:
        return (torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    cols = merge_columns(sorted_keys, sorted_vals, queries, val_bits,
                         membership)
    merged = bitonic_cuda.merge_bitonic(cols, num_cmp=2)
    dest, val = merge_fill_cuda.merge_fill(
        merged[0], merged[1], merged[2] if len(merged) == 3 else None, nq,
        val16=(val_bits == 16 and not membership), membership=membership)
    is_real_q = dest != -1

    if compact_first is None:
        compact_first = dev.type != "cpu"
    cols_u = (dest,) if membership else (dest, val)
    if compact_first:
        # every real query appears exactly once, so capacity == count
        cols_u, _ = compact_cuda.compact_mask(is_real_q, cols_u, capacity=nq)
    # unsort: real dests are distinct and < 2^31, the -1 rows sort last
    # as unsigned (uint32 0xFFFFFFFF)
    sd, order = torch.sort(bias_u32(cols_u[0]))
    sd = bias_u32(sd[:nq])
    found_out = (sd & 1) == 1
    if membership:
        return found_out, torch.zeros(nq, dtype=torch.int32, device=dev)
    sval = cols_u[1][order[:nq]]
    return found_out, torch.where(found_out, sval, 0)


def sort_table(keys, vals=None):
    """Key-sorted copy for ``merge_lookup``: (sorted_keys, sorted_vals) with
    EMPTY keys (padding, free slots) last. The sort is stable, so the order
    of duplicate keys' values is the input order (the JAX package's sort is
    unstable there)."""
    if vals is None:
        sk = sort_by_key(keys, unsigned=True)
        return sk, torch.zeros_like(sk)
    return sort_by_key(keys, vals, unsigned=True)
