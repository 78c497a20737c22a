"""Filter / two-pass scan (stream compaction) for the scan dwarfs.

The port of ``dwarf_bench_tpu/ops/scan.py``. The reference's TwoPassScan
(scan/scan.cl:3-42) and DPLScan (scan/dplscan.cpp:43-44) both filter
``x < 5``. Engines:

  * ``filter_xla``: mask, cumsum, scatter to rank (``primitives.compact``);
  * ``filter_two_pass``: per-tile counts, exclusive tile offsets, scatter at
    tile offset + rank within the tile, in plain torch;
  * ``filter_sparse``: the sparsity-adaptive engine, with the kernels
    ``chunk_stats`` (and ``cumsum``), ``scan_tail_streams``,
    ``compact_mask``, ``emit_prefix`` and, where its caps trip, ``filter``.

Outputs follow the fixed-capacity + count pattern: ``(out[capacity], count)``
with garbage past ``count`` and ``count`` a 0-d int32 tensor on the input's
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import (
    chunk_stats_cuda,
    compact_cuda,
    filter_cuda,
    scan_tail_cuda,
    trace,
)
from .chunk_stats import chunk_stats
from .filter_cuda import DEFAULT_THRESHOLD  # x < 5 (scan/scan.cl:14)
from .primitives import compact, exclusive_cumsum

# position sentinel of the ordering sort: sorts after every real position
_BIG = scan_tail_cuda.BIG

_TWO_PASS_TILE = 8192  # the JAX filter_two_pass's default tile


def filter_xla(x: torch.Tensor, threshold: int = DEFAULT_THRESHOLD,
               capacity: Optional[int] = None):
    """copy_if(x, x < threshold) -> (out, count)."""
    return compact(x, x < threshold, capacity)


def filter_two_pass(x: torch.Tensor, threshold: int = DEFAULT_THRESHOLD,
                    capacity: Optional[int] = None):
    """Two-pass tiled filter mirroring scan/scan.cl's structure: per-tile
    match counts (pass 1), an exclusive cumsum over them (the reference's
    thread-0 serial loop, scan.cl:23-31), and each tile's matches scattered
    at tile offset + rank within the tile (pass 2). Out-of-capacity writes
    are dropped; ``count`` is the full count."""
    n = x.shape[0]
    if capacity is None:
        capacity = n
    tile = _TWO_PASS_TILE
    pad = (-n) % tile
    xp = torch.cat([x, torch.full((pad,), threshold, dtype=x.dtype,
                                  device=x.device)]) if pad else x
    mask = (xp.view(-1, tile) < threshold).to(torch.int32)
    tile_counts = mask.sum(1, dtype=torch.int32)  # pass 1
    tile_offsets = exclusive_cumsum(tile_counts)  # prefix
    count = tile_offsets[-1] + tile_counts[-1]
    rank = tile_offsets[:, None] + exclusive_cumsum(mask, 1)  # pass 2
    idx = torch.where((mask > 0) & (rank < capacity), rank, capacity)
    out = torch.zeros(capacity + 1, dtype=x.dtype, device=x.device)
    out[idx.view(-1).to(torch.int64)] = xp
    return out[:capacity], count


def sparse_counts(x, threshold: int = DEFAULT_THRESHOLD, chunk: int = 128):
    """(n_single, n_multi, n_melems) of the numpy int32 host column, as
    ``filter_sparse`` counts them on the device: the in-window single-match
    chunks, the other matching chunks, and the matches outside the
    singles; the quantities its caps bound."""
    x = np.asarray(x)
    thr = int(threshold)
    pad = (-x.shape[0]) % chunk
    xp = np.pad(x, (0, pad), constant_values=thr)
    x2 = xp.reshape(-1, chunk)
    m = x2 < thr
    cnt = m.sum(axis=1)
    # window encoding (ops/chunk_stats): vsum is the match's distance only
    # when the single match lies in (thr-256, thr); out-of-window singles
    # (the vsum 256 marker) take the multi/gather path
    d = np.clip(thr - np.maximum(x2, thr - 512), 0, 256)
    vs = np.minimum(d.sum(axis=1), 511)
    single = (cnt == 1) & (vs >= 1) & (vs <= 255)
    multi = (cnt >= 1) & ~single
    n_single = int(single.sum())
    return n_single, int(multi.sum()), int(cnt.sum()) - n_single


def sparse_caps_ok(
    x,
    threshold: int = DEFAULT_THRESHOLD,
    chunk: int = 128,
    cap_mc: Optional[int] = None,
    cap_single: Optional[int] = None,
    cap_melems: Optional[int] = None,
) -> bool:
    """Host-side precondition of ``filter_sparse(assume_sparse=True)``: the
    numpy host column fits the sparse pipeline's caps. Replicates the
    on-device ``ok`` predicate exactly (the chunk classification of
    ops/chunk_stats), so a caller that holds the host data checks the caps
    once instead of reading ``ok`` back from the card on every call (the
    radix host-range-check convention)."""
    x = np.asarray(x)
    n = x.shape[0]
    if x.dtype != np.int32 or n >= (1 << 30):
        return False
    if int(threshold) <= -(2**31) + 512:
        return False
    if cap_mc is None:
        cap_mc = max(512, n >> 15)
    if cap_single is None:
        cap_single = max(16384, n >> 10)
    if cap_melems is None:
        cap_melems = max(4096, n >> 12)
    n_single, n_multi, n_melems = sparse_counts(x, threshold, chunk)
    return (
        n_single <= cap_single
        and n_multi <= cap_mc
        and n_melems <= cap_melems
    )


def _iota(k: int, device: torch.device) -> torch.Tensor:
    return torch.arange(k, dtype=torch.int32, device=device)


def filter_sparse(
    x: torch.Tensor,
    threshold: int = DEFAULT_THRESHOLD,
    capacity: Optional[int] = None,
    chunk: int = 128,
    cap_mc: Optional[int] = None,
    cap_single: Optional[int] = None,
    cap_melems: Optional[int] = None,
    stats_pallas: Optional[bool] = None,
    assume_sparse: bool = False,
):
    """Sparsity-adaptive copy_if -> (out, count).

    The reference predicate (x < 5 over uniform [1, 10000]) keeps ~0.04 % of
    the rows, so the engine avoids a full compaction of x:

      phase A (kernel ``chunk_stats``, then ``cumsum``): per 128-row chunk
        the match count, the window-encoded match sum and the exclusive
        output offset. A chunk with one match inside the 255-wide window
        below the threshold needs no second read of x: its value is
        ``threshold - vsum``.
      tail (kernel ``scan_tail_streams``): singles' (position, value) and the
        other matching chunks' (id, offset) compacted in one pass.
      phase B: the <= ``cap_mc`` multi chunks are gathered, their matches
        given positions in-chunk and compacted (kernel ``compact_mask``) to
        <= ``cap_melems`` (position, value) pairs.
      ordering: one small sort of singles and multi elements by position
        (unique; the sentinel ``_BIG`` sorts past ``count``), and the sorted
        values go to the front of the output (kernel ``emit_prefix``, which
        gathers them by the sort's order in the same launch).

    When a cap trips, the general compaction (kernel ``filter``) runs
    instead, so every selectivity gives the right answer. This structure
    runs on every device; on the CPU the kernels' plain twins stand in.

    ``stats_pallas`` selects the JAX package's round-2 path, as there
    (dwarf_bench_tpu/ops/scan.py:244-256, 334-410): phase A from the
    ``chunk_stats`` kernel (``csrc/chunk_stats.cu`` under the name
    ``chunk_stats_pallas``, with ``base`` from the cumsum kernel) when True,
    from the plain ``chunk_stats`` when False; then the singles' (base,
    value) and the multi chunks' ids are compacted separately
    (``compact_mask``, 2 columns, then 1) and the multis' offsets gathered
    from ``base``. The rest is the same. None (the default) is the
    streaming tail above, with phase A from ``chunk_stats_cuda.chunk_stats``
    (the kernel on the card, the plain ``chunk_stats`` on the CPU) where the
    JAX package fuses ``chunk_stats_xla`` with XLA.

    ``assume_sparse=True`` (PRECONDITION: ``sparse_caps_ok`` holds on the
    host) runs the sparse pipeline without looking at the caps, and reads
    nothing back from the card. Otherwise the caps' predicate is read once
    on the host to pick the branch.

    Non-int32 input and n >= 2^30 (position sentinel headroom) take the
    general engine: the ``filter`` kernel on the card (int32 only; other
    dtypes raise there) and ``filter_two_pass`` on the CPU.

    Each phase is a span (``ops/trace.py``): ``filter_sparse.phase_a``,
    ``.tail``, ``.caps`` (the read), ``.phase_b``, ``.order``, ``.emit``,
    or ``.general``; the ``stats_pallas`` path has the same phases.
    """
    n = x.shape[0]
    assert chunk == 128, "filter_sparse chunks are 128 rows"
    if capacity is None:
        capacity = n
    sp = trace.begin("filter_sparse")
    try:
        if x.dtype != torch.int32 or n >= (1 << 30):
            trace.take("filter_sparse", "general")
            if sp:
                sp.next("filter_sparse.general")
            if x.device.type == "cuda":
                return filter_cuda.filter(x, threshold, capacity)
            return filter_two_pass(x, threshold, capacity)
        if cap_mc is None:
            # expected multi-match chunks at the benchmark selectivity
            # s = 4e-4 are (chunk·s)²/2 per chunk ≈ n/2^17; the caps scale
            # with n
            cap_mc = max(512, n >> 15)
        if cap_single is None:
            cap_single = max(16384, n >> 10)
        if cap_melems is None:
            cap_melems = max(4096, n >> 12)
        thr = int(threshold)
        device = x.device

        if sp:
            sp.next("filter_sparse.phase_a")
        pad = (-n) % chunk
        # padded rows hold the threshold, so they never match
        xp = torch.cat([x, torch.full((pad,), thr, dtype=torch.int32,
                                      device=device)]) if pad else x
        nch = xp.shape[0] // chunk
        x2 = xp.view(nch, chunk)
        if stats_pallas is None:
            stat, base = chunk_stats_cuda.chunk_stats(x2, thr)
            if sp:
                sp.next("filter_sparse.tail")
            spos, sval, mids, mbase, n_single, n_multi = (
                scan_tail_cuda.scan_tail_streams(stat, base, thr, cap_single,
                                                 cap_mc)
            )
        else:
            # the JAX package's round-2 path: the stats from the kernel or
            # from plain torch, then one compaction per chunk class
            stats = chunk_stats_cuda.chunk_stats_pallas if stats_pallas \
                else chunk_stats
            stat, base = stats(x2, thr)
            if sp:
                sp.next("filter_sparse.tail")
            cnt, vsw = stat >> 9, stat & 511
            single = (cnt == 1) & (vsw >= 1) & (vsw <= 255)
            multi = (cnt >= 1) & ~single
            (spos, sval), n_single = compact_cuda.compact_mask(
                single, (base, thr - vsw), cap_single)
            spos = torch.where(_iota(cap_single, device) < n_single, spos,
                               _BIG)
            (mids,), n_multi = compact_cuda.compact_mask(
                multi, (_iota(nch, device),), cap_mc)
            mbase = base[torch.where(_iota(cap_mc, device) < n_multi, mids,
                                     0)]
        total = base[-1] + (stat[-1] >> 9)
        n_melems = total - n_single
        if not assume_sparse:
            if sp:
                sp.next("filter_sparse.caps")
            ok = (
                (n_single <= cap_single)
                & (n_multi <= cap_mc)
                & (n_melems <= cap_melems)
            )
            # threshold - 512 must not wrap in the window encoding. The one
            # host read of this path: eager torch has no lax.cond.
            if thr <= -(2**31) + 512 or not trace.read(
                    ok, "filter_sparse.caps"):
                trace.take("filter_sparse", "general")
                if sp:
                    sp.next("filter_sparse.general")
                return filter_cuda.filter(x, thr, capacity)
        trace.take("filter_sparse", "sparse")

        if sp:
            sp.next("filter_sparse.phase_b")
        valid_m = _iota(cap_mc, device) < n_multi
        rows = x2[torch.where(valid_m, mids, 0)]  # (cap_mc, chunk) row gather
        gm = (rows < thr) & valid_m[:, None]
        gpos = torch.where(gm, mbase[:, None] + exclusive_cumsum(
            gm.to(torch.int32), 1), _BIG)
        (mpos, mval), _ = compact_cuda.compact_mask(
            gm.view(-1), (gpos.view(-1), rows.reshape(-1)), cap_melems)
        mpos = torch.where(_iota(cap_melems, device) < n_melems, mpos, _BIG)
        if sp:
            sp.next("filter_sparse.order")
        all_pos = torch.cat([spos, mpos])
        all_val = torch.cat([sval, mval])
        # valid positions are unique and the sentinel rows are garbage, so
        # an unstable sort is exact; the emit gathers the values in sorted
        # order
        order = torch.sort(all_pos).indices
        if sp:
            sp.next("filter_sparse.emit")
        k = min(capacity, all_val.shape[0])
        return compact_cuda.emit_prefix(all_val, capacity, order[:k]), total
    finally:
        if sp:
            sp.close()


def filter_oracle(x, threshold: int = DEFAULT_THRESHOLD):
    """Host oracle: std::copy_if equivalent (scan/scan.cpp:12-17)."""
    x = np.asarray(x)
    return x[x < threshold]
