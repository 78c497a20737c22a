"""Mask compaction and the prefix emit: CUDA kernels (``csrc/compact.cu``)
and their plain PyTorch twins.

``compact_mask`` is the contract of ``dwarf_bench_tpu/ops/compact_pallas.py``
``compact_mask_pallas``: copy_if of 1-3 int32 columns by one mask, keeping
order, into ``capacity`` slots (default the column length); returns
``(tuple_of_outs, count)`` with garbage past ``count`` and ``count`` the full
number of selected rows, a 0-d int32 tensor on the columns' device. The mask
is a bool tensor.

``emit_prefix`` is the contract of ``emit_prefix_pallas``: ``vals``
(L <= capacity) in slots [0, L) of a (capacity,) int32 buffer whose other
slots are left uninitialised (garbage past the caller's count). With an
int64 ``index`` it emits ``vals[index]`` (L = the index's length) in the
same one launch: the sparse scan's gather and emit together, where the
JAX package sorts (position, value) pairs and emits the sorted values.

A wrapper takes the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises. ``compact_mask`` is one launch a call, with
no memset: its scratch is one lasting buffer a stream, which the kernel
leaves zero. ``_lookback_compact`` renders the schedule of
``csrc/compact.cuh`` (tiles, the in-tile ranks, the look-back over the
tiles' status words, blocks interleaved in a scrambled order) in plain
PyTorch for the tests; ``filter_cuda`` and ``scan_tail_cuda`` run it too.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build, trace
from .primitives import compact_multi


def _check_mask(mask: torch.Tensor, n: int, device: torch.device) -> None:
    if not isinstance(mask, torch.Tensor) or mask.dim() != 1:
        raise ValueError("compact_mask: the mask must be a 1-D tensor")
    if mask.numel() != n or mask.device != device:
        raise ValueError(
            f"compact_mask: mask of {mask.numel()} rows on {mask.device}, "
            f"columns of {n} rows on {device}"
        )
    if mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError(f"compact_mask: the mask must be a contiguous bool "
                         f"tensor, got {mask.dtype}")


def _check_cols(cols: Sequence[torch.Tensor]):
    cols = tuple(cols)
    if not 1 <= len(cols) <= 3:
        raise ValueError(f"compact_mask: 1-3 columns, got {len(cols)}")
    device = _build.check_vectors("compact_mask", *cols)
    n = cols[0].numel()
    if any(c.numel() != n for c in cols):
        raise ValueError("compact_mask: columns of different lengths")
    return cols, device, n


def compact_mask_plain(mask: torch.Tensor, cols: Sequence[torch.Tensor],
                       capacity: Optional[int] = None):
    return compact_multi(tuple(cols), mask, capacity)


def compact_mask(mask: torch.Tensor, cols: Sequence[torch.Tensor],
                 capacity: Optional[int] = None):
    sp = trace.begin("kernel.compact_mask")
    try:
        cols, device, n = _check_cols(cols)
        _check_mask(mask, n, device)
        cap = _build.check_capacity("compact_mask", capacity, n)
        if device.type == "cpu":
            return compact_mask_plain(mask, cols, cap)
        # two counters and the status words: zero when made, left zero
        scratch = _build.stream_scratch("compact", device,
                                        _build.compact_scratch_words(n, 1))
        outs = [cols[0].new_empty(cap) for _ in cols]
        count = cols[0].new_empty(())
        col_ptrs = [c.data_ptr() for c in cols] + [None] * (3 - len(cols))
        out_ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(cols))
        _build.launch("dbt_compact_mask", device, mask.data_ptr(), *col_ptrs,
                      len(cols), n, *out_ptrs, cap, count.data_ptr(),
                      scratch.data_ptr())
        _build.LAUNCHES["compact_mask"] += 1
        return tuple(outs), count
    finally:
        if sp:
            sp.close()


_AGGREGATE, _PREFIX = 1, 2  # status flags of csrc/compact.cuh
_M32 = 0xFFFFFFFF
_STATES = {0: "none", _AGGREGATE: "aggregate", _PREFIX: "prefix"}


def _in_tile_ranks(keep: torch.Tensor, warps: int, vecs: int, lanes: int):
    """The kernel's in-tile ranks of one stream's flags shaped (tiles,
    warps, vecs, lanes, 4): in each group of 4 runs, a lane's counts of its
    runs packed one byte a run into one word, scanned across the lanes; the
    warp's runs chained; the warp counts scanned. Returns (each row's rank
    within its tile, each tile's count)."""
    assert 4 * lanes <= 255, "a run's count fits a byte"
    k = keep.to(torch.int64)
    own = k.sum(4)                                    # (t, w, v, l)
    below, runs = [], []
    for g in range(0, vecs, 4):
        grp = own[:, :, g: g + 4]
        shifts = 8 * torch.arange(grp.shape[2], dtype=torch.int64)
        packed = (grp << shifts[:, None]).sum(2)      # (t, w, l)
        inc = torch.cumsum(packed, 2)
        below.append(((inc - packed)[:, :, None, :] >> shifts[:, None])
                     & 0xFF)
        runs.append((inc[..., -1:] >> shifts) & 0xFF)
    lane_below, runs = torch.cat(below, 2), torch.cat(runs, 2)
    warp_count = runs.sum(2)                          # (t, w)
    before_run = torch.cumsum(runs, 2) - runs
    before_warp = torch.cumsum(warp_count, 1) - warp_count
    in_run = torch.cumsum(k, 4) - k
    rank = (before_warp[:, :, None, None, None] + before_run[..., None, None]
            + lane_below[..., None] + in_run)
    return rank.reshape(rank.shape[0], -1), warp_count.sum(1)


def _read_state(words) -> str:
    """How a reader sees one predecessor's K status words."""
    flags = sorted({w >> 32 for w in words})
    if len(flags) == 1:
        return _STATES[flags[0]]
    return "one flag" if flags[0] == 0 else "aggregate and prefix"


def _nearest(words, s, flag) -> int:
    """The distance - 1 of the nearest word of stream ``s`` with ``flag`` in
    a look-back window, or the window's length."""
    return next((d for d, w in enumerate(words) if w[s] >> 32 == flag),
                len(words))


def _tile_steps(t, k, agg, status, write, window, reads, finish):
    """Block ``t`` of the kernel as a generator, one step a store or a read
    of its look-back window: publish each stream's aggregate, walk back to
    each stream's inclusive prefix (reading the window again while, in a
    stream still open, a word nearer than its nearest prefix is
    unpublished), publish the prefixes, write its kept rows
    (``write(t, prefixes)``), count itself finished."""
    b = [0] * k
    if t:
        for s in range(k):
            status[t][s] = _AGGREGATE << 32 | agg[t][s]
            yield
        open_ = [True] * k
        last = t - 1
        while True:
            while True:
                words = [status[i] if i >= 0 else [_PREFIX << 32] * k
                         for i in range(last, last - window, -1)]
                for i, w in zip(range(last, last - window, -1), words):
                    if i >= 0:
                        reads[_read_state(w)] += 1
                if not any(open_[s] and _nearest(words, s, 0)
                           < _nearest(words, s, _PREFIX) for s in range(k)):
                    break
                yield
            for s in range(k):
                if open_[s]:
                    flags = [w[s] >> 32 for w in words]
                    stop = flags.index(_PREFIX) if _PREFIX in flags \
                        else window - 1
                    b[s] = (b[s] + sum(w[s] & _M32 for w in words[: stop + 1])
                            ) & _M32
                    open_[s] = _PREFIX not in flags
            if not any(open_):
                break
            last -= window
    for s in range(k):
        status[t][s] = _PREFIX << 32 | (b[s] + agg[t][s]) & _M32
        yield
    write(t, b)
    finish()


def _lookback_compact(keep: torch.Tensor, emit, caps, *, warps: int = 16,
                      vecs: int = 4, lanes: int = 32, window: int = 32,
                      resident: int = 8, seed: Optional[int] = None,
                      last_tile=None):
    """A compaction by the schedule of ``csrc/compact.cuh``, for the tests.
    ``keep`` is a (K, n) bool tensor, ``emit[s]`` the columns stream ``s``
    writes and ``caps[s]`` its slots. Tiles of warps x vecs x lanes x 4 rows
    (the kernel's 16 x 4 x 32 x 4 for the mask, 16 x 8 x 32 x 4 for the
    filter, ``scan_tail_cuda.TAIL_TILE`` for the scan tail) take tickets in
    order. With a ``seed``, ``resident`` blocks run at a time, a new one
    starting as soon as one ends, and the running blocks advance one step at
    a time in an order drawn from it, so tiles publish out of order and a
    look-back finds words unpublished, aggregates, prefixes, and with K = 2
    one word of a pair published; without one, each block runs to its end
    before the next starts. The look-back reads ``window`` predecessors at a
    time (32 in the kernel: a word a lane of warp 0). A block writes its
    kept rows once its prefixes are known: row r of stream s goes to its
    tile's prefix + its rank, unless that reaches ``caps[s]``; slots no row
    reaches are -1. The last tile's block then calls ``last_tile(outs,
    counts)`` (the kernel's Op::last_tile), if given. Returns (outs a
    stream, counts as 0-d int32 tensors, the states the look-backs read);
    asserts that the last block out left every status word zero."""
    k, n = keep.shape
    tile_rows = warps * vecs * lanes * 4
    ntiles = max(-(-n // tile_rows), 1)
    flags = torch.zeros(k, ntiles * tile_rows, dtype=torch.bool)
    flags[:, :n] = keep.cpu()
    ranks, agg = zip(*(_in_tile_ranks(
        flags[s].view(ntiles, warps, vecs, lanes, 4), warps, vecs, lanes)
        for s in range(k)))
    agg = [[int(agg[s][t]) for s in range(k)] for t in range(ntiles)]
    status = [[0] * k for _ in range(ntiles)]
    reads = collections.Counter()
    finished = [0]
    outs = [tuple(torch.full((caps[s],), -1, dtype=torch.int32)
                  for _ in emit[s]) for s in range(k)]
    counts = [None] * k

    def write(t, before):  # tile t's kept rows, then the last tile's counts
        rows = slice(t * tile_rows, min((t + 1) * tile_rows, n))
        for s in range(k):
            pos = before[s] + ranks[s][t][: rows.stop - rows.start]
            hit = flags[s, rows] & (pos < caps[s])
            for o, col in zip(outs[s], emit[s]):
                o[pos[hit]] = col.cpu()[rows][hit]
        if t == ntiles - 1:
            for s in range(k):
                counts[s] = torch.tensor((before[s] + agg[t][s]) & _M32,
                                         dtype=torch.int64).to(torch.int32)
            if last_tile is not None:
                last_tile(outs, counts)

    def finish():  # the last block out zeroes the status words
        finished[0] += 1
        if finished[0] == ntiles:
            for words in status:
                words[:] = [0] * k

    rng = None if seed is None else np.random.default_rng(seed)
    live, started = [], 0
    while started < ntiles or live:
        if rng is None:  # each block runs to its end
            pick = 0 if live else len(live)
        elif started < ntiles and len(live) < resident:
            pick = len(live)  # a block starts once a slot is free
        else:
            pick = int(rng.integers(len(live)))
        if pick == len(live):
            live.append(_tile_steps(started, k, agg, status, write, window,
                                    reads, finish))
            started += 1
            continue
        try:
            next(live[pick])
        except StopIteration:
            live.pop(pick)
    assert all(w == [0] * k for w in status), "status words left set"
    return outs, counts, reads


def _lookback_compact_mask(mask: torch.Tensor, cols, capacity=None,
                           **schedule):
    """``compact_mask`` by the kernel's schedule (``_lookback_compact``):
    ``(outs, count, reads)``."""
    cols, _, n = _check_cols(cols)
    _check_mask(mask, n, mask.device)
    cap = _build.check_capacity("compact_mask", capacity, n)
    (outs,), (count,), reads = _lookback_compact(mask[None], (cols,), (cap,),
                                                 **schedule)
    return outs, count, reads


def _check_emit(vals: torch.Tensor, capacity: int,
                index: Optional[torch.Tensor] = None):
    device = _build.check_vectors("emit_prefix", vals)
    length = vals.numel()
    if index is not None:
        if not isinstance(index, torch.Tensor) or index.dim() != 1 \
                or index.dtype != torch.int64 or not index.is_contiguous():
            raise ValueError("emit_prefix: the index must be a contiguous "
                             "1-D int64 tensor")
        if index.device != device:
            raise ValueError(f"emit_prefix: values on {device}, index on "
                             f"{index.device}")
        length = index.numel()
    if length > capacity:
        raise ValueError(f"emit_prefix: {length} values exceed "
                         f"capacity {capacity}")
    return device


def emit_prefix_plain(vals: torch.Tensor, capacity: int) -> torch.Tensor:
    _check_emit(vals, capacity)
    out = torch.zeros(capacity, dtype=torch.int32, device=vals.device)
    out[: vals.numel()] = vals
    return out


def emit_prefix(vals: torch.Tensor, capacity: int,
                index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``vals``, or ``vals[index]`` (every index a valid position of
    ``vals``: the kernel does not check), in the first slots of a
    (capacity,) buffer; its twin is ``emit_prefix_plain`` of the same
    values."""
    sp = trace.begin("kernel.emit_prefix")
    try:
        device = _check_emit(vals, capacity, index)
        if device.type == "cpu":
            return emit_prefix_plain(vals if index is None else vals[index],
                                     capacity)
        out = torch.empty(capacity, dtype=torch.int32, device=device)
        length = vals.numel() if index is None else index.numel()
        _build.launch("dbt_emit_prefix", device, vals.data_ptr(),
                      None if index is None else index.data_ptr(), length,
                      out.data_ptr())
        _build.LAUNCHES["emit_prefix"] += 1
        return out
    finally:
        if sp:
            sp.close()
