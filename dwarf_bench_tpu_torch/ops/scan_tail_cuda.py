"""The sparse filter's chunk-level tail: CUDA kernel (``csrc/scan_tail.cu``)
and its plain PyTorch twin.

The contract of ``dwarf_bench_tpu/ops/scan_tail_pallas.py``
``scan_tail_streams``: from the (nch,) int32 ``stat`` and ``base`` of
``ops/chunk_stats``, a chunk is *single* when cnt == 1 and 1 <= vsw <= 255
(cnt = stat >> 9, vsw = stat & 511) and *multi* when cnt >= 1 and it is not
single. Returns ``(spos, sval, mids, mbase, n_single, n_multi)``:

  * singles' (base, threshold - vsw), in chunk order, in ``cap_single``
    slots; ``spos`` is 0x7FFFFFFF past ``n_single``, ``sval`` garbage;
  * multis' (chunk id, base), in chunk order, in ``cap_mc`` slots, garbage
    past ``n_multi``;
  * ``n_single`` and ``n_multi``: the full counts, 0-d int32 tensors on the
    input's device.

``scan_tail_compact`` is the same contract under its JAX name, with that
function's limit of 2^18 chunks.

A wrapper takes the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises: one launch a call (the two-stream compaction
of ``csrc/compact.cuh``, whose last tile's block also writes the sentinel),
no memset. ``_lookback_tail`` runs the kernel's schedule in plain PyTorch
(``compact_cuda._lookback_compact`` at the kernel's tile, ``TAIL_TILE``)
for the tests.
"""

from __future__ import annotations

import torch

from . import _build, compact_cuda
from .primitives import compact_multi

BIG = 0x7FFFFFFF  # position sentinel: sorts after every real position
# the kernel's tile (TailOp in csrc/scan_tail.cu): 16 warps of lanes of one
# run of 4 chunks, 2048 chunks
TAIL_TILE = dict(warps=16, vecs=1, lanes=32, window=32)


def _check(stat, base, threshold, cap_single, cap_mc):
    device = _build.check_vectors("scan_tail_streams", stat, base)
    if stat.numel() != base.numel():
        raise ValueError(f"scan_tail_streams: {stat.numel()} stats but "
                         f"{base.numel()} bases")
    thr = _build.check_int32("scan_tail_streams", "threshold", threshold)
    cap_single, cap_mc = int(cap_single), int(cap_mc)
    if min(cap_single, cap_mc) < 0:
        raise ValueError(f"scan_tail_streams: negative caps {cap_single}, "
                         f"{cap_mc}")
    return device, thr, cap_single, cap_mc


def _streams(stat, base, thr: int):
    """Each chunk's (single, multi) flags and the columns each stream
    keeps: (base, thr - vsw) and (chunk id, base)."""
    cnt, vsw = stat >> 9, stat & 511
    single = (cnt == 1) & (vsw >= 1) & (vsw <= 255)
    multi = (cnt >= 1) & ~single
    ids = torch.arange(stat.numel(), dtype=torch.int32, device=stat.device)
    return (single, multi), ((base, thr - vsw), (ids, base))


def _past_count(spos, n_single):
    """spos with the sentinel past n_single."""
    iota = torch.arange(spos.numel(), dtype=torch.int32, device=spos.device)
    return torch.where(iota < n_single, spos, BIG)


def scan_tail_streams_plain(stat, base, threshold: int, cap_single: int,
                            cap_mc: int):
    _, thr, cap_single, cap_mc = _check(stat, base, threshold, cap_single,
                                        cap_mc)
    (single, multi), (scols, mcols) = _streams(stat, base, thr)
    (spos, sval), n_single = compact_multi(scols, single, cap_single)
    (mids, mbase), n_multi = compact_multi(mcols, multi, cap_mc)
    return _past_count(spos, n_single), sval, mids, mbase, n_single, n_multi


def _lookback_tail(stat, base, threshold: int, cap_single: int, cap_mc: int,
                   **schedule):
    """``scan_tail_streams`` by the kernel's schedule (``TAIL_TILE`` unless
    ``schedule`` says otherwise), two streams over two status words a tile,
    the last tile's block writing the sentinel past n_single:
    ``(spos, sval, mids, mbase, n_single, n_multi, reads)``."""
    _, thr, cap_single, cap_mc = _check(stat, base, threshold, cap_single,
                                        cap_mc)
    keep, cols = _streams(stat, base, thr)

    def sentinel(outs, counts):  # TailOp::last_tile
        outs[0][0][int(counts[0]):] = BIG

    ((spos, sval), (mids, mbase)), (n_single, n_multi), reads = \
        compact_cuda._lookback_compact(torch.stack(keep), cols,
                                       (cap_single, cap_mc),
                                       **{**TAIL_TILE, **schedule},
                                       last_tile=sentinel)
    return spos, sval, mids, mbase, n_single, n_multi, reads


def scan_tail_streams(stat, base, threshold: int, cap_single: int,
                      cap_mc: int):
    device, thr, cap_single, cap_mc = _check(stat, base, threshold,
                                             cap_single, cap_mc)
    if device.type == "cpu":
        return scan_tail_streams_plain(stat, base, thr, cap_single, cap_mc)
    nch = stat.numel()

    def empty(k):
        return torch.empty(k, dtype=torch.int32, device=device)

    spos, sval, mids, mbase = (empty(cap_single), empty(cap_single),
                               empty(cap_mc), empty(cap_mc))
    counts = empty(2)
    # two counters and the status words: zero when made, left zero
    scratch = _build.stream_scratch("compact", device,
                                    _build.compact_scratch_words(nch, 2))
    _build.launch("dbt_scan_tail_streams", device, stat.data_ptr(),
                  base.data_ptr(), nch, thr, spos.data_ptr(), sval.data_ptr(),
                  cap_single, mids.data_ptr(), mbase.data_ptr(), cap_mc,
                  counts.data_ptr(), scratch.data_ptr())
    _build.LAUNCHES["scan_tail_streams"] += 1
    return spos, sval, mids, mbase, counts[0], counts[1]


# scan_tail_compact's single-step merge tree holds at most 128 rows of 2048
# chunks (dwarf_bench_tpu/ops/scan_tail_pallas.py:38-39, 294)
MAX_COMPACT_CHUNKS = 128 * 2048


def scan_tail_compact(stat, base, threshold: int, cap_single: int,
                      cap_mc: int):
    """``scan_tail_compact`` (``dwarf_bench_tpu/ops/scan_tail_pallas.py:266``):
    ``scan_tail_streams``' contract and outputs, served by its kernel, with
    the JAX function's limit of 2^18 chunks (ValueError above it, where the
    JAX function's ``assert rows <= _MAX_ROWS`` fires)."""
    device = _check(stat, base, threshold, cap_single, cap_mc)[0]
    if stat.numel() > MAX_COMPACT_CHUNKS:
        raise ValueError(f"scan_tail_compact: {stat.numel()} chunks; at "
                         f"most {MAX_COMPACT_CHUNKS}")
    if device.type == "cpu":
        return scan_tail_streams_plain(stat, base, threshold, cap_single,
                                       cap_mc)
    out = scan_tail_streams(stat, base, threshold, cap_single, cap_mc)
    _build.LAUNCHES["scan_tail_compact"] += 1
    return out
