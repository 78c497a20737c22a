"""Histograms of int32 keys: CUDA kernels (``csrc/hist.cu``) and their plain
PyTorch twins.

``histogram`` is the contract of ``dwarf_bench_tpu/ops/hist_pallas.py``
``histogram_16k_swar_pallas`` (and ``ops/sort.histogram_16k``): a
(hi_bins·128,) int32 count of keys, where a key whose uint32 value is at or
above hi_bins·128 (negatives, EMPTY, padding) counts nowhere. With a
``shift`` (an int, or a one-element int32 tensor on the keys' device, read
there) it counts the keys ``k - shift``, wrapping as int32 subtraction does,
subtracted as the kernel loads each key: the counting sort's histogram of
``x - min`` without the shifted column. Its kernel
keeps a copy of the bins in each block's shared memory and merges the
copies through a lasting scratch a stream, the last blocks to start adding
a slice of the bins each, in one cooperative launch that writes every bin
(no memset): the CUDA driver refuses a grid the context cannot hold at once
(``RuntimeError``, "too many blocks in cooperative launch"), so the waiting
mergers never hang. ``histogram_plan`` chooses the blocks and the mergers,
and ``_histogram_schedule`` renders the schedule in plain PyTorch for the
tests.

``weighted_histogram`` is the contract of ``weighted_histogram_i8_swar_pallas``
(hi_bins 256 and 512) and ``weighted_histogram_i8_pallas`` (hi_bins below
256): (hi_bins·128,) int32 sums of v per bin, wrapping mod 2^32, with
out-of-range keys dropped. The card's kernel has no v < 2^14 precondition.
Up to 2^15 bins each of its copies of the bins lies in one block's shared
memory. Above, from 2^20 rows on, clusters of blocks take tiles of keys and
values multicast to every block of the cluster, each block adding only the
keys whose bins it owns, and add their slices into the zeroed output; below
2^20 rows a cluster of 16 blocks holds each copy, every row added into the
shared memory of the block that owns its bin. ``weighted_plan`` chooses the
kernel, the cluster size and the number of copies or clusters, and
``_weighted_schedule`` renders the multicast clusters' split in plain
PyTorch for the tests.

``histogram_16k_pallas`` (hist_pallas.py:40, hi_bins <= 128) and
``weighted_histogram_pallas`` (:279, hi_bins <= 512, with its 2^14-bin alias
``weighted_histogram_16k_pallas``, :476) are the same two contracts under
their JAX names, with those functions' ``hi_bins % 8 == 0`` checks; each
counts its own launches.

A wrapper takes the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build, trace
from .primitives import as_u32, wrap_i32

MAX_HIST_HI_BINS = 128  # 2^14 bins: 64 KB of shared memory per block
MAX_WEIGHTED_HI_BINS = 512  # 2^16 bins, the G = 2^16 group-by

# The count histogram's launch plan (csrc/hist.cu), chosen by the plan
# sweep of ``utils/kernel_times.py --sweep histogram`` on an H100 (PERF.md):
# blocks of HIST_THREADS lanes (the kernel's kHistThreads), each counting at
# least HIST_BLOCK_ROWS keys into its own copy of the bins, at most
# HIST_MAX_BLOCKS and as many as ``copy_bins_limit`` allows; and up to
# HIST_MERGERS of them merging the copies. A merger waits for every block,
# so the launch is cooperative: a plan runs only where every block is
# resident at once (HIST_MAX_BLOCKS against the H100's 132 SMs).
HIST_THREADS = 512
HIST_BLOCK_ROWS = 8192
HIST_MAX_BLOCKS = 128
HIST_MERGERS = 64

# The weighted histogram's launch plans (csrc/hist.cu), chosen by the plan
# sweep of ``utils/kernel_times.py --sweep weighted`` on an H100 (PERF.md).
# Up to CLUSTER1_MAX_BINS bins (128 KB) one block holds a copy of the bins;
# ``copies`` blocks each take a share of the rows, and a second kernel adds
# their copies. The copies are written and read once, so copies * nbins <=
# copy_bins_limit keeps them within 8 bytes a row, beside the 8 bytes a row
# of keys and values; more copies than MAX_COPIES cost the second kernel more
# than they save.
CLUSTER1_MAX_BINS = 32768
MAX_COPIES = 64
# Above it, below MULTICAST_MIN_ROWS rows, a cluster of REMOTE_CLUSTER blocks
# holds a copy (16 KB a block at 2^16 bins), each block adding its rows into
# the owner block's shared memory; copies as above, at most
# MAX_WEIGHTED_BLOCKS blocks. From MULTICAST_MIN_ROWS rows on, clusters of
# MULTICAST_CLUSTER blocks each own nbins / MULTICAST_CLUSTER bins; tiles of
# MULTICAST_TILE_ROWS keys and as many values are copied once into a ring of
# MULTICAST_STAGES stages of every block of a cluster, and each block's
# adding warps, one a 128 rows of a tile, add only the rows whose bins it
# owns. Each cluster adds its slices into the output once, so clusters *
# nbins <= copy_bins_limit keeps the flush within an add a row; at most
# MULTICAST_MAX_CLUSTERS, the clusters an H100 holds at once. The flush
# bound leaves the multicast kernel one cluster (2 SMs) a 2^16 rows, so the
# remote adds, which spread few rows over more SMs, stay faster below the
# sweep's crossover (2^19 rows: 0.0184 ms against 0.0199; 2^20: 0.0257
# against 0.0213). ``launch_weighted`` sends clusters of MULTICAST_CLUSTERS
# blocks to the multicast kernel.
REMOTE_CLUSTER = 16
MAX_WEIGHTED_BLOCKS = 256
MULTICAST_MIN_ROWS = 1 << 20
MULTICAST_CLUSTER = 2
MULTICAST_CLUSTERS = (2, 4)
MULTICAST_MAX_CLUSTERS = 66
MULTICAST_STAGES = 3
MULTICAST_TILE_ROWS = 3968  # 31 adding warps: with the copying one, 1024 lanes


def _check_hi_bins(op: str, hi_bins: int, most: int) -> int:
    if not 1 <= hi_bins <= most:
        raise ValueError(f"{op}: hi_bins must be in [1, {most}], got {hi_bins}")
    return hi_bins * 128


def histogram_plain(k: torch.Tensor, hi_bins: int = 128,
                    shift: Optional[_build.Int32] = None) -> torch.Tensor:
    nbins = _check_hi_bins("histogram", hi_bins, MAX_HIST_HI_BINS)
    ku = as_u32(k)
    if shift is not None:
        s = _build.int32_tensor("histogram", "shift", shift, k.device)
        ku = (ku - as_u32(s)) & 0xFFFFFFFF
    ku = ku[ku < nbins]
    return torch.bincount(ku, minlength=nbins).to(torch.int32)


def _pow2_at_most(x: int) -> int:
    return 1 << (max(x, 1).bit_length() - 1)


def histogram_plan(hi_bins: int, n: int) -> Tuple[int, int]:
    """(blocks, mergers) of the count histogram of ``n`` keys into
    hi_bins·128 bins: blocks of HIST_BLOCK_ROWS keys or more, at most
    HIST_MAX_BLOCKS and ``copy_bins_limit`` // bins, at least one; and the
    most mergers up to HIST_MERGERS that the blocks hold, a power of two
    whose slices of the bins are whole 16-byte words of 16-bit bins."""
    nbins = hi_bins * 128
    blocks = max(min(n // HIST_BLOCK_ROWS, HIST_MAX_BLOCKS,
                     copy_bins_limit(n, nbins) // nbins), 1)
    mergers = min(HIST_MERGERS, _pow2_at_most(blocks),
                  _pow2_at_most(nbins // 8))
    return blocks, mergers


def _narrow(threads: int, blocks: int, nvec: int) -> bool:
    """Whether the kernel stores 16-bit copies of the bins: every block
    counts fewer than 2^16 keys (at most its share of the ``nvec`` 16-byte
    vectors, and block 0 the head and the tail)."""
    lanes = threads * blocks
    return 4 * threads * -(-nvec // lanes) + 8 < 1 << 16


def merge_bytes(hi_bins: int, n: int) -> int:
    """Bytes the count histogram's copies move on the wrapper's plan for
    ``n`` aligned keys: each block's copy written once and read once, in
    16-bit or 32-bit bins, mostly in the L2; 0 with one block. They are
    the design's own scratch, not part of the function's bound."""
    blocks, _ = histogram_plan(hi_bins, n)
    if blocks == 1:
        return 0
    width = 2 if _narrow(HIST_THREADS, blocks, n // 4) else 4
    return 2 * blocks * hi_bins * 128 * width


def histogram(k: torch.Tensor, hi_bins: int = 128,
              shift: Optional[_build.Int32] = None) -> torch.Tensor:
    sp = trace.begin("kernel.histogram")
    try:
        nbins = _check_hi_bins("histogram", hi_bins, MAX_HIST_HI_BINS)
        device = _build.check_vectors("histogram", k)
        if device.type == "cpu":
            return histogram_plain(k, hi_bins, shift)
        return launch_histogram(k, nbins, *histogram_plan(hi_bins, k.numel()),
                                shift=shift)
    finally:
        if sp:
            sp.close()


@functools.lru_cache(maxsize=64)
def _scratch_words(nbins: int, blocks: int) -> int:
    """int32 scratch words of the count histogram: the counters, then the
    copies."""
    return int(_build.library().dbt_histogram_scratch(nbins, blocks))


def launch_histogram(k: torch.Tensor, nbins: int, blocks: int,
                     mergers: int,
                     shift: Optional[_build.Int32] = None) -> torch.Tensor:
    """The count-histogram kernel on a checked CUDA vector under an
    explicit plan (``histogram_plan`` gives the wrapper's). Without a
    ``shift`` the kernel built with none runs."""
    shift_t, shift_val = (None, 0) if shift is None else _build.pack_int32(
        "histogram", "shift", shift, k.device)
    out = torch.empty(nbins, dtype=torch.int32, device=k.device)
    # the counters are zero when made and left zero; every copy is written
    # in full before it is read
    scratch = None if blocks == 1 else _build.stream_scratch(
        "histogram", k.device, _scratch_words(nbins, blocks))
    _build.launch("dbt_histogram", k.device, k.data_ptr(), k.numel(),
                  out.data_ptr(), nbins, blocks, mergers,
                  None if scratch is None else scratch.data_ptr(),
                  None if shift_t is None else shift_t.data_ptr(), shift_val)
    _build.LAUNCHES["histogram"] += 1
    return out


def _histogram_schedule(k: torch.Tensor, hi_bins: int, blocks: int,
                        mergers: int, threads: int = HIST_THREADS,
                        offset: int = 0, seed: int = 0,
                        resident: Optional[int] = None):
    """``histogram`` by the kernel's schedule, for the tests: the keys as
    the kernel splits them (a view ``offset`` int32 past a 16-byte boundary:
    the head before the next boundary, then 16-byte vectors, vector i to
    block (i mod blocks·threads) // threads, and the ragged tail, head and
    tail to block 0) into a copy a block, stored as 16-bit bins when every
    block counts fewer than 2^16 keys. With more than one block the launch
    is cooperative: where the context holds ``resident`` blocks at once
    (None: any number) and the plan has more, it raises as the CUDA driver
    refuses the launch, before anything runs. Else every block is resident,
    and they start in an order drawn from ``seed``; once every block is
    done, the last ``mergers`` to start each add one slice of
    nbins / mergers bins over the copies, and the last of them out puts the
    counters back. ``threads`` other than the kernel's shrinks the schedule
    for small inputs. Returns (out, the blocks that merged in the order of
    their slices, whether the copies were 16-bit, the counters after the
    call)."""
    nbins = hi_bins * 128
    n = k.numel()
    assert 1 <= mergers <= blocks and nbins % (8 * mergers) == 0
    if blocks > 1 and resident is not None and blocks > resident:
        raise RuntimeError(f"dbt_histogram: {blocks} blocks, {resident} "
                           "resident: too many blocks in cooperative launch")
    ku = as_u32(k.cpu())
    head = min((4 - offset % 4) % 4, n)
    nvec = (n - head) // 4
    row = torch.arange(n, dtype=torch.int64)
    vec = (row - head) // 4
    block = torch.where((row >= head) & (vec < nvec),
                        (vec % (blocks * threads)) // threads, 0)
    keep = ku < nbins
    copies = torch.zeros(blocks * nbins, dtype=torch.int64)
    copies.index_add_(0, block[keep] * nbins + ku[keep],
                      torch.ones(int(keep.sum()), dtype=torch.int64))
    copies = copies.view(blocks, nbins)
    narrow = _narrow(threads, blocks, nvec)
    if blocks == 1:
        return wrap_i32(copies[0]), [], narrow, [0, 0, 0]
    if narrow:  # the 16-bit copies hold every count
        assert int(torch.bincount(block).max()) < 1 << 16
        copies = copies & 0xFFFF
    rng = np.random.default_rng(seed)
    counters = [0, 0, 0]  # start tickets, blocks done, mergers done
    start = {}
    for b in rng.permutation(blocks):  # the order the blocks start in
        start[int(b)] = counters[0]
        counters[0] += 1
    counters[1] = blocks  # every block is done: each merger's wait ends
    out = torch.empty(nbins, dtype=torch.int64)
    slice_ = nbins // mergers
    merged = [None] * mergers
    for b, t in start.items():
        m = t - (blocks - mergers)
        if m >= 0:
            lo = m * slice_
            out[lo: lo + slice_] = copies[:, lo: lo + slice_].sum(0)
            merged[m] = b
            counters[2] += 1
            if counters[2] == mergers:  # the last merger out
                counters = [0, 0, 0]
    return wrap_i32(out), merged, narrow, counters


def weighted_histogram_plain(
    k: torch.Tensor, v: torch.Tensor, hi_bins: int = 512
) -> torch.Tensor:
    nbins = _check_hi_bins("weighted_histogram", hi_bins, MAX_WEIGHTED_HI_BINS)
    ku = as_u32(k)
    keep = ku < nbins
    out = torch.zeros(nbins, dtype=torch.int64, device=k.device)
    out.index_add_(0, ku[keep], v[keep].to(torch.int64))
    return wrap_i32(out)


def copy_bins_limit(n: int, nbins: int) -> int:
    """The most bins that the copies of a weighted histogram of ``n`` rows
    may hold together."""
    return max(nbins, n)


def weighted_plan(hi_bins: int, n: int) -> Tuple[int, int]:
    """(cluster, copies) of the weighted histogram of ``n`` rows into
    hi_bins·128 bins: up to CLUSTER1_MAX_BINS bins one block a copy, as many
    copies as ``copy_bins_limit`` and MAX_COPIES allow; above, below
    MULTICAST_MIN_ROWS rows, clusters of REMOTE_CLUSTER blocks a copy, as
    many as also MAX_WEIGHTED_BLOCKS allows; from MULTICAST_MIN_ROWS rows on,
    MULTICAST_CLUSTER blocks a cluster, as many clusters as
    ``copy_bins_limit`` and MULTICAST_MAX_CLUSTERS allow; at least one."""
    nbins = hi_bins * 128
    copies = copy_bins_limit(n, nbins) // nbins
    if nbins <= CLUSTER1_MAX_BINS:
        return 1, max(min(copies, MAX_COPIES), 1)
    if n < MULTICAST_MIN_ROWS:
        return REMOTE_CLUSTER, max(min(copies, MAX_COPIES,
                                       MAX_WEIGHTED_BLOCKS // REMOTE_CLUSTER),
                                   1)
    return MULTICAST_CLUSTER, max(min(copies, MULTICAST_MAX_CLUSTERS), 1)


def weighted_histogram(
    k: torch.Tensor, v: torch.Tensor, hi_bins: int = 512
) -> torch.Tensor:
    sp = trace.begin("kernel.weighted_histogram")
    try:
        nbins = _check_hi_bins("weighted_histogram", hi_bins,
                               MAX_WEIGHTED_HI_BINS)
        device = _build.check_vectors("weighted_histogram", k, v)
        if k.numel() != v.numel():
            raise ValueError(
                f"weighted_histogram: {k.numel()} keys but {v.numel()} values"
            )
        if device.type == "cpu":
            return weighted_histogram_plain(k, v, hi_bins)
        return launch_weighted(k, v, nbins,
                               *weighted_plan(hi_bins, k.numel()))
    finally:
        if sp:
            sp.close()


def launch_weighted(k: torch.Tensor, v: torch.Tensor, nbins: int,
                    cluster: int, copies: int,
                    stages: int = MULTICAST_STAGES,
                    tile_rows: int = MULTICAST_TILE_ROWS) -> torch.Tensor:
    """The weighted-histogram kernel on checked CUDA vectors under an
    explicit plan (``weighted_plan`` gives the wrapper's): cluster 2 or 4
    (MULTICAST_CLUSTERS), ``copies`` clusters of the multicast kernel with
    ``stages`` stages of ``tile_rows`` rows (a multiple of 128 up to 3968,
    128 an adding warp); else ``copies`` copies of a cluster of ``cluster``
    blocks (1, 8 or 16) that add into the owner block."""
    out = torch.empty(nbins, dtype=torch.int32, device=k.device)
    if cluster in MULTICAST_CLUSTERS:  # zeroed and added into in one call
        _build.launch("dbt_weighted_multicast", k.device, k.data_ptr(),
                      v.data_ptr(), k.numel(), out.data_ptr(), nbins,
                      cluster, copies, stages, tile_rows)
        _build.LAUNCHES["weighted_multicast"] += 1
    else:
        # every copy is written in full before it is read
        scratch = None if copies == 1 else _build.stream_scratch(
            "weighted_histogram", k.device, copies * nbins)
        _build.launch("dbt_weighted_histogram", k.device, k.data_ptr(),
                      v.data_ptr(), k.numel(), out.data_ptr(), nbins,
                      cluster, copies,
                      None if scratch is None else scratch.data_ptr())
    _build.LAUNCHES["weighted_histogram"] += 1
    return out


def _multicast_pieces(rows: int, cluster: int):
    """The pieces of a staged tile of ``rows`` rows (a multiple of 4) that
    the ranks of a cluster copy, as the kernel's ``piece_rows`` cuts them:
    (rank, column, first row, end row), ranks below cluster / 2 the keys
    (column 0) and the others the values (column 1), each an equal share of
    whole 16-byte words; the empty pieces of a short tile are left out."""
    half = cluster // 2
    per = (-(-rows // half) + 3) // 4 * 4
    pieces = []
    for rank in range(cluster):
        p0 = min((rank % half) * per, rows)
        p1 = min(p0 + per, rows)
        if p1 > p0:
            pieces.append((rank, int(rank >= half), p0, p1))
    return pieces


def _weighted_schedule(k: torch.Tensor, v: torch.Tensor, hi_bins: int,
                       cluster: int, clusters: int,
                       tile_rows: int = MULTICAST_TILE_ROWS,
                       offsets: Tuple[int, int] = (0, 0)):
    """``weighted_histogram`` by the multicast kernel's split, for the
    tests: keys and values as views ``offsets`` int32 past a 16-byte
    boundary. Where the two lie alike, the rows from the first boundary on,
    in whole 16-byte words, are cut into tiles of ``tile_rows``, tile t going
    to cluster t mod ``clusters``; each tile is staged from the pieces its
    ranks copy (``_multicast_pieces``), every row exactly once, and the rows
    before the boundary and the last (n - head) % 4 go to cluster 0. Else
    the tiles cover every row and each block reads them itself. Block r of a
    cluster adds the staged rows whose keys fall in its nbins / cluster
    bins; each cluster that took rows then adds its slices into the zeroed
    output. Returns (out, the adds of each (cluster, block), the rows each
    cluster staged, the bins flushed, whether the rows were staged)."""
    nbins = hi_bins * 128
    assert cluster in (2, 4) and nbins % (32 * cluster) == 0
    assert tile_rows > 0 and tile_rows % 128 == 0 and clusters >= 1
    owned = nbins // cluster
    n = k.numel()
    ku, vu = as_u32(k.cpu()), v.cpu().to(torch.int64)
    mis_k, mis_v = (o % 4 for o in offsets)
    bulk = mis_k == mis_v
    head = min((4 - mis_k) % 4, n) if bulk else 0
    nbulk = (n - head) // 4 * 4 if bulk else 0
    lo, count = (head, nbulk) if bulk else (0, n)
    sums = torch.zeros(clusters, cluster, owned, dtype=torch.int64)
    adds = torch.zeros(clusters, cluster, dtype=torch.int64)
    staged = torch.zeros(clusters, dtype=torch.int64)
    took = torch.zeros(clusters, dtype=torch.bool)

    def add(c, keys, vals):
        took[c] = True
        for r in range(cluster):
            b = keys - r * owned  # wraps below 0 for other blocks' keys
            mine = (b >= 0) & (b < owned)
            sums[c, r].index_add_(0, b[mine], vals[mine])
            adds[c, r] += int(mine.sum())

    for t in range(-(-count // tile_rows)):
        c = t % clusters
        row0 = lo + t * tile_rows
        rows = min(tile_rows, lo + count - row0)
        if bulk:
            stage = torch.full((2, rows), -1, dtype=torch.int64)
            for _, col, p0, p1 in _multicast_pieces(rows, cluster):
                assert p0 % 4 == 0 and (p1 - p0) % 4 == 0
                assert bool((stage[col, p0:p1] == -1).all())  # once a row
                stage[col, p0:p1] = (ku, vu)[col][row0 + p0: row0 + p1]
            assert bool((stage != -1).all())
            staged[c] += rows
            add(c, stage[0], stage[1])
        else:
            add(c, ku[row0: row0 + rows], vu[row0: row0 + rows])
    if bulk:
        rest = torch.cat([torch.arange(head), torch.arange(head + nbulk, n)])
        add(0, ku[rest], vu[rest])
    flushing = took.clone()
    flushing[0] = True  # cluster 0 flushes even with no rows
    out = sums[flushing].reshape(-1, nbins).sum(0)
    return (wrap_i32(out), adds, staged, int(flushing.sum()) * nbins, bulk)


def _check_jax_hi_bins(op: str, hi_bins: int, most: int) -> int:
    """The JAX kernels' ``hi_bins % 8 == 0 and hi_bins <= most`` check, as
    a ValueError."""
    hi_bins = int(hi_bins)
    if hi_bins % 8 or not 8 <= hi_bins <= most:
        raise ValueError(f"{op}: hi_bins must be a multiple of 8 in "
                         f"[8, {most}], got {hi_bins}")
    return hi_bins


def histogram_16k_pallas(k: torch.Tensor, hi_bins: int = 128) -> torch.Tensor:
    """``dwarf_bench_tpu/ops/hist_pallas.py:40`` ``histogram_16k_pallas``:
    ``histogram``'s contract for hi_bins <= 128, served by its kernel."""
    hi_bins = _check_jax_hi_bins("histogram_16k_pallas", hi_bins,
                                 MAX_HIST_HI_BINS)
    out = histogram(k, hi_bins)
    if out.is_cuda:
        _build.LAUNCHES["histogram_16k_pallas"] += 1
    return out


def weighted_histogram_pallas(k: torch.Tensor, v: torch.Tensor,
                              hi_bins: int = 128) -> torch.Tensor:
    """``dwarf_bench_tpu/ops/hist_pallas.py:279`` ``weighted_histogram_pallas``:
    ``weighted_histogram``'s contract for hi_bins <= 512, served by its
    kernel. The JAX kernel asks 0 <= v < 2^14 (two 7-bit planes); the card's
    kernel sums any int32 values mod 2^32."""
    hi_bins = _check_jax_hi_bins("weighted_histogram_pallas", hi_bins,
                                 MAX_WEIGHTED_HI_BINS)
    out = weighted_histogram(k, v, hi_bins)
    if out.is_cuda:
        _build.LAUNCHES["weighted_histogram_pallas"] += 1
    return out


def weighted_histogram_16k_pallas(k: torch.Tensor,
                                  v: torch.Tensor) -> torch.Tensor:
    """``hist_pallas.py:476``, the alias of ``weighted_histogram_pallas``
    at 2^14 bins."""
    out = weighted_histogram_pallas(k, v, 128)
    if out.is_cuda:
        _build.LAUNCHES["weighted_histogram_16k_pallas"] += 1
    return out
