"""Histograms of int32 keys: CUDA kernels (``csrc/hist.cu``) and their plain
PyTorch twins.

``histogram`` is the contract of ``dwarf_bench_tpu/ops/hist_pallas.py``
``histogram_16k_swar_pallas`` (and ``ops/sort.histogram_16k``): a
(hi_bins·128,) int32 count of keys, where a key whose uint32 value is at or
above hi_bins·128 (negatives, EMPTY, padding) counts nowhere. Its kernel
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
It keeps each copy of the bins in the shared memory of one block or of a
cluster of blocks; ``weighted_plan`` chooses the cluster size and the number
of copies.

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

# The weighted histogram's launch plan (csrc/hist.cu). A cluster of
# ``cluster`` blocks holds one copy of the bins, nbins / cluster in each
# block's shared memory; ``copies`` clusters each take a share of the rows,
# and a second kernel adds their copies. Chosen by the plan sweep of
# ``utils/kernel_times.py --sweep`` on an H100 (PERF.md): a row added into
# another block's shared memory costs several times one added into the
# block's own, so one block holds the bins whenever they fit
# (CLUSTER1_MAX_BINS, 128 KB), and the 2^16 bins of the G = 2^16 group-by
# take a cluster of 16 (16 KB a block).
CLUSTER1_MAX_BINS = 32768
# The copies are written and read once, so copies * nbins <= max(nbins, n)
# keeps them within 8 bytes a row, beside the 8 bytes a row of keys and
# values; more copies than MAX_COPIES cost the second kernel more than they
# save.
MAX_COPIES = 64
MAX_WEIGHTED_BLOCKS = 256


def _check_hi_bins(op: str, hi_bins: int, most: int) -> int:
    if not 1 <= hi_bins <= most:
        raise ValueError(f"{op}: hi_bins must be in [1, {most}], got {hi_bins}")
    return hi_bins * 128


def histogram_plain(k: torch.Tensor, hi_bins: int = 128) -> torch.Tensor:
    nbins = _check_hi_bins("histogram", hi_bins, MAX_HIST_HI_BINS)
    ku = as_u32(k)
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


def histogram(k: torch.Tensor, hi_bins: int = 128) -> torch.Tensor:
    sp = trace.begin("kernel.histogram")
    try:
        nbins = _check_hi_bins("histogram", hi_bins, MAX_HIST_HI_BINS)
        device = _build.check_vectors("histogram", k)
        if device.type == "cpu":
            return histogram_plain(k, hi_bins)
        return launch_histogram(k, nbins, *histogram_plan(hi_bins, k.numel()))
    finally:
        if sp:
            sp.close()


@functools.lru_cache(maxsize=64)
def _scratch_words(nbins: int, blocks: int) -> int:
    """int32 scratch words of the count histogram: the counters, then the
    copies."""
    return int(_build.library().dbt_histogram_scratch(nbins, blocks))


def launch_histogram(k: torch.Tensor, nbins: int, blocks: int,
                     mergers: int) -> torch.Tensor:
    """The count-histogram kernel on a checked CUDA vector under an
    explicit plan (``histogram_plan`` gives the wrapper's)."""
    out = torch.empty(nbins, dtype=torch.int32, device=k.device)
    # the counters are zero when made and left zero; every copy is written
    # in full before it is read
    scratch = None if blocks == 1 else _build.stream_scratch(
        "histogram", k.device, _scratch_words(nbins, blocks))
    _build.launch("dbt_histogram", k.device, k.data_ptr(), k.numel(),
                  out.data_ptr(), nbins, blocks, mergers,
                  None if scratch is None else scratch.data_ptr())
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
    hi_bins·128 bins: one block when it holds the bins, else a cluster of
    16, and as many copies as ``copy_bins_limit``, MAX_COPIES and
    MAX_WEIGHTED_BLOCKS allow, at least one."""
    nbins = hi_bins * 128
    cluster = 1 if nbins <= CLUSTER1_MAX_BINS else 16
    copies = min(copy_bins_limit(n, nbins) // nbins, MAX_COPIES,
                 MAX_WEIGHTED_BLOCKS // cluster)
    return cluster, max(copies, 1)


def weighted_histogram(
    k: torch.Tensor, v: torch.Tensor, hi_bins: int = 512
) -> torch.Tensor:
    nbins = _check_hi_bins("weighted_histogram", hi_bins, MAX_WEIGHTED_HI_BINS)
    device = _build.check_vectors("weighted_histogram", k, v)
    if k.numel() != v.numel():
        raise ValueError(
            f"weighted_histogram: {k.numel()} keys but {v.numel()} values"
        )
    if device.type == "cpu":
        return weighted_histogram_plain(k, v, hi_bins)
    return launch_weighted(k, v, nbins, *weighted_plan(hi_bins, k.numel()))


def launch_weighted(k: torch.Tensor, v: torch.Tensor, nbins: int,
                    cluster: int, copies: int) -> torch.Tensor:
    """The weighted-histogram kernel on checked CUDA vectors under an
    explicit plan (``weighted_plan`` gives the wrapper's)."""
    out = torch.empty(nbins, dtype=torch.int32, device=k.device)
    # every copy is written in full before it is read
    scratch = None if copies == 1 else _build.stream_scratch(
        "weighted_histogram", k.device, copies * nbins)
    _build.launch("dbt_weighted_histogram", k.device, k.data_ptr(),
                  v.data_ptr(), k.numel(), out.data_ptr(), nbins, cluster,
                  copies, None if scratch is None else scratch.data_ptr())
    _build.LAUNCHES["weighted_histogram"] += 1
    return out


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
