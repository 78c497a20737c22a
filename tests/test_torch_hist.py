"""Port parity: dwarf_bench_tpu_torch.ops.hist_cuda against the JAX Pallas
histograms (interpret mode on the CPU). All outputs are integers, so the
tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops.groupby import groupby_oracle
from dwarf_bench_tpu.ops.hist_pallas import (
    histogram_16k_swar_pallas,
    weighted_histogram_i8_pallas,
    weighted_histogram_i8_swar_pallas,
)
from dwarf_bench_tpu_torch.ops import _build, hist_cuda


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


@pytest.mark.parametrize("hi_bins,n", [(80, 1 << 14), (128, 20_000)])
def test_histogram_matches_swar_pallas(rng, hi_bins, n):
    k = rng.integers(-100, hi_bins * 128 + 500, n).astype(np.int32)
    ref = np.asarray(histogram_16k_swar_pallas(
        jnp.asarray(k), hi_bins=hi_bins, interpret=True))
    got = hist_cuda.histogram(_t(k), hi_bins=hi_bins)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


# the degenerate inputs of tests/test_hist_pallas.py::test_swar_histogram_degenerate
@pytest.mark.parametrize("case", [
    np.full(777, 5, np.int32),                       # one hot bin
    np.full(64, 1 << 14, np.int32),                  # all out of range
    np.array([0, 127, 128, 16383, -1], np.int32),    # digit extremes
    np.array([16256 + 127], np.int32),               # last bin only
    np.array([-2147483648, 2147483647, -7], np.int32),  # negatives, int32 max
])
@pytest.mark.parametrize("hi_bins", [80, 128])
def test_histogram_degenerate(case, hi_bins):
    ref = np.asarray(histogram_16k_swar_pallas(
        jnp.asarray(case), hi_bins=hi_bins, interpret=True))
    got = hist_cuda.histogram(_t(case), hi_bins=hi_bins).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("hi_bins", [256, 512])
def test_weighted_matches_swar_pallas(rng, hi_bins):
    n = 1 << 14
    k = rng.integers(-3, hi_bins * 128 + 99, n).astype(np.int32)
    v = rng.integers(1, 10000, n).astype(np.int32)
    ref = np.asarray(weighted_histogram_i8_swar_pallas(
        jnp.asarray(k), jnp.asarray(v), hi_bins=hi_bins, interpret=True))
    got = hist_cuda.weighted_histogram(_t(k), _t(v), hi_bins=hi_bins)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hi_bins", [8, 64, 128])
def test_weighted_matches_i8_pallas(rng, hi_bins):
    """The hi_bins < 256 contract (weighted_histogram_i8_pallas), served by
    the same kernel on the card."""
    n = 10_000
    k = rng.integers(-3, hi_bins * 128 + 99, n).astype(np.int32)
    v = rng.integers(0, 1 << 14, n).astype(np.int32)
    ref = np.asarray(weighted_histogram_i8_pallas(
        jnp.asarray(k), jnp.asarray(v), hi_bins=hi_bins, interpret=True))
    got = hist_cuda.weighted_histogram(_t(k), _t(v), hi_bins=hi_bins)
    assert np.array_equal(got.numpy(), ref)


def test_weighted_wraps_without_value_bound(rng):
    """v >= 2^14 is outside the TPU kernels' precondition; the port's
    contract is the uint32 oracle's mod-2^32 sum for any value."""
    n, hb = 30_000, 8
    k = rng.integers(0, hb * 128, n).astype(np.int32)
    k[:7] = 0
    v = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    v[:7] = 2**31 - 1  # bin 0 crosses 2^31 and 2^32
    got = hist_cuda.weighted_histogram(_t(k), _t(v), hi_bins=hb).numpy()
    assert np.array_equal(got.view(np.uint32),
                          groupby_oracle(k, v.view(np.uint32), hb * 128))


@pytest.fixture(scope="module")
def schedule_keys():
    """20011 keys over [-50, 10300): out-of-range and negative keys, a hot
    key in stretches, and the int32 extremes; the same with every key one
    bin."""
    rng = np.random.default_rng(31)
    k = rng.integers(-50, 10300, 20_011).astype(np.int32)
    k[rng.random(k.size) < 0.2] = 77  # a hot key
    k[:3] = [-(2**31), 2**31 - 1, -1]
    return k


_SWAR = {}


def _swar(k, hi_bins):
    key = (k.tobytes(), hi_bins)
    if key not in _SWAR:
        _SWAR[key] = np.asarray(histogram_16k_swar_pallas(
            jnp.asarray(k), hi_bins=hi_bins, interpret=True))
    return _SWAR[key]


@pytest.mark.parametrize("hi_bins", [8, 80, 128])
@pytest.mark.parametrize("threads,blocks,mergers", [
    (32, 1, 1), (32, 3, 2), (64, 8, 8), (32, 37, 16), (128, 64, 64),
    (512, 64, 64), (32, 128, 128)])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_histogram_schedule_matches_swar_pallas(schedule_keys, hi_bins,
                                                threads, blocks, mergers,
                                                offset):
    """The kernel's schedule (keys split over blocks as its vector loop
    splits them, a copy a block, 16-bit copies, the last blocks to start
    merging a slice each) bit for bit against the Pallas kernel, at block
    counts that leave blocks without keys and views off 16 bytes."""
    k = schedule_keys[offset:]
    out, merged, narrow, counters = hist_cuda._histogram_schedule(
        torch.from_numpy(k), hi_bins, blocks, mergers, threads=threads,
        offset=offset, seed=blocks + offset)
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), _swar(k, hi_bins))
    assert counters == [0, 0, 0]  # left zero for the next call
    assert len(merged) == (mergers if blocks > 1 else 0)
    assert len(set(merged)) == len(merged)
    assert narrow


# Blocks an H100 holds at once (132 SMs): 4 a SM at 8192 bins (2048
# threads), 3 at 2^14 (the copy's 64 KB of shared memory).
H100_RESIDENT = {64: 4 * 132, 128: 3 * 132}


@pytest.mark.parametrize("hi_bins,blocks", [(64, 1024), (128, 2048)])
def test_histogram_schedule_refuses_a_grid_the_context_cannot_hold(
        schedule_keys, hi_bins, blocks):
    """Every block a merger (mergers == blocks), more blocks than an H100
    holds at once: the mergers would wait on blocks that cannot start, so
    the cooperative launch is refused before anything runs, as the CUDA driver
    refuses it; the wrapper's plans fit one block an SM. A context that
    holds the grid runs it exactly."""
    k = torch.from_numpy(schedule_keys)
    with pytest.raises(RuntimeError, match="cooperative launch"):
        hist_cuda._histogram_schedule(k, hi_bins, blocks, blocks, threads=32,
                                      resident=H100_RESIDENT[hi_bins])
    assert hist_cuda.histogram_plan(hi_bins, 1 << 24)[0] <= 132
    if blocks <= 1024:  # the copies of the larger plan take 268 MB here
        out, merged, _, counters = hist_cuda._histogram_schedule(
            k, hi_bins, blocks, blocks, threads=32, seed=5)
        assert np.array_equal(out.numpy(), _swar(schedule_keys, hi_bins))
        assert sorted(merged) == list(range(blocks))
        assert counters == [0, 0, 0]


@pytest.mark.parametrize("case", [
    np.full(20_000, 77, np.int32),                   # one hot bin
    np.full(64, 1 << 14, np.int32),                  # all out of range
    np.array([16383], np.int32),                     # n = 1
    np.array([-5, -(2**31)], np.int32),              # negatives only
])
@pytest.mark.parametrize("hi_bins", [8, 128])
def test_histogram_schedule_degenerate(case, hi_bins):
    for threads, blocks, mergers in ((32, 1, 1), (32, 5, 4), (64, 16, 8)):
        out, _, _, counters = hist_cuda._histogram_schedule(
            torch.from_numpy(case), hi_bins, blocks, mergers,
            threads=threads, seed=3)
        assert np.array_equal(out.numpy(), _swar(case, hi_bins))
        assert counters == [0, 0, 0]


@pytest.mark.parametrize("hi_bins", [1, 8, 80, 128])
@pytest.mark.parametrize("n", [0, 1, 4097, 100_003, 1 << 20, 1 << 22,
                               1 << 24])
def test_histogram_plan(hi_bins, n):
    """The count histogram's plan: at least one block; the blocks' copies
    hold no more bins than the keys (copies * nbins <= max(nbins, n), so
    the merge moves no more than the keys); mergers that the blocks hold,
    with slices of whole 16-byte words of 16-bit bins; and the main paths'
    plans of the sweep (Radix hi80 at 2^22: 128 blocks; the JoinOmnisci
    build hi128 at 2^20: 64)."""
    nbins = hi_bins * 128
    blocks, mergers = hist_cuda.histogram_plan(hi_bins, n)
    assert 1 <= blocks <= hist_cuda.HIST_MAX_BLOCKS
    assert blocks * nbins <= max(nbins, n)
    assert 1 <= mergers <= min(blocks, hist_cuda.HIST_MERGERS)
    assert nbins % (8 * mergers) == 0
    if (hi_bins, n) == (80, 1 << 22):
        assert (blocks, mergers) == (128, 64)
    if (hi_bins, n) == (128, 1 << 20):
        assert (blocks, mergers) == (64, 64)


def test_plain_twins_do_not_count_launches(rng):
    before = dict(_build.LAUNCHES)
    hist_cuda.histogram(_t(rng.integers(0, 100, 50)), hi_bins=8)
    hist_cuda.weighted_histogram(_t([1, 2]), _t([3, 4]), hi_bins=8)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("bad", [
    lambda: hist_cuda.histogram(torch.zeros(4, dtype=torch.int64)),
    lambda: hist_cuda.histogram(torch.zeros(8, dtype=torch.int32)[::2]),
    lambda: hist_cuda.histogram(torch.zeros((2, 2), dtype=torch.int32)),
    lambda: hist_cuda.histogram(torch.zeros(4, dtype=torch.int32), hi_bins=129),
    lambda: hist_cuda.weighted_histogram(
        torch.zeros(4, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)),
    lambda: hist_cuda.weighted_histogram(
        torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
        hi_bins=513),
])
def test_wrappers_reject_bad_input(bad):
    with pytest.raises(ValueError):
        bad()



@pytest.mark.parametrize("hi_bins", [1, 8, 64, 80, 128, 129, 160, 256, 257,
                                     511, 512])
@pytest.mark.parametrize("n", [0, 1, 100, 1000, 1 << 16, 1_000_003, 1 << 20,
                               1 << 22, 1 << 24])
def test_weighted_plan(hi_bins, n):
    """The weighted histogram's plan: a cluster of 1, 8 or 16 blocks whose
    shared memory holds the bins (128 KB a block at most), that divides the
    bins evenly, one block whenever it holds them, and copies that hold at
    most ``copy_bins_limit`` bins together (no more than the rows), within
    the copy and block budgets."""
    nbins = hi_bins * 128
    cluster, copies = hist_cuda.weighted_plan(hi_bins, n)
    assert cluster in (1, 8, 16)
    assert nbins % cluster == 0 and nbins // cluster * 4 <= 128 * 1024
    assert (cluster == 1) == (nbins <= hist_cuda.CLUSTER1_MAX_BINS)
    assert 1 <= copies <= hist_cuda.MAX_COPIES
    assert copies * nbins <= hist_cuda.copy_bins_limit(n, nbins)
    assert copies * cluster <= hist_cuda.MAX_WEIGHTED_BLOCKS
    assert hist_cuda.copy_bins_limit(n, nbins) <= max(nbins, n)


def test_weighted_plan_grows_with_rows():
    """More rows never mean fewer copies, and the main path's G = 2^16 at
    2^20 rows gets 16 copies of a 16-block cluster (the sweep's best)."""
    for hb in (1, 128, 160, 512):
        copies = [hist_cuda.weighted_plan(hb, 1 << e)[1] for e in range(25)]
        assert copies == sorted(copies)
    assert hist_cuda.weighted_plan(512, 1 << 20) == (16, 16)
