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


# shifts of the counting sort's histogram: small, the column's min (as the
# sort passes it, a 0-dim tensor), both int32 extremes (k - s wraps) and
# half the bins either way (keys pushed out of [0, nbins) drop)
SHIFTS = [0, 1, "min", -(2**31), 2**31 - 1, "half", "-half"]


def _shift_value(shift, k, nbins):
    if shift == "min":
        return int(k.min())
    if shift in ("half", "-half"):
        return nbins // 2 * (1 if shift == "half" else -1)
    return shift


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("hi_bins", [1, 80, 128])
def test_histogram_plain_with_a_shift(rng, hi_bins, shift, as_tensor):
    """The twin with a shift, an int or a 0-dim int32 tensor, is the
    bincount of as_u32(k - s) below nbins, wrapping as int32 does, and the
    wrapper on a CPU tensor is the twin."""
    nbins = hi_bins * 128
    k = rng.integers(-100, nbins + 100, 20_011).astype(np.int32)
    k[:3] = [-(2**31), 2**31 - 1, -1]
    s = _shift_value(shift, k, nbins)
    ku = (k.astype(np.int64) - s) % (1 << 32)
    exp = np.bincount(ku[ku < nbins], minlength=nbins)
    arg = torch.tensor(s, dtype=torch.int32) if as_tensor else s
    got = hist_cuda.histogram_plain(_t(k), hi_bins, shift=arg)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), exp)
    assert torch.equal(hist_cuda.histogram(_t(k), hi_bins, shift=arg), got)


@pytest.mark.parametrize("shift", [-(2**31), -5000, 1, 2**31 - 1])
def test_shifted_histogram_matches_swar_pallas(rng, shift):
    """The shifted histogram is the JAX kernel's histogram of the shifted
    keys, k - s wrapped to int32."""
    k = rng.integers(-(2**31), 2**31, 1 << 12).astype(np.int32)
    k[: 1 << 11] = rng.integers(0, 80 * 128, 1 << 11) + shift
    shifted = ((k.astype(np.int64) - shift) % (1 << 32)).astype(np.uint32)
    ref = np.asarray(histogram_16k_swar_pallas(
        jnp.asarray(shifted.view(np.int32)), hi_bins=80, interpret=True))
    got = hist_cuda.histogram(_t(k), hi_bins=80, shift=shift)
    assert np.array_equal(got.numpy(), ref)


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
    lambda: hist_cuda.histogram(torch.zeros(4, dtype=torch.int32),
                                shift=torch.zeros((), dtype=torch.int64)),
    lambda: hist_cuda.histogram(torch.zeros(4, dtype=torch.int32),
                                shift=torch.zeros(2, dtype=torch.int32)),
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
                               1 << 22, 1 << 24, 1 << 27])
def test_weighted_plan(hi_bins, n):
    """The weighted histogram's plan: one block a copy whenever a block's
    shared memory holds the bins (up to CLUSTER1_MAX_BINS, 128 KB), within
    MAX_COPIES; above, below MULTICAST_MIN_ROWS rows, the remote-add
    cluster of 16 blocks (16 KB a block), within the copy and block
    budgets; from MULTICAST_MIN_ROWS rows on, multicast clusters of 2
    blocks whose slices divide the bins evenly and fit a block beside its
    stages, no more than an H100 holds at once, with no scratch. Copies or
    clusters hold, or flush, at most ``copy_bins_limit`` bins together (no
    more than the rows)."""
    nbins = hi_bins * 128
    cluster, copies = hist_cuda.weighted_plan(hi_bins, n)
    assert 1 <= copies and copies * nbins <= hist_cuda.copy_bins_limit(
        n, nbins) <= max(nbins, n)
    if nbins <= hist_cuda.CLUSTER1_MAX_BINS:
        assert cluster == 1 and nbins * 4 <= 128 * 1024
        assert copies <= hist_cuda.MAX_COPIES
    elif n < hist_cuda.MULTICAST_MIN_ROWS:
        assert cluster == 16 and nbins % cluster == 0
        assert copies <= hist_cuda.MAX_COPIES
        assert copies * cluster <= hist_cuda.MAX_WEIGHTED_BLOCKS
    else:
        assert cluster in hist_cuda.MULTICAST_CLUSTERS
        assert nbins % (32 * cluster) == 0
        ring = 2 * hist_cuda.MULTICAST_STAGES * hist_cuda.MULTICAST_TILE_ROWS
        assert (nbins // cluster + ring) * 4 <= 227 * 1024
        assert copies <= hist_cuda.MULTICAST_MAX_CLUSTERS
        assert cluster * copies <= 132  # one block an SM of an H100
        # an adding warp a 128 rows of a tile, 31 with the copying warp
        assert hist_cuda.MULTICAST_TILE_ROWS % 128 == 0
        assert hist_cuda.MULTICAST_TILE_ROWS <= 31 * 128


def test_weighted_plan_grows_with_rows():
    """More rows never mean fewer copies or clusters; the 2^16-bin plan
    crosses from the remote-add cluster of 16 to the multicast clusters of
    2 at 2^20 rows, the sweep's crossover; and the main paths' G = 2^16
    gets 16 multicast clusters at 2^20 rows, 66 (one block on each of the
    H100's 132 SMs) at 2^27."""
    for hb in (1, 128, 160, 257, 512):
        copies = [hist_cuda.weighted_plan(hb, 1 << e)[1] for e in range(28)]
        assert copies == sorted(copies)
    assert hist_cuda.MULTICAST_MIN_ROWS == 1 << 20
    assert hist_cuda.weighted_plan(512, (1 << 20) - 1) == (16, 15)
    assert hist_cuda.weighted_plan(512, 1 << 19) == (16, 8)
    assert hist_cuda.weighted_plan(512, 1 << 16) == (16, 1)
    assert hist_cuda.weighted_plan(512, 1 << 20) == (2, 16)
    assert hist_cuda.weighted_plan(512, 1 << 27) == (2, 66)
    assert hist_cuda.weighted_plan(256, 1 << 27) == (1, 64)


@pytest.mark.parametrize("rows", [4, 8, 12, 16, 64, 1020, 2048, 4096])
@pytest.mark.parametrize("cluster", [2, 4])
def test_multicast_pieces_cover_the_tile(rows, cluster):
    """The ranks' pieces of a staged tile: keys from the first half of the
    ranks, values from the second, whole 16-byte words, each row of each
    column copied by exactly one rank."""
    pieces = hist_cuda._multicast_pieces(rows, cluster)
    for col in (0, 1):
        covered = sorted((p0, p1) for rank, c, p0, p1 in pieces if c == col)
        assert [p0 for p0, _ in covered] == [0] + [p1 for _, p1 in covered][:-1]
        assert (covered[-1][1] if covered else 0) == rows
    for rank, col, p0, p1 in pieces:
        assert col == int(rank >= cluster // 2)
        assert p0 % 4 == 0 and p1 % 4 == 0 and p1 > p0


def _schedule_case(name, n, rng):
    k = rng.integers(0, 65536, n)
    v = rng.integers(1, 10001, n)
    if name == "dropped":  # negatives, the int32 extremes, keys >= nbins
        k = rng.choice([-1, -(2**31), 65536, 2**31 - 1, 70_000, 5], n)
    elif name == "hot":
        k = np.full(n, 40_000)
    elif name == "wraps":  # values near 2^31 whose sums wrap mod 2^32
        k = rng.integers(0, 8, n) * 8191
        v = rng.integers(2**31 - 100, 2**31, n)
    elif name == "signed":
        k = rng.integers(-3, 65536 + 3, n)
        v = rng.integers(-(2**31), 2**31, n)
    return k.astype(np.int32), v.astype(np.int32)


@pytest.mark.parametrize("case", ["uniform", "dropped", "hot", "wraps",
                                  "signed"])
@pytest.mark.parametrize("n", [0, 1, 7, 1000, 20_011])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (2, 2), (1, 2), (0, 3)])
@pytest.mark.parametrize("cluster,clusters,tile_rows", [
    (2, 1, 3968), (2, 3, 256), (4, 5, 128)])
def test_weighted_schedule_matches_plain(case, n, offsets, cluster, clusters,
                                         tile_rows):
    """The multicast kernel's split (tiles to clusters, pieces to ranks,
    rows to the blocks that own their keys, the head before the first
    16-byte boundary and the tail to cluster 0, keys and values off 16 bytes
    differently read by each block itself, each cluster's slices added into
    the zeroed output) against the plain twin, bit for bit: ragged n, n
    below one tile, dropped keys, one hot key, sums that wrap, views one and
    two int32 off a 16-byte boundary. Every kept row is added once, by the
    block that owns its key, and the flush adds no more bins than the
    plan's clusters hold."""
    rng = np.random.default_rng(n * 7 + sum(offsets))
    k, v = _schedule_case(case, n, rng)
    out, adds, staged, flushed, bulk = hist_cuda._weighted_schedule(
        torch.from_numpy(k), torch.from_numpy(v), 512, cluster, clusters,
        tile_rows, offsets)
    assert out.dtype == torch.int32
    assert torch.equal(out, hist_cuda.weighted_histogram_plain(
        torch.from_numpy(k), torch.from_numpy(v), 512))
    assert bulk == (offsets[0] % 4 == offsets[1] % 4)
    ku = k.view(np.uint32)
    owned = 65536 // cluster
    for r in range(cluster):
        mine = (ku >= r * owned) & (ku < (r + 1) * owned)
        assert int(adds[:, r].sum()) == int(mine.sum())
    head = min((4 - offsets[0] % 4) % 4, n) if bulk else 0
    assert int(staged.sum()) == ((n - head) // 4 * 4 if bulk else 0)
    assert flushed <= clusters * 65536


def test_weighted_schedule_main_path_plan(rng):
    """The wrapper's plan at 2^20 rows (16 clusters of 2) deals the tiles
    round, no cluster staging a tile more than another, and matches the
    twin."""
    n = 1 << 20
    k = rng.integers(0, 65536, n).astype(np.int32)
    v = rng.integers(1, 10001, n).astype(np.int32)
    cluster, clusters = hist_cuda.weighted_plan(512, n)
    out, adds, staged, flushed, bulk = hist_cuda._weighted_schedule(
        torch.from_numpy(k), torch.from_numpy(v), 512, cluster, clusters)
    assert torch.equal(out, hist_cuda.weighted_histogram_plain(
        torch.from_numpy(k), torch.from_numpy(v), 512))
    assert bulk and int(staged.sum()) == n
    assert int(staged.max() - staged.min()) <= hist_cuda.MULTICAST_TILE_ROWS
    assert flushed == clusters * 65536 <= hist_cuda.copy_bins_limit(n, 65536)
