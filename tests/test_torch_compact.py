"""The one-pass schedule of the ordered compaction (``csrc/compact.cuh``),
rendered in plain PyTorch (``compact_cuda._lookback_compact``), against the
JAX package's Pallas kernels in interpret mode: ``compact_mask_pallas``,
``filter_pallas`` and ``scan_tail_streams``, on the same numpy-seeded
inputs. Tiles of 8-64 rows and the kernel's (8192 rows for the mask, 16384
for the filter, 2048 chunks for the scan tail); blocks interleaved in a
scrambled order, so that a look-back reads words unpublished, aggregates and
prefixes, and with two streams a pair with one word published; capacities
that cut inside a tile. Every output is an integer: the tolerance is exact
equality up to each output's count (the rest is garbage by contract)."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops.chunk_stats import chunk_stats_xla
from dwarf_bench_tpu.ops.compact_pallas import compact_mask_pallas
from dwarf_bench_tpu.ops.scan_pallas import filter_pallas
from dwarf_bench_tpu.ops.scan_tail_pallas import scan_tail_streams as jax_tail
from dwarf_bench_tpu_torch.ops import compact_cuda, filter_cuda, scan_tail_cuda

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
# the kernel's tiles: 8192 rows for the mask, 16384 for the filter, 2048
# chunks for the scan tail
KERNEL_TILE = dict(warps=16, vecs=4, lanes=32, window=32)
FILTER_TILE = dict(KERNEL_TILE, vecs=8)
TAIL_TILE = scan_tail_cuda.TAIL_TILE

# (warps, vecs, lanes, window): tiles of 8, 16, 32 and 64 rows, and 64
# rows in two groups of 4 runs
SMALL_TILES = [(1, 1, 2, 4), (2, 1, 2, 32), (1, 2, 4, 3), (2, 2, 4, 5),
               (1, 8, 2, 4)]


def _schedule(shape, seed):
    warps, vecs, lanes, window = shape
    return dict(warps=warps, vecs=vecs, lanes=lanes, window=window,
                seed=seed)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _stretches(rng, n, tile):
    """Kept flags in stretches: some tiles keep nothing, some everything,
    the rest about half, so that a look-back walks past many aggregates."""
    kind = rng.integers(0, 3, -(-n // tile))
    dens = np.array([0.0, 1.0, 0.5])[kind]
    return rng.random(n) < np.repeat(dens, tile)[:n]


def _cut_inside_a_tile(keep, tile_rows):
    """A capacity past half of the kept rows whose cut falls inside a tile:
    that tile keeps rows on both sides of it."""
    kept = np.flatnonzero(keep)
    tiles = kept // tile_rows
    for r in range(len(kept) // 2, len(kept)):
        if tiles[r] == tiles[r - 1]:
            return r
    raise AssertionError("no tile keeps two rows")


def _tile_rows(shape):
    warps, vecs, lanes, _ = shape
    return warps * vecs * lanes * 4


def _assert_scrambled(reads, two_streams=False):
    assert reads["none"] and reads["aggregate"] and reads["prefix"]
    if two_streams:
        assert reads["one flag"]


@pytest.fixture(scope="module")
def mask_case():
    """20011 rows in stretches of 16, three int32 columns."""
    rng = np.random.default_rng(9)
    n = 20_011
    mask = _stretches(rng, n, 16)
    cols = [rng.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
            for _ in range(3)]
    return mask, cols


_PALLAS = {}


def _pallas_mask(mask, cols, cap):
    key = (id(mask), len(cols), cap)
    if key not in _PALLAS:
        outs, count = compact_mask_pallas(
            jnp.asarray(mask), tuple(jnp.asarray(c) for c in cols),
            capacity=cap, interpret=True)
        _PALLAS[key] = [np.asarray(o) for o in outs], int(count)
    return _PALLAS[key]


def _same_mask(got_outs, got_count, ref_outs, ref_count, cap):
    assert got_count.shape == () and int(got_count) == ref_count
    k = min(ref_count, cap)
    assert len(got_outs) == len(ref_outs)
    for g, r in zip(got_outs, ref_outs):
        assert g.shape == (cap,)
        assert np.array_equal(g.numpy()[:k], r[:k])


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("shape", SMALL_TILES)
@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_compact_mask_schedule_matches_pallas(mask_case, ncols, shape, cut):
    mask, cols = mask_case
    cols = cols[:ncols]
    cap = _cut_inside_a_tile(mask, _tile_rows(shape)) if cut else None
    cap_n = len(mask) if cap is None else cap
    outs, count, reads = compact_cuda._lookback_compact_mask(
        torch.from_numpy(mask), [_t(c) for c in cols], cap,
        **_schedule(shape, seed=ncols))
    ref_outs, ref_count = _pallas_mask(mask, cols, cap)
    _same_mask(outs, count, ref_outs, ref_count, cap_n)
    assert ref_count > cap_n or not cut
    _assert_scrambled(reads)


@pytest.fixture(scope="module")
def mask_case_big():
    """Five kernel tiles and a part-filled sixth, in stretches of 512 rows
    (a warp's stretch), three int32 columns."""
    rng = np.random.default_rng(10)
    n = 5 * 8192 + 77
    mask = _stretches(rng, n, 512)
    cols = [rng.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
            for _ in range(3)]
    return mask, cols


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_compact_mask_schedule_at_the_kernel_tile(mask_case_big, ncols, cut):
    """The kernel's tile and window; with few tiles a look-back finds its
    predecessors mostly unpublished, so the blocks run in order: each
    reads prefixes."""
    mask, cols = mask_case_big
    cols = cols[:ncols]
    cap = _cut_inside_a_tile(mask, 8192) if cut else None
    cap_n = len(mask) if cap is None else cap
    outs, count, reads = compact_cuda._lookback_compact_mask(
        torch.from_numpy(mask), [_t(c) for c in cols], cap, **KERNEL_TILE)
    ref_outs, ref_count = _pallas_mask(mask, cols, cap)
    _same_mask(outs, count, ref_outs, ref_count, cap_n)
    assert reads["prefix"] and not reads["none"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_compact_mask_schedule_at_the_kernel_tile_scrambled(mask_case_big,
                                                            seed):
    mask, cols = mask_case_big
    outs, count, reads = compact_cuda._lookback_compact_mask(
        torch.from_numpy(mask), [_t(c) for c in cols[:2]], 40_000,
        **KERNEL_TILE, seed=seed, resident=6)
    ref_outs, ref_count = _pallas_mask(mask, cols[:2], 40_000)
    _same_mask(outs, count, ref_outs, ref_count, 40_000)
    assert reads["none"]


@pytest.fixture(scope="module")
def filter_case():
    """Three filter tiles and a part-filled fourth of values in [1, 10000]
    with the int32 extremes, and stretches of values below 5000."""
    rng = np.random.default_rng(11)
    n = 3 * 16384 + 77
    x = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    low = _stretches(rng, n, 32)
    x[low] = rng.integers(-1000, 5000, low.sum())
    x[:2] = [I32_MIN, I32_MAX]
    return x


@pytest.mark.parametrize("threshold,cut", [(5000, False), (5000, True),
                                           (5, False), (10001, True)])
@pytest.mark.parametrize("shape", SMALL_TILES + [None])
def test_filter_schedule_matches_pallas(filter_case, shape, threshold, cut):
    x = filter_case
    tile = 16384 if shape is None else _tile_rows(shape)
    cap = _cut_inside_a_tile(x < threshold, tile) if cut else None
    cap_n = len(x) if cap is None else cap
    schedule = FILTER_TILE if shape is None else _schedule(shape, seed=7)
    out, count, reads = filter_cuda._lookback_filter(_t(x), threshold, cap,
                                                     **schedule)
    ref, rcount = filter_pallas(jnp.asarray(x), threshold, capacity=cap,
                                interpret=True)
    k = min(int(rcount), cap_n)
    assert count.shape == () and int(count) == int(rcount)
    assert out.shape == (cap_n,)
    assert np.array_equal(out.numpy()[:k], np.asarray(ref)[:k])
    if shape is not None and threshold == 5000:
        _assert_scrambled(reads)


@pytest.fixture(scope="module")
def tail_case():
    """The chunk stats of 3000 chunks of 128 values whose matches (values
    in [-1000, 5)) come in stretches: singles, multis and chunks below the
    window (vsw 256, multi)."""
    rng = np.random.default_rng(12)
    nch = 3000
    x2 = rng.integers(1, 10001, (nch, 128)).astype(np.int32)
    dens = np.array([0.0, 1 / 128, 0.02])[rng.integers(0, 3, nch // 8)]
    hit = rng.random((nch, 128)) < np.repeat(dens, 8)[:, None]
    x2[hit] = rng.integers(-1000, 5, hit.sum())
    stat, base = chunk_stats_xla(jnp.asarray(x2), 5)
    return np.asarray(stat), np.asarray(base)


@pytest.mark.parametrize("caps", [(16384, 2048), (101, 57)])
@pytest.mark.parametrize("shape", SMALL_TILES + [None])
def test_scan_tail_schedule_matches_pallas(tail_case, shape, caps):
    """Two streams over two status words a tile; with caps (101, 57) both
    streams are cut, each inside a tile."""
    stat, base = tail_case
    schedule = TAIL_TILE if shape is None else _schedule(shape, seed=5)
    got = scan_tail_cuda._lookback_tail(_t(stat), _t(base), 5, *caps,
                                        **schedule)
    ref = [np.asarray(r) for r in jax_tail(jnp.asarray(stat),
                                           jnp.asarray(base), 5, *caps,
                                           interpret=True)]
    ns, nm = int(ref[4]), int(ref[5])
    assert (int(got[4]), int(got[5])) == (ns, nm)
    assert ns > caps[0] and nm > caps[1] or caps[0] > 1000
    ks, km = min(ns, caps[0]), min(nm, caps[1])
    assert np.array_equal(got[0].numpy(), ref[0])  # spos: BIG past ns
    assert np.array_equal(got[1].numpy()[:ks], ref[1][:ks])
    assert np.array_equal(got[2].numpy()[:km], ref[2][:km])
    assert np.array_equal(got[3].numpy()[:km], ref[3][:km])
    if shape is not None:
        _assert_scrambled(got[6], two_streams=True)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 65, 1000, 4099])
@pytest.mark.parametrize("k", [1, 2])
def test_schedule_any_length(rng, n, k):
    """Any length, zero included (one block runs and writes zero counts),
    against the plain copy_if of each stream."""
    keep = torch.from_numpy(rng.random((k, n)) < 0.4)
    cols = [(_t(rng.integers(I32_MIN, I32_MAX, n, endpoint=True)),)
            for _ in range(k)]
    caps = [n, max(n // 3, 1)][:k]
    outs, counts, _ = compact_cuda._lookback_compact(
        keep, cols, caps, warps=2, vecs=1, lanes=2, window=4, seed=n)
    for s in range(k):
        (exp,), ecount = compact_cuda.compact_mask_plain(keep[s], cols[s],
                                                         caps[s])
        kk = min(int(ecount), caps[s])
        assert int(counts[s]) == int(ecount)
        assert torch.equal(outs[s][0][:kk], exp[:kk])
        # no slot past the count is written
        assert bool((outs[s][0][kk:] == -1).all())


@pytest.mark.parametrize("vecs", [1, 4, 8])
def test_in_tile_ranks_are_the_row_order(vecs):
    """The packed-byte ranks equal the exclusive count of kept rows before
    each row of its tile, at a warp's whole 32 lanes with every row kept
    (128 a run, the most one byte holds) and at random flags: the scan
    tail's tiles (one run a group), the mask's (one group of 4 runs) and
    the filter's (two)."""
    rng = np.random.default_rng(13)
    for keep in (np.ones((2, 16, vecs, 32, 4), bool),
                 rng.random((3, 16, vecs, 32, 4)) < 0.5):
        flags = torch.from_numpy(keep)
        rank, count = compact_cuda._in_tile_ranks(flags, 16, vecs, 32)
        flat = flags.reshape(flags.shape[0], -1).to(torch.int64)
        assert torch.equal(rank, torch.cumsum(flat, 1) - flat)
        assert torch.equal(count, flat.sum(1))
