"""The traffic generator: the same queries for the same seed, the same set
of sizes for every seed, and every range inside its column."""

from __future__ import annotations

import itertools
from collections import Counter

import pytest

import bm_util  # noqa: F401  (the repository's root on the import path)
from benchmark import loadgen, spec

GRID = [256 << i for i in range(9)]


def take(traffic, cols, rows, seed, k):
    return list(itertools.islice(loadgen.deal(traffic, cols, rows, seed), k))


def test_same_seed_same_queries_large_seed():
    tr = spec.load_traffic("small_grid")
    seed = 2**31 + 12345
    assert take(tr, 8, 1 << 20, seed, 5000) == take(tr, 8, 1 << 20, seed, 5000)
    assert take(tr, 8, 1 << 20, seed, 50) != take(tr, 8, 1 << 20, seed + 1, 50)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**33 + 5])
def test_every_deck_holds_each_size_once(seed):
    tr = spec.load_traffic("small_grid")
    qs = take(tr, 8, 1 << 20, seed, 9 * 40)
    for d in range(40):
        assert sorted(n for _, _, n in qs[9 * d:9 * d + 9]) == GRID
    for col, off, n in qs:
        assert 0 <= col < 8 and off % 256 == 0 and off + n <= 1 << 20


def test_whole_columns_in_turn():
    tr = spec.load_traffic("col_2p27")
    qs = take(tr, 8, 1 << 12, 3, 20)
    assert all(off == 0 and n == 1 << 12 for _, off, n in qs)
    cols = [c for c, _, _ in qs]
    assert all((b - a) % 8 == 1 for a, b in zip(cols, cols[1:]))


def test_random_ranges_spread_over_columns():
    tr = spec.load_traffic("lt5000_2p20")
    qs = take(tr, 8, 1 << 22, 11, 8000)
    assert all(n == 1 << 20 and off % 256 == 0 and off + n <= 1 << 22
               for _, off, n in qs)
    assert set(Counter(c for c, _, _ in qs)) == set(range(8))
    assert len({off for _, off, _ in qs}) > 1000


def test_a_length_beyond_the_column_raises():
    tr = spec.load_traffic("lt5000_2p20")
    with pytest.raises(ValueError):
        next(loadgen.deal(tr, 8, 1 << 10, 1))
