"""The plain references, their controls, the comparisons and the byte
counts, against cases worked by hand."""

from __future__ import annotations

import torch

import bm_util  # noqa: F401  (the repository's root on the import path)
from benchmark.queries import filter as qfilter
from benchmark.queries import sort as qsort
from benchmark.reference import filter as rfilter
from benchmark.reference import sort as rsort
from benchmark.work import filter as wfilter
from benchmark.work import sort as wsort


def t(values):
    return torch.tensor(values, dtype=torch.int32)


def test_sort_reference_by_hand():
    assert rsort.expected(t([5, 1, 10000, 3, 3]), {}).tolist() == [
        1, 3, 3, 5, 10000]
    assert rsort.expected(t([]), {}).tolist() == []


def test_sort_control_rounds_values_above_256():
    # bfloat16 holds 8 bits of mantissa: 257 rounds to 256, 9999 to 9984
    assert rsort.control(t([9999, 257, 3]), {}).tolist() == [3, 256, 9984]


def test_filter_reference_by_hand():
    x = t([7, 4, 1, 9, 4, 2, 5])
    assert rfilter.expected(x, {"threshold": 5}).tolist() == [4, 1, 4, 2]
    assert rfilter.expected(x, {"threshold": 1}).tolist() == []


def test_filter_control_keeps_count_breaks_order():
    out, count = rfilter.control(t([7, 4, 1, 9, 4, 2, 5]), {"threshold": 5})
    assert out.numel() == 7 and int(count) == 4
    assert out[:4].tolist() == [1, 2, 4, 4]


def test_sort_compare_counts_wrong_elements():
    x = t([3, 1, 2])
    a = (x,)
    assert qsort.compare(t([1, 2, 3]), a, {}) == {"wrong_elements": 0}
    assert qsort.compare(t([1, 3, 2]), a, {}) == {"wrong_elements": 2}
    assert qsort.compare(t([1, 2]), a, {}) == {"wrong_elements": 1}
    assert qsort.compare(x, a, {})["wrong_elements"] == 3


def test_filter_compare_counts_rows_and_count():
    x = t([7, 4, 1, 9, 4, 2, 5])
    a, p = (x,), {"threshold": 5}
    good = (t([4, 1, 4, 2, 99, 99, 99]), torch.tensor(4, dtype=torch.int32))
    assert qfilter.compare(good, a, p) == {"wrong_rows": 0}
    swapped = (t([1, 4, 4, 2, 0, 0, 0]), torch.tensor(4, dtype=torch.int32))
    assert qfilter.compare(swapped, a, p) == {"wrong_rows": 2}
    short = (t([4, 1, 4, 0, 0, 0, 0]), torch.tensor(3, dtype=torch.int32))
    assert qfilter.compare(short, a, p) == {"wrong_rows": 1}
    long = (t([4, 1, 4, 2, 7, 0, 0]), torch.tensor(5, dtype=torch.int32))
    assert qfilter.compare(long, a, p) == {"wrong_rows": 1}
    assert qfilter.compare(rfilter.control(x, p), a, p)["wrong_rows"] == 3


def test_byte_counts():
    # a sort reads 4 B and writes 4 B a row
    col = torch.empty(1 << 27, dtype=torch.int32, device="meta")
    assert wsort.bytes_needed((col,)) == 8 * (1 << 27)
    # a filter reads 4 B a row and writes 4 B a kept row
    rng = torch.empty(1 << 20, dtype=torch.int32, device="meta")
    assert wfilter.bytes_needed((rng,), 524288) == 4 * (1 << 20) + 4 * 524288
    assert wfilter.bytes_needed((t([0] * 100),), 0) == 400


def test_written_rows():
    assert qsort.written(t([1, 2])) == 0
    out = (t([4, 1]), torch.tensor(2, dtype=torch.int32))
    assert int(qfilter.written(out)) == 2
