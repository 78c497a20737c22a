"""Port parity: dwarf_bench_tpu_torch.ops.hist_cuda against the JAX Pallas
histograms (interpret mode on the CPU). All outputs are integers, so the
tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
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

