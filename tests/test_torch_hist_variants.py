"""The histogram and group-by variants' names on the CPU (``hist_cuda``
``histogram_16k_pallas``, ``weighted_histogram_pallas`` and its 2^14-bin
alias; ``groupby_cuda`` ``groupby_small_swar_pallas`` and
``groupby_small_pallas_f32``) held exactly against the JAX package's Pallas
kernels in interpret mode, out-of-range keys included. Values stay below
2^14, the JAX kernels' precondition."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops import groupby_pallas as jax_gb
from dwarf_bench_tpu.ops import hist_pallas as jax_hist
from dwarf_bench_tpu_torch.ops import groupby_cuda, hist_cuda


def _keys(rng, nbins, n):
    k = rng.integers(-100, nbins + 500, n).astype(np.int32)
    k[:4] = [-1, -(2**31), nbins, nbins - 1]
    return k


def _vals(rng, n):
    return rng.integers(1, 10000, n, endpoint=True).astype(np.int32)


@pytest.mark.parametrize("hi_bins", [80, 128])
def test_histogram_16k_pallas_matches_jax(rng, hi_bins):
    k = _keys(rng, hi_bins * 128, 50_000)
    ref = jax_hist.histogram_16k_pallas(jnp.asarray(k), hi_bins=hi_bins,
                                        interpret=True)
    got = hist_cuda.histogram_16k_pallas(torch.from_numpy(k), hi_bins)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("hi_bins", [128, 512])
def test_weighted_histogram_pallas_matches_jax(rng, hi_bins):
    n = 50_000
    k, v = _keys(rng, hi_bins * 128, n), _vals(rng, n)
    ref = jax_hist.weighted_histogram_pallas(
        jnp.asarray(k), jnp.asarray(v), hi_bins=hi_bins, interpret=True)
    got = hist_cuda.weighted_histogram_pallas(torch.from_numpy(k),
                                              torch.from_numpy(v), hi_bins)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_weighted_histogram_16k_alias_matches_jax(rng):
    n = 30_000
    k, v = _keys(rng, 1 << 14, n), _vals(rng, n)
    ref = jax_hist.weighted_histogram_16k_pallas(
        jnp.asarray(k), jnp.asarray(v), interpret=True)
    got = hist_cuda.weighted_histogram_16k_pallas(torch.from_numpy(k),
                                                  torch.from_numpy(v))
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("num_groups", [64, 10000])
@pytest.mark.parametrize("name", ["groupby_small_swar_pallas",
                                  "groupby_small_pallas_f32"])
def test_groupby_variants_match_jax(rng, name, num_groups):
    """G = 64 runs the groupby_small kernel on the card and G = 10000 the
    weighted_histogram one; keys in [G, 128 * ceil(G / 128)) are dropped
    like every other out-of-range key."""
    n = 1 << 15
    k = rng.integers(0, num_groups + 200, n).astype(np.int32)
    k[:5] = [-1, -(2**31), num_groups, num_groups - 1, 2**31 - 1]
    v = _vals(rng, n)
    ref = getattr(jax_gb, name)(jnp.asarray(k), jnp.asarray(v), num_groups,
                                interpret=True)
    got = getattr(groupby_cuda, name)(torch.from_numpy(k),
                                      torch.from_numpy(v), num_groups)
    assert got.dtype == torch.int32 and got.shape == (num_groups,)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(ref))


def test_variant_limits():
    """The JAX kernels' asserts, as ValueErrors."""
    k = torch.zeros(8, dtype=torch.int32)
    for bad in (0, 81, 136):
        with pytest.raises(ValueError, match="hi_bins"):
            hist_cuda.histogram_16k_pallas(k, bad)
    with pytest.raises(ValueError, match="hi_bins"):
        hist_cuda.weighted_histogram_pallas(k, k, 520)
    assert hist_cuda.weighted_histogram_pallas(k, k, 512).shape == (1 << 16,)
    # the SWAR kernel's hi digit stops at 120 (G <= 15360), the f32 one's
    # key space at 2^14
    assert groupby_cuda.groupby_small_swar_pallas(k, k, 15360).shape == \
        (15360,)
    with pytest.raises(ValueError, match="hi digit"):
        groupby_cuda.groupby_small_swar_pallas(k, k, 15361)
    assert groupby_cuda.groupby_small_pallas_f32(k, k, 1 << 14).shape == \
        (1 << 14,)
    for fn in (groupby_cuda.groupby_small_swar_pallas,
               groupby_cuda.groupby_small_pallas_f32):
        with pytest.raises(ValueError, match="num_groups"):
            fn(k, k, (1 << 14) + 1)
        with pytest.raises(ValueError, match="num_groups"):
            fn(k, k, 0)
