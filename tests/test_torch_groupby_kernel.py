"""Port parity: dwarf_bench_tpu_torch.ops.groupby_cuda against the JAX
Pallas groupby_small_pallas (interpret mode on the CPU). Sums are uint32 in
the JAX package and int32 bit patterns in the port; the tolerance is exact
equality of the bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwarf_bench_tpu.ops.groupby import groupby_oracle
from dwarf_bench_tpu.ops.groupby_pallas import groupby_small_pallas
from dwarf_bench_tpu_torch.ops import groupby_cuda


def _t(a):
    return torch.from_numpy(np.array(a).astype(np.int64).astype(np.int32))


def _bits(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("num_groups", [1, 20, 64, 1000, 4096])
def test_matches_pallas(rng, num_groups):
    n = 1 << 14
    k = rng.integers(0, num_groups + 7, n).astype(np.uint32)  # some OOR
    v = rng.integers(0, 1 << 14, n).astype(np.uint32)
    ref = np.asarray(groupby_small_pallas(
        jnp.asarray(k), jnp.asarray(v), num_groups, interpret=True))
    got = groupby_cuda.groupby_small(_t(k), _t(v), num_groups)
    assert got.dtype == torch.int32
    assert np.array_equal(_bits(got), ref)


# the degenerate inputs of tests/test_hist_pallas.py::test_groupby_small_swar_degenerate
@pytest.mark.parametrize("k,v,G", [
    (np.zeros(5000, np.uint32), np.full(5000, (1 << 14) - 1, np.uint32), 64),
    (np.array([0, 63, 64, 127], np.uint32),
     np.array([1, 2, 3, 4], np.uint32), 64),
    (np.array([7], np.uint32), np.array([0], np.uint32), 20),
    (np.array([0xFFFFFFFF, 0x80000000, 3], np.uint32),
     np.array([5, 6, 7], np.uint32), 4),
])
def test_degenerate(k, v, G):
    ref = np.asarray(groupby_small_pallas(
        jnp.asarray(k), jnp.asarray(v), G, interpret=True))
    got = groupby_cuda.groupby_small(_t(k), _t(v), G)
    assert np.array_equal(_bits(got), ref)


def test_sums_wrap_without_value_bound(rng):
    """v >= 2^14 is outside the TPU kernel's precondition (bf16 planes);
    the port's contract is the uint32 oracle's mod-2^32 sum."""
    n, G = 20_000, 64
    k = rng.integers(0, G, n).astype(np.uint32)
    v = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    got = groupby_cuda.groupby_small(_t(k), _t(v), G)
    assert np.array_equal(_bits(got), groupby_oracle(k, v, G))


@pytest.mark.parametrize("G", [0, 4097])
def test_rejects_group_count(G):
    with pytest.raises(ValueError):
        groupby_cuda.groupby_small(torch.zeros(3, dtype=torch.int32),
                                   torch.zeros(3, dtype=torch.int32), G)

