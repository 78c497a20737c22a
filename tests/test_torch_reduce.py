"""The port's int32 sum against the JAX package (ops/reduce.py), exact:
``reduce_sum_pallas`` in interpret mode, ``reduce_sum_xla`` and the numpy
oracle, including sums that wrap past 2^31 and 2^32."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops import reduce as jr
from dwarf_bench_tpu_torch.ops import reduce as tr
from dwarf_bench_tpu_torch.ops import reduce_cuda


def _inputs(rng):
    yield "n=1", np.array([7], np.int32)
    yield "random n=1000", rng.integers(1, 10000, 1000, endpoint=True)
    yield "crosses 2^31", np.full(4097, 2**30, np.int64)
    yield "wraps 2^32 and negative", rng.integers(-(2**31), 2**31, 70_001)
    yield "INT32 extremes", np.array([2**31 - 1] * 3 + [-(2**31)] * 5)
    yield "n=2^19+3", rng.integers(1, 10000, (1 << 19) + 3, endpoint=True)


@pytest.mark.parametrize("case", range(6))
def test_reduce_matches_jax(rng, case):
    label, x = list(_inputs(rng))[case]
    x = np.asarray(x).astype(np.int32)
    t = torch.from_numpy(x)
    expected = jr.reduce_oracle(x)
    assert tr.reduce_oracle(x) == expected
    pallas = int(jr.reduce_sum_pallas(jnp.asarray(x), interpret=True))
    assert pallas == expected, label
    assert int(jr.reduce_sum_xla(jnp.asarray(x))) == expected
    for fn in (tr.reduce_sum, tr.reduce_sum_xla, tr.reduce_sum_pallas,
               reduce_cuda.reduce_sum_plain):
        out = fn(t)
        assert out.shape == () and out.dtype == torch.int32, label
        assert int(out) == expected, label


def test_reduce_empty_and_checks():
    out = tr.reduce_sum(torch.zeros(0, dtype=torch.int32))
    assert out.shape == () and int(out) == 0
    with pytest.raises(ValueError):
        tr.reduce_sum(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        tr.reduce_sum(torch.zeros(2, 2, dtype=torch.int32))


@pytest.mark.parametrize("n,offset", [(1, 1), (3, 1), (5, 3), (4099, 2)])
def test_reduce_of_a_view_is_a_0d_tensor_of_its_own(rng, n, offset):
    """Views that start off a 16-byte boundary (the kernel's scalar head)
    sum as the JAX kernel does, into a 0-d tensor that is not a view."""
    x = rng.integers(-(2**31), 2**31, n + offset).astype(np.int32)
    view = torch.from_numpy(x)[offset:]
    got = reduce_cuda.reduce_sum(view)
    assert got.shape == () and got.dtype == torch.int32 and got._base is None
    assert int(got) == int(jr.reduce_sum_pallas(jnp.asarray(x[offset:]),
                                                interpret=True))
