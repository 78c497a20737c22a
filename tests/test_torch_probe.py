"""The dense join's lookup names on the CPU: ``ops/probe_cuda.py``'s
``probe_dense_rel_pallas`` and ``probe_dense_cat_pallas`` held exactly
against the JAX package's Pallas kernels in interpret mode, over a table
that the JAX ``build_dense`` made (carried across with
``csr_join.table_from_numpy``). The JAX kernels are exact for tables below
2^24 (``packed3_ok``), which these tables meet."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwarf_bench_tpu.ops import csr_join as jax_csr
from dwarf_bench_tpu.ops import probe_pallas as jax_probe
from dwarf_bench_tpu_torch.ops import csr_join, probe_cuda


def _table(rng, span, n=1 << 14):
    a = rng.integers(1, span, n, endpoint=True).astype(np.uint32)
    jt = jax_csr.build_dense(jnp.asarray(a))
    assert bool(jt.packed3_ok)
    return jt, csr_join.table_from_numpy(jt)


def _queries(rng, hi_rows, n=1 << 14):
    """Min-shifted keys: in range, past the range, negative, EMPTY."""
    ki = rng.integers(-3, hi_rows * 128 + 900, n).astype(np.int32)
    ki[:6] = [-1, -(2**31), 2**31 - 1, 1 << 14, hi_rows * 128,
              hi_rows * 128 - 1]
    return ki


def _same(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_probe_dense_rel_matches_jax(rng):
    jt, t = _table(rng, 10000)
    ki = _queries(rng, 128)
    ref = jax_probe.probe_dense_rel_pallas(jt.packed3, jt.base128,
                                           jnp.asarray(ki), interpret=True)
    _same(probe_cuda.probe_dense_rel_pallas(t.packed3, t.base128,
                                            torch.from_numpy(ki)), ref)


@pytest.mark.parametrize("hi_rows", [128, 80])
def test_probe_dense_cat_matches_jax(rng, hi_rows):
    jt, t = _table(rng, hi_rows * 128 - 300)
    ki = _queries(rng, hi_rows)
    ref = jax_probe.probe_dense_cat_pallas(
        jt.packed3, jt.base128, jnp.asarray(ki), hi_rows=hi_rows,
        interpret=True)
    _same(probe_cuda.probe_dense_cat_pallas(
        t.packed3, t.base128, torch.from_numpy(ki), hi_rows=hi_rows), ref)


def test_lookup_agrees_with_probe_dense(rng):
    """(pos, cnt) of the lookup are probe_dense's views for in-range keys,
    and found is cnt > 0."""
    a = rng.integers(1, 10000, 5000, endpoint=True).astype(np.int32)
    b = rng.integers(1, 12000, 7000, endpoint=True).astype(np.int32)
    b[:3] = [-1, 0, 2**31 - 1]
    t = csr_join.build_dense(torch.from_numpy(a))
    res = csr_join.probe_dense(t, torch.from_numpy(b))
    ki = torch.from_numpy(b) - t.minv
    ki = torch.where(torch.from_numpy(b) == -1, -1, ki)
    pos, cnt = probe_cuda.probe_dense_rel_pallas(t.packed3, t.base128, ki)
    assert torch.equal(cnt, res.counts) and torch.equal(pos, res.pos)
    assert torch.equal(cnt > 0, res.found)


def test_checks():
    p3 = torch.zeros(1 << 14, dtype=torch.int32)
    b = torch.zeros(128, dtype=torch.int32)
    k = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="tables"):
        probe_cuda.probe_dense_rel_pallas(p3[:100], b, k)
    with pytest.raises(ValueError, match="hi_rows"):
        probe_cuda.probe_dense_cat_pallas(p3, b, k, hi_rows=129)
    with pytest.raises(ValueError, match="int32"):
        probe_cuda.probe_dense_rel_pallas(p3, b, k.to(torch.int64))
