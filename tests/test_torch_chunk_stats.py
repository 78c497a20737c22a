"""The opt-in scan kernels' names on the CPU: ``ops/chunk_stats_cuda.py``'s
three chunk-stats names and ``scan_tail_cuda.scan_tail_compact`` held
exactly against the JAX package's Pallas kernels in interpret mode, on the
cases of ``tests/test_chunk_stats.py``. On the CPU the wrappers run their
plain versions; ``tests/test_torch_gpu.py`` holds the kernels to those on
the card."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops import chunk_stats_pallas as jax_stats
from dwarf_bench_tpu.ops.chunk_stats import chunk_stats_xla
from dwarf_bench_tpu.ops.scan_tail_pallas import \
    scan_tail_compact as jax_tail_compact
from dwarf_bench_tpu_torch.ops import chunk_stats_cuda, scan_tail_cuda

I32_MIN = -(2**31)


def _rows(rng, nch, thr):
    x2 = rng.integers(-10000, 10000, (nch, 128)).astype(np.int32)
    x2[0, :] = thr - 1  # an all-match chunk (cnt = 128)
    x2[-1, :] = thr + 1 if thr < 2**31 - 2 else thr  # an all-miss chunk
    return x2


def _same(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and g.shape == r.shape
        assert np.array_equal(g.numpy(), np.asarray(r))


CASES = [(256, 5), (1024, 5000), (300, -100), (4096, 5), (4097, 10000)]


@pytest.mark.parametrize("nch,thr", CASES)
def test_chunk_stats_pallas_matches_jax(rng, nch, thr):
    x2 = _rows(rng, nch, thr)
    ref = jax_stats.chunk_stats_pallas(jnp.asarray(x2), thr, interpret=True)
    _same(chunk_stats_cuda.chunk_stats_pallas(torch.from_numpy(x2), thr), ref)


@pytest.mark.parametrize("nch,thr", CASES + [(9000, 5)])
def test_chunk_stats_fused_matches_jax(rng, nch, thr):
    x2 = _rows(rng, nch, thr)
    ref = jax_stats.chunk_stats_fused(jnp.asarray(x2), thr, interpret=True)
    _same(chunk_stats_cuda.chunk_stats_fused(torch.from_numpy(x2), thr), ref)


@pytest.mark.parametrize("nch,thr", [(256, 5), (1000, 5000), (300, -100),
                                     (128, 5), (4096, 9999)])
def test_chunk_stats_roll_pallas_matches_jax(rng, nch, thr):
    x2 = _rows(rng, nch, thr)
    ref = jax_stats.chunk_stats_roll_pallas(jnp.asarray(x2), thr, rows=1024,
                                            interpret=True)
    _same(chunk_stats_cuda.chunk_stats_roll_pallas(torch.from_numpy(x2),
                                                   thr), ref)


@pytest.mark.parametrize("thr", [I32_MIN + 100, I32_MIN, I32_MIN + 512,
                                 2**31 - 1])
def test_wrapped_threshold_matches_xla(rng, thr):
    """t - 512 and t - max(x, t - 512) wrap mod 2^32 as XLA's int32 do: a
    threshold near INT32_MIN gives the same garbage bit for bit."""
    x2 = rng.integers(I32_MIN, 2**31, (777, 128), dtype=np.int64)
    x2 = x2.astype(np.int32)
    edge = [I32_MIN, I32_MIN + 1, 2**31 - 1, thr, thr - 1]
    x2[3, :5] = np.array(edge, np.int64).astype(np.int32)  # thr - 1 wraps
    ref = chunk_stats_xla(jnp.asarray(x2), thr)
    for fn in (chunk_stats_cuda.chunk_stats_pallas,
               chunk_stats_cuda.chunk_stats_roll_pallas,
               chunk_stats_cuda.chunk_stats_fused):
        _same(fn(torch.from_numpy(x2), thr), ref)


def test_misaligned_view_and_checks(rng):
    """A row-major view at any offset is taken; other layouts raise."""
    flat = rng.integers(-50, 50, 128 * 40 + 1).astype(np.int32)
    view = torch.from_numpy(flat)[1:].view(40, 128)
    ref = chunk_stats_xla(jnp.asarray(flat[1:].reshape(40, 128)), 5)
    _same(chunk_stats_cuda.chunk_stats_pallas(view, 5), ref)
    with pytest.raises(ValueError, match="contiguous"):
        chunk_stats_cuda.chunk_stats_pallas(
            torch.zeros(128, 8, dtype=torch.int32).t(), 5)
    with pytest.raises(ValueError, match="int32"):
        chunk_stats_cuda.chunk_stats_fused(torch.zeros(4, 64,
                                                       dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="not an int32"):
        chunk_stats_cuda.chunk_stats_roll_pallas(
            torch.zeros(4, 128, dtype=torch.int32), 2**31)


@pytest.mark.parametrize("nch,density", [(2048, 0.001), (6000, 0.01),
                                         (2048, 0.0)])
def test_scan_tail_compact_matches_jax(rng, nch, density):
    thr = 5
    x2 = rng.integers(1, 10001, (nch, 128)).astype(np.int32)
    hit = rng.random((nch, 128)) < density
    x2[hit] = rng.integers(-1000, 5, hit.sum()).astype(np.int32)
    stat, base = chunk_stats_xla(jnp.asarray(x2), thr)
    for cap_s, cap_m in ((4096, 512), (7, 3)):
        ref = jax_tail_compact(stat, base, thr, cap_s, cap_m, interpret=True)
        got = scan_tail_cuda.scan_tail_compact(
            torch.from_numpy(np.array(stat)),
            torch.from_numpy(np.array(base)), thr, cap_s, cap_m)
        ns, nm = int(ref[4]), int(ref[5])
        assert (int(got[4]), int(got[5])) == (ns, nm)
        # spos holds the sentinel past n_single; the rest is garbage past
        # the counts (capped at the slots)
        assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
        ks, km = min(ns, cap_s), min(nm, cap_m)
        assert np.array_equal(got[1].numpy()[:ks], np.asarray(ref[1])[:ks])
        for g, r in zip(got[2:4], ref[2:4]):
            assert np.array_equal(g.numpy()[:km], np.asarray(r)[:km])


def test_scan_tail_compact_chunk_limit():
    """The JAX function asserts at most 128 x 2048 chunks; the port raises
    ValueError there."""
    ok = torch.zeros(128 * 2048, dtype=torch.int32)
    assert int(scan_tail_cuda.scan_tail_compact(ok, ok, 5, 16, 16)[4]) == 0
    big = torch.zeros(128 * 2048 + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="chunks"):
        scan_tail_cuda.scan_tail_compact(big, big, 5, 16, 16)
