"""Port parity of the sparse scan's kernels, on the CPU: the plain twins of
``scan_tail_streams``, ``compact_mask``, ``emit_prefix`` and ``filter``
against the JAX package's Pallas kernels in interpret mode, and
``chunk_stats`` against ``chunk_stats_xla``. All outputs are integers, so
the tolerance is exact equality, up to each output's count (the rest is
garbage by contract)."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops.chunk_stats import chunk_stats_xla
from dwarf_bench_tpu.ops.compact_pallas import (
    compact_mask_pallas,
    emit_prefix_pallas,
)
from dwarf_bench_tpu.ops.scan_pallas import filter_pallas
from dwarf_bench_tpu.ops.scan_tail_pallas import scan_tail_streams as jax_tail
from dwarf_bench_tpu_torch.ops import (
    _build,
    compact_cuda,
    filter_cuda,
    scan_tail_cuda,
)
from dwarf_bench_tpu_torch.ops.chunk_stats import chunk_stats

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _np(a):
    return np.asarray(a)


@pytest.mark.parametrize("nch,thr", [
    (256, 5), (1024, 5000), (300, -100),
    (64, I32_MAX),
    (64, I32_MIN + 5),  # threshold - 512 wraps: garbage, but the same
    (64, I32_MIN + 512), (64, I32_MIN + 513),
])
def test_chunk_stats_matches_xla(rng, nch, thr):
    x2 = rng.integers(I32_MIN, I32_MAX, (nch, 128), endpoint=True)
    x2[: nch // 2] = rng.integers(-10000, 10000, (nch // 2, 128))
    x2[0, :] = thr - 1 if thr > I32_MIN else thr  # all-match chunk
    x2 = x2.astype(np.int32)
    stat, base = chunk_stats(_t(x2), thr)
    es, eb = chunk_stats_xla(jnp.asarray(x2), thr)
    assert stat.dtype == base.dtype == torch.int32
    assert np.array_equal(stat.numpy(), _np(es))
    assert np.array_equal(base.numpy(), _np(eb))


@pytest.mark.parametrize("density", [0.0, 5e-4, 1e-2])
@pytest.mark.parametrize("nch", [2048, 8192, 20000])
def test_scan_tail_streams_matches_pallas(rng, nch, density):
    """Values in [-1000, 5) put some singles below the window (vsw = 256):
    they must take the multi stream. At 1e-2 the multi count passes cap_mc
    and the counts stay full."""
    thr, cap_s, cap_m = 5, 16384, 2048
    x2 = rng.integers(1, 10001, (nch, 128)).astype(np.int32)
    hit = rng.random((nch, 128)) < density
    x2[hit] = rng.integers(-1000, 5, hit.sum()).astype(np.int32)
    stat, base = chunk_stats_xla(jnp.asarray(x2), thr)
    ref = [_np(r) for r in jax_tail(stat, base, thr, cap_s, cap_m,
                                    interpret=True)]
    got = [r.numpy() for r in scan_tail_cuda.scan_tail_streams(
        _t(stat), _t(base), thr, cap_s, cap_m)]
    ns, nm = int(ref[4]), int(ref[5])
    assert (int(got[4]), int(got[5])) == (ns, nm)
    assert got[4].shape == got[5].shape == ()
    ks, km = min(ns, cap_s), min(nm, cap_m)
    assert np.array_equal(got[0], ref[0])  # spos: 0x7FFFFFFF past ns
    assert np.all(got[0][ks:] == 0x7FFFFFFF)
    assert np.array_equal(got[1][:ks], ref[1][:ks])
    assert np.array_equal(got[2][:km], ref[2][:km])
    assert np.array_equal(got[3][:km], ref[3][:km])


def _tail_rows(nch, singles, seed):
    """(nch, 128) chunks of values in [5, 10000] (no match for x < 5) with
    ``singles`` chunks holding one match in the window, and some chunks
    with two matches (multis)."""
    rng = np.random.default_rng(seed)
    x2 = rng.integers(5, 10001, (nch, 128)).astype(np.int32)
    rows = rng.permutation(nch)
    x2[rows[:singles], rng.integers(0, 128, singles)] = 3
    multi = rows[singles: singles + nch // 50]
    x2[multi, :2] = -7
    return x2


@pytest.mark.parametrize("nch", [1, 2047, 2048, 2049, 5000])
@pytest.mark.parametrize("cut", ["none", "equal", "below"])
def test_lookback_tail_matches_pallas_past_n_single(nch, cut):
    """The scan tail by the kernel's schedule (its tile of 2048 chunks, the
    sentinel written by the last tile's block past n_single) against the
    Pallas kernel in interpret mode, where n_single is 0, equals
    cap_single and exceeds it."""
    singles = 0 if cut == "none" else max(nch // 3, 1)
    x2 = _tail_rows(nch, singles, seed=nch)
    stat, base = chunk_stats_xla(jnp.asarray(x2), 5)
    cap_single = {"none": 64, "equal": singles, "below": singles - 1}[cut]
    cap_mc = 512
    ref = [_np(r) for r in jax_tail(stat, base, 5, cap_single, cap_mc,
                                    interpret=True)]
    got = scan_tail_cuda._lookback_tail(_t(stat), _t(base), 5, cap_single,
                                        cap_mc)
    assert (int(got[4]), int(ref[4])) == (singles, singles)
    assert int(got[5]) == int(ref[5])
    assert np.array_equal(got[0].numpy(), ref[0])  # the sentinel past ns
    ks, km = min(singles, cap_single), min(int(ref[5]), cap_mc)
    assert np.array_equal(got[1].numpy()[:ks], ref[1][:ks])
    assert np.array_equal(got[2].numpy()[:km], ref[2][:km])
    assert np.array_equal(got[3].numpy()[:km], ref[3][:km])
    # every slot past ns is written, by the last tile's block alone
    assert (got[0].numpy()[ks:] == scan_tail_cuda.BIG).all()


@pytest.mark.parametrize("ncols,sel,capacity", [
    (1, 0.01, None),
    (2, 0.3, 1000),  # count above capacity
    (3, 1.0, 4096),
    (2, 0.0, None),
    (3, 0.001, None),
])
def test_compact_mask_matches_pallas(rng, ncols, sel, capacity):
    n = 20_000
    mask = rng.random(n) < sel
    cols = [rng.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
            for _ in range(ncols)]
    ref, rcount = compact_mask_pallas(
        jnp.asarray(mask), tuple(jnp.asarray(c) for c in cols),
        capacity=capacity, interpret=True)
    got, count = compact_cuda.compact_mask(
        torch.from_numpy(mask), [_t(c) for c in cols], capacity)
    cap = n if capacity is None else capacity
    k = min(int(rcount), cap)
    assert count.shape == () and int(count) == int(rcount)
    assert len(got) == ncols
    for g, r in zip(got, ref):
        assert g.shape == (cap,)
        assert np.array_equal(g.numpy()[:k], _np(r)[:k])


@pytest.mark.parametrize("index", [None, "permuted", "into longer vals"])
@pytest.mark.parametrize("length,capacity", [(128, 128), (100, 1000),
                                             (37, 40), (0, 16)])
def test_emit_prefix_matches_pallas(rng, length, capacity, index):
    """Without an index, vals itself; with one, vals[index] against the
    Pallas emit of the gathered values (the JAX package gathers by sorting
    pairs): a permutation of vals, and positions into a longer vals with
    repeats. L = 0 and L = capacity included."""
    nvals = length if index != "into longer vals" else 3 * length + 5
    v = rng.integers(I32_MIN, I32_MAX, nvals, endpoint=True).astype(np.int32)
    idx = None
    if index == "permuted":
        idx = rng.permutation(length)
    elif index == "into longer vals":
        idx = rng.integers(0, nvals, length)
    emitted = v if idx is None else v[idx]
    # the interpreter cannot run the Pallas kernel's zero-length DMA: at
    # L = 0 no slot holds data, and only the shape is compared
    ref = emitted if length == 0 else _np(emit_prefix_pallas(
        jnp.asarray(emitted), capacity, interpret=True))
    out = compact_cuda.emit_prefix(
        _t(v), capacity, None if idx is None else torch.from_numpy(idx))
    assert out.dtype == torch.int32 and out.shape == (capacity,)
    assert np.array_equal(out.numpy()[:length], ref[:length])
    assert np.array_equal(out.numpy()[:length], emitted)


@pytest.mark.parametrize("n,threshold,capacity", [
    (20_000, 1, None),       # nothing kept
    (20_000, 5, None),       # the reference selectivity, ~4e-4
    (20_000, 5000, None),    # 0.5
    (20_000, 10001, None),   # everything kept
    (20_000, 5000, 777),     # count above capacity
    (16_384, 5, None),       # one whole TPU block
    (1, 5, None),
])
def test_filter_matches_pallas(rng, n, threshold, capacity):
    x = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    if n > 2:
        x[:2] = [I32_MIN, I32_MAX]
    ref, rcount = filter_pallas(jnp.asarray(x), threshold, capacity=capacity,
                                interpret=True)
    out, count = filter_cuda.filter(_t(x), threshold, capacity)
    cap = n if capacity is None else capacity
    k = min(int(rcount), cap)
    assert count.shape == () and int(count) == int(rcount)
    assert out.shape == (cap,)
    assert np.array_equal(out.numpy()[:k], _np(ref)[:k])
    assert np.array_equal(out.numpy()[:k], x[x < threshold][:k])


def test_wrappers_check_their_inputs():
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        filter_cuda.filter(x.to(torch.int64))
    with pytest.raises(ValueError):
        filter_cuda.filter(x, 2**31)
    with pytest.raises(ValueError):
        compact_cuda.compact_mask(x > 0, (x, x, x, x))
    with pytest.raises(ValueError):
        compact_cuda.compact_mask(x[:4] > 0, (x,))
    with pytest.raises(ValueError):
        compact_cuda.compact_mask(x, (x,))  # the mask is bool
    with pytest.raises(ValueError):
        compact_cuda.emit_prefix(x, 7)
    idx = torch.arange(8)
    with pytest.raises(ValueError):  # longer than the capacity
        compact_cuda.emit_prefix(x, 7, idx)
    with pytest.raises(ValueError):  # int32 index
        compact_cuda.emit_prefix(x, 8, idx.to(torch.int32))
    with pytest.raises(ValueError):  # not contiguous
        compact_cuda.emit_prefix(x, 8, idx[::2])
    with pytest.raises(ValueError):
        scan_tail_cuda.scan_tail_streams(x, x[:4], 5, 4, 4)


def test_cpu_tensors_take_the_twins():
    """On the CPU no kernel is built or launched."""
    x = torch.arange(100, dtype=torch.int32)
    before = dict(_build.LAUNCHES)
    filter_cuda.filter(x, 5)
    compact_cuda.compact_mask(x < 5, (x,))
    compact_cuda.emit_prefix(x, 100)
    compact_cuda.emit_prefix(x, 100, torch.arange(99, -1, -1))
    scan_tail_cuda.scan_tail_streams(x, x, 5, 4, 4)
    assert _build.LAUNCHES == before
