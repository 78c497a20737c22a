"""Port parity: the counting sort's run expansion
(``dwarf_bench_tpu_torch/ops/expand_runs_cuda.py``, its CPU twin here) and
the sorts that call it against the JAX package's ``_expand_runs``,
``sort_counting`` and ``sort_auto``. All outputs are integers, so the
tolerance is exact equality. The kernel is held to the twin on the card in
``tests/test_torch_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops import sort as jsort
from dwarf_bench_tpu_torch.ops import expand_runs_cuda, sort

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _keys(case: str, rng) -> np.ndarray:
    """Sort keys (bin indices, as the histogram sees them after the
    min-shift) of each case; their bincount is the case's counts."""
    if case == "hi80":
        return rng.integers(0, 80 * 128, 25_600)
    if case == "hi128":
        return rng.integers(0, 128 * 128, 30_000)
    if case == "empty_ends":  # bins before 3000 and after 6999 empty
        return rng.integers(3000, 7000, 9_000)
    if case == "one_bin":
        return np.full(20_000, 9000)
    if case == "runs_of_one":  # 10240 runs of one row each
        return rng.permutation(80 * 128)
    assert case == "n1"
    return np.array([4321])


CASES = ["hi80", "hi128", "empty_ends", "one_bin", "runs_of_one", "n1"]


def _nbins(case: str) -> int:
    return 128 * 128 if case == "hi128" else 80 * 128


def _shifts(keys: np.ndarray):
    """0, INT32_MIN, INT32_MAX - span (the last row lands on INT32_MAX),
    INT32_MAX (every bin past 0 wraps) and -7."""
    return [0, I32_MIN, I32_MAX - int(keys.max()), I32_MAX, -7]


@pytest.mark.parametrize("case", CASES)
def test_twin_matches_jax_expand_runs(rng, case):
    keys = _keys(case, rng)
    n = keys.size
    counts = np.bincount(keys, minlength=_nbins(case)).astype(np.int32)
    ct = torch.from_numpy(counts)
    for shift in _shifts(keys):
        ref = np.asarray(jsort._expand_runs(jnp.asarray(counts), n, shift))
        got = expand_runs_cuda.expand_runs(ct, n, shift)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref), shift
        # a one-element int32 tensor shifts alike, as the sort's min does
        got_t = expand_runs_cuda.expand_runs(
            ct, n, torch.tensor([shift], dtype=torch.int32))
        assert np.array_equal(got_t.numpy(), ref), shift
        # the sort's entry point
        assert np.array_equal(sort._expand_runs(ct, n, shift).numpy(), ref)


@pytest.mark.parametrize("case", CASES)
def test_sorts_match_jax(rng, case):
    """sort_counting and sort_auto on columns whose histogram is each case's
    counts, at the bottom and the top of the int32 range."""
    keys = _keys(case, rng)
    for base in (I32_MIN, I32_MAX - int(keys.max()), 1):
        x = (keys.astype(np.int64) + base).astype(np.int32)
        expected = np.sort(x)
        ref_counting = np.asarray(jsort.sort_counting(jnp.asarray(x)))
        ref_auto = np.asarray(jsort.sort_auto(jnp.asarray(x),
                                              force_dispatch=True))
        xt = torch.from_numpy(x)
        for got, ref in ((sort.sort_counting(xt), ref_counting),
                         (sort.sort_auto(xt), ref_auto)):
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), ref), base
            assert np.array_equal(got.numpy(), expected), base


@pytest.mark.parametrize("bad", ["no_bins", "too_many_bins", "int64",
                                 "sum_not_n", "shift_int64", "n_2p31"])
def test_rejects(bad):
    counts = torch.tensor([2, 0, 3], dtype=torch.int32)
    n, shift = 5, 0
    if bad == "no_bins":
        counts = counts[:0]
        n = 0
    elif bad == "too_many_bins":
        counts = torch.zeros(expand_runs_cuda.MAX_BINS + 1, dtype=torch.int32)
        n = 0
    elif bad == "int64":
        counts = counts.to(torch.int64)
    elif bad == "sum_not_n":
        n = 6
    elif bad == "shift_int64":
        shift = torch.tensor([3], dtype=torch.int64)
    else:
        n = 2**31
    with pytest.raises(ValueError):
        expand_runs_cuda.expand_runs(counts, n, shift)
