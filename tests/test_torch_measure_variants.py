"""The measurement scripts' TPU kernels (``scripts/measure_r*.py``) against
their ports in ``dwarf_bench_tpu_torch/ops/measure_variants.py`` on the CPU,
exactly, with the script functions in Pallas interpret mode (the three
without an ``interpret`` argument under ``force_tpu_interpret_mode``). Keys
include negatives and keys past the last bin for the histograms; values stay
in [1, 10000], below the TPU kernels' 2^14 limit."""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dwarf_bench_tpu_torch.ops import measure_variants as mv

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] /
                       "scripts"))
import measure_r2  # noqa: E402
import measure_r2b  # noqa: E402
import measure_r2c  # noqa: E402
import measure_r3  # noqa: E402
import measure_r3b  # noqa: E402
import measure_r3c  # noqa: E402
import measure_r4  # noqa: E402
import measure_r5  # noqa: E402

N = 1 << 17


def _keys(rng, nbins, n=N):
    k = rng.integers(-100, nbins + 500, n).astype(np.int32)
    k[:4] = [-1, -(2**31), nbins, 2**31 - 1]
    return k


def _vals(rng, n=N):
    return rng.integers(1, 10000, n, endpoint=True).astype(np.int32)


def _same(got, ref):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(ref.dtype), ref)


T = torch.from_numpy


@pytest.mark.parametrize("name,mod,kwargs,hi_bins", [
    ("histogram_16k_i8cmp", measure_r2, {}, 128),
    ("hist16k_bf16cmp", measure_r2b, {}, 128),
    ("hist16k_bf16cmp", measure_r2b, {"w": 4096}, 128),
    ("hist_variant", measure_r3, {"hi_bins": 80}, 80),
    ("hist_variant", measure_r3, {"hi_bins": 128, "i16": True}, 128),
    ("hist_rows", measure_r3c, {"hi_bins": 128, "rows": 32}, 128),
    ("hist_rows", measure_r3c, {"hi_bins": 80}, 80),
    ("hist_swar", measure_r4, {"hi_bins": 80, "form": "f1"}, 80),
    ("hist_swar", measure_r4, {"hi_bins": 80, "form": "f3"}, 80),
    ("hist_swar", measure_r4, {"hi_bins": 80, "form": "f4"}, 80),
    ("hist_swar", measure_r4, {"hi_bins": 128, "form": "f5", "rows": 32},
     128),
])
def test_histograms_match_scripts(rng, name, mod, kwargs, hi_bins):
    k = _keys(rng, hi_bins * 128)
    ref = getattr(mod, name)(jnp.asarray(k), interpret=True, **kwargs)
    _same(getattr(mv, name)(T(k), **kwargs), ref)


@pytest.mark.parametrize("name,mod,hi_bins", [
    ("weighted_histogram_i8", measure_r2c, 512),
    ("weighted_histogram_i8", measure_r2c, 128),
    ("whist_i8", measure_r3, 512),
    ("whist_i8", measure_r3, 64),
])
def test_weighted_histograms_match_scripts(rng, name, mod, hi_bins):
    k, v = _keys(rng, hi_bins * 128), _vals(rng)
    ref = getattr(mod, name)(jnp.asarray(k), jnp.asarray(v),
                             hi_bins=hi_bins, interpret=True)
    _same(getattr(mv, name)(T(k), T(v), hi_bins=hi_bins), ref)


def test_dyn_store_probe_matches_script(rng):
    """In-range indices only: the TPU kernel stores out of bounds past
    8192, where the port drops the index (ROADMAP queue 3)."""
    idx = rng.integers(0, 64 * 128, 256).astype(np.int32)
    idx[:3] = [0, 8191, 8191]
    ref = measure_r2c.dyn_store_probe(jnp.asarray(idx), interpret=True)
    _same(mv.dyn_store_probe(T(idx)), ref)
    out = mv.dyn_store_probe(T(np.array([-1, 8192, 5], np.int32)))
    assert int(out.sum()) == 1 and int(out[0, 5]) == 1


@pytest.mark.parametrize("num_groups", [64, 4096])
@pytest.mark.parametrize("name,mod,kwargs", [
    ("groupby_small_v2", measure_r2b, {}),
    ("groupby_small_v2", measure_r2b, {"w": 2048, "bf16cmp": False}),
    ("groupby_small_v3", measure_r2c, {}),
    ("groupby_small_v3", measure_r2c, {"one_dot": True}),
    ("groupby_small_v5", measure_r3b, {}),
    ("groupby_small_v5", measure_r3b, {"rows": 32, "w": 1024}),
])
def test_groupbys_match_scripts(rng, name, mod, kwargs, num_groups):
    k = rng.integers(-3, num_groups + 100, N).astype(np.int32)
    k[:3] = [-(2**31), num_groups, 2**31 - 1]
    v = _vals(rng)
    ref = getattr(mod, name)(jnp.asarray(k), jnp.asarray(v), num_groups,
                             interpret=True, **kwargs)
    _same(getattr(mv, name)(T(k), T(v), num_groups, **kwargs), ref)


@pytest.mark.parametrize("stack", [2, 4])
def test_groupby_small_stacked_matches_script(rng, stack):
    num_groups = 64
    k = rng.integers(-3, num_groups + 100, N).astype(np.int32)
    v = _vals(rng)
    ref = measure_r4.groupby_small_stacked(
        jnp.asarray(k), jnp.asarray(v), num_groups, stack=stack,
        interpret=True)
    _same(mv.groupby_small_stacked(T(k), T(v), num_groups, stack=stack), ref)


def test_gb_dbuf_kernel_matches_script(rng):
    k = rng.integers(-3, 64 + 100, N).astype(np.int32)
    v = _vals(rng)
    with pltpu.force_tpu_interpret_mode():
        ref = measure_r5._gb_dbuf_kernel()(jnp.asarray(k), jnp.asarray(v))
    _same(mv._gb_dbuf_kernel()(T(k), T(v)), ref)


@pytest.mark.parametrize("mode,naccs", [("full", 1), ("full", 4),
                                        ("dotonly", 1), ("dotonly", 4),
                                        ("nodot", 1)])
def test_gb_diag_matches_script(rng, mode, naccs):
    """2^18 + 777 rows leave the last rows x w block part-filled, so the
    zero padding counts in nodot. Keys in [0, 64) only: the TPU's SWAR
    bytes alias for others (ROADMAP queue 3)."""
    n = (1 << 18) + 777
    k = rng.integers(0, 64, n).astype(np.int32)
    v = _vals(rng, n)
    with pltpu.force_tpu_interpret_mode():
        ref = measure_r5._gb_diag_kernel_factory(mode, naccs=naccs)(
            jnp.asarray(k), jnp.asarray(v))
    _same(mv._gb_diag_kernel_factory(mode, naccs=naccs)(T(k), T(v)), ref)


@pytest.mark.parametrize("mode", ["full", "dotonly", "nodot"])
def test_gb_diag_plain_closed_forms(rng, mode):
    """The plain version against a loop over the rows, at a shape where
    ga < gb and with keys out of range, which the port drops."""
    ga, gb, rows, w = 4, 8, 3, 16
    n = 2 * rows * w + 5
    k = rng.integers(-2, ga * gb + 3, n)
    v = rng.integers(-(2**20), 2**20, n)
    exp = np.zeros((ga, gb), np.int64)
    kp = np.concatenate([k, np.zeros((-n) % (rows * w), np.int64)])
    vp = np.concatenate([v, np.zeros((-n) % (rows * w), np.int64)])
    for i, (key, val) in enumerate(zip(kp, vp)):
        if not 0 <= key < ga * gb:
            continue
        p = (val & 0x7F) + (val >> 7)
        if mode == "full" and i < n:
            exp[key // gb, key % gb] += p
        elif mode == "dotonly" and i < n and i % (rows * w) < w:
            exp[key // gb, key % gb] += rows * p
        elif mode == "nodot" and i % w < gb:
            exp[key // gb, i % w] -= 128
            if key % gb < ga:
                exp[key % gb, i % w] += p
    got = mv.gb_diag_plain(T(k.astype(np.int32)), T(v.astype(np.int32)),
                           mode, ga, gb, rows, w)
    assert np.array_equal(got.numpy(), exp.astype(np.int32))


def test_script_asserts_are_value_errors():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="rows"):
        mv.hist_swar(k, rows=6)
    with pytest.raises(ValueError, match="f5"):
        mv.hist_swar(k, hi_bins=82, form="f5")
    with pytest.raises(ValueError, match="form"):
        mv.hist_swar(k, form="f2")
    with pytest.raises(ValueError, match="hi_bins"):
        mv.weighted_histogram_i8(k, k, hi_bins=100)
    with pytest.raises(ValueError, match="2\\^24"):
        mv.groupby_small_stacked(k, k, 64, rows=64, w=4096)
    with pytest.raises(ValueError, match="stack"):
        mv.groupby_small_stacked(k, k, 64, rows=30, stack=4)
    with pytest.raises(ValueError, match="num_groups"):
        mv.groupby_small_v5(k, k, 4097)
    with pytest.raises(ValueError, match="multiples of 4"):
        mv._gb_dbuf_kernel(ga=6)
    with pytest.raises(ValueError, match="power of two"):
        mv._gb_diag_kernel_factory("full", gb=12)
    with pytest.raises(ValueError, match="mode"):
        mv._gb_diag_kernel_factory("both")
    with pytest.raises(ValueError, match="ga <= gb"):
        mv._gb_diag_kernel_factory("nodot", ga=16, gb=8)
    assert mv._gb_diag_kernel_factory("full", ga=4, gb=8)(k, k).shape == (4, 8)
