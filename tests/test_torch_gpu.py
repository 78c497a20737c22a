"""Kernel-against-twin tests that need a CUDA device; they skip without one.

A GPU host need not have JAX, and tests/conftest.py imports it, so this
file imports neither and runs on its own there:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Every output is an integer, so kernel and twin must agree exactly.
"""

import numpy as np
import pytest
import torch

from dwarf_bench_tpu_torch import cli, populate_registry
from dwarf_bench_tpu_torch.ops import _build, cumsum_cuda, groupby_cuda, hist_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def _t(a, device):
    return torch.from_numpy(np.array(a).astype(np.int64).astype(np.int32)).to(device)


@pytest.mark.parametrize("hi_bins", [1, 80, 128])
@pytest.mark.parametrize("n", [1, 4097, 1_000_003])
def test_histogram(cuda, rng, hi_bins, n):
    k = _t(rng.integers(-100, hi_bins * 128 + 100, n), cuda)
    k[: min(n, 3)] = torch.tensor([-(2**31), 2**31 - 1, -1][: min(n, 3)])
    assert torch.equal(hist_cuda.histogram(k, hi_bins),
                       hist_cuda.histogram_plain(k, hi_bins))


@pytest.mark.parametrize("hi_bins", [1, 8, 64, 256, 512])
def test_weighted_histogram(cuda, rng, hi_bins):
    n = 1_000_003
    k = _t(rng.integers(-3, hi_bins * 128 + 3, n), cuda)
    v = _t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
    assert torch.equal(hist_cuda.weighted_histogram(k, v, hi_bins),
                       hist_cuda.weighted_histogram_plain(k, v, hi_bins))


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 1_000_003])
def test_cumsum(cuda, rng, n):
    x = _t(rng.integers(-(2**31), 2**31, n), cuda)
    for carry in (0, 2**31 - 1, _t([-(2**31)], cuda)):
        assert torch.equal(cumsum_cuda.cumsum(x, carry),
                           cumsum_cuda.cumsum_plain(x, carry))


@pytest.mark.parametrize("num_groups", [1, 64, 4096])
def test_groupby_small(cuda, rng, num_groups):
    n = 1_000_003
    k = _t(rng.integers(-3, num_groups + 3, n), cuda)
    v = _t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
    assert torch.equal(groupby_cuda.groupby_small(k, v, num_groups),
                       groupby_cuda.groupby_small_plain(k, v, num_groups))


def test_wrappers_count_their_launches(cuda):
    k = torch.zeros(10, dtype=torch.int32, device=cuda)
    before = dict(_build.LAUNCHES)
    hist_cuda.histogram(k, 8)
    hist_cuda.weighted_histogram(k, k, 8)
    groupby_cuda.groupby_small(k, k, 8)
    cumsum_cuda.cumsum(k)
    hist_cuda.histogram_plain(k, 8)
    assert {n: _build.LAUNCHES[n] - before[n] for n in before} == {
        "histogram": 1, "cumsum": 1, "groupby_small": 1,
        "weighted_histogram": 1,
    }


def test_wrapper_rejects_int64_on_gpu(cuda):
    with pytest.raises(ValueError):
        hist_cuda.histogram(torch.zeros(4, dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("dwarf,extra,kernels", [
    ("RadixCuda", [], ("histogram", "cumsum")),
    ("GroupByCuda", ["--groups_count=64"], ("groupby_small",)),
    ("GroupByCuda", ["--groups_count=65536"], ("weighted_histogram",)),
    ("JoinOmnisciCuda", [], ("histogram",)),
])
def test_dwarfs_run_through_the_kernels(cuda, tmp_path, dwarf, extra, kernels):
    before = dict(_build.LAUNCHES)
    rc = cli.main([dwarf, "--input_size", "1000", "65536", "--iterations=2",
                   f"--report_path={tmp_path / 'r.csv'}", *extra])
    assert rc == 0
    results = populate_registry().find(dwarf).get_results()
    assert len(results) == 4 and all(r.result.valid for r in results)
    assert all(_build.LAUNCHES[k] > before[k] for k in kernels)
    lines = open(tmp_path / "r.csv").read().splitlines()
    assert lines[0] == "device_type,buf_size_bytes,host_time_ms,kernel_time_ms"
    assert all(line.startswith("GPU,") for line in lines[1:])
