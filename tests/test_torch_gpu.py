"""Kernel-against-twin tests that need a CUDA device; they skip without one.

A GPU host need not have JAX, and tests/conftest.py imports it, so this
file imports neither and runs on its own there:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Every output is an integer, so kernel and twin must agree exactly.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu_torch import (
    ApiDeviceType,
    DwarfBench,
    DwarfKind,
    RunConfig,
    cli,
    populate_registry,
)
from dwarf_bench_tpu_torch.examples import bench_usage, lock_add, vadd
from dwarf_bench_tpu_torch.ops import (
    _build,
    bitonic_cuda,
    bucket_hash,
    chunk_stats_cuda,
    compact_cuda,
    csr_join,
    cuckoo,
    cumsum_cuda,
    filter_cuda,
    groupby,
    groupby_cuda,
    hist_cuda,
    lock_add_cuda,
    measure_variants,
    merge_fill_cuda,
    merge_lookup,
    probe_cuda,
    reduce_cuda,
    scan,
    scan_tail_cuda,
    vadd_cuda,
)
from dwarf_bench_tpu_torch.ops.chunk_stats import chunk_stats
from dwarf_bench_tpu_torch.utils.kernel_times import device_ops

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


@pytest.mark.parametrize("hi_bins,n", [(80, 1 << 22), (128, 1 << 20),
                                       (8, 100_003), (128, 1)])
def test_histogram_plan(cuda, rng, hi_bins, n):
    """The wrapper's plan at the main-path shapes (Radix hi80 at 2^22, the
    JoinOmnisci build hi128 at 2^20) and at small ones: its copies hold no
    more bins than the keys, and the result is exact."""
    blocks, mergers = hist_cuda.histogram_plan(hi_bins, n)
    assert blocks * hi_bins * 128 <= max(hi_bins * 128, n)
    assert mergers <= blocks and hi_bins * 128 % (8 * mergers) == 0
    k = _t(rng.integers(-3, hi_bins * 128 + 3, n), cuda)
    assert torch.equal(hist_cuda.histogram(k, hi_bins),
                       hist_cuda.histogram_plain(k, hi_bins))


@pytest.mark.parametrize("blocks,mergers", [(1, 1), (5, 1), (5, 4), (16, 16),
                                            (64, 64), (128, 32), (3, 2),
                                            (132, 64), (256, 16)])
def test_histogram_explicit_plans(cuda, rng, blocks, mergers):
    """Plans with 16-bit copies (every block under 2^16 keys) and, with few
    blocks, 32-bit ones; views off 16 bytes take the scalar head and tail.
    The counters are left zero: each next call on the stream is exact."""
    for n in (300_007, 1 << 20, 1 << 22):
        k = _t(rng.integers(-3, 80 * 128 + 3, n), cuda)
        for off in (0, 1, 2, 3):
            assert torch.equal(hist_cuda.launch_histogram(
                k[off:], 80 * 128, blocks, mergers),
                hist_cuda.histogram_plain(k[off:], 80))


REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("hi_bins,blocks", [(64, 1024), (128, 2048)])
def test_histogram_plan_the_card_cannot_hold_ends(cuda, hi_bins, blocks):
    """Every block a merger, more blocks than an H100 holds at once (528 at
    8192 bins, 396 at 2^14): mergers that waited on blocks unable to start
    would hang. In a subprocess under a time limit, so that a hang fails
    this test instead of stalling the suite: the cooperative launch is
    refused, the wrapper raises the CUDA driver's error, and the next call on
    the stream is exact."""
    proc = subprocess.run(
        [sys.executable, "-m", "dwarf_bench_tpu_torch.utils.hist_plan",
         str(hi_bins), str(blocks)],
        capture_output=True, text=True, timeout=180, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "refused:" in proc.stdout, proc.stdout
    assert "cooperative launch" in proc.stdout, proc.stdout
    assert "next call exact: True" in proc.stdout, proc.stdout


@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 4097, 1 << 20])
def test_histogram_of_views_off_16_bytes(cuda, rng, off, n):
    k = _t(rng.integers(-3, 128 * 128 + 3, n + off), cuda)[off:]
    assert torch.equal(hist_cuda.histogram(k, 128),
                       hist_cuda.histogram_plain(k, 128))


@pytest.mark.parametrize("hi_bins,n", [(80, 1 << 22), (128, 1 << 20),
                                       (1, 77_777)])
def test_histogram_of_one_bin(cuda, hi_bins, n):
    """Every key in one bin (a hot key), in range or not."""
    for key in (0, 3, hi_bins * 128 - 1, hi_bins * 128, -1):
        k = torch.full((n,), key, dtype=torch.int32, device=cuda)
        assert torch.equal(hist_cuda.histogram(k, hi_bins),
                           hist_cuda.histogram_plain(k, hi_bins))


@pytest.mark.parametrize("hi_bins,n", [(80, 1 << 22), (128, 1 << 20)])
def test_histogram_is_one_kernel_and_no_memset(cuda, rng, hi_bins, n):
    k = _t(rng.integers(0, 10000, n), cuda)
    assert device_ops(hist_cuda.histogram, k, hi_bins) == (1, 0)


def test_histogram_back_to_back_and_on_two_streams(cuda, rng):
    """Calls queued back to back on one stream, each finding the tickets
    the one before left at 0, and three on each of two streams behind a
    sleep, each stream with its own scratch."""
    ks = [_t(rng.integers(0, 10000, 1 << 22), cuda),
          _t(rng.integers(0, 16384, 1 << 20), cuda)]
    shapes = [(ks[0], 80), (ks[1], 128), (ks[0][3:], 80), (ks[1], 8)]
    got = [hist_cuda.histogram(k, hb) for k, hb in shapes * 2]
    for g, (k, hb) in zip(got, shapes * 2):
        assert torch.equal(g, hist_cuda.histogram_plain(k, hb))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for i, st in enumerate(streams):
        with torch.cuda.stream(st):
            torch.cuda._sleep(5_000_000)
            outs[i] = [hist_cuda.histogram(ks[i], 80 if i == 0 else 128)
                       for _ in range(3)]
    torch.cuda.synchronize()
    for i, hb in enumerate((80, 128)):
        exp = hist_cuda.histogram_plain(ks[i], hb)
        assert all(torch.equal(o, exp) for o in outs[i])


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


CUMSUM_TILE = 8192  # values a block of csrc/cumsum.cu scans
I32_EDGES = (-(2**31), 2**31 - 1)


@pytest.mark.parametrize("n", [CUMSUM_TILE - 1, CUMSUM_TILE, CUMSUM_TILE + 1,
                               33 * CUMSUM_TILE + 5, (1 << 24) + 3])
def test_cumsum_tile_boundaries(cuda, rng, n):
    x = _t(rng.integers(-(2**31), 2**31, n), cuda)
    for carry in I32_EDGES + tuple(_t([c], cuda) for c in I32_EDGES):
        assert torch.equal(cumsum_cuda.cumsum(x, carry),
                           cumsum_cuda.cumsum_plain(x, carry))
    # a view that is not 16-byte aligned takes the scalar loads
    assert torch.equal(cumsum_cuda.cumsum(x[1:], 5),
                       cumsum_cuda.cumsum_plain(x[1:], 5))


def _late_input(n, rng, device):
    """A column written on the current stream behind a sleep of a few ms: a
    kernel launched on another stream would read it before it is written."""
    src = _t(rng.integers(-1000, 1000, n), device)
    torch.cuda._sleep(20_000_000)
    return src + 0, src


def test_cumsum_runs_on_the_current_stream(cuda, rng):
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        x, src = _late_input(1 << 20, rng, cuda)
        got = cumsum_cuda.cumsum(x, 7)
    side.synchronize()
    assert torch.equal(got, cumsum_cuda.cumsum_plain(src, 7))


def test_cumsum_int_carry_makes_no_host_copy(cuda, rng):
    x = _t(rng.integers(-5, 5, 1 << 20), cuda)
    cumsum_cuda.cumsum(x, -1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cumsum_cuda.cumsum(x, -1)
        got_max = cumsum_cuda.cumsum(x, 2**31 - 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, cumsum_cuda.cumsum_plain(x, -1))
    assert torch.equal(got_max, cumsum_cuda.cumsum_plain(x, 2**31 - 1))


@pytest.mark.parametrize("hi_bins", [1, 8, 64, 80, 128, 160, 256, 512])
@pytest.mark.parametrize("n", [1, 100, 1 << 20])
def test_weighted_histogram_plans(cuda, rng, hi_bins, n):
    """The wrapper's own plan (cluster 1, 8 or 16; one copy or many) at
    every width the dwarfs and the scripts use."""
    k = _t(rng.integers(-3, hi_bins * 128 + 3, n), cuda)
    v = _t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
    assert torch.equal(hist_cuda.weighted_histogram(k, v, hi_bins),
                       hist_cuda.weighted_histogram_plain(k, v, hi_bins))


@pytest.mark.parametrize("hi_bins,cluster", [(128, 1), (128, 8), (128, 16),
                                             (256, 8), (512, 8), (512, 16)])
@pytest.mark.parametrize("copies", [1, 3, 16])
def test_weighted_histogram_explicit_plans(cuda, rng, hi_bins, cluster,
                                           copies):
    n = 300_007
    nbins = hi_bins * 128
    k = _t(rng.integers(-3, nbins + 3, n), cuda)
    v = _t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
    got = hist_cuda.launch_weighted(k, v, nbins, cluster, copies)
    assert torch.equal(got, hist_cuda.weighted_histogram_plain(k, v, hi_bins))
    # misaligned views take the scalar loads
    got = hist_cuda.launch_weighted(k[1:], v[1:], nbins, cluster, copies)
    assert torch.equal(got, hist_cuda.weighted_histogram_plain(
        k[1:], v[1:], hi_bins))


@pytest.mark.parametrize("case", ["one bin", "one block's slice",
                                  "out of range"])
def test_weighted_histogram_skew(cuda, rng, case):
    n = 1 << 20
    keys = {"one bin": np.full(n, 40_000),
            "one block's slice": rng.integers(4096, 8192, n),
            "out of range": rng.choice([-1, -(2**31), 65536, 2**31 - 1], n)}
    k = _t(keys[case], cuda)
    v = _t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
    assert torch.equal(hist_cuda.weighted_histogram(k, v, 512),
                       hist_cuda.weighted_histogram_plain(k, v, 512))


def test_weighted_histogram_runs_on_the_current_stream(cuda, rng):
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        k, src = _late_input(1 << 20, rng, cuda)
        got = hist_cuda.weighted_histogram(k, k, 512)
    side.synchronize()
    assert torch.equal(got, hist_cuda.weighted_histogram_plain(src, src, 512))


@pytest.mark.parametrize("num_groups", [1, 64, 4096])
def test_groupby_small(cuda, rng, num_groups):
    n = 1_000_003
    k = _t(rng.integers(-3, num_groups + 3, n), cuda)
    v = _t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
    assert torch.equal(groupby_cuda.groupby_small(k, v, num_groups),
                       groupby_cuda.groupby_small_plain(k, v, num_groups))


def _groupby_input(rng, n, num_groups, device):
    """Keys in [-3, G + 3) with the int32 extremes at the front (negative
    keys and keys >= G are dropped), values any int32."""
    k = _t(rng.integers(-3, num_groups + 3, n), device)
    k[: min(n, 3)] = torch.tensor([-(2**31), 2**31 - 1, num_groups][: min(n, 3)])
    v = _t(rng.integers(0, 2**32, n, dtype=np.uint64), device)
    return k, v


@pytest.mark.parametrize("num_groups", [1, 20, 64, 4096])
@pytest.mark.parametrize("n", [1, 3, 4097, (1 << 22) + 3])
def test_groupby_small_bit_exact(cuda, rng, num_groups, n):
    k, v = _groupby_input(rng, n, num_groups, cuda)
    assert torch.equal(groupby_cuda.groupby_small(k, v, num_groups),
                       groupby_cuda.groupby_small_plain(k, v, num_groups))


@pytest.mark.parametrize("k_off,v_off", [(1, 1), (2, 2), (3, 3), (1, 0),
                                         (0, 3), (2, 1)])
@pytest.mark.parametrize("num_groups", [64, 4096])
def test_groupby_small_misaligned_views(cuda, rng, k_off, v_off, num_groups):
    """Views off 4-12 bytes: equal offsets peel their head rows, unequal
    ones take the scalar loop."""
    n = (1 << 20) + 7
    k, v = _groupby_input(rng, n + 3, num_groups, cuda)
    kv, vv = k[k_off: k_off + n], v[v_off: v_off + n]
    plan = groupby_cuda.groupby_plan(num_groups, n, 132, k_off, v_off)
    assert (plan.design == "scalar") == (k_off != v_off)
    assert torch.equal(groupby_cuda.groupby_small(kv, vv, num_groups),
                       groupby_cuda.groupby_small_plain(kv, vv, num_groups))


@pytest.mark.parametrize("design", groupby_cuda.DESIGNS)
@pytest.mark.parametrize("num_groups", [1, 64, 4096])
def test_groupby_small_every_design(cuda, rng, design, num_groups):
    """Each loop under its default plan, at 2^22 + 3 rows and at 4097 (one
    block), from an aligned base and a view off 4 bytes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in ((1 << 22) + 3, 4097):
        k, v = _groupby_input(rng, n + 1, num_groups, cuda)
        for off in (0, 1):
            kv, vv = k[off: off + n], v[off: off + n]
            plan = groupby_cuda.groupby_plan(num_groups, n, sms, off, off,
                                             design=design)
            assert plan.design == design
            got = groupby_cuda.launch_groupby(kv, vv, num_groups, plan)
            assert torch.equal(got, groupby_cuda.groupby_small_plain(
                kv, vv, num_groups)), (plan, n, off)


def test_groupby_small_hot_key_wraps(cuda):
    """Every row on one key, with sums past 2^32 (mod 2^32)."""
    n = (1 << 22) + 3
    k = torch.full((n,), 17, dtype=torch.int32, device=cuda)
    v = torch.full((n,), 1 << 30, dtype=torch.int32, device=cuda)
    for g in (20, 64, 4096):
        got = groupby_cuda.groupby_small(k, v, g)
        assert torch.equal(got, groupby_cuda.groupby_small_plain(k, v, g))
    wrapped = np.array([(n << 30) % 2**32], np.uint64).astype(np.uint32)
    assert int(got[17]) == int(wrapped.view(np.int32)[0])


def test_groupby_small_refuses_a_broken_plan(cuda, rng):
    """A plan whose head leaves the keys off 16 bytes, or whose tables do
    not fit its shared bytes, launches nothing and raises."""
    k, v = _groupby_input(rng, 1 << 16, 64, cuda)
    good = groupby_cuda.groupby_plan(64, 1 << 16, 132)
    for bad in (good._replace(head=1), good._replace(smem=4 * 64 - 4),
                good._replace(tables=17, smem=4 * 64 * 17)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            groupby_cuda.launch_groupby(k, v, 64, bad)
    assert torch.equal(groupby_cuda.launch_groupby(k, v, 64, good),
                       groupby_cuda.groupby_small_plain(k, v, 64))


def test_groupby_small_back_to_back_and_on_two_streams(cuda, rng):
    """The last block leaves the ticket and the accumulator at 0: calls back
    to back on one stream, and three on each of two streams at once (each
    with its own scratch), are each exact."""
    n = (1 << 22) + 3
    cases = [(g, *_groupby_input(rng, n, g, cuda)) for g in (64, 4096)]
    exp = [groupby_cuda.groupby_small_plain(k, v, g) for g, k, v in cases]
    for _ in range(3):
        for (g, k, v), e in zip(cases, exp):
            assert torch.equal(groupby_cuda.groupby_small(k, v, g), e)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(1_000_000)
            outs.append([groupby_cuda.groupby_small(k, v, g)
                         for _ in range(3) for g, k, v in cases])
    torch.cuda.synchronize()
    for out in outs:
        for got, e in zip(out, exp * 3):
            assert torch.equal(got, e)
    for s in streams + [torch.cuda.current_stream()]:
        with torch.cuda.stream(s):
            scratch = _build.stream_scratch("groupby_small", cuda,
                                            groupby_cuda.SCRATCH_WORDS)
        assert not scratch.any()


def test_groupby_small_replays_in_a_captured_graph(cuda, rng):
    """One call captured in a CUDA graph, replayed 3 times on new inputs
    copied into its static ones: each replay is exact, and finds the
    scratch the last one left at 0."""
    n = (1 << 22) + 3
    k, v = _groupby_input(rng, n, 64, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        groupby_cuda.groupby_small(k, v, 64)  # the side stream's scratch
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = groupby_cuda.groupby_small(k, v, 64)
    for _ in range(3):
        k2, v2 = _groupby_input(rng, n, 64, cuda)
        k.copy_(k2)
        v.copy_(v2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, groupby_cuda.groupby_small_plain(k, v, 64))
    graph.reset()


def test_groupby_small_one_kernel_no_sync(cuda, rng):
    """One kernel and no memset a call, and no read back to the host (sync
    debug mode "error")."""
    k, v = _groupby_input(rng, 1 << 22, 64, cuda)
    assert device_ops(groupby_cuda.groupby_small, k, v, 64) == (1, 0)
    assert device_ops(groupby_cuda.groupby_small, k[1:], v[1:], 4096) == (1, 0)
    groupby_cuda.groupby_small(k, v, 64)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = groupby_cuda.groupby_small(k, v, 64)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, groupby_cuda.groupby_small_plain(k, v, 64))


def _same_prefix(got, exp, k):
    """Equal in the first k slots (the rest is garbage by contract)."""
    return got.shape == exp.shape and torch.equal(got[:k], exp[:k])


@pytest.mark.parametrize("threshold", [1, 5, 5000, 10001, -(2**31)])
@pytest.mark.parametrize("n", [1, 4097, 1_000_003])
def test_filter(cuda, rng, n, threshold):
    x = _t(rng.integers(1, 10000, n, endpoint=True), cuda)
    x[: min(n, 2)] = torch.tensor([-(2**31), 2**31 - 1][: min(n, 2)])
    for cap in (n, n // 3):
        out, count = filter_cuda.filter(x, threshold, cap)
        pout, pcount = filter_cuda.filter_plain(x, threshold, cap)
        assert count.shape == () and int(count) == int(pcount)
        assert _same_prefix(out, pout, min(int(count), cap))


@pytest.mark.parametrize("ncols", [1, 2, 3])
@pytest.mark.parametrize("n,sel", [(1, 1.0), (65536, 0.02), (1_000_003, 0.0),
                                   (1_000_003, 0.5), (70_001, 1.0)])
def test_compact_mask(cuda, rng, ncols, n, sel):
    mask = torch.from_numpy(rng.random(n) < sel).to(cuda)
    cols = [_t(rng.integers(-(2**31), 2**31, n), cuda) for _ in range(ncols)]
    for cap in (n, 4096):
        outs, count = compact_cuda.compact_mask(mask, cols, cap)
        pouts, pcount = compact_cuda.compact_mask_plain(mask, cols, cap)
        assert int(count) == int(pcount)
        k = min(int(count), cap)
        assert all(_same_prefix(o, p, k) for o, p in zip(outs, pouts))


@pytest.mark.parametrize("index", [None, "permuted", "into longer vals"])
@pytest.mark.parametrize("off", [0, 1, 2])
@pytest.mark.parametrize("length,cap", [(0, 16), (37, 40), (128, 128),
                                        (1023, 1100), (1025, 1025),
                                        (20480, 1 << 24)])
def test_emit_prefix(cuda, rng, length, cap, index, off):
    """With and without an index (its twin: the plain emit of vals[index]),
    at the tile's edges (1024 values a block), with views of vals and of
    the index off 16 bytes (the scalar path)."""
    nvals = length if index != "into longer vals" else 3 * length + 5
    v = _t(rng.integers(-(2**31), 2**31, nvals + off), cuda)[off:]
    if index is None:
        idx = None
    else:
        pos = rng.permutation(length) if index == "permuted" else \
            rng.integers(0, nvals, length)
        idx = torch.from_numpy(np.concatenate(
            [np.zeros(off, np.int64), pos])).to(cuda)[off:]
    exp = compact_cuda.emit_prefix_plain(v if idx is None else v[idx], cap)
    assert _same_prefix(compact_cuda.emit_prefix(v, cap, idx), exp, length)


@pytest.mark.parametrize("density", [0.0, 5e-4, 1e-2])
@pytest.mark.parametrize("nch", [1, 2048, 131072])
def test_scan_tail_streams(cuda, rng, nch, density):
    x = rng.integers(1, 10001, (nch, 128))
    hit = rng.random((nch, 128)) < density
    x[hit] = rng.integers(-1000, 5, hit.sum())  # some below the window
    stat, base = chunk_stats(_t(x, cuda), 5)
    for caps in ((16384, 512), (7, 3)):
        got = scan_tail_cuda.scan_tail_streams(stat, base, 5, *caps)
        exp = scan_tail_cuda.scan_tail_streams_plain(stat, base, 5, *caps)
        ns, nm = int(exp[4]), int(exp[5])
        assert (int(got[4]), int(got[5])) == (ns, nm)
        assert torch.equal(got[0], exp[0])  # spos is BIG past ns
        assert _same_prefix(got[1], exp[1], min(ns, caps[0]))
        assert _same_prefix(got[2], exp[2], min(nm, caps[1]))
        assert _same_prefix(got[3], exp[3], min(nm, caps[1]))


# rows a block of csrc/compact.cuh compacts: for compact_mask, for the
# filter, and chunks for the scan tail
COMPACT_TILE, FILTER_TILE = 8192, 16384
TAIL_TILE = 2048


def _tile_sizes(tile):
    return [1, tile - 1, tile, tile + 1, (1 << 25) + 3]


def _caps(kept, n):
    """Capacity 0, a cut inside a tile (about half of the kept rows, at
    half density), and the column length."""
    return (0, kept // 2 + 1, n)


def _same_compaction(got, exp, cap):
    """(outs, count) pairs equal in the count and in the slots below it."""
    (gouts, gcount), (eouts, ecount) = got, exp
    gouts = gouts if isinstance(gouts, tuple) else (gouts,)
    eouts = eouts if isinstance(eouts, tuple) else (eouts,)
    k = min(int(ecount), cap)
    return (gcount.shape == () and int(gcount) == int(ecount)
            and all(_same_prefix(g, e, k) for g, e in zip(gouts, eouts)))


@pytest.mark.parametrize("ncols", [1, 2, 3])
@pytest.mark.parametrize("n", _tile_sizes(COMPACT_TILE))
def test_compact_mask_tile_boundaries(cuda, rng, n, ncols):
    mask = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    cols = [_t(rng.integers(-(2**31), 2**31, n), cuda) for _ in range(ncols)]
    for cap in _caps(int(mask.sum()), n):
        assert _same_compaction(compact_cuda.compact_mask(mask, cols, cap),
                                compact_cuda.compact_mask_plain(mask, cols,
                                                                cap), cap)


@pytest.mark.parametrize("threshold", [5, 5000])
@pytest.mark.parametrize("n", _tile_sizes(FILTER_TILE))
def test_filter_tile_boundaries(cuda, rng, n, threshold):
    x = _t(rng.integers(1, 10000, n, endpoint=True), cuda)
    for cap in _caps(int((x < threshold).sum()), n):
        assert _same_compaction(filter_cuda.filter(x, threshold, cap),
                                filter_cuda.filter_plain(x, threshold, cap),
                                cap)


@pytest.mark.parametrize("offset", range(1, 16))
def test_compact_mask_of_views_off_16_bytes(cuda, rng, offset):
    """The mask 1-15 bytes past a 16-byte boundary (past a 4-byte one, the
    scalar loads) and its columns 4-12 bytes past one."""
    n = 5 * COMPACT_TILE + 77
    raw = torch.from_numpy(rng.random(n + 16) < 0.5).to(cuda)
    mask = raw[offset: offset + n]
    wide = [_t(rng.integers(-(2**31), 2**31, n + 3), cuda) for _ in range(2)]
    cols = [c[offset % 4: offset % 4 + n] for c in wide]
    for cap in _caps(int(mask.sum()), n):
        assert _same_compaction(compact_cuda.compact_mask(mask, cols, cap),
                                compact_cuda.compact_mask_plain(mask, cols,
                                                                cap), cap)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_filter_and_scan_tail_of_views_off_16_bytes(cuda, rng, offset):
    """x, stat and base 4, 8 or 12 bytes past a 16-byte boundary: every
    tile takes the scalar loads."""
    n = 5 * FILTER_TILE + 77
    x = _t(rng.integers(1, 10000, n + 3), cuda)[offset: offset + n]
    for cap in _caps(int((x < 5000).sum()), n):
        assert _same_compaction(filter_cuda.filter(x, 5000, cap),
                                filter_cuda.filter_plain(x, 5000, cap), cap)
    rows = rng.integers(1, 10001, (n, 128))
    rows[rng.random((n, 128)) < 0.01] = 3
    stat, base = chunk_stats(_t(rows, cuda), 5)
    stat = torch.cat([stat[:offset], stat])[offset:]
    base = torch.cat([base[:offset], base])[offset:]
    got = scan_tail_cuda.scan_tail_streams(stat, base, 5, 16384, 2048)
    exp = scan_tail_cuda.scan_tail_streams_plain(stat, base, 5, 16384, 2048)
    ns, nm = int(exp[4]), int(exp[5])
    assert (int(got[4]), int(got[5])) == (ns, nm)
    assert torch.equal(got[0], exp[0])
    assert _same_prefix(got[1], exp[1], min(ns, 16384))
    assert _same_prefix(got[2], exp[2], min(nm, 2048))
    assert _same_prefix(got[3], exp[3], min(nm, 2048))


@pytest.mark.parametrize("nch", [1, TAIL_TILE - 1, TAIL_TILE, TAIL_TILE + 1,
                                 8192, 131072, 131073])
def test_scan_tail_tile_boundaries_and_sentinel(cuda, rng, nch):
    """The scan tail at its tile's boundaries; n_single 0, equal to
    cap_single, and above it: spos is exact whole (the last tile's block
    writes the sentinel past n_single)."""
    x = rng.integers(5, 10001, (nch, 128))
    single = rng.random(nch) < 0.3
    x[single, rng.integers(0, 128, int(single.sum()))] = 3
    stat, base = chunk_stats(_t(x, cuda), 5)
    ns = int(single.sum())
    for caps in ((16384, 512), (ns, 512), (max(ns - 1, 0), 512), (0, 0),
                 (ns + 5, 1)):
        got = scan_tail_cuda.scan_tail_streams(stat, base, 5, *caps)
        exp = scan_tail_cuda.scan_tail_streams_plain(stat, base, 5, *caps)
        assert (int(exp[4]), int(exp[5])) == (ns, 0)
        assert (int(got[4]), int(got[5])) == (ns, 0)
        assert torch.equal(got[0], exp[0])
        assert _same_prefix(got[1], exp[1], min(ns, caps[0]))
    # no single at all: spos is the sentinel whole
    none = chunk_stats(_t(np.full((nch, 128), 9), cuda), 5)
    got = scan_tail_cuda.scan_tail_streams(*none, 5, 16384, 512)
    assert int(got[4]) == 0 and bool((got[0] == 0x7FFFFFFF).all())


def _compaction_calls(rng, device):
    """Calls of the three wrappers that share the compaction's scratch, of
    mixed sizes, each with its twin: (kernel call, plain call, capacity)."""
    calls = []
    for n, cap in (((1 << 22) + 1, None), (3, 1), (1_000_003, 1000),
                   (COMPACT_TILE, None), ((1 << 20) + 9, 0)):
        x = _t(rng.integers(1, 10000, n, endpoint=True), device)
        mask = x < 5000
        cols = (x, x + 1)
        cap_n = n if cap is None else cap
        calls.append((lambda x=x, c=cap: filter_cuda.filter(x, 5000, c),
                      lambda x=x, c=cap: filter_cuda.filter_plain(x, 5000, c),
                      cap_n))
        calls.append((lambda m=mask, cs=cols, c=cap:
                      compact_cuda.compact_mask(m, cs, c),
                      lambda m=mask, cs=cols, c=cap:
                      compact_cuda.compact_mask_plain(m, cs, c), cap_n))
    return calls


def test_compactions_back_to_back(cuda, rng):
    """Ten calls of the filter and the mask compaction queued on one
    stream: each finds the counters and status words the one before left
    at 0."""
    calls = _compaction_calls(rng, cuda)
    torch.cuda.synchronize()
    got = [call() for call, _, _ in calls]
    for g, (_, plain, cap) in zip(got, calls):
        assert _same_compaction(g, plain(), cap)


def test_compactions_on_two_streams(cuda, rng):
    """Two streams at once, each with its own scratch, behind a sleep so
    that their calls overlap on the card: three calls a stream, the scan
    tail between the filter and the mask compaction."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    xs = [_t(rng.integers(1, 10000, (1 << 22) + 7 * i, endpoint=True), cuda)
          for i in range(2)]
    stats = [chunk_stats(x[: (x.numel() // 128) * 128].view(-1, 128), 5000)
             for x in xs]
    torch.cuda.synchronize()
    got = [[], []]
    for i, st in enumerate(streams):
        with torch.cuda.stream(st):
            torch.cuda._sleep(5_000_000)
            got[i].append(filter_cuda.filter(xs[i], 5000))
            got[i].append(scan_tail_cuda.scan_tail_streams(*stats[i], 5000,
                                                           4096, 4096))
            got[i].append(compact_cuda.compact_mask(xs[i] < 7000,
                                                    (xs[i], xs[i] - 1)))
    torch.cuda.synchronize()
    for i, x in enumerate(xs):
        n = x.numel()
        assert _same_compaction(got[i][0], filter_cuda.filter_plain(x, 5000),
                                n)
        exp = scan_tail_cuda.scan_tail_streams_plain(*stats[i], 5000, 4096,
                                                     4096)
        assert [int(v) for v in got[i][1][4:]] == [int(v) for v in exp[4:]]
        assert torch.equal(got[i][1][0], exp[0])
        assert _same_compaction(got[i][2], compact_cuda.compact_mask_plain(
            x < 7000, (x, x - 1)), n)


def test_compactions_replay_in_a_captured_graph(cuda, rng):
    """A CUDA graph of a filter, a mask compaction and a scan tail, replayed
    on new inputs copied into its static ones: each replay finds the
    scratch the last one left at 0."""
    n = (1 << 20) + 5
    x = _t(rng.integers(1, 10000, n, endpoint=True), cuda)
    stat, base = chunk_stats(x[: (n // 128) * 128].view(-1, 128), 5000)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())

    def calls():
        return (filter_cuda.filter(x, 5000),
                compact_cuda.compact_mask(x < 3000, (x, x + 7), 9000),
                scan_tail_cuda.scan_tail_streams(stat, base, 5000, 777, 99))

    with torch.cuda.stream(side):
        calls()  # the side stream's scratch, made outside the capture
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out_f, out_c, out_t = calls()
    for rep in range(3):
        x.copy_(_t(rng.integers(1, 10000, n, endpoint=True), cuda))
        s2, b2 = chunk_stats(x[: (n // 128) * 128].view(-1, 128), 5000)
        stat.copy_(s2)
        base.copy_(b2)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_compaction(out_f, filter_cuda.filter_plain(x, 5000), n)
        assert _same_compaction(out_c, compact_cuda.compact_mask_plain(
            x < 3000, (x, x + 7), 9000), 9000)
        exp = scan_tail_cuda.scan_tail_streams_plain(stat, base, 5000, 777,
                                                     99)
        assert [int(v) for v in out_t[4:]] == [int(v) for v in exp[4:]]
        assert torch.equal(out_t[0], exp[0])
        assert _same_prefix(out_t[2], exp[2], min(int(exp[5]), 99))


@pytest.mark.parametrize("n", [0, 65536, 1 << 25])
def test_compactions_are_one_kernel_and_no_memset(cuda, rng, n):
    """compact_mask with 1-3 columns, the filter and the scan tail (whose
    last tile's block writes the sentinel): one kernel, no memset a
    call."""
    x = _t(rng.integers(1, 10000, n, endpoint=True), cuda)
    mask = x < 5000
    for ncols in (1, 2, 3):
        assert device_ops(compact_cuda.compact_mask, mask,
                          (x,) * ncols) == (1, 0)
    assert device_ops(filter_cuda.filter, x, 5) == (1, 0)
    nch = n // 128
    stat, base = chunk_stats(x[: nch * 128].view(-1, 128), 5)
    assert device_ops(scan_tail_cuda.scan_tail_streams, stat, base, 5,
                      16384, 512) == (1, 0)


@pytest.mark.parametrize("n,threshold,deep", [(1 << 20, 5, 0), (1 << 20, 5, 40),
                                              (100_003, 5, 5), (1 << 20, 5000, 0)])
def test_filter_sparse_matches_oracle(cuda, rng, n, threshold, deep):
    x = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    x[rng.integers(0, n, deep)] = -700
    expected = scan.filter_oracle(x, threshold)
    runs = [{}]
    if scan.sparse_caps_ok(x, threshold):
        runs.append({"assume_sparse": True})
    for kw in runs:
        out, count = scan.filter_sparse(_t(x, cuda), threshold, **kw)
        assert int(count) == len(expected)
        assert np.array_equal(out[: len(expected)].cpu().numpy(), expected)


def test_filter_sparse_assume_sparse_reads_nothing_back(cuda, rng):
    x = _t(rng.integers(1, 10000, 1 << 20, endpoint=True), cuda)
    scan.filter_sparse(x, assume_sparse=True)  # build and warm up
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, count = scan.filter_sparse(x, assume_sparse=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.is_cuda and count.is_cuda
    # phase A on its kernel: chunk_stats once, its cumsum, the tail
    assert {k: _build.LAUNCHES[k] - before[k]
            for k in ("chunk_stats", "cumsum", "scan_tail_streams",
                      "chunk_stats_pallas")} == {
        "chunk_stats": 1, "cumsum": 1, "scan_tail_streams": 1,
        "chunk_stats_pallas": 0}


@pytest.mark.parametrize("n,threshold", [(1 << 24, 5), (1 << 20, 5000)])
def test_filter_sparse_default_path_runs_phase_a_on_its_kernel(cuda, rng, n,
                                                               threshold):
    """The default path takes the chunk-stats kernel once a call, where the
    caps hold and where they trip, exact against filter_oracle."""
    x = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    expected = scan.filter_oracle(x, threshold)
    before = _build.LAUNCHES["chunk_stats"]
    out, count = scan.filter_sparse(_t(x, cuda), threshold)
    assert _build.LAUNCHES["chunk_stats"] == before + 1
    assert int(count) == len(expected)
    assert np.array_equal(out[: len(expected)].cpu().numpy(), expected)


def test_filter_sparse_folds_the_gather_into_the_emit(cuda, rng,
                                                     monkeypatch):
    """At 2^24 x < 5 the sparse path puts one kernel fewer on the card than
    with the gather before the emit (the graph nodes of one call), with no
    memset added, and both are exact."""
    x = rng.integers(1, 10000, 1 << 24, endpoint=True).astype(np.int32)
    xd = _t(x, cuda)
    expected = scan.filter_oracle(x)

    def call(v):
        return scan.filter_sparse(v, assume_sparse=True)

    folded = device_ops(call, xd)
    out, count = call(xd)
    emit = compact_cuda.emit_prefix
    monkeypatch.setattr(compact_cuda, "emit_prefix",
                        lambda vals, cap, index: emit(vals[index], cap))
    gathered = device_ops(call, xd)
    out_g, count_g = call(xd)
    assert folded == (gathered[0] - 1, gathered[1])
    for o, c in ((out, count), (out_g, count_g)):
        assert int(c) == len(expected)
        assert np.array_equal(o[: len(expected)].cpu().numpy(), expected)


def test_wrappers_count_their_launches(cuda):
    k = torch.zeros(10, dtype=torch.int32, device=cuda)
    before = dict(_build.LAUNCHES)
    hist_cuda.histogram(k, 8)
    hist_cuda.weighted_histogram(k, k, 8)
    groupby_cuda.groupby_small(k, k, 8)
    cumsum_cuda.cumsum(k)
    filter_cuda.filter(k, 5)
    compact_cuda.compact_mask(k > 0, (k,))
    compact_cuda.emit_prefix(k, 10)
    scan_tail_cuda.scan_tail_streams(k, k, 5, 4, 4)
    k8 = torch.zeros(8, dtype=torch.int32, device=cuda)
    bitonic_cuda.merge_bitonic((k8, k8))
    merge_fill_cuda.merge_fill(k, k, k, 4)
    reduce_cuda.reduce_sum(k)
    x2 = torch.zeros(2, 128, dtype=torch.int32, device=cuda)
    chunk_stats_cuda.chunk_stats(x2, 5)  # + cumsum
    # the JAX names: each counts itself and the kernel wrapper it goes
    # through
    chunk_stats_cuda.chunk_stats_pallas(x2, 5)  # + cumsum
    chunk_stats_cuda.chunk_stats_roll_pallas(x2, 5)  # + cumsum
    chunk_stats_cuda.chunk_stats_fused(x2, 5)  # + cumsum
    scan_tail_cuda.scan_tail_compact(k, k, 5, 4, 4)  # + scan_tail_streams
    p3 = torch.zeros(1 << 14, dtype=torch.int32, device=cuda)
    probe_cuda.probe_dense_rel_pallas(p3, p3[:128], k)
    probe_cuda.probe_dense_cat_pallas(p3, p3[:128], k, 80)
    hist_cuda.histogram_16k_pallas(k, 8)  # + histogram
    hist_cuda.weighted_histogram_pallas(k, k, 8)  # + weighted_histogram
    # + weighted_histogram_pallas + weighted_histogram
    hist_cuda.weighted_histogram_16k_pallas(k, k)
    groupby_cuda.groupby_small_swar_pallas(k, k, 8)  # + groupby_small
    groupby_cuda.groupby_small_pallas_f32(k, k, 5000)  # + weighted_histogram
    hist_cuda.histogram_plain(k, 8)
    filter_cuda.filter_plain(k, 5)
    bitonic_cuda.merge_bitonic_plain((k8, k8))
    merge_fill_cuda.merge_fill_plain(k, k, k, 4)
    reduce_cuda.reduce_sum_plain(k)
    chunk_stats_cuda.chunk_stats_plain(x2, 5)
    probe_cuda.probe_dense_plain(p3, p3[:128], k)
    groupby_cuda.groupby_digits_plain(k, k, 5000)
    # the examples' kernels and the measurement scripts' names
    vadd_cuda.vadd_pallas(k, k)
    lock_add_cuda.grid_accumulate(3, device=cuda)
    mv = measure_variants
    for fn in (mv.histogram_16k_i8cmp, mv.hist16k_bf16cmp, mv.dyn_store_probe,
               mv.hist_variant, mv.hist_rows, mv.hist_swar):  # + histogram
        fn(k)
    mv.weighted_histogram_i8(k, k)  # + weighted_histogram
    mv.whist_i8(k, k)  # + weighted_histogram
    for fn in (mv.groupby_small_v2, mv.groupby_small_v3, mv.groupby_small_v5,
               mv.groupby_small_stacked):  # + groupby_small
        fn(k, k, 64)
    mv._gb_dbuf_kernel()(k, k)  # + groupby_small
    mv._gb_diag_kernel_factory("nodot")(k, k)
    vadd_cuda.vadd_plain(k, k)
    lock_add_cuda.grid_accumulate_plain(3, device=cuda)
    mv.gb_diag_plain(k, k, "full", 8, 8, 32, 4096)
    assert {n: _build.LAUNCHES[n] - before[n] for n in before} == {
        "histogram": 8, "cumsum": 5, "groupby_small": 7,
        "weighted_histogram": 6, "filter": 1, "compact_mask": 1,
        "emit_prefix": 1, "scan_tail_streams": 2, "merge_bitonic": 1,
        "merge_fill": 1, "reduce_sum": 1, "chunk_stats": 1,
        "chunk_stats_pallas": 1, "chunk_stats_roll_pallas": 1,
        "chunk_stats_fused": 1, "scan_tail_compact": 1,
        "probe_dense_rel_pallas": 1, "probe_dense_cat_pallas": 1,
        "histogram_16k_pallas": 1, "weighted_histogram_pallas": 2,
        "weighted_histogram_16k_pallas": 1, "groupby_small_swar_pallas": 1,
        "groupby_small_pallas_f32": 1,
        "vadd_pallas": 1, "grid_accumulate": 1,
        "histogram_16k_i8cmp": 1, "hist16k_bf16cmp": 1, "groupby_small_v2": 1,
        "groupby_small_v3": 1, "weighted_histogram_i8": 1,
        "dyn_store_probe": 1, "hist_variant": 1, "whist_i8": 1,
        "groupby_small_v5": 1, "hist_rows": 1, "hist_swar": 1,
        "groupby_small_stacked": 1, "_gb_diag_kernel_factory": 1,
        "_gb_dbuf_kernel": 1,
    }


STATS_NAMES = ("chunk_stats_pallas", "chunk_stats_roll_pallas",
               "chunk_stats_fused")


@pytest.mark.parametrize("name", ("chunk_stats",) + STATS_NAMES)
@pytest.mark.parametrize("nch,thr", [(1, 5), (7, 5), (4097, 10000),
                                     (131072, 5), (3001, -(2**31) + 100),
                                     (3001, -(2**31)), (300, 2**31 - 1)])
def test_chunk_stats(cuda, rng, name, nch, thr):
    """nch 7 and 4097 leave a block part-filled; thresholds near INT32_MIN
    wrap t - 512 and must give the plain version's garbage bit for bit."""
    x = _t(rng.integers(-(2**31), 2**31, nch * 128 + 1), cuda)
    x[5] = thr
    for x2 in (x[:-1].view(nch, 128), x[1:].view(nch, 128)):  # misaligned
        got = getattr(chunk_stats_cuda, name)(x2, thr)
        exp = chunk_stats_cuda.chunk_stats_plain(x2, thr)
        assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


@pytest.mark.parametrize("nch", [1, 2048, 131072, 1 << 18])
def test_scan_tail_compact(cuda, rng, nch):
    x = rng.integers(1, 10001, (nch, 128))
    hit = rng.random((nch, 128)) < 5e-4
    x[hit] = rng.integers(-1000, 5, hit.sum())
    stat, base = chunk_stats(_t(x, cuda), 5)
    for caps in ((16384, 512), (7, 3)):
        got = scan_tail_cuda.scan_tail_compact(stat, base, 5, *caps)
        exp = scan_tail_cuda.scan_tail_streams_plain(stat, base, 5, *caps)
        ns, nm = int(exp[4]), int(exp[5])
        assert (int(got[4]), int(got[5])) == (ns, nm)
        assert torch.equal(got[0], exp[0])
        assert _same_prefix(got[1], exp[1], min(ns, caps[0]))
        assert _same_prefix(got[2], exp[2], min(nm, caps[1]))
        assert _same_prefix(got[3], exp[3], min(nm, caps[1]))
    big = torch.zeros((1 << 18) + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        scan_tail_cuda.scan_tail_compact(big, big, 5, 16, 16)


@pytest.mark.parametrize("hi_rows", [128, 80, 1])
@pytest.mark.parametrize("n", [1, 4097, 1 << 20])
def test_probe_dense(cuda, rng, hi_rows, n):
    """Any table (the contract holds past the JAX kernels' 2^24 limit)."""
    p3 = _t(rng.integers(-(2**31), 2**31, 1 << 14), cuda)
    p3[:3] = torch.tensor([0, 1023, 1024])
    base = _t(rng.integers(-(2**31), 2**31, 128), cuda)
    ki = _t(rng.integers(-5, hi_rows * 128 + 5, n), cuda)
    ki[: min(n, 4)] = torch.tensor([-1, -(2**31), 2**31 - 1,
                                    hi_rows * 128][: min(n, 4)])
    names = ["probe_dense_cat_pallas"] + (["probe_dense_rel_pallas"]
                                          if hi_rows == 128 else [])
    exp = probe_cuda.probe_dense_plain(p3, base, ki, hi_rows)
    for name in names:
        args = (p3, base, ki) + ((hi_rows,) if "cat" in name else ())
        got = getattr(probe_cuda, name)(*args)
        assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


@pytest.mark.parametrize("n", [1, 1_000_003])
def test_hist_and_groupby_variants(cuda, rng, n):
    for hb in (8, 80, 128):
        k = _t(rng.integers(-100, hb * 128 + 100, n), cuda)
        assert torch.equal(hist_cuda.histogram_16k_pallas(k, hb),
                           hist_cuda.histogram_plain(k, hb))
    v = _t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
    for hb in (128, 512):
        k = _t(rng.integers(-3, hb * 128 + 3, n), cuda)
        assert torch.equal(hist_cuda.weighted_histogram_pallas(k, v, hb),
                           hist_cuda.weighted_histogram_plain(k, v, hb))
    assert torch.equal(hist_cuda.weighted_histogram_16k_pallas(k, v),
                       hist_cuda.weighted_histogram_plain(k, v, 128))
    for g in (1, 64, 4096, 4097, 10000, 15360):
        k = _t(rng.integers(-3, g + 300, n), cuda)
        exp = groupby_cuda.groupby_digits_plain(k, v, g)
        assert torch.equal(groupby_cuda.groupby_small_swar_pallas(k, v, g),
                           exp)
        assert torch.equal(groupby_cuda.groupby_small_pallas_f32(k, v, g),
                           exp)


@pytest.mark.parametrize("stats_pallas", [True, False])
@pytest.mark.parametrize("n,threshold,deep", [(1 << 20, 5, 0),
                                              (100_003, 5, 5),
                                              (1 << 20, 5000, 0)])
def test_filter_sparse_stats_pallas(cuda, rng, stats_pallas, n, threshold,
                                    deep):
    x = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    x[rng.integers(0, n, deep)] = -700
    expected = scan.filter_oracle(x, threshold)
    runs = [{}]
    if scan.sparse_caps_ok(x, threshold):
        runs.append({"assume_sparse": True})
    for kw in runs:
        before = _build.LAUNCHES["chunk_stats_pallas"]
        out, count = scan.filter_sparse(_t(x, cuda), threshold,
                                        stats_pallas=stats_pallas, **kw)
        assert int(count) == len(expected)
        assert np.array_equal(out[: len(expected)].cpu().numpy(), expected)
        assert (_build.LAUNCHES["chunk_stats_pallas"] > before) == \
            stats_pallas


def test_stats_pallas_assume_sparse_reads_nothing_back(cuda, rng):
    x = _t(rng.integers(1, 10000, 1 << 20, endpoint=True), cuda)
    for stats_pallas in (True, False):
        scan.filter_sparse(x, assume_sparse=True, stats_pallas=stats_pallas)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, count = scan.filter_sparse(x, assume_sparse=True,
                                            stats_pallas=stats_pallas)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert out.is_cuda and count.is_cuda


@pytest.mark.parametrize("na,nb", [(1000, 777), (1 << 17, 1 << 17)])
def test_csr_join_on_cuda_matches_cpu(cuda, rng, na, nb):
    """The general CSR join on the card gives the CPU build's tables and
    answers; probe_merge_bitonic runs the 4-column merge and compact_mask
    there."""
    pool = rng.integers(0, 2**32 - 1, na // 3 + 1, dtype=np.uint64)
    a = rng.choice(pool, na).astype(np.uint32)
    a[:3] = 0xFFFFFFFF
    b = np.concatenate([rng.choice(pool, nb // 2), rng.integers(
        0, 2**32, nb - nb // 2, dtype=np.uint64)]).astype(np.uint32)
    b[:3] = [0xFFFFFFFF, 0, 0xFFFFFFFE]
    d = len(np.unique(a[a != 0xFFFFFFFF]))
    da, db = _t(a.view(np.int32), cuda), _t(b.view(np.int32), cuda)
    gt = csr_join.build(da, d, 2 * d)
    ct = csr_join.build(da.cpu(), d, 2 * d)
    for f in ("pos", "counts", "distinct_keys", "num_distinct"):
        assert torch.equal(getattr(gt, f).cpu(), getattr(ct, f))
    exp = csr_join.probe(ct, db.cpu())
    for name in ("probe", "probe_sorted", "probe_merge",
                 "probe_merge_bitonic"):
        before = dict(_build.LAUNCHES)
        got = getattr(csr_join, name)(gt, db)
        for g, e in zip(got, exp):
            assert torch.equal(g.cpu(), e)
        if name == "probe_merge_bitonic":
            assert _build.LAUNCHES["merge_bitonic"] > before["merge_bitonic"]
            assert _build.LAUNCHES["compact_mask"] > before["compact_mask"]


def _bitonic_cols(rng, n, ncols, key_hi):
    """Ascending prefix, descending suffix in (key, aux), ties included."""
    k = rng.integers(0, key_hi, n, dtype=np.uint64)
    a = rng.integers(0, 4, n, dtype=np.uint64)
    cut = int(n * 0.4)
    o1 = np.lexsort((a[:cut], k[:cut]))
    o2 = np.lexsort((a[cut:], k[cut:]))[::-1]
    cols = [np.concatenate([k[:cut][o1], k[cut:][o2]]),
            np.concatenate([a[:cut][o1], a[cut:][o2]])]
    cols += [rng.integers(0, 2**32, n, dtype=np.uint64)
             for _ in range(ncols - 2)]
    return cols


@pytest.mark.parametrize("num_cmp", [1, 2])
@pytest.mark.parametrize("ncols", [2, 3, 4])
@pytest.mark.parametrize("n,key_hi", [(1, 2**32), (2, 3), (1024, 50),
                                      (2048, 2**32), (4096, 7),
                                      (1 << 20, 2**32), (1 << 21, 1000)])
def test_merge_bitonic(cuda, rng, n, key_hi, ncols, num_cmp):
    cols = tuple(_t(c.astype(np.uint32).view(np.int32), cuda)
                 for c in _bitonic_cols(rng, n, ncols, key_hi))
    got = bitonic_cuda.merge_bitonic(cols, num_cmp)
    exp = bitonic_cuda.merge_bitonic_plain(cols, num_cmp)
    assert all(torch.equal(g, e) for g, e in zip(got, exp))


def test_merge_bitonic_any_input(cuda, rng):
    cols = tuple(_t(rng.integers(-(2**31), 2**31, 1 << 16), cuda)
                 for _ in range(3))
    got = bitonic_cuda.merge_bitonic(cols)
    exp = bitonic_cuda.merge_bitonic_plain(cols)
    assert all(torch.equal(g, e) for g, e in zip(got, exp))


def _bitonic_on(rng, n, ncols, key_hi, device):
    return tuple(_t(c.astype(np.uint32).view(np.int32), device)
                 for c in _bitonic_cols(rng, n, ncols, key_hi))


@pytest.mark.parametrize("num_cmp", [1, 2])
@pytest.mark.parametrize("ncols", [2, 4])
@pytest.mark.parametrize("k", range(23))
def test_merge_bitonic_every_power_of_two(cuda, rng, k, ncols, num_cmp):
    """Every N = 2^k up to 2^22: every pass boundary of the plan (one short
    tile, one full tile, one to two strided passes) meets the twin."""
    cols = _bitonic_on(rng, 1 << k, ncols, 1 << 12, cuda)
    got = bitonic_cuda.merge_bitonic(cols, num_cmp)
    exp = bitonic_cuda.merge_bitonic_plain(cols, num_cmp)
    assert all(torch.equal(g, e) for g, e in zip(got, exp))


@pytest.mark.parametrize("ncols", [2, 3])
def test_merge_bitonic_2p25(cuda, rng, ncols):
    cols = _bitonic_on(rng, 1 << 25, ncols, 2**32, cuda)
    got = bitonic_cuda.merge_bitonic(cols)
    exp = bitonic_cuda.merge_bitonic_plain(cols)
    assert all(torch.equal(g, e) for g, e in zip(got, exp))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_merge_bitonic_of_views_off_16_bytes(cuda, rng, offset):
    """Columns that start 4, 8 or 12 bytes past a 16-byte boundary."""
    n = 1 << 16
    cols = tuple(torch.cat([torch.zeros(offset, dtype=torch.int32,
                                        device=cuda), c])[offset:]
                 for c in _bitonic_on(rng, n, 3, 1000, cuda))
    got = bitonic_cuda.merge_bitonic(cols)
    exp = bitonic_cuda.merge_bitonic_plain(cols)
    assert all(torch.equal(g, e) for g, e in zip(got, exp))


def test_merge_bitonic_refuses_a_broken_plan(cuda):
    n = 1 << 14
    cols = (torch.zeros(n, dtype=torch.int32, device=cuda),) * 2
    plan = bitonic_cuda._tiled_plan(n, 2, 9)
    for passes in (plan.passes[1:], plan.passes[:-1],
                   ((14, 14),) + plan.passes, ((9, 14), (0, 9))):
        with pytest.raises(RuntimeError, match="invalid argument"):
            bitonic_cuda._launch(cols, cuda, n, 2,
                                 plan._replace(passes=passes))


@pytest.mark.parametrize("n,ncols", [(1 << 25, 2), (1 << 25, 3),
                                     (1 << 21, 4), (1 << 10, 2)])
def test_merge_bitonic_kernels_per_call(cuda, rng, n, ncols):
    """One kernel a pass and nothing else: 3 at 2^25 (15 before)."""
    cols = _bitonic_on(rng, n, ncols, 2**32, cuda)
    passes = len(bitonic_cuda.merge_plan(n, ncols).passes)
    assert device_ops(bitonic_cuda.merge_bitonic, cols) == (passes, 0)
    if n == 1 << 25:
        assert passes == 3


@pytest.mark.parametrize("mode", ["val32", "val16", "membership"])
@pytest.mark.parametrize("n", [1, 1023, 1025, 1 << 15, 1_000_003])
def test_merge_fill(cuda, rng, n, mode):
    sk = _t(rng.integers(-(2**31), 2**31, n), cuda)
    sk[: min(n, 2)] = -1  # EMPTY rows
    sa = _t(rng.integers(-(2**31), 2**31, n), cuda)  # bit 31: query rows
    dv = _t(rng.integers(-(2**31), 2**31, n), cuda)
    kw = dict(val16=mode == "val16", membership=mode == "membership")
    for nq in (0, n // 2, 2**30 - 1):
        got = merge_fill_cuda.merge_fill(sk, sa, dv, nq, **kw)
        exp = merge_fill_cuda.merge_fill_plain(sk, sa, dv, nq, **kw)
        assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


FILL_TILE = 8192  # rows a block of csrc/merge_fill.cu scans
FILL_MODES = ("val32", "val16", "membership")


def _fill_columns(rng, n, device):
    """(sk, sa, dv): random int32 bit patterns, EMPTY keys first, half of
    the rows queries (bit 31 of sa)."""
    sk = _t(rng.integers(-(2**31), 2**31, n), device)
    sk[: min(n, 2)] = -1
    return (sk, _t(rng.integers(-(2**31), 2**31, n), device),
            _t(rng.integers(-(2**31), 2**31, n), device))


def _fill_kw(mode):
    return dict(val16=mode == "val16", membership=mode == "membership")


def _same_fill(got, exp):
    return torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


@pytest.mark.parametrize("mode", FILL_MODES)
@pytest.mark.parametrize("n", [FILL_TILE - 1, FILL_TILE, FILL_TILE + 1,
                               33 * FILL_TILE + 5, (1 << 25) + 3])
def test_merge_fill_tile_boundaries(cuda, rng, n, mode):
    cols = _fill_columns(rng, n, cuda)
    for nq in (n // 3, 2**30 - 1):
        assert _same_fill(
            merge_fill_cuda.merge_fill(*cols, nq, **_fill_kw(mode)),
            merge_fill_cuda.merge_fill_plain(*cols, nq, **_fill_kw(mode)))


@pytest.mark.parametrize("mode", FILL_MODES)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_merge_fill_of_views_off_16_bytes(cuda, rng, offset, mode):
    """Each column in turn starts 4, 8 or 12 bytes past a 16-byte boundary:
    every tile takes the scalar loads."""
    n = 5 * FILL_TILE + 77
    cols = _fill_columns(rng, n, cuda)
    for i in range(3):
        moved = list(cols)
        moved[i] = torch.cat([torch.zeros(offset, dtype=torch.int32,
                                          device=cuda), cols[i]])[offset:]
        assert _same_fill(
            merge_fill_cuda.merge_fill(*moved, n // 2, **_fill_kw(mode)),
            merge_fill_cuda.merge_fill_plain(*cols, n // 2, **_fill_kw(mode)))


def test_merge_fill_back_to_back(cuda, rng):
    """Five calls of mixed sizes and modes queued on one stream: each finds
    the counters and status words the one before left at 0."""
    calls = [(_fill_columns(rng, n, cuda), n // 2, mode) for n, mode in (
        ((1 << 22) + 1, "val32"), (3, "val16"), (1_000_003, "membership"),
        (FILL_TILE, "val32"), ((1 << 20) + 9, "val16"))]
    torch.cuda.synchronize()
    got = [merge_fill_cuda.merge_fill(*c, nq, **_fill_kw(m))
           for c, nq, m in calls]
    for g, (c, nq, m) in zip(got, calls):
        assert _same_fill(g, merge_fill_cuda.merge_fill_plain(
            *c, nq, **_fill_kw(m)))


def test_merge_fill_on_two_streams(cuda, rng):
    """Two streams at once, each with its own scratch, behind a sleep so
    that their calls overlap on the card."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    cols = [_fill_columns(rng, (1 << 22) + 7 * i, cuda) for i in range(2)]
    torch.cuda.synchronize()
    got = [[], []]
    for rep in range(3):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                if rep == 0:
                    torch.cuda._sleep(5_000_000)
                got[i].append(merge_fill_cuda.merge_fill(
                    *cols[i], 1 << 20, **_fill_kw(FILL_MODES[rep])))
    torch.cuda.synchronize()
    for i in range(2):
        for rep, g in enumerate(got[i]):
            assert _same_fill(g, merge_fill_cuda.merge_fill_plain(
                *cols[i], 1 << 20, **_fill_kw(FILL_MODES[rep])))


@pytest.mark.parametrize("mode", FILL_MODES)
def test_merge_fill_is_one_kernel_and_no_memset(cuda, rng, mode):
    cols = _fill_columns(rng, 1 << 25, cuda)
    assert device_ops(merge_fill_cuda.merge_fill, *cols, 1 << 24,
                      mode == "val16", mode == "membership") == (1, 0)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 4097, 1_000_003, 1 << 24])
def test_reduce_sum(cuda, rng, n):
    x = _t(rng.integers(-(2**31), 2**31, n + 1), cuda)
    for v in (x[:n], x[1:]):  # aligned and misaligned starts
        got = reduce_cuda.reduce_sum(v)
        assert got.shape == () and got.is_cuda
        assert int(got) == int(reduce_cuda.reduce_sum_plain(v.cpu()))


def test_reduce_sum_returns_a_0d_tensor_of_its_own(cuda, rng):
    got = reduce_cuda.reduce_sum(_t(rng.integers(0, 9, 1000), cuda))
    assert got.shape == () and got.dtype == torch.int32 and got._base is None


@pytest.mark.parametrize("n", [0, 5, 1 << 24])
def test_reduce_sum_is_one_kernel_and_no_memset(cuda, rng, n):
    x = _t(rng.integers(-(2**31), 2**31, n), cuda)
    assert device_ops(reduce_cuda.reduce_sum, x) == (1, 0)


def test_reduce_sum_back_to_back(cuda, rng):
    """Calls queued one after another on a stream: each finds the ticket
    the one before left at 0."""
    xs = [_t(rng.integers(-(2**31), 2**31, n), cuda)
          for n in (1 << 24, 3, 0, 1_000_003, (1 << 20) + 1)]
    torch.cuda.synchronize()
    got = [reduce_cuda.reduce_sum(x) for x in xs for _ in range(3)]
    exp = [int(reduce_cuda.reduce_sum_plain(x.cpu())) for x in xs
           for _ in range(3)]
    assert [int(g) for g in got] == exp


def test_reduce_sum_on_two_streams(cuda, rng):
    """Two streams at once, each with its own scratch, behind a sleep so
    that their calls overlap on the card."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    xs = [_t(rng.integers(-(2**31), 2**31, (1 << 22) + i), cuda)
          for i in range(2)]
    torch.cuda.synchronize()
    got = [[], []]
    for rep in range(4):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                if rep == 0:
                    torch.cuda._sleep(5_000_000)
                got[i].append(reduce_cuda.reduce_sum(xs[i]))
    torch.cuda.synchronize()
    for i, x in enumerate(xs):
        exp = int(reduce_cuda.reduce_sum_plain(x.cpu()))
        assert [int(g) for g in got[i]] == [exp] * 4


@pytest.mark.parametrize("mode", ["val16", "val32", "membership"])
@pytest.mark.parametrize("nt,nq", [(1, 7), (5000, 70_000), (1 << 20, 1 << 20)])
def test_merge_lookup_bitonic_on_cuda(cuda, rng, mode, nt, nq):
    keys = (rng.permutation(4 * nt)[:nt] + 1).astype(np.uint32)
    hi = 1 << 16 if mode == "val16" else 1 << 32
    vals = rng.integers(0, hi, nt, dtype=np.uint64).astype(np.uint32)
    q = np.concatenate([rng.permutation(keys)[: nq // 2],
                        rng.integers(0, 2**32, nq - nq // 2,
                                     dtype=np.uint64).astype(np.uint32)])
    rng.shuffle(q)
    kw = dict(val_bits=16 if mode == "val16" else 32,
              membership=mode == "membership")
    sk, sv = merge_lookup.sort_table(_t(keys.view(np.int32), cuda),
                                     _t(vals.view(np.int32), cuda))
    exp = merge_lookup.merge_lookup_bitonic(sk.cpu(), sv.cpu(),
                                            _t(q.view(np.int32), "cpu"), **kw)
    for compact_first in (None, False):
        before = dict(_build.LAUNCHES)
        got = merge_lookup.merge_lookup_bitonic(
            sk, sv, _t(q.view(np.int32), cuda), compact_first=compact_first,
            **kw)
        assert torch.equal(got[0].cpu(), exp[0])
        assert torch.equal(got[1].cpu(), exp[1])
        assert _build.LAUNCHES["merge_bitonic"] > before["merge_bitonic"]
        assert _build.LAUNCHES["merge_fill"] > before["merge_fill"]


def test_hash_tables_on_cuda_match_cpu(cuda, rng):
    """bucket_hash and cuckoo give the CPU build's answers on the card; the
    bulk probes take the merge engine there."""
    n = 1 << 17
    keys = (rng.permutation(2 * n)[:n] + 1).astype(np.uint32)
    vals = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    probes = np.concatenate([keys[: n // 2],
                             rng.integers(0, n, n - n // 2).astype(np.uint32)
                             + np.uint32(4 * n)])
    k, v, p = (_t(a.view(np.int32), cuda) for a in (keys, vals, probes))
    nb = bucket_hash.calculate_buckets_count(n)
    gt = bucket_hash.build(k, v, nb)
    ct = bucket_hash.build(k.cpu(), v.cpu(), nb)
    assert torch.equal(gt.keys.cpu(), ct.keys)
    for val_bits in (16, 32):
        found, val = bucket_hash.find(gt, p, val_bits=val_bits)
        efound, eval_ = bucket_hash.find(ct, p.cpu(), engine="tile")
        assert torch.equal(found.cpu(), efound)
        assert torch.equal(val.cpu(), eval_)
    g = cuckoo.build(k, 4 * n, 0x9E3779B9, 0x85EBCA6B, 256, values=v)
    c = cuckoo.build(k.cpu(), 4 * n, 0x9E3779B9, 0x85EBCA6B, 256,
                     values=v.cpu())
    assert (g.success, g.rounds) == (c.success, c.rounds) and g.success
    assert torch.equal(g.keys.cpu(), c.keys)
    assert torch.equal(cuckoo.has(g, p).cpu(), cuckoo.has(c, p.cpu()))
    got, exp = cuckoo.at(g, p), cuckoo.at(c, p.cpu())
    assert torch.equal(got[0].cpu(), exp[0])
    assert torch.equal(got[1].cpu(), exp[1])


def test_wrapper_rejects_int64_on_gpu(cuda):
    with pytest.raises(ValueError):
        hist_cuda.histogram(torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        filter_cuda.filter(torch.zeros(4, dtype=torch.int64, device=cuda))
    # the sparse filter's general engine for non-int32 input is the same
    # int32-only kernel on the card
    with pytest.raises(ValueError):
        scan.filter_sparse(torch.zeros(4, dtype=torch.int64, device=cuda))


SCAN_KERNELS = ("scan_tail_streams", "compact_mask", "emit_prefix")
MERGE_KERNELS = ("merge_bitonic", "merge_fill", "compact_mask")


@pytest.mark.parametrize("dwarf,extra,kernels", [
    ("RadixCuda", [], ("histogram", "cumsum")),
    ("GroupByCuda", ["--groups_count=64"], ("groupby_small",)),
    ("GroupByCuda", ["--groups_count=65536"], ("weighted_histogram",)),
    ("JoinOmnisciCuda", [], ("histogram",)),
    ("TwoPassScan", ["--device=gpu"], SCAN_KERNELS),
    ("DPLScan", ["--device=gpu"], SCAN_KERNELS),
    ("DPLScanCuda", [], SCAN_KERNELS),
    ("ReduceDPCPP", ["--device=gpu"], ("reduce_sum",)),
    ("SlabHashBuild", ["--device=gpu"], MERGE_KERNELS),
    ("SlabProbe", ["--device=gpu"], MERGE_KERNELS),
    ("SlabJoin", ["--device=gpu"], MERGE_KERNELS),
    ("CuckooHashBuild", ["--device=gpu"], MERGE_KERNELS),
    ("HashBuild", ["--device=gpu"], ()),
    ("HashBuildNonBitmask", ["--device=gpu"], ()),
    ("Join", ["--device=gpu"], ()),
    ("NestedLoopJoin", ["--device=gpu"], ()),
])
def test_dwarfs_run_through_the_kernels(cuda, tmp_path, dwarf, extra, kernels):
    before = dict(_build.LAUNCHES)
    size = "1048576" if kernels in (SCAN_KERNELS, MERGE_KERNELS) else "65536"
    rc = cli.main([dwarf, "--input_size", "1000", size, "--iterations=2",
                   f"--report_path={tmp_path / 'r.csv'}", *extra])
    assert rc == 0
    results = populate_registry().find(dwarf).get_results()
    assert len(results) == 4 and all(r.result.valid for r in results)
    assert all(_build.LAUNCHES[k] > before[k] for k in kernels)
    lines = open(tmp_path / "r.csv").read().splitlines()
    assert lines[0] == "device_type,buf_size_bytes,host_time_ms,kernel_time_ms"
    assert all(line.startswith("GPU,") for line in lines[1:])


# -- the library API, GroupByLocal, the Constant* dwarfs and the examples'
#    and measurement scripts' kernels -------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("n", [1, 3, 1024, 4099, 1 << 24])
def test_vadd(cuda, rng, dtype, n):
    if dtype == torch.float32:
        a = torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32))
    else:
        a = _t(rng.integers(-(2**31), 2**31, n + 1), "cpu")
        b = _t(rng.integers(-(2**31), 2**31, n + 1), "cpu")
    a, b = a.to(cuda), b.to(cuda)
    for x, y in ((a[:-1], b[:-1]), (a[1:], b[1:]), (a[1:], b[:-1])):
        got = vadd_cuda.vadd_pallas(x, y)
        exp = vadd_cuda.vadd_plain(x, y)
        # bit for bit, through int32 views (a NaN is no NaN's equal)
        assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
    m = a[:-1].view(-1, 1) if n > 1 else a[:1]
    assert vadd_cuda.vadd_pallas(m, m).shape == m.shape


VADD_TILE = 2048  # values a block of csrc/vadd.cu adds


def _vadd_inputs(rng, dtype, n, device):
    if dtype == torch.float32:
        return tuple(torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(device) for _ in range(2))
    return tuple(_t(rng.integers(-(2**31), 2**31, n), device)
                 for _ in range(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("n", [VADD_TILE - 1, VADD_TILE, VADD_TILE + 1,
                               5 * VADD_TILE + 3, 5 * VADD_TILE + 4,
                               (1 << 24) + 1])
def test_vadd_tile_boundaries(cuda, rng, dtype, n):
    """Aligned inputs (the vector path and its scalar tail) and inputs 4-12
    bytes off a 16-byte boundary (the scalar path)."""
    a, b = _vadd_inputs(rng, dtype, n + 3, cuda)
    for off in range(4):
        x, y = a[off: off + n], b[off: off + n]
        got = vadd_cuda.vadd_pallas(x, y)
        assert torch.equal(got.view(torch.int32),
                           vadd_cuda.vadd_plain(x, y).view(torch.int32))


@pytest.mark.parametrize("off", [0, 1])
def test_vadd_is_one_kernel(cuda, rng, off):
    a, b = _vadd_inputs(rng, torch.float32, (1 << 24) + 1, cuda)
    n = (1 << 24) - 5
    assert device_ops(vadd_cuda.vadd_pallas, a[off: off + n],
                      b[off: off + n]) == (1, 0)


@pytest.mark.parametrize("n_steps", [1, 2, 64, 1000, 1 << 16])
def test_grid_accumulate(cuda, n_steps):
    """Exact, and twice in a row on one stream: the second call finds the
    lock's scratch zero, as the last ticket of the first left it."""
    first = lock_add_cuda.grid_accumulate(n_steps)
    second = lock_add_cuda.grid_accumulate(n_steps)
    exp = lock_add_cuda.grid_accumulate_plain(n_steps, cuda)
    for got in (first, second):
        assert got.is_cuda and got.shape == (1, 1)
        assert torch.equal(got, exp)
    scratch = _build.stream_scratch("grid_accumulate", cuda,
                                    lock_add_cuda.LOCK_SCRATCH_WORDS)
    assert not scratch.any()


@pytest.mark.parametrize("n_steps", [1, 64, 1 << 16])
def test_grid_accumulate_is_one_kernel_and_no_memset(cuda, n_steps):
    assert device_ops(lock_add_cuda.grid_accumulate, n_steps, cuda) == (1, 0)


def test_l2_round_trip_is_measured(cuda):
    """One thread's chain of dependent atomics: a round trip between 10 ns
    and 10 us (the chain's last value is checked inside)."""
    assert 1e-8 < lock_add_cuda.l2_round_trip(cuda, chain=4096) < 1e-5


@pytest.mark.parametrize("n", [1, 4097, 1_000_003])
def test_measure_variants(cuda, rng, n):
    mv = measure_variants
    for hb in (64, 80, 128):
        k = _t(rng.integers(-100, hb * 128 + 100, n), cuda)
        exp = hist_cuda.histogram_plain(k, hb)
        assert torch.equal(mv.hist_variant(k, hb), exp)
        assert torch.equal(mv.hist_rows(k, hb, rows=32), exp)
        for form in mv.SWAR_FORMS:
            assert torch.equal(mv.hist_swar(k, hb, form), exp)
        if hb == 128:
            assert torch.equal(mv.histogram_16k_i8cmp(k), exp)
            assert torch.equal(mv.hist16k_bf16cmp(k), exp)
        if hb == 64:
            assert torch.equal(mv.dyn_store_probe(k), exp.view(64, 128))
    v = _t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
    for hb in (64, 512):
        k = _t(rng.integers(-3, hb * 128 + 3, n), cuda)
        exp = hist_cuda.weighted_histogram_plain(k, v, hb)
        assert torch.equal(mv.weighted_histogram_i8(k, v, hb), exp)
        assert torch.equal(mv.whist_i8(k, v, hb), exp)
    for g in (1, 64, 4096):
        k = _t(rng.integers(-3, g + 300, n), cuda)
        exp = groupby_cuda.groupby_small_plain(k, v, g)
        for fn in (mv.groupby_small_v2, mv.groupby_small_v3,
                   mv.groupby_small_v5, mv.groupby_small_stacked):
            assert torch.equal(fn(k, v, g), exp)
    k = _t(rng.integers(-3, 64 + 300, n), cuda)
    assert torch.equal(mv._gb_dbuf_kernel()(k, v),
                       groupby_cuda.groupby_small_plain(k, v, 64))


@pytest.mark.parametrize("mode", ["full", "dotonly", "nodot"])
@pytest.mark.parametrize("n,shape", [(1, (8, 8, 32, 4096)),
                                     ((1 << 18) + 777, (8, 8, 32, 4096)),
                                     (1 << 22, (8, 8, 32, 4096)),
                                     (100_003, (4, 16, 3, 64)),
                                     (100_003, (64, 64, 2, 128))])
def test_gb_diag(cuda, rng, mode, n, shape):
    ga, gb, rows, w = shape
    if mode == "nodot" and ga > gb:
        pytest.skip("nodot needs ga <= gb")
    k = _t(rng.integers(-5, ga * gb + 5, n), cuda)
    v = _t(rng.integers(-(2**31), 2**31, n), cuda)
    got = measure_variants._gb_diag_kernel_factory(mode, ga, gb, rows, w)(k, v)
    exp = measure_variants.gb_diag_plain(k, v, mode, ga, gb, rows, w)
    assert got.shape == (ga, gb) and torch.equal(got, exp)


@pytest.mark.parametrize("mode", ["full", "dotonly", "nodot"])
@pytest.mark.parametrize("n,shape", [(4096 * 32 - 1, (8, 8, 32, 4096)),
                                     (4096 * 32 + 1, (8, 8, 32, 4096)),
                                     (100_003, (4, 4, 5, 96)),
                                     (100_003, (8, 16, 7, 100)),
                                     ((1 << 22) + 5, (64, 64, 2, 4096))])
def test_gb_diag_edges(cuda, rng, mode, n, shape):
    """Blocks of rows x w cut one row short and one row past, w not a power
    of two (the dotonly division path), and 4096 cells over a full grid
    (one lane a cell in the last block's sum)."""
    ga, gb, rows, w = shape
    if mode == "nodot" and ga > gb:
        pytest.skip("nodot needs ga <= gb")
    k = _t(rng.integers(-5, ga * gb + 5, n), cuda)
    v = _t(rng.integers(-(2**31), 2**31, n), cuda)
    got = measure_variants._gb_diag_kernel_factory(mode, ga, gb, rows, w)(k, v)
    exp = measure_variants.gb_diag_plain(k, v, mode, ga, gb, rows, w)
    assert got.shape == (ga, gb) and torch.equal(got, exp)


@pytest.mark.parametrize("mode", ["full", "dotonly", "nodot"])
def test_gb_diag_one_key(cuda, rng, mode):
    """Every row one key: each lane's run-length fold holds one cell."""
    n = 1 << 22
    k = torch.full((n,), 37, dtype=torch.int32, device=cuda)
    v = _t(rng.integers(1, 10001, n), cuda)
    got = measure_variants._gb_diag_kernel_factory(mode)(k, v)
    assert torch.equal(got, measure_variants.gb_diag_plain(
        k, v, mode, 8, 8, 32, 4096))


@pytest.mark.parametrize("mode", ["full", "dotonly", "nodot"])
def test_gb_diag_is_one_kernel_and_no_memset(cuda, rng, mode):
    n = 1 << 22
    k = _t(rng.integers(0, 64, n), cuda)
    v = _t(rng.integers(1, 10001, n), cuda)
    assert device_ops(measure_variants._gb_diag_kernel_factory(mode),
                      k, v) == (1, 0)


def test_gb_diag_back_to_back_and_on_two_streams(cuda, rng):
    """The last block leaves the ticket at 0: calls back to back on one
    stream, and on two streams at once (each with its own scratch), are
    each exact."""
    n = 1_000_003
    k = _t(rng.integers(-3, 67, n), cuda)
    v = _t(rng.integers(1, 10001, n), cuda)
    fns = {m: measure_variants._gb_diag_kernel_factory(m)
           for m in ("full", "dotonly", "nodot")}
    exp = {m: measure_variants.gb_diag_plain(k, v, m, 8, 8, 32, 4096)
           for m in fns}
    for _ in range(3):
        for m, fn in fns.items():
            assert torch.equal(fn(k, v), exp[m])
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(1_000_000)
            outs.append([(m, fn(k, v)) for m, fn in fns.items()
                         for _ in range(3)])
    torch.cuda.synchronize()
    for out in outs:
        for m, got in out:
            assert torch.equal(got, exp[m])
    scratch = _build.stream_scratch(
        "gb_diag", cuda, measure_variants.gb_diag_scratch_words(64))
    assert not scratch[: measure_variants.gb_diag_scratch_words(64)].any()


# -- the timers and the bench ------------------------------------------------


def _agree(timer_s, graph_ms_):
    """The slope timer against graph_ms of the same call: within 10 % or
    3 us, whichever is larger."""
    return abs(timer_s * 1e3 - graph_ms_) <= max(0.1 * graph_ms_, 3e-3)


def test_looped_timer_agrees_with_graph_ms(cuda, rng):
    from dwarf_bench_tpu_torch.utils import timing

    x = _t(rng.integers(1, 10001, 1 << 24), cuda)
    fn = lambda v: scan.filter_sparse(v, assume_sparse=True)  # noqa: E731
    k = _t(rng.integers(0, 10000, 1 << 22), cuda)
    for f, a in ((fn, (x,)), (lambda v: hist_cuda.histogram(v, 80), (k,))):
        t = timing.time_device_looped_inplace(f, *a)
        g = timing.graph_ms(f, *a)
        assert _agree(t, g), (t * 1e3, g)
        cold = timing.time_device_looped(f, *a, cold=True)
        assert cold > 0.8 * t, (cold, t)


def test_timers_raise_on_a_read_back(cuda):
    from dwarf_bench_tpu_torch.utils import timing

    x = torch.ones(1024, dtype=torch.int32, device=cuda)

    def reads_back(v):
        return v + int(v.sum().item())

    for timer in (timing.time_device_looped,
                  timing.time_device_looped_inplace):
        with pytest.raises(RuntimeError, match="reads back to the host"):
            timer(reads_back, x)
    with pytest.raises(RuntimeError, match="reads back to the host"):
        timing.check_sync_free(lambda v: scan.filter_sparse(v), x)


def test_captured_cooperative_histogram_replays_under_the_timer(cuda, rng):
    """The count histogram's cooperative launch captured in the timer's
    graphs: the replays run, and a replayed graph's output is exact."""
    from dwarf_bench_tpu_torch.utils import timing

    k = _t(rng.integers(0, 10000, 1 << 22), cuda)
    exp = hist_cuda.histogram_plain(k, 80)
    out = torch.empty_like(exp)
    fn = lambda v: out.copy_(hist_cuda.histogram(v, 80))  # noqa: E731
    assert timing.time_device_looped(fn, k, k=4) > 0
    out.zero_()
    graph, stream = timing.capture(fn, k, k=2)
    out.zero_()
    with torch.cuda.stream(stream):
        graph.replay()
    stream.synchronize()
    graph.reset()
    assert torch.equal(out, exp)


@pytest.mark.parametrize("name,n", [("radix", 1 << 16), ("groupby", 1 << 16),
                                    ("groupby_big", 1 << 16),
                                    ("join", 1 << 16), ("scan", 1 << 20)])
def test_bench_components_on_the_card(cuda, name, n):
    from dwarf_bench_tpu_torch import bench

    extras = {}
    cold, warm, events = bench.run_component(
        name, n, np.random.default_rng(0), cuda, extras)
    assert cold > 0 and warm > 0 and events > 0


def test_bench_on_the_card(cuda, capsys, monkeypatch):
    import json

    from dwarf_bench_tpu_torch import bench

    monkeypatch.setattr(bench, "SIZES", {
        "radix": 1 << 16, "groupby": 1 << 16, "groupby_big": 1 << 16,
        "join": 1 << 16, "scan": 1 << 20, "scan_sel50_extra": 1 << 16,
        "reduce_extra": 1 << 20})
    monkeypatch.setenv("BENCH_HASH_N", str(1 << 17))
    assert bench.main([]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["skipped"] == []
    assert set(line["components_rows_per_s"]) == set(bench.COMPONENTS)
    assert all(v > 0 for v in line["components_rows_per_s"].values())
    assert "H100" in line["device"] or "," in line["device"]


def test_entry_on_the_card_matches_the_cpu(cuda):
    from dwarf_bench_tpu_torch import entry

    fn, (a, b) = entry.entry()
    assert a.is_cuda and b.is_cuda
    got = fn(a, b)
    exp = fn(a.cpu(), b.cpu())
    assert torch.equal(got[0].cpu(), exp[0])
    assert torch.equal(got[2].cpu(), exp[2])
    # both sorts are stable here: positions and id_buffer agree exactly
    assert torch.equal(got[1].cpu(), exp[1])
    assert torch.equal(got[3].cpu(), exp[3])


@pytest.mark.parametrize("groups,executors", [(64, 64), (20, 1024),
                                              (4096, 1024), (16, 3)])
def test_groupby_partials_on_cuda_matches_cpu(cuda, rng, groups, executors):
    n = 1_000_003
    k = _t(rng.integers(-3, groups + 3, n), cuda)
    v = _t(rng.integers(1, 10001, n), cuda)
    got = groupby.groupby_partials(k, v, groups, executors)
    exp = groupby.groupby_partials(k.cpu(), v.cpu(), groups, executors)
    assert torch.equal(got.cpu(), exp)
    assert torch.equal(groupby.groupby_merge(got).cpu(),
                       groupby.groupby_merge(exp))


@pytest.mark.parametrize("extra,kernel", [
    (["--groups_count=64", "--executors=64"], "groupby_small"),
    (["--groups_count=20", "--executors=1024"], "weighted_histogram"),
])
def test_groupby_local_on_cuda(cuda, tmp_path, extra, kernel):
    before = dict(_build.LAUNCHES)
    rc = cli.main(["GroupByLocal", "--device=gpu", "--input_size", "1000",
                   "1048576", "--iterations=2",
                   f"--report_path={tmp_path / 'r.csv'}", *extra])
    assert rc == 0
    results = populate_registry().find("GroupByLocal").get_results()
    assert len(results) == 4 and all(r.result.valid for r in results)
    assert _build.LAUNCHES[kernel] > before[kernel]
    lines = open(tmp_path / "r.csv").read().splitlines()
    assert lines[0] == ("device_type,buf_size_bytes,total_time,"
                        "group_by_time,reduction_time")


@pytest.mark.parametrize("name", ["ConstantExample", "ConstantExampleCAPI",
                                  "ConstantExampleDPCPP",
                                  "ConstantExampleDPCPPCuda"])
def test_constant_dwarfs_on_cuda(cuda, capsys, name):
    assert cli.main([name, "--device=gpu", "--iterations=3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line for line in out if line.startswith("42")] == ["42 = 42"] * 3
    assert len(populate_registry().find(name).get_results()) == 0


@pytest.mark.parametrize("kind", list(DwarfKind))
def test_api_on_cuda(cuda, kind):
    conf = RunConfig(device=ApiDeviceType.GPU, input_size=65536,
                     iterations=2, dwarf=kind)
    ms = DwarfBench().make_measurements(conf)
    assert [m.data_size for m in ms] == [65536, 65536]
    impl = {"Scan": "DPLScanCuda", "Join": "JoinOmnisciCuda",
            "GroupBy": "GroupByCuda", "Sort": "RadixCuda"}[kind.name]
    results = populate_registry().find(impl).get_results()
    assert len(results) == 2 and all(r.result.valid for r in results)


@pytest.mark.parametrize("example", [bench_usage, vadd, lock_add])
def test_examples_on_cuda(cuda, example):
    assert example.main([]) == 0


# -- the distributed layer on a world of one NCCL rank ------------------------

@pytest.fixture(scope="module")
def nccl_meshes():
    """An NCCL world of one rank (the card) with its (1,) and (1, 1)
    meshes, destroyed after this module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket

    import torch.distributed as dist

    from dwarf_bench_tpu_torch import parallel

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    parallel.init_multihost(f"localhost:{port}", num_processes=1,
                            process_id=0)
    try:
        yield parallel.make_mesh(), parallel.make_mesh_2d(1, 1)
    finally:
        dist.destroy_process_group()


def _pairs(a, b):
    """(A's count of each B row's key, the number of matching pairs)."""
    ca = np.bincount(a, minlength=1 << 14).astype(np.int64)
    return ca[b], int(ca[b].sum())


_DIST_JOINS = {
    "dist_csr_join": dict(shuffle_capacity=1 << 16),
    "dist_csr_join dense": dict(shuffle_capacity=1 << 16, dense=True),
    "dist_csr_join_ring": {},
    "dist_csr_join_ring dense": dict(dense=True),
    "dist_csr_join_2d": dict(cap_ici=1 << 16, cap_dcn=1 << 16),
    "dist_csr_join_2d dense": dict(cap_ici=1 << 16, cap_dcn=1 << 16,
                                   dense=True),
    "dist_csr_join_ring_2d": {},
}


@pytest.mark.parametrize("name", list(_DIST_JOINS))
def test_dist_joins_on_one_nccl_rank(nccl_meshes, rng, name):
    """Per-B-row counts (a world of one receives its rows in order), the
    totals and zero overflow against the host; the dense builds launch the
    histogram kernel, the general ones compact_mask."""
    from dwarf_bench_tpu_torch import parallel

    n = 1 << 16
    a = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    b = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    per_row, pairs = _pairs(a, b)
    builder, *dense = name.split()
    mesh = nccl_meshes[1] if builder.endswith("_2d") else nccl_meshes[0]
    fn = getattr(parallel, builder)(mesh, rows_per_chip=n,
                                    distinct_cap=1 << 14, ht_size=1 << 15,
                                    **_DIST_JOINS[name])
    before = dict(_build.LAUNCHES)
    out = fn(*parallel.shard_rows(mesh, a, b))
    kernel = "histogram" if dense else "compact_mask"
    assert _build.LAUNCHES[kernel] > before[kernel]
    assert out[0].is_cuda
    assert np.array_equal(out[0].cpu().numpy(), per_row)
    assert int(out[1]) == int(out[2]) == pairs
    if "ring" not in builder:
        assert int(out[3]) == 0


def test_dist_csr_join_skew_on_one_nccl_rank(nccl_meshes, rng):
    from dwarf_bench_tpu_torch import parallel

    mesh = nccl_meshes[0]
    n = 1 << 16
    a = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    b = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    a[rng.random(n) < 0.6] = 7
    b[rng.random(n) < 0.6] = 7
    _, pairs = _pairs(a, b)
    fn = parallel.dist_csr_join_skew(mesh, rows_per_chip=n,
                                     distinct_cap=1 << 14, ht_size=1 << 15,
                                     shuffle_capacity=n)
    light, heavy, total, ov = fn(*parallel.shard_rows(mesh, a, b))
    h = heavy.cpu().numpy().astype(np.int64)
    assert np.array_equal(h, np.where(b == 7, int((a == 7).sum()), 0))
    assert int(light.sum(dtype=torch.int64)) + int(h.sum()) == pairs
    assert int(total) % (1 << 32) == pairs % (1 << 32) and int(ov) == 0


def test_dist_hash_join_rows_on_one_nccl_rank(nccl_meshes):
    from dwarf_bench_tpu_torch import parallel
    from dwarf_bench_tpu_torch.common.datagen import make_unique_random
    from dwarf_bench_tpu_torch.ops.join import seq_join_oracle

    mesh = nccl_meshes[0]
    n = 1 << 16
    cols = [make_unique_random(n, seed=s) for s in (21, 22, 23, 24)]
    before = _build.LAUNCHES["compact_mask"]
    k, a, b, cnt, ov = parallel.dist_hash_join_rows(
        mesh, shuffle_capacity=n, ht_size=2 * n)(
        *parallel.shard_rows(mesh, *cols))
    assert _build.LAUNCHES["compact_mask"] == before + 1
    c = int(cnt)
    rows = np.stack([t[:c].cpu().numpy().view(np.uint32).astype(np.uint64)
                     for t in (k, a, b)], axis=1)
    assert int(ov) == 0
    assert np.array_equal(rows[np.lexsort(rows.T[::-1])],
                          seq_join_oracle(*cols))


@pytest.mark.parametrize("groups,n", [(64, 1 << 18), (1 << 16, 1 << 16)])
def test_dist_groupbys_on_one_nccl_rank(nccl_meshes, rng, groups, n):
    from dwarf_bench_tpu_torch import parallel

    mesh = nccl_meshes[0]
    keys = rng.integers(0, groups, n).astype(np.uint32)
    vals = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    exp = groupby.groupby_oracle(keys, vals, groups)
    dk, dv = parallel.shard_rows(mesh, keys, vals)
    before = _build.LAUNCHES["groupby_small"]
    dense = parallel.dist_groupby_dense(mesh, groups)(dk, dv)
    sums, ov = parallel.dist_groupby_shuffle(mesh, groups, n)(dk, dv)
    if groups <= 4096:
        assert _build.LAUNCHES["groupby_small"] == before + 2
    for got in (dense, sums):
        assert np.array_equal(got.cpu().numpy().view(np.uint32), exp)
    assert int(ov) == 0


@pytest.mark.parametrize("n,thr,kernel", [(1 << 20, 5, "chunk_stats"),
                                          (1 << 16, 5000, "filter")])
def test_dist_filter_on_one_nccl_rank(nccl_meshes, rng, n, thr, kernel):
    from dwarf_bench_tpu_torch import parallel

    mesh = nccl_meshes[0]
    x = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    before = _build.LAUNCHES[kernel]
    out, cnt, off, total = parallel.dist_filter(mesh, thr, n)(
        parallel.shard_rows(mesh, x))
    assert _build.LAUNCHES[kernel] > before
    hits = x[x < thr]
    assert int(cnt) == int(total) == hits.size and int(off) == 0
    assert np.array_equal(out[: hits.size].cpu().numpy(), hits)


def test_dist_sort_on_one_nccl_rank(nccl_meshes, rng):
    from dwarf_bench_tpu_torch import parallel

    mesh = nccl_meshes[0]
    x = rng.integers(0, 1 << 32, 1 << 18, dtype=np.uint64).astype(np.uint32)
    out, valid, ov = parallel.dist_sort(mesh, x.size)(
        parallel.shard_rows(mesh, x))
    v = int(valid)
    assert int(ov) == 0 and v == int((x != 0xFFFFFFFF).sum())
    assert np.array_equal(out[:v].cpu().numpy().view(np.uint32),
                          np.sort(x)[:v])


def test_shuffles_on_one_nccl_rank(nccl_meshes, rng):
    """A world of one keeps every row in its order, in one slot: the
    exchange is a copy through all_to_all_single on the card."""
    from dwarf_bench_tpu_torch import parallel

    mesh, mesh2 = nccl_meshes
    n = 1 << 16
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    keys[keys == 0xFFFFFFFF] = 1
    vals = np.arange(n, dtype=np.uint32)
    k, v = parallel.shard_rows(mesh, keys, vals)
    rk, rv, rcnt, ov = parallel.partition_for_shuffle(
        k, v, 1, n, mesh.get_group("x"))
    assert int(rcnt[0]) == n and int(ov) == 0
    assert torch.equal(rk[0], k) and torch.equal(rv[0], v)
    rk, rv, rcnt, ov = parallel.partition_for_shuffle_2d(
        k, (v,), 1, 1, n, n, mesh2.get_group("dcn"), mesh2.get_group("ici"))
    assert int(rcnt[0]) == n and int(ov) == 0
    assert torch.equal(rk[0], k) and torch.equal(rv[0][0], v)


def test_ops_layer_names_on_the_card(cuda, rng):
    """The JAX names the distributed layer and the JAX call sites use: the
    packed-sort group-by (its group ends through compact_mask),
    chunk_stats_xla (the chunk_stats kernel) and build_dense with global row
    ids, each equal to the same call on the CPU."""
    from dwarf_bench_tpu_torch.ops.chunk_stats import chunk_stats_xla

    keys = torch.from_numpy(rng.integers(0, 5100, 1 << 18).astype(np.int32))
    vals = torch.from_numpy(rng.integers(0, 1 << 16, 1 << 18).astype(np.int32))
    before = dict(_build.LAUNCHES)
    got = groupby.groupby_sum_packed_sort(keys.cuda(), vals.cuda(), 5000)
    assert _build.LAUNCHES["compact_mask"] == before["compact_mask"] + 1
    assert torch.equal(got.cpu(),
                       groupby.groupby_sum_packed_sort(keys, vals, 5000))
    x2 = torch.from_numpy(rng.integers(1, 10000, (4096, 128), endpoint=True)
                          .astype(np.int32))
    got = chunk_stats_xla(x2.cuda(), 5)
    assert _build.LAUNCHES["chunk_stats"] == before["chunk_stats"] + 1
    for g, e in zip(got, chunk_stats_xla(x2, 5)):
        assert torch.equal(g.cpu(), e)
    a = torch.from_numpy(rng.integers(1, 10000, 1 << 16, endpoint=True)
                         .astype(np.int32))
    ids = torch.arange(1 << 16, dtype=torch.int32) + (3 << 16)
    got = csr_join.build_dense(a.cuda(), row_ids=ids.cuda())
    for g, e in zip(got, csr_join.build_dense(a, row_ids=ids)):
        assert torch.equal(g.cpu(), e)


# -- the scripts (dwarf_bench_tpu_torch/scripts/) ------------------------------

def test_hash_hit50_on_the_card(cuda, tmp_path):
    """The 50 %-hit harness at 2^20 on the card: both phases validated on
    the device (it raises otherwise), the probes through the merge engine,
    9 GPU rows a phase."""
    from dwarf_bench_tpu_torch.scripts import hash_hit50

    before = dict(_build.LAUNCHES)
    found = hash_hit50.run(20, "all", cuda, str(tmp_path))
    for k in ("merge_bitonic", "merge_fill", "compact_mask"):
        assert _build.LAUNCHES[k] > before[k]
    half = 1 << 19
    for f in found.values():
        assert f.is_cuda and bool(f[:half].all()) and not bool(f[half:].any())
    rows = (tmp_path / "report_hash_hit50.csv").read_text().splitlines()[1:]
    assert len(rows) == 18
    assert all(r.startswith(f"GPU,{4 << 20},") for r in rows)


def test_scaling_world_of_one_on_the_card(cuda, tmp_path):
    """scaling.py on an NCCL world of one rank at 2^16 rows: the five ops
    timed with zero overflow (a rank raises otherwise), the card's rates
    and the rank's launches in the compute file."""
    import json

    path = tmp_path / "compute.json"
    proc = subprocess.run(
        [sys.executable, "-m", "dwarf_bench_tpu_torch.scripts.scaling",
         "--device", "gpu", "--rows_per_chip", str(1 << 16),
         "--compute_json", str(path)],
        capture_output=True, text=True, timeout=600,
        cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    assert [x["op"] for x in lines] == ["dist_groupby", "dist_csr_join",
                                        "dist_filter", "dist_csr_join_ring",
                                        "dist_sort"]
    got = json.loads(path.read_text())
    assert got["device"]["platform"] == "gpu" and got["card"]
    assert all(v > 0 for v in got["rows_per_s"].values())
    assert got["launches"]["histogram"] > 0
    assert got["launches"]["groupby_small"] > 0


def test_release_kernels_runs_unpacked_without_nvcc(cuda, tmp_path):
    """release.py --kernels ships the built library; the unpacked tree's
    entry loads it with nvcc hidden and builds nothing."""
    import os
    import tarfile

    from dwarf_bench_tpu_torch.scripts import release

    tar = release.release(str(tmp_path / "dist"), kernels=True)
    with tarfile.open(tar) as tf:
        tf.extractall(tmp_path / "x", filter="data")
    root = tmp_path / "x" / os.path.basename(tar)[: -len(".tar.gz")]
    build = root / "dwarf_bench_tpu_torch" / "build"
    shipped = sorted(os.listdir(build))
    assert len(shipped) == 1 and shipped[0].startswith("libdbt_kernels_")
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "no_cuda"))
    env["PATH"] = os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if p and not os.path.exists(os.path.join(p, "nvcc")))
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-m", "dwarf_bench_tpu_torch.entry"],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=root)
    assert proc.returncode == 0 and "entry OK" in proc.stdout, proc.stderr
    assert sorted(os.listdir(build)) == shipped
