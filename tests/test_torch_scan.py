"""The sparse scan slice on the CPU: ``ops/scan.py`` held exactly against
the JAX package's ``filter_sparse`` (interpret mode, which forces its fused
accelerator structure), ``filter_two_pass``, ``filter_xla`` and
``sparse_caps_ok``, and the scan dwarfs through ``python -m
dwarf_bench_tpu_torch`` against the JAX CLI's CSV. Outputs are compared up
to their count: the rest is garbage by contract."""

import contextlib
import io
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.cli import main as jax_main
from dwarf_bench_tpu.ops import scan as jax_scan
from dwarf_bench_tpu_torch.ops import chunk_stats_cuda, compact_cuda, scan

REPO = pathlib.Path(__file__).resolve().parents[1]


def _data(rng, n, deep=0):
    x = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    if deep:
        x[rng.integers(0, n, deep)] = -700  # singles below the window
    return x


def _same(got, ref, x, threshold):
    (out, count), (rout, rcount) = got, ref
    expected = scan.filter_oracle(x, threshold)
    assert count.shape == () and count.dtype == torch.int32
    assert int(count) == int(rcount) == len(expected)
    assert np.array_equal(out.numpy()[: len(expected)], expected)
    assert np.array_equal(np.asarray(rout)[: len(expected)], expected)


@pytest.mark.parametrize("n,threshold,deep,caps", [
    (1 << 18, 5, 0, {}),        # benchmark selectivity: the sparse branch
    (1 << 18, 5, 40, {}),       # out-of-window singles take the gather path
    (100_000, 5, 5, {}),        # n not a multiple of 128
    (100_000, 5000, 0, {}),     # dense: the caps trip, general branch
    (100_000, 5, 0, {"cap_single": 16}),  # one cap trips
])
def test_filter_sparse_matches_jax(rng, n, threshold, deep, caps):
    x = _data(rng, n, deep)
    ref = jax_scan.filter_sparse(jnp.asarray(x), threshold, interpret=True,
                                 **caps)
    runs = [False]
    if jax_scan.sparse_caps_ok(x, threshold, **caps):
        runs.append(True)
    for assume in runs:
        got = scan.filter_sparse(torch.from_numpy(x), threshold,
                                 assume_sparse=assume, **caps)
        _same(got, ref, x, threshold)


@pytest.mark.parametrize("n,threshold,deep,stats_pallas", [
    (1 << 18, 5, 0, None), (1 << 18, 5, 40, None), (100_000, 5, 5, None),
    (100_000, 5, 5, False), (1 << 18, 5, 40, True)])
def test_filter_sparse_emits_through_the_index(rng, monkeypatch, n, threshold,
                                               deep, stats_pallas):
    """The ordering's gather is folded into the emit: filter_sparse hands
    emit_prefix the unsorted values and the sort's order (int64, the first
    min(capacity, values) of it), once a call, and the whole result equals
    the JAX package's filter_sparse, which sorts (position, value) pairs
    instead."""
    seen = []
    emit = compact_cuda.emit_prefix

    def spy(vals, capacity, index=None):
        seen.append((vals.numel(), capacity,
                     None if index is None else (index.dtype, index.numel())))
        return emit(vals, capacity, index)

    monkeypatch.setattr(compact_cuda, "emit_prefix", spy)
    x = _data(rng, n, deep)
    ref = jax_scan.filter_sparse(jnp.asarray(x), threshold, interpret=True)
    got = scan.filter_sparse(torch.from_numpy(x), threshold,
                             stats_pallas=stats_pallas)
    _same(got, ref, x, threshold)
    assert len(seen) == 1
    nvals, capacity, index = seen[0]
    assert index == (torch.int64, min(capacity, nvals))


def test_filter_sparse_assume_sparse_matches_jax(rng):
    x = _data(rng, 1 << 18, 40)
    assert scan.sparse_caps_ok(x)
    ref = jax_scan.filter_sparse(jnp.asarray(x), interpret=True,
                                 assume_sparse=True)
    _same(scan.filter_sparse(torch.from_numpy(x), assume_sparse=True), ref,
          x, scan.DEFAULT_THRESHOLD)


@pytest.mark.parametrize("threshold,capacity", [(5, None), (5000, None),
                                                (5000, 1000)])
def test_filter_two_pass_and_xla_match_jax(rng, threshold, capacity):
    x = _data(rng, 100_003)
    k = min(int((x < threshold).sum()),
            len(x) if capacity is None else capacity)
    for port, jax_fn in ((scan.filter_two_pass, jax_scan.filter_two_pass),
                         (scan.filter_xla, jax_scan.filter_xla)):
        out, count = port(torch.from_numpy(x), threshold, capacity)
        rout, rcount = jax_fn(jnp.asarray(x), threshold, capacity=capacity)
        assert int(count) == int(rcount) and count.dtype == torch.int32
        assert out.shape == rout.shape
        assert np.array_equal(out.numpy()[:k], np.asarray(rout)[:k])


def _caps_cases(rng):
    dense = _data(rng, 50_000)
    yield _data(rng, 1 << 16), 5
    yield _data(rng, 1 << 16, 3000), 5   # too many multi chunks
    yield dense, 5000                    # too many elements
    yield dense, 10001
    yield dense, -(2**31) + 512          # window arithmetic would wrap
    yield dense, -(2**31) + 513
    yield dense.astype(np.int64), 5      # not int32
    yield np.array([4], np.int32), 5


def test_sparse_caps_ok_matches_jax(rng):
    seen = set()
    for x, threshold in _caps_cases(rng):
        ok = scan.sparse_caps_ok(x, threshold)
        assert ok == jax_scan.sparse_caps_ok(x, threshold)
        seen.add(ok)
    assert seen == {True, False}


def test_filter_sparse_general_engines_on_cpu(rng):
    """Non-int32 input takes filter_two_pass on the CPU, whatever
    stats_pallas says."""
    x = _data(rng, 5000).astype(np.int64)
    expected = scan.filter_oracle(x, 5000)
    for stats_pallas in (None, True, False):
        out, count = scan.filter_sparse(torch.from_numpy(x), 5000,
                                        stats_pallas=stats_pallas)
        assert int(count) == len(expected)
        assert out.dtype == torch.int64
        assert np.array_equal(out.numpy()[: len(expected)], expected)


@pytest.mark.parametrize("n,threshold,deep,assume", [
    (1 << 18, 5, 0, False),      # benchmark selectivity: the sparse branch
    (1 << 18, 5, 40, True),      # assume_sparse, out-of-window singles
    (100_000, 5, 5, False),      # n not a multiple of 128
    (100_000, 5, 5, True),
    (100_000, 5000, 0, False),   # dense: the caps trip, general branch
])
def test_filter_sparse_stats_pallas_matches_jax(rng, n, threshold, deep,
                                                assume):
    """The round-2 path (stats_pallas=True: the chunk-stats kernel's name;
    False: the plain stats) against the JAX package's round-2 path with its
    Pallas stats kernel in interpret mode, and against filter_oracle."""
    x = _data(rng, n, deep)
    if assume:
        assert scan.sparse_caps_ok(x, threshold)
    ref = jax_scan.filter_sparse(jnp.asarray(x), threshold, interpret=True,
                                 stats_pallas=True, assume_sparse=assume)
    for stats_pallas in (True, False):
        got = scan.filter_sparse(torch.from_numpy(x), threshold,
                                 stats_pallas=stats_pallas,
                                 assume_sparse=assume)
        _same(got, ref, x, threshold)


def test_stats_pallas_thresholds_near_int32_min(rng):
    """Where threshold - 512 would wrap, the round-2 path takes the general
    engine, as the JAX package's does."""
    x = _data(rng, 3000)
    x[:7] = np.array([-(2**31), -(2**31) + 1, -(2**31) + 600, 0, 5, 6, 7])
    for threshold in (-(2**31) + 512, -(2**31) + 513, -(2**31) + 700):
        ref = jax_scan.filter_sparse(jnp.asarray(x), threshold,
                                     interpret=True, stats_pallas=True)
        for stats_pallas in (True, False):
            got = scan.filter_sparse(torch.from_numpy(x), threshold,
                                     stats_pallas=stats_pallas)
            _same(got, ref, x, threshold)


def test_assume_sparse_reads_nothing_back(rng, monkeypatch):
    """With the caps checked on the host, filter_sparse returns (out, count)
    without reading any tensor's value on the host; without the check it
    reads the cap predicate once."""
    x = torch.from_numpy(_data(rng, 1 << 16, 20))
    reads = []

    def host_read(name):
        def read(self, *args, **kwargs):
            reads.append(name)
            raise AssertionError(f"host read: Tensor.{name}")
        return read

    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, host_read(name))
    scan.filter_sparse(x, assume_sparse=True)
    assert reads == []
    with pytest.raises(AssertionError, match="host read"):
        scan.filter_sparse(x)
    assert reads == ["item"]  # ops/trace.read


def test_stats_pallas_assume_sparse_reads_nothing_back(rng, monkeypatch):
    """The round-2 path with the caps checked on the host reads no tensor's
    value on the host either."""
    x = torch.from_numpy(_data(rng, 1 << 16, 20))

    def host_read(self, *args, **kwargs):
        raise AssertionError("host read")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    for stats_pallas in (True, False):
        scan.filter_sparse(x, assume_sparse=True, stats_pallas=stats_pallas)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it routes a wrapper as a
    card's tensor would, with no card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def test_phase_a_routing(rng, monkeypatch):
    """filter_sparse's default path takes phase A from
    chunk_stats_cuda.chunk_stats once a call, which launches the
    chunk-stats kernel for a tensor on the card and runs its plain twin for
    a CPU tensor; stats_pallas=False keeps the plain stats."""
    calls = []
    launched = []
    plain = chunk_stats_cuda.chunk_stats_plain

    def launch(op, x2, thr):
        launched.append(op)
        return plain(x2.as_subclass(torch.Tensor), thr)

    monkeypatch.setattr(chunk_stats_cuda, "_launch", launch)
    _spy(monkeypatch, chunk_stats_cuda, "chunk_stats_plain", calls)
    _spy(monkeypatch, chunk_stats_cuda, "chunk_stats", calls)
    x2 = torch.from_numpy(_data(rng, 64 * 128).reshape(64, 128))
    exp = plain(x2, 5)
    got = chunk_stats_cuda.chunk_stats(x2, 5)
    assert calls == ["chunk_stats", "chunk_stats_plain"] and launched == []
    calls.clear()
    got_card = chunk_stats_cuda.chunk_stats(x2.as_subclass(_OnCard), 5)
    assert calls == ["chunk_stats"] and launched == ["chunk_stats"]
    for g in (got, got_card):
        assert all(torch.equal(a, b) for a, b in zip(g, exp))

    x = _data(rng, 1 << 16, 5)
    calls.clear()
    out, count = scan.filter_sparse(torch.from_numpy(x), assume_sparse=True)
    assert calls == ["chunk_stats", "chunk_stats_plain"]
    expected = scan.filter_oracle(x)
    assert int(count) == len(expected)
    assert np.array_equal(out.numpy()[: len(expected)], expected)
    calls.clear()
    scan.filter_sparse(torch.from_numpy(x), stats_pallas=False)
    assert "chunk_stats" not in calls


def _csv_rows(path):
    return [line.split(",") for line in open(path).read().splitlines()]


@pytest.mark.parametrize("dwarf", ["TwoPassScan", "DPLScan"])
def test_cli_matches_jax_package(tmp_path, dwarf):
    args = [dwarf, "--device=cpu", "--input_size", "65536", "100003",
            "--iterations=2"]
    port_csv = tmp_path / "port.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "dwarf_bench_tpu_torch", *args,
         f"--report_path={port_csv}"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert f"[{dwarf}] 4/4 runs valid" in proc.stderr, proc.stderr

    jax_csv = tmp_path / "jax.csv"
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jax_main([*args, f"--report_path={jax_csv}"]) == 0
    port, ref = _csv_rows(port_csv), _csv_rows(jax_csv)
    assert open(port_csv).readline() == open(jax_csv).readline()
    assert port[0] == ["device_type", "buf_size_bytes", "host_time_ms",
                       "kernel_time_ms"]
    assert len(port) == len(ref) == 1 + 2 * 2
    for p, r in zip(port[1:], ref[1:]):
        assert p[:2] == r[:2]  # device_type, buf_size_bytes
        assert all(float(v) >= 0 for v in p[2:])
