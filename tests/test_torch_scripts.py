"""Port parity of ``dwarf_bench_tpu_torch/scripts/`` against the JAX
package's ``scripts/`` on the CPU: the report's summary and table, the
sweep grids against the ``benchmark_*.sh`` files and the runner's
device-aware skip, the 50 %-hit hash harness's probe vectors against the
JAX functions on the same data, and the release tar. The JAX scripts are
loaded from their files (``report.py`` imports no JAX); nothing in them
changes. Every compared value is an integer or a string: no tolerance.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import pathlib
import re
import shlex
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwarf_bench_tpu.ops import bucket_hash as jbucket
from dwarf_bench_tpu.ops import cuckoo as jcuckoo
from dwarf_bench_tpu_torch import __version__
from dwarf_bench_tpu_torch.scripts import hash_hit50, release, report, sweeps

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_report():
    return _load("report")


# -- report.py ----------------------------------------------------------------

def _synthetic_csv(path):
    rows = ["device_type,buf_size_bytes,host_time_ms,kernel_time_ms",
            "GPU,1024,5.0,1.5", "GPU,1024,1.0,0.25", "GPU,1024,2.0,0.5",
            "CPU,1024,7.125,3.0", "GPU,4096,9.0,2.0", "CPU,256,1.5,0.75",
            "CPU,256,0.5,0.125"]
    path.write_text("\n".join(rows) + "\n")
    return str(path)


@pytest.mark.parametrize("column", ["host_time_ms", "kernel_time_ms"])
@pytest.mark.parametrize("which", ["report_radix", "synthetic"])
def test_report_equals_the_jax_script(jax_report, tmp_path, which, column):
    """``summarize`` and the printed table, on the JAX package's committed
    ``results/sweeps/report_radix.csv`` (read only) and a small CSV."""
    path = (str(REPO / "results" / "sweeps" / "report_radix.csv")
            if which == "report_radix" else _synthetic_csv(tmp_path / "s.csv"))
    rows = report.load(path)
    assert rows == jax_report.load(path)
    assert report.summarize(rows, column) == jax_report.summarize(rows, column)
    out = []
    for main in (report.main, jax_report.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([path, "--column", column]) == 0
        out.append(buf.getvalue())
    assert out[0] == out[1]
    assert len(out[0].splitlines()) == 1 + len(report.summarize(rows, column))


def test_report_summary_drops_the_slowest(tmp_path):
    rows = report.load(_synthetic_csv(tmp_path / "s.csv"))
    assert report.summarize(rows, "host_time_ms") == [
        ("CPU", 256, 0.5, 1), ("CPU", 1024, 7.125, 1),
        ("GPU", 1024, 1.5, 2), ("GPU", 4096, 9.0, 1)]


def test_report_plot_without_matplotlib_raises(tmp_path, monkeypatch):
    path = _synthetic_csv(tmp_path / "s.csv")
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib is not installed"):
        report.main([path, "--plot", str(tmp_path / "p.png")])
    assert not (tmp_path / "p.png").exists()


def test_report_of_an_empty_csv_fails(tmp_path):
    path = tmp_path / "e.csv"
    path.write_text("device_type,buf_size_bytes,host_time_ms,kernel_time_ms\n")
    assert report.main([str(path)]) == 1


# -- sweeps.py ----------------------------------------------------------------

def _parse_sh(path: pathlib.Path):
    """(dwarfs, sizes, csv basename, iterations, devices) of one
    ``benchmark_*.sh``, read from its text."""
    text = path.read_text().replace("\\\n", " ")
    var = {}
    for name, value in re.findall(r'^(\w+)="([^"]*)"', text, re.M):
        value = re.sub(r"^\$\{\w+:-(.*)\}$", r"\1", value)
        var[name] = value
    loop = re.search(r"^for D in ([\w ]+); do", text, re.M)
    if loop:  # the hash grid: run_sweeps_tpu.sh once a dwarf
        call = shlex.split(re.search(r"scripts/run_sweeps_tpu\.sh (.*)$",
                                     text, re.M).group(1))
        csv = os.path.basename(call[1]).replace("${D,,}", "{dwarf}")
        return (tuple(loop.group(1).split()),
                tuple(int(s) for s in var["SIZES"].split()), csv,
                int(var["ITER"]), ("gpu",))
    dwarfs, devices, sizes, csvs, iters = [], [], set(), set(), set()
    for line in re.findall(r"^python -m dwarf_bench_tpu (.*)$", text, re.M):
        words = shlex.split(line.replace("$SIZES", var.get("SIZES", "")))
        dwarfs.append(words[0])
        i = words.index("--input_size")
        got = []
        for w in words[i + 1:]:
            if w.startswith("--"):
                break
            got.append(int(w))
        sizes.add(tuple(got))
        for w in words:
            if w.startswith("--device="):
                devices.append({"tpu": "gpu", "cpu": "cpu"}[w.split("=")[1]])
            elif w.startswith("--report_path="):
                csvs.add(w.split("=", 1)[1])
            elif w.startswith("--iterations="):
                iters.add(int(w.split("=")[1]))
    assert len(set(dwarfs)) == len(sizes) == len(csvs) == len(iters) == 1
    return ((dwarfs[0],), sizes.pop(), csvs.pop(), iters.pop(),
            tuple(devices))


SH_FILES = sorted(SCRIPTS.glob("benchmark_*.sh"))


def test_grids_are_the_ten_sh_files():
    assert len(SH_FILES) == 10
    assert set(sweeps.GRIDS) == {p.stem[len("benchmark_"):] for p in SH_FILES}


@pytest.mark.parametrize("path", SH_FILES, ids=lambda p: p.stem)
def test_grid_equals_its_sh_file(path):
    dwarfs, sizes, csv, iterations, devices = _parse_sh(path)
    grid = sweeps.GRIDS[path.stem[len("benchmark_"):]]
    assert grid == sweeps.Grid(dwarfs, sizes, csv, iterations, devices)
    for d in dwarfs:
        # into --out, never results/
        assert "/" not in sweeps.csv_name(grid, d)


def test_large_grids_reach_2p27():
    for name in ("radix_large", "twopassscan", "dplscan_large",
                 "dplscan_large_cuda", "radix_large_cuda"):
        assert max(sweeps.GRIDS[name].sizes) == 1 << 27
        assert len(sweeps.GRIDS[name].sizes) == 11


def test_cpu_sweep_writes_then_skips(tmp_path):
    """Radix at 1024 and 2048 on the CPU, 1 iteration: both rows, and the
    log; a second run skips both and runs no CLI."""
    csv = str(tmp_path / "report_radix_small.csv")
    first = sweeps.run_sweep("Radix", csv, 1, [1024, 2048], "cpu")
    assert first.ran == [1024, 2048] and not first.failed
    rows = pathlib.Path(csv).read_text().splitlines()
    assert rows[0] == "device_type,buf_size_bytes,host_time_ms,kernel_time_ms"
    assert sorted(r.split(",")[:2] for r in rows[1:]) == [
        ["CPU", "4096"], ["CPU", "8192"]]
    log = (tmp_path / "report_radix_small.log").read_text()
    assert "=== Radix size 1024 ===" in log and "[Radix] 1/1 runs valid" in log
    second = sweeps.run_sweep("Radix", csv, 1, [1024, 2048], "cpu")
    assert second.ran == [] and second.skipped == [1024, 2048]
    assert pathlib.Path(csv).read_text().splitlines() == rows


def test_cpu_row_does_not_skip_the_gpu_half(tmp_path):
    """The skip matches the device: a CSV holding only a CPU row at 1024
    still runs the GPU half there (without a card the CLI fails, and the
    size is recorded as FAILED)."""
    csv = tmp_path / "r.csv"
    csv.write_text("device_type,buf_size_bytes,host_time_ms,kernel_time_ms\n"
                   "CPU,4096,1.0,0.5\n")
    assert sweeps.recorded(str(csv), "cpu", 1024)
    assert not sweeps.recorded(str(csv), "gpu", 1024)
    assert not sweeps.recorded(str(csv), "cpu", 2048)
    got = sweeps.run_sweep("Radix", str(csv), 1, [1024], "gpu")
    assert got.skipped == []
    log = (tmp_path / "r.log").read_text()
    assert "=== Radix size 1024 ===" in log
    if not torch.cuda.is_available():
        assert got.failed == ["FAILED Radix 1024 (rc 1)"]
        assert "FAILED Radix 1024 (rc 1)" in log


def test_sweeps_on_the_card_need_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweeps.main(["radix_small", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())


# -- hash_hit50.py ------------------------------------------------------------

@pytest.fixture(scope="module")
def hit50(tmp_path_factory):
    out = tmp_path_factory.mktemp("hit50")
    found = hash_hit50.run(12, "all", torch.device("cpu"), str(out))
    return out, found


def test_hit50_data_is_the_jax_scripts():
    """The reference harness's data: make_unique_random(n, 1234), then
    default_rng(99) for the probes and values."""
    from dwarf_bench_tpu.common.datagen import make_unique_random

    n = 1 << 12
    keys, vals, probes = hash_hit50.hit50_data(n)
    assert np.array_equal(keys, make_unique_random(n, seed=1234))
    rng = np.random.default_rng(99)
    assert np.array_equal(probes[: n // 2], rng.permutation(keys)[: n // 2])
    assert np.array_equal(probes[n // 2:], rng.integers(0, n, n // 2)
                          .astype(np.uint32) + np.uint32(1 << 28))
    assert np.array_equal(vals, rng.integers(1, 10000, n, endpoint=True)
                          .astype(np.uint32))


def test_hit50_found_equals_jax(hit50):
    """The slab ``find(val_bits=16)`` and the cuckoo ``has`` vectors at
    n = 2^12 equal the JAX functions' on the same data."""
    _, found = hit50
    n = 1 << 12
    keys, vals, probes = hash_hit50.hit50_data(n)
    nb = jbucket.calculate_buckets_count(n)
    tbl = jbucket.build(jnp.asarray(keys), jnp.asarray(vals), num_buckets=nb)
    exp_slab, _ = jbucket.find(tbl, jnp.asarray(probes), val_bits=16)
    assert np.array_equal(found["slab"].numpy(), np.asarray(exp_slab))
    ct = jcuckoo.build(jnp.asarray(keys), 4 * n, np.uint32(0x9E3779B9),
                       np.uint32(0x85EBCA6B), min(n, 256))
    assert bool(ct.success)
    exp_has = jcuckoo.has(ct, jnp.asarray(probes))
    assert np.array_equal(found["cuckoo"].numpy(), np.asarray(exp_has))
    half = n // 2
    for f in found.values():
        assert bool(f[:half].all()) and not bool(f[half:].any())


def test_hit50_writes_nine_rows_a_phase(hit50):
    out, _ = hit50
    rows = (out / "report_hash_hit50.csv").read_text().splitlines()
    assert rows[0] == "device_type,buf_size_bytes,host_time_ms,kernel_time_ms"
    assert len(rows) == 1 + 2 * 9
    for r in rows[1:]:
        dev, nbytes, host_ms, kernel_ms = r.split(",")
        assert dev == "CPU" and nbytes == str(4 << 12)
        assert float(host_ms) >= 0 and float(kernel_ms) > 0
    log = (out / "report_hash_hit50.log").read_text()
    assert log.count("-> VALID") == 2 and "converged=True" in log


def test_hit50_failed_validation_raises(tmp_path):
    h = hash_hit50.Harness(8, torch.device("cpu"), str(tmp_path))
    h.validate(torch.tensor([1, 1, 1, 1, 0, 0, 0, 0], dtype=torch.bool), "ok")
    for bad in ([1, 1, 1, 0, 0, 0, 0, 0], [1, 1, 1, 1, 0, 0, 1, 0]):
        with pytest.raises(hash_hit50.Hit50Failure):
            h.validate(torch.tensor(bad, dtype=torch.bool), "slab")


def test_hit50_on_the_card_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hash_hit50.main(["10", "--out", str(tmp_path)])


# -- release.py ---------------------------------------------------------------

def test_release_tar(tmp_path):
    path = release.release(str(tmp_path))
    name = f"dwarf_bench_tpu_torch-{__version__}"
    assert os.path.basename(path) == f"{name}.tar.gz"
    with tarfile.open(path) as tf:
        members = tf.getnames()
        pyproject = tf.extractfile(f"{name}/pyproject.toml").read().decode()
    assert all(m == name or m.startswith(name + "/") for m in members)
    tops = {m.split("/")[1] for m in members if m != name}
    assert tops == {"dwarf_bench_tpu_torch", "native", "README.md",
                    "pyproject.toml"}
    assert {m for m in members if m.startswith(f"{name}/native/")} == {
        f"{name}/native/{f}" for f in ("oracles.cpp", "Makefile",
                                       "liboracles.so")}
    for bad in ("__pycache__", "build", "results"):
        assert not any(bad in m.split("/") for m in members), bad
    cu = sorted(p.name for p in (REPO / "dwarf_bench_tpu_torch" / "csrc")
                .iterdir())
    assert sorted(m.rsplit("/", 1)[1] for m in members
                  if "/csrc/" in m) == cu
    assert f"{name}/dwarf_bench_tpu_torch/scripts/release.py" in members
    assert ('dwarf-bench-tpu-torch = "dwarf_bench_tpu_torch.cli:main"'
            in pyproject)


def test_release_kernels_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        release.main(["--kernels", "--out", str(tmp_path / "dist")])
    assert not (tmp_path / "dist").exists()


@pytest.mark.parametrize("module, argv", [
    (sweeps, ["radix_small", "--devices", "cpu", "--out"]),
    (hash_hit50, ["10", "--device", "cpu", "--out"]),
])
def test_scripts_refuse_the_results_directory(module, argv):
    """results/ holds the JAX package's committed TPU artifacts."""
    before = sorted((REPO / "results").rglob("*"))
    for out in ("results", "results/sweeps"):
        with pytest.raises(ValueError, match="results/ holds"):
            module.main(argv + [str(REPO / out)])
    assert sorted((REPO / "results").rglob("*")) == before
