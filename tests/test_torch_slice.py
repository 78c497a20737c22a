"""The ported slice end to end on the CPU: ``python -m dwarf_bench_tpu_torch``
for Radix, GroupBy (G=64 and 2^16) and JoinOmnisci, held against the JAX
package's CLI on the same arguments, plus the harness pieces the two
packages share (datagen, device options, CSV schema)."""

import contextlib
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dwarf_bench_tpu.cli import main as jax_main
from dwarf_bench_tpu.common import datagen as jax_datagen
from dwarf_bench_tpu.common.options import DeviceType as JaxDeviceType
from dwarf_bench_tpu.common.options import RunOptions as JaxRunOptions
from dwarf_bench_tpu.dwarfs import join as jax_join_dwarf
from dwarf_bench_tpu_torch.common import datagen
from dwarf_bench_tpu_torch.common.device import resolve_device
from dwarf_bench_tpu_torch.common.options import (
    DeviceType,
    RunOptions,
    parse_device_type,
    to_string,
)
from dwarf_bench_tpu_torch.dwarfs import join as join_dwarf
from dwarf_bench_tpu_torch.ops import csr_join

REPO = pathlib.Path(__file__).resolve().parents[1]

SLICE = [
    ("Radix", []),
    ("GroupBy", ["--groups_count=64"]),
    ("GroupBy", ["--groups_count=65536"]),
    ("JoinOmnisci", []),
]


def _csv_rows(path):
    return [line.split(",") for line in open(path).read().splitlines()]


@pytest.mark.parametrize("dwarf,extra", SLICE)
def test_cli_matches_jax_package(tmp_path, dwarf, extra):
    args = [dwarf, "--device=cpu", "--input_size", "1024", "4096",
            "--iterations=2", *extra]
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
    assert len(port) == len(ref) == 1 + 2 * 2
    for p, r in zip(port[1:], ref[1:]):
        assert len(p) == len(r)
        assert p[:2] == r[:2]  # device_type, buf_size_bytes
        assert all(float(x) >= 0 for x in p[2:])


@pytest.mark.parametrize("size,seed", [(1, 0), (1000, 7), (1 << 16, 123)])
def test_datagen_byte_identical(size, seed):
    for i in range(3):
        s = datagen.derive_seed(seed, size, i)
        assert s == jax_datagen.derive_seed(seed, size, i)
        for dtype in (np.int32, np.uint32):
            a = datagen.make_random(size, seed=s, dtype=dtype)
            b = jax_datagen.make_random(size, seed=s, dtype=dtype)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        g = datagen.make_random(size, 0, 63, seed=s, dtype=np.uint32)
        assert g.tobytes() == jax_datagen.make_random(
            size, 0, 63, seed=s, dtype=np.uint32).tobytes()
        u = datagen.make_unique_random(size, seed=s)
        assert u.tobytes() == jax_datagen.make_unique_random(
            size, seed=s).tobytes()


def test_device_options():
    assert parse_device_type("gpu") is DeviceType.GPU
    assert parse_device_type("CUDA") is DeviceType.GPU
    assert parse_device_type("cpu") is DeviceType.CPU
    assert parse_device_type("tpu") is DeviceType.DEFAULT
    assert to_string(DeviceType.GPU) == "GPU"
    assert to_string(DeviceType.DEFAULT) == "GPU"
    assert to_string(DeviceType.CPU) == "CPU"
    assert resolve_device(DeviceType.CPU) == torch.device("cpu")


def test_gpu_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(DeviceType.GPU)
    proc = subprocess.run(
        [sys.executable, "-m", "dwarf_bench_tpu_torch", "RadixCuda",
         "--input_size", "16", f"--report_path={tmp_path / 'r.csv'}"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 1
    assert "CUDA is not available" in proc.stderr
    assert not os.path.exists(tmp_path / "r.csv")


def test_wide_join_keys_take_the_general_join(monkeypatch, tmp_path):
    """Keys past one 2^14 window take the general CSR join (build +
    probe_merge), as in the JAX dwarf: the port's dwarf is valid on them
    and writes the JAX dwarf's CSV header."""
    def wide(size, lo=1, hi=10000, seed=0, dtype=np.int32):
        return np.arange(size, dtype=dtype) * np.asarray(70_000, dtype)

    monkeypatch.setattr(join_dwarf, "make_random", wide)
    monkeypatch.setattr(jax_join_dwarf, "make_random", wide)
    assert not csr_join.dense_applicable(wide(4), wide(4))
    runs = ((join_dwarf, RunOptions(device_ty=DeviceType.CPU)),
            (jax_join_dwarf, JaxRunOptions(device_ty=JaxDeviceType.CPU)))
    csvs = []
    for module, opts in runs:
        opts.input_size, opts.iterations = [4, 1000], 2
        opts.report_path = str(tmp_path / f"{len(csvs)}.csv")
        dwarf = module.JoinOmnisci()
        dwarf.init(opts)
        with contextlib.redirect_stdout(io.StringIO()):
            dwarf.run(opts)
        dwarf.report(opts)
        csvs.append(opts.report_path)
        if module is join_dwarf:
            results = [r.result for r in dwarf.get_results()]
            assert len(results) == 4 and all(r.valid for r in results)
    port, ref = (open(p).read().splitlines() for p in csvs)
    assert port[0] == ref[0] == \
        "device_type,buf_size_bytes,host_time_ms,kernel_time_ms"
    assert [r.split(",")[:2] for r in port] == [r.split(",")[:2] for r in ref]


def test_default_device_needs_cuda(tmp_path):
    """DEFAULT is the card: without CUDA it raises, and the CLI without
    --device exits 1 instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for dt in (DeviceType.DEFAULT, parse_device_type("tpu")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dt)
    assert RunOptions().device_ty is DeviceType.DEFAULT
    for extra in ([], ["--device=default"]):
        proc = subprocess.run(
            [sys.executable, "-m", "dwarf_bench_tpu_torch", "Radix",
             "--input_size", "16", *extra,
             f"--report_path={tmp_path / 'r.csv'}"],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 1
        assert "CUDA is not available" in proc.stderr
        assert not os.path.exists(tmp_path / "r.csv")


def test_join_validator_rejects_corruption(rng):
    """The exact CSR-join check accepts the port's result and rejects a
    broken id_buffer, count or position."""
    a = rng.integers(1, 50, 500).astype(np.uint32)
    b = rng.integers(1, 60, 400).astype(np.uint32)
    table = csr_join.build_dense(torch.from_numpy(a.view(np.int32)))
    res = csr_join.probe_dense(table, torch.from_numpy(b.view(np.int32)))
    ids, found, pos, cnt = (x.numpy().copy() for x in
                            (table.id_buffer, res.found, res.pos, res.counts))
    check = join_dwarf.validate_csr_join
    assert check(a, b, ids, found, pos, cnt)
    first, last = ids[0], ids[-1]  # different keys: smallest and largest
    swapped = ids.copy()
    swapped[0], swapped[-1] = last, first
    assert not check(a, b, swapped, found, pos, cnt)
    hit = int(np.argmax(found))
    wrong_cnt, wrong_pos = cnt.copy(), pos.copy()
    wrong_cnt[hit] += 1
    wrong_pos[hit] += 1
    assert not check(a, b, ids, found, wrong_cnt, pos)
    assert not check(a, b, ids, found, cnt, wrong_pos)
    assert not check(a, b, ids[:-1], found, pos, cnt)
