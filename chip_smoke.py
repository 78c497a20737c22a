#!/usr/bin/env python3
"""Smoke run of dwarf_bench_tpu_torch on one CUDA GPU (an H100 for this port).

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels from ``csrc/``
with nvcc, then:

  1. prints the card (``nvidia-smi`` name and power limit), the torch, CUDA
     and nvcc versions, and the kernel build time;
  2. runs each kernel against its plain PyTorch twin on the card, at the
     shapes the dwarfs give it and on edge cases, and requires exact
     agreement (every output is an integer); prints both times;
  3. drives the dwarfs through the CLI entry point with ``--device=gpu``
     (Radix 2^22, GroupBy 2^22 with G=64, GroupBy 2^20 with G=2^16,
     JoinOmnisci 2^20, three iterations each) and requires every result to
     be valid, every kernel of a dwarf's path to have launched in its run,
     and the CSV header to be the one the JAX package writes;
  4. prints one JSON line with each kernel's launches, error and times, and
     last the JSON line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. It exits non-zero at once
when CUDA is not available. It imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The JAX package's CSV header for Radix, GroupBy and JoinOmnisci (they keep
# the default report header; tests/test_torch_slice.py holds the port to
# the JAX package's own CSV on the CPU).
JAX_CSV_HEADER = "device_type,buf_size_bytes,host_time_ms,kernel_time_ms"

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "histogram": ("dwarf_bench_tpu_torch/csrc/hist.cu",
                  "dwarf_bench_tpu/ops/hist_pallas.py:119"),
    "cumsum": ("dwarf_bench_tpu_torch/csrc/cumsum.cu",
               "dwarf_bench_tpu/ops/cumsum_pallas.py:35"),
    "groupby_small": ("dwarf_bench_tpu_torch/csrc/groupby.cu",
                      "dwarf_bench_tpu/ops/groupby_pallas.py:307"),
    "weighted_histogram": ("dwarf_bench_tpu_torch/csrc/hist.cu",
                           "dwarf_bench_tpu/ops/hist_pallas.py:482"),
}

DWARF_RUNS = [
    # (dwarf, rows, extra CLI flags, kernels its path must launch)
    ("Radix", 1 << 22, [], ("histogram", "cumsum")),
    ("GroupBy", 1 << 22, ["--groups_count=64"], ("groupby_small",)),
    ("GroupBy", 1 << 20, ["--groups_count=65536"], ("weighted_histogram",)),
    ("JoinOmnisci", 1 << 20, [], ("histogram",)),
]


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def nvcc_version(nvcc: str) -> str:
    proc = subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, timeout=60)
    check(proc.returncode == 0, f"{nvcc} --version failed")
    return proc.stdout.strip().splitlines()[-1]


def phase_kernels(dev):
    """Each kernel against its plain twin on ``dev``. Returns
    {kernel: {"max_abs_err", "ms", "plain_ms"}} with the times taken at the
    kernel's first (main-path) case."""
    from dwarf_bench_tpu_torch.common.datagen import make_random
    from dwarf_bench_tpu_torch.ops import cumsum_cuda, groupby_cuda, hist_cuda
    from dwarf_bench_tpu_torch.utils.timing import kernel_time, sync

    rng = np.random.default_rng(20261016)
    stats = {name: {"max_abs_err": 0, "ms": None, "plain_ms": None}
             for name in KERNELS}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def run(name, label, kernel, plain, *args, timed=False):
        got = sync(kernel(*args))
        exp = sync(plain(*args))
        check(got.shape == exp.shape and got.dtype == exp.dtype,
              f"{name} [{label}]: {got.shape}/{got.dtype} vs "
              f"{exp.shape}/{exp.dtype}")
        err = 0
        if got.numel():
            err = int((got.to(torch.int64) - exp.to(torch.int64)).abs().max())
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        line = f"kernel {name} [{label}]: max_abs_err={err}"
        if timed:
            ms = kernel_time(kernel, *args, k=20) * 1e3
            plain_ms = kernel_time(plain, *args, k=20) * 1e3
            if stats[name]["ms"] is None:
                stats[name]["ms"], stats[name]["plain_ms"] = ms, plain_ms
            line += f" kernel_ms={ms!r} plain_ms={plain_ms!r}"
        print(line, flush=True)
        check(err == 0, f"{name} [{label}]: kernel and plain twin differ "
                        f"(max_abs_err {err})")

    i32max, i32min = 2**31 - 1, -2**31
    # -- histogram (radix hi80 at 2^22, join build hi128 at 2^20) ------
    h, hp = hist_cuda.histogram, hist_cuda.histogram_plain
    radix_k = make_random(1 << 22, seed=1) - 1
    run("histogram", "radix hi80 n=2^22", h, hp, t(radix_k), 80, timed=True)
    run("histogram", "join hi128 n=2^20", h, hp,
        t(make_random(1 << 20, seed=2) - 1), 128, timed=True)
    run("histogram", "all out of range", h, hp,
        t(np.full(5000, 80 * 128, np.int64)), 80)
    run("histogram", "negative keys", h, hp,
        t(rng.choice([-1, -7, i32min, i32max, 5], 100_003)), 128)
    run("histogram", "single bin", h, hp, t(np.full(77_777, 3)), 1)
    run("histogram", "n=1", h, hp, t([16383]), 128)
    run("histogram", "n=1000003 spread", h, hp,
        t(rng.integers(-100, 16384 + 100, 1_000_003)), 128)

    # -- cumsum (radix run expansion at 2^22) ---------------------------
    c, cp = cumsum_cuda.cumsum, cumsum_cuda.cumsum_plain
    n = 1 << 22
    counts = np.bincount(radix_k, minlength=80 * 128)
    starts = np.cumsum(counts) - counts
    s = np.bincount(np.minimum(starts, n), minlength=n + 1)[:n]
    run("cumsum", "radix expansion n=2^22", c, cp, t(s), -1, timed=True)
    run("cumsum", "n=1", c, cp, t([7]), 0)
    run("cumsum", "n=1000003 random int32", c, cp,
        t(rng.integers(i32min, i32max, 1_000_003, endpoint=True)), 0)
    run("cumsum", "crosses 2^31 and 2^32", c, cp,
        t(np.full(4099, 1 << 30)), 0)
    run("cumsum", "carry_init near INT32_MAX", c, cp,
        t(rng.integers(0, 1000, 70_001)), i32max - 5)
    run("cumsum", "carry_init tensor", c, cp,
        t(rng.integers(-5, 5, 9_999)), t([i32min + 3]))

    # -- groupby_small (G=64 at 2^22) -----------------------------------
    g, gp = groupby_cuda.groupby_small, groupby_cuda.groupby_small_plain
    run("groupby_small", "G=64 n=2^22", g, gp,
        t(make_random(1 << 22, 0, 63, seed=3)),
        t(make_random(1 << 22, seed=4)), 64, timed=True)
    run("groupby_small", "G=4096 n=1000003", g, gp,
        t(rng.integers(0, 4096, 1_000_003)),
        t(rng.integers(1, 10000, 1_000_003)), 4096)
    run("groupby_small", "out of range and negative keys", g, gp,
        t(rng.choice([-1, i32min, 64, 65, 0, 63], 50_001)),
        t(rng.integers(1, 10000, 50_001)), 64)
    run("groupby_small", "single group, sums cross 2^32", g, gp,
        t(np.zeros(10_007)), t(np.full(10_007, 1 << 30)), 1)
    run("groupby_small", "n=1", g, gp, t([5]), t([-3]), 20)

    # -- weighted_histogram (G=2^16 at 2^20; hi 256 and the hi < 256
    #    contract of weighted_histogram_i8_pallas) ----------------------
    w, wp = hist_cuda.weighted_histogram, hist_cuda.weighted_histogram_plain
    run("weighted_histogram", "hi512 n=2^20", w, wp,
        t(make_random(1 << 20, 0, 65535, seed=5)),
        t(make_random(1 << 20, seed=6)), 512, timed=True)
    run("weighted_histogram", "hi256 n=2^20", w, wp,
        t(rng.integers(-3, 256 * 128 + 99, 1 << 20)),
        t(rng.integers(1, 10000, 1 << 20)), 256)
    run("weighted_histogram", "hi64 (G=5000) n=1000003", w, wp,
        t(rng.integers(0, 5000, 1_000_003)),
        t(rng.integers(1, 10000, 1_000_003)), 64)
    run("weighted_histogram", "all out of range", w, wp,
        t(rng.choice([-1, i32min, 8 * 128], 3_001)),
        t(rng.integers(1, 10000, 3_001)), 8)
    run("weighted_histogram", "single bin, sums cross 2^32", w, wp,
        t(np.full(20_011, 127)), t(np.full(20_011, i32max)), 1)
    run("weighted_histogram", "n=1", w, wp, t([65535]), t([9]), 512)
    return stats


def phase_dwarfs(device_flag):
    """The dwarfs through the CLI entry point on ``--device=device_flag``.
    Returns the
    launch counts of the whole phase."""
    from dwarf_bench_tpu_torch import cli, populate_registry
    from dwarf_bench_tpu_torch.ops import _build

    registry = populate_registry()
    with tempfile.TemporaryDirectory() as tmp:
        _build.reset_launches()
        for i, (name, rows, extra, path_kernels) in enumerate(DWARF_RUNS):
            before = dict(_build.LAUNCHES)
            csv = os.path.join(tmp, f"{i}_{name}.csv")
            argv = [name, f"--device={device_flag}", "--input_size", str(rows),
                    "--iterations=3", f"--report_path={csv}", *extra]
            rc = cli.main(argv)
            label = " ".join([name, str(rows), *extra])
            check(rc == 0, f"dwarf {label}: CLI exit code {rc}")
            results = [r.result for r in registry.find(name).get_results()]
            check(len(results) == 3, f"dwarf {label}: {len(results)} results")
            check(all(r.valid for r in results),
                  f"dwarf {label}: invalid result")
            for k in path_kernels:
                check(_build.LAUNCHES[k] > before[k],
                      f"dwarf {label}: kernel {k} was not launched")
            with open(csv) as f:
                header = f.readline().rstrip("\n")
            check(header == JAX_CSV_HEADER,
                  f"dwarf {label}: CSV header {header!r}")
            kt = results[0].kernel_time
            hosts = sorted(r.host_time for r in results)
            print(
                f"dwarf {label}: valid 3/3 kernel_time_ms={kt * 1e3!r} "
                f"rows_per_s={rows / kt!r} "
                f"median_host_time_ms={hosts[1] * 1e3!r}",
                flush=True,
            )
        launches = dict(_build.LAUNCHES)
    print(f"launches in the dwarf phase: {launches}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from dwarf_bench_tpu_torch.ops import _build

    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"nvcc: {nvcc_version(_build.nvcc_path())}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel library ready in {time.perf_counter() - t0!r} s "
          f"(nvcc build {_build.build_seconds!r} s)", flush=True)

    stats = phase_kernels(torch.device("cuda:0"))
    launches = phase_dwarfs("gpu")
    for name in KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the dwarfs")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
