"""The size sweeps: the port of ``scripts/run_sweeps_tpu.sh`` and the ten
``scripts/benchmark_*.sh`` grids, over the port's CLI.

    python -m dwarf_bench_tpu_torch.scripts.sweeps [GRID ...] [--out DIR]
        [--devices gpu[,cpu]] [--sizes N ...] [--iterations K]
        [--timeout SECONDS]

``GRIDS`` holds one entry for each ``.sh`` file: its dwarfs, sizes, CSV name
and iterations, and the devices of its halves. The accelerator half is
``gpu`` (the ``.sh`` files' ``--device=tpu``); the ``*_cuda`` grids pin the
card through the ``*Cuda`` dwarfs, and ``hash_large`` (BASELINE config #4's
sweep, whose ``SIZES`` and ``ITER`` ``--sizes`` and ``--iterations``
override) runs on the accelerator only. The CPU half of a grid runs only
when asked for (``--devices cpu`` or ``--devices gpu,cpu``). With no GRID
every grid runs.

``run_sweep`` is ``run_sweeps_tpu.sh``: one CLI process per (dwarf, size),
so that each finished size has its rows in the CSV at once; a size whose
(device_type, buf_size_bytes) row the CSV already holds is skipped (the
device is part of the check: a CSV may hold the CPU half of a grid, and
then the GPU half must still run); each size has its own time limit; a
``.log`` beside the CSV keeps each size's stderr, and a size that fails
(an exit code other than 0, a time limit, or a run that is not valid) is
recorded there as ``FAILED <dwarf> <size> (rc N)``. The runner exits 1 if
any size failed. A grid runs its sizes largest first, so that a fault at
the top of a grid shows before its small sizes.

The CSV has no dwarf column: grids that share a CSV name (``radix_large``
and ``radix_large_cuda``, the scan grids) skip each other's sizes when they
write into one directory, so give each its own ``--out`` to run both.
CSVs go to ``--out`` (default: the current directory), never to the
repository's ``results/sweeps/``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from . import check_out

SMALL = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
# 100 KiB, 1, 2, 4 ... 512 MiB of int32
LARGE = (25600, 262144, 524288, 1048576, 2097152, 4194304, 8388608,
         16777216, 33554432, 67108864, 134217728)
BOTH = ("gpu", "cpu")
CARD = ("gpu",)


class Grid(NamedTuple):
    dwarfs: Tuple[str, ...]
    sizes: Tuple[int, ...]
    # the CSV's file name; "{dwarf}" stands for the dwarf's name in lower case
    csv: str
    iterations: int
    devices: Tuple[str, ...]


GRIDS: Dict[str, Grid] = {
    "dplscan_large": Grid(("DPLScan",), LARGE, "report_dpl_scan.csv", 9,
                          BOTH),
    "dplscan_large_cuda": Grid(("DPLScanCuda",), LARGE,
                               "report_dpl_scan.csv", 9, CARD),
    "dplscan_small": Grid(("DPLScan",), SMALL, "report_dpl_scan_small.csv",
                          9, BOTH),
    "dplscan_small_cuda": Grid(("DPLScanCuda",), SMALL,
                               "report_dpl_scan_small.csv", 9, CARD),
    "hash_large": Grid(("CuckooHashBuild", "SlabHashBuild", "SlabProbe"),
                       (1048576, 4194304, 16777216), "report_{dwarf}.csv", 9,
                       CARD),
    "radix_large": Grid(("Radix",), LARGE, "report_radix.csv", 9, BOTH),
    "radix_large_cuda": Grid(("RadixCuda",), LARGE, "report_radix.csv", 9,
                             CARD),
    "radix_small": Grid(("Radix",), SMALL, "report_radix_small.csv", 9,
                        BOTH),
    "radix_small_cuda": Grid(("RadixCuda",), SMALL, "report_radix_small.csv",
                             9, CARD),
    "twopassscan": Grid(("TwoPassScan",), LARGE, "report.csv", 9, BOTH),
}

# the package's parent, put on the CLI processes' path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_VALID = re.compile(r"^\[(\S+)\] (\d+)/(\d+) runs valid$", re.M)
_LAUNCHES = re.compile(r"^launches: (\{.*\})$", re.M)


class Sweep(NamedTuple):
    ran: List[int]
    skipped: List[int]
    failed: List[str]  # the log's FAILED lines
    launches: collections.Counter  # the CUDA kernel launches of the runs


def csv_name(grid: Grid, dwarf: str) -> str:
    return grid.csv.format(dwarf=dwarf.lower())


def recorded(csv: str, device: str, size: int) -> bool:
    """Whether ``csv`` holds a row of ``device`` ("gpu" or "cpu") at
    ``size`` elements: its second column is buf_size_bytes = size * 4."""
    if not os.path.exists(csv):
        return False
    prefix = f"{device.upper()},{size * 4},"
    with open(csv) as f:
        return any(line.startswith(prefix) for line in f)


def _cli(dwarf: str, size: int, csv: str, iterations: int,
         device: str) -> List[str]:
    return [sys.executable, "-m", "dwarf_bench_tpu_torch", dwarf,
            f"--device={device}", "--input_size", str(size),
            f"--report_path={csv}", f"--iterations={iterations}",
            "--print_launches"]


def _env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH", "")) if p)
    return env


def run_sweep(dwarf: str, csv: str, iterations: int, sizes: Sequence[int],
              device: str = "gpu", timeout: float = 3600.0) -> Sweep:
    """One CLI process of ``dwarf`` on ``device`` for each size of
    ``sizes`` not yet in ``csv``, in the order given, appending to ``csv``
    and to the ``.log`` beside it."""
    log_path = os.path.splitext(csv)[0] + ".log"
    out = Sweep([], [], [], collections.Counter())
    for size in sizes:
        if recorded(csv, device, size):
            print(f"skip {dwarf} {size} (already in {csv})", flush=True)
            out.skipped.append(size)
            continue
        head = f"=== {dwarf} size {size} ==="
        print(head, flush=True)
        try:
            proc = subprocess.run(_cli(dwarf, size, csv, iterations, device),
                                  capture_output=True, text=True,
                                  timeout=timeout, env=_env())
            rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:  # the child is killed
            rc = 124
            stdout = _text(e.stdout)
            stderr = _text(e.stderr) + f"timed out after {timeout} s\n"
        sys.stdout.write(stdout)
        sys.stderr.write(stderr)
        valid = _VALID.search(stderr)
        ok = (rc == 0 and valid is not None
              and valid.group(2) == valid.group(3) != "0")
        lines = [head, stderr.rstrip("\n")]
        if ok:
            out.ran.append(size)
            found = _LAUNCHES.search(stderr)
            if found:
                out.launches.update(json.loads(found.group(1)))
        else:
            why = "" if rc != 0 else (
                f", {valid.group(2)}/{valid.group(3)} runs valid" if valid
                else ", no validity line")
            failed = f"FAILED {dwarf} {size} (rc {rc}{why})"
            print(failed, flush=True)
            out.failed.append(failed)
            lines.append(failed)
        with open(log_path, "a") as f:
            f.write("\n".join(line for line in lines if line) + "\n")
    return out


def _text(b) -> str:
    if b is None:
        return ""
    return b.decode(errors="replace") if isinstance(b, bytes) else b


def run_grid(name: str, out_dir: str, devices: Sequence[str],
             sizes: Optional[Sequence[int]] = None,
             iterations: Optional[int] = None,
             timeout: float = 3600.0) -> Dict[Tuple[str, str], Sweep]:
    """Each dwarf of grid ``name`` on each of ``devices`` that the grid has,
    its sizes (``sizes`` if given) largest first, into ``out_dir``. Returns
    {(dwarf, device): Sweep}."""
    grid = GRIDS[name]
    order = sorted(grid.sizes if sizes is None else sizes, reverse=True)
    iters = grid.iterations if iterations is None else iterations
    os.makedirs(out_dir, exist_ok=True)
    done = {}
    for device in (d for d in grid.devices if d in devices):
        for dwarf in grid.dwarfs:
            csv = os.path.join(out_dir, csv_name(grid, dwarf))
            done[(dwarf, device)] = run_sweep(dwarf, csv, iters, order,
                                              device, timeout)
    return done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("grids", nargs="*",
                   help=f"grids to run (default: all): {', '.join(GRIDS)}")
    p.add_argument("--out", default=".", help="directory of the CSVs")
    p.add_argument("--devices", default="gpu",
                   help="halves to run: gpu (the default: the card), cpu, "
                        "or gpu,cpu")
    p.add_argument("--sizes", type=int, nargs="+", default=None,
                   help="sizes in place of each grid's")
    p.add_argument("--iterations", type=int, default=None,
                   help="iterations in place of each grid's")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="seconds a size may take")
    args = p.parse_args(argv)
    devices = tuple(d.strip() for d in args.devices.split(","))
    for d in devices:
        if d not in BOTH:
            p.error(f"--devices: {d!r} is neither gpu nor cpu")
    for name in args.grids:
        if name not in GRIDS:
            p.error(f"no grid {name!r}: {', '.join(GRIDS)}")
    if "gpu" in devices:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--devices gpu: CUDA is not available; pass "
                               "--devices cpu to sweep on the CPU")
    check_out(args.out)
    failed = []
    for name in args.grids or GRIDS:
        for sweep in run_grid(name, args.out, devices, args.sizes,
                              args.iterations, args.timeout).values():
            failed += sweep.failed
    for line in failed:
        print(line, file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
