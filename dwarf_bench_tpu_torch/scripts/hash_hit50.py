"""BASELINE config #4 at 50 % hits: the port of
``scripts/benchmark_hash_hit50.py``. A slab table and a cuckoo table are
built from 2^lg distinct keys and probed with 2^lg queries, the first half
inserted keys and the second half keys that are absent, 9 iterations each.

The registered dwarfs probe every inserted key (the reference's
hash/cuckoo_hash_build.cpp:101-119, probe/slab_probe.cpp:78-95); this
harness makes the mixed probe set itself:

  * keys: ``make_unique_random(n, seed=1234)``, distinct in [1, 10n];
  * probes, from ``default_rng(99)``: half a permutation's prefix of the
    keys, half absent keys in [2^28, 2^28 + n) (10n < 2^28 up to n = 2^24);
  * values in [1, 10000], from the same generator.

Slab: ``bucket_hash.build``, then ``find(val_bits=16)`` (every value is
below 2^16). Cuckoo: ``cuckoo.build`` at 4n slots with ``max_iters =
min(n, 256)`` and the host re-seed loop (at most 7 attempts, seeds
0x9E3779B9 + a and 0x85EBCA6B + 2a), then ``has``. Each probe is checked
on the device (hits == n / 2 and no false hit) before it is timed; a
failed check, or a cuckoo build that does not converge, raises.

Each phase writes 9 rows to ``<out>/report_hash_hit50.csv`` in the
reference schema (``device_type,buf_size_bytes,host_time_ms,
kernel_time_ms``: host_time the fenced wall time of one probe call,
kernel_time the queue-k slope of ``utils/timing.time_amortized``) and a
side log (``report_hash_hit50.log``) with the builds' times, the cuckoo
attempts and rounds, and the rates.

    python -m dwarf_bench_tpu_torch.scripts.hash_hit50 [lg (24)]
        [all|slab|cuckoo] [--device gpu|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from functools import partial

import numpy as np
import torch

from ..common.datagen import make_unique_random
from ..common.device import resolve_device
from ..common.options import parse_device_type
from ..ops import bucket_hash, cuckoo
from ..utils.timing import sync, time_amortized, timed
from . import check_out

HEADER = "device_type,buf_size_bytes,host_time_ms,kernel_time_ms"
ITERATIONS = 9
ATTEMPTS = 7


class Hit50Failure(RuntimeError):
    pass


def hit50_data(n: int):
    """(keys, vals, probes), uint32: the reference harness's data."""
    keys = make_unique_random(n, seed=1234)  # distinct, in [1, 10n]
    rng = np.random.default_rng(99)
    probes = np.empty(n, np.uint32)
    half = n // 2
    probes[:half] = rng.permutation(keys)[:half]
    # absent: keys live in [1, 10n] <= 10*2^24 < 2^28; take [2^28, 2^28+n)
    probes[half:] = (
        rng.integers(0, n, n - half).astype(np.uint32) + np.uint32(1 << 28)
    )
    vals = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    return keys, vals, probes


class Harness:
    """The CSV, the log and the device check of one run."""

    def __init__(self, n: int, device: torch.device, out_dir: str):
        self.n = n
        self.half = n // 2
        self.device_ty = "CPU" if device.type == "cpu" else "GPU"
        os.makedirs(out_dir, exist_ok=True)
        self.csv = os.path.join(out_dir, "report_hash_hit50.csv")
        self.logf = os.path.join(out_dir, "report_hash_hit50.log")

    def log(self, msg: str) -> None:
        print(msg, flush=True)
        with open(self.logf, "a") as f:
            f.write(msg + "\n")

    def csv_row(self, host_ms: float, kernel_ms: float) -> None:
        need_header = not os.path.exists(self.csv)
        with open(self.csv, "a") as f:
            if need_header:
                f.write(HEADER + "\n")
            f.write(f"{self.device_ty},{self.n * 4},{host_ms:.3f},"
                    f"{kernel_ms:.3f}\n")

    def validate(self, found: torch.Tensor, what: str) -> None:
        """hits == n / 2 in the first half and none in the second, summed
        on the device; raises otherwise."""
        f = found.to(torch.int32)
        hits = int(f[: self.half].sum())
        misses = int(f[self.half:].sum())
        ok = hits == self.half and misses == 0
        self.log(f"  validation: hits {hits}/{self.half}, false hits "
                 f"{misses} -> {'VALID' if ok else 'INVALID'}")
        if not ok:
            raise Hit50Failure(f"{what} 50%-hit probe validation failed")

    def probe_rows(self, what: str, fn, *args) -> None:
        for it in range(ITERATIONS):
            _, t_host = timed(fn, *args)
            t_k = time_amortized(fn, *args)
            self.csv_row(t_host * 1e3, t_k * 1e3)
            self.log(f"{what} probe iter {it}: host {t_host * 1e3:.1f} ms, "
                     f"kernel {t_k * 1e3:.3f} ms = "
                     f"{self.n / t_k / 1e9:.3f} Grows/s")


def run_slab(h: Harness, dk, dv, dp) -> torch.Tensor:
    """Slab build and ``find(val_bits=16)``; returns ``found``."""
    n = h.n
    nb = bucket_hash.calculate_buckets_count(n)
    build_fn = partial(bucket_hash.build, num_buckets=nb)
    tbl, t0 = timed(build_fn, dk, dv)  # warm
    _, t_build = timed(build_fn, dk, dv)
    h.log(f"slab build: {t_build * 1e3:.1f} ms (buckets={nb}; first "
          f"{t0:.1f} s); {n / t_build / 1e9:.3f} Grows/s")
    # val_bits=16 is host knowledge (values are [1, 10000]), as in radix
    find = partial(bucket_hash.find, val_bits=16)
    found, _ = sync(find(tbl, dp))
    h.validate(found, "slab")
    h.probe_rows("slab", find, tbl, dp)
    return found


def run_cuckoo(h: Harness, dk, dp) -> torch.Tensor:
    """Cuckoo build at 4n with the re-seed loop, and ``has``; returns the
    membership vector."""
    n = h.n
    ht_size = 4 * n  # cuckoo_hash_build.cpp:14
    # a rounds cap, not the reference's per-key chain bound; the host
    # re-seeds on failure (dwarfs/hash_build.py)
    max_iters = min(n, 256)
    t0 = time.perf_counter()
    for attempt in range(ATTEMPTS):  # cuckoo_hash_build.cpp:43-93
        seeds = (0x9E3779B9 + attempt, 0x85EBCA6B + 2 * attempt)
        tbl, t_try = timed(cuckoo.build, dk, ht_size, *seeds, max_iters)
        h.log(f"cuckoo build attempt {attempt}: {t_try:.2f} s, "
              f"rounds={tbl.rounds}, converged={tbl.success}")
        if tbl.success:
            break
    h.log(f"cuckoo build total: {time.perf_counter() - t0:.1f} s; "
          f"attempts={attempt + 1}")
    if not tbl.success:
        raise Hit50Failure(f"cuckoo build did not converge in {ATTEMPTS} "
                           "attempts")
    _, t_warm = timed(cuckoo.build, dk, ht_size, tbl.seed1, tbl.seed2,
                      max_iters)
    h.log(f"cuckoo build (warm, winning seeds): {t_warm * 1e3:.1f} ms = "
          f"{n / t_warm / 1e9:.4f} Grows/s")
    found = sync(cuckoo.has(tbl, dp))
    h.validate(found, "cuckoo")
    h.probe_rows("cuckoo", cuckoo.has, tbl, dp)
    return found


def run(lg: int, phase: str, device: torch.device, out_dir: str) -> dict:
    """Both phases (or one) at n = 2^lg; returns {phase: found}."""
    n = 1 << lg
    h = Harness(n, device, out_dir)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    h.log(f"=== hash hit50 n=2^{lg} on {name} "
          f"({time.strftime('%Y-%m-%d %H:%M:%S')}) ===")
    keys, vals, probes = hit50_data(n)
    dk, dv, dp = (torch.from_numpy(a.view(np.int32)).to(device)
                  for a in (keys, vals, probes))
    sync(dp)
    found = {}
    if phase in ("all", "slab"):
        found["slab"] = run_slab(h, dk, dv, dp)
    if phase in ("all", "cuckoo"):
        found["cuckoo"] = run_cuckoo(h, dk, dp)
    h.log("=== hash hit50 done ===")
    return found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("lg", nargs="?", type=int, default=24, help="log2 n")
    p.add_argument("phase", nargs="?", default="all",
                   choices=("all", "slab", "cuckoo"))
    p.add_argument("--device", default="gpu",
                   help="gpu (the default: the card) or cpu")
    p.add_argument("--out", default=".", help="directory of the CSV and log")
    args = p.parse_args(argv)
    run(args.lg, args.phase, resolve_device(parse_device_type(args.device)),
        check_out(args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
