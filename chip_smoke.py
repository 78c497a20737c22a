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
     JoinOmnisci 2^20, TwoPassScan, DPLScan and DPLScanCuda 2^24,
     ReduceDPCPP, SlabHashBuild, SlabProbe, SlabJoin, CuckooHashBuild,
     HashBuild, HashBuildNonBitmask and Join 2^24, NestedLoopJoin 2^14,
     three iterations each) and requires every result to be valid, every
     kernel of a dwarf's path to have launched in its run, and the CSV
     header to be the one the JAX package writes; then calls filter_sparse
     where its caps trip (the ``filter`` kernel's path) and, under CUDA's
     sync debug mode, where the dwarfs call it; then runs the BASELINE
     config-#4 hash extra (bench.py run_hash2p24_extra: slab build and
     16-bit probe, cuckoo build and ``has``, 2^24 keys, 2^24 probes at
     50 % hits) against a numpy oracle;
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
    "scan_tail_streams": ("dwarf_bench_tpu_torch/csrc/scan_tail.cu",
                          "dwarf_bench_tpu/ops/scan_tail_pallas.py:47"),
    "compact_mask": ("dwarf_bench_tpu_torch/csrc/compact.cu",
                     "dwarf_bench_tpu/ops/compact_pallas.py:195"),
    "emit_prefix": ("dwarf_bench_tpu_torch/csrc/compact.cu",
                    "dwarf_bench_tpu/ops/compact_pallas.py:225"),
    "filter": ("dwarf_bench_tpu_torch/csrc/filter.cu",
               "dwarf_bench_tpu/ops/scan_pallas.py:80"),
    "merge_bitonic": ("dwarf_bench_tpu_torch/csrc/bitonic.cu",
                      "dwarf_bench_tpu/ops/bitonic_pallas.py:100"),
    "merge_fill": ("dwarf_bench_tpu_torch/csrc/merge_fill.cu",
                   "dwarf_bench_tpu/ops/merge_fill_pallas.py:52"),
    "reduce_sum": ("dwarf_bench_tpu_torch/csrc/reduce.cu",
                   "dwarf_bench_tpu/ops/reduce.py:36"),
}

SCAN_KERNELS = ("scan_tail_streams", "compact_mask", "emit_prefix")
# the bulk hash probe: bitonic merge, fused fill, compaction before unsort
MERGE_KERNELS = ("merge_bitonic", "merge_fill", "compact_mask")

DWARF_RUNS = [
    # (dwarf, rows, extra CLI flags, kernels its path must launch)
    ("Radix", 1 << 22, [], ("histogram", "cumsum")),
    ("GroupBy", 1 << 22, ["--groups_count=64"], ("groupby_small",)),
    ("GroupBy", 1 << 20, ["--groups_count=65536"], ("weighted_histogram",)),
    ("JoinOmnisci", 1 << 20, [], ("histogram",)),
    # the reference's scan: x < 5 over 2^24 uniform [1, 10000] (bench.py
    # run_scan); DPLScanCuda is pinned to the GPU whatever --device says
    ("TwoPassScan", 1 << 24, [], SCAN_KERNELS),
    ("DPLScan", 1 << 24, [], SCAN_KERNELS),
    ("DPLScanCuda", 1 << 24, [], SCAN_KERNELS),
    ("ReduceDPCPP", 1 << 24, [], ("reduce_sum",)),
    # the hash family at the BASELINE config-#4 scale; the slab and cuckoo
    # dwarfs' bulk probes (2^24 queries on the card) take the merge engine
    ("SlabHashBuild", 1 << 24, [], MERGE_KERNELS),
    ("SlabProbe", 1 << 24, [], MERGE_KERNELS),
    ("SlabJoin", 1 << 24, [], MERGE_KERNELS),
    ("CuckooHashBuild", 1 << 24, [], MERGE_KERNELS),
    ("HashBuild", 1 << 24, [], ()),
    ("HashBuildNonBitmask", 1 << 24, [], ()),
    ("Join", 1 << 24, [], ()),
    # its (n, n) compare mask takes 256 MB at 2^14
    ("NestedLoopJoin", 1 << 14, [], ()),
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
    from dwarf_bench_tpu_torch.ops import (
        bitonic_cuda,
        compact_cuda,
        cumsum_cuda,
        filter_cuda,
        groupby_cuda,
        hist_cuda,
        merge_fill_cuda,
        merge_lookup,
        reduce_cuda,
        scan_tail_cuda,
    )
    from dwarf_bench_tpu_torch.ops.chunk_stats import chunk_stats
    from dwarf_bench_tpu_torch.utils.timing import kernel_time, sync

    rng = np.random.default_rng(20261016)
    stats = {name: {"max_abs_err": 0, "ms": None, "plain_ms": None}
             for name in KERNELS}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def whole(res):
        return [], [(res, res.numel())]

    def run(name, label, kernel, plain, *args, view=whole, timed=False):
        """Kernel against twin on ``args``. ``view`` maps a result to
        (counts, [(tensor, slots that hold data)]): a compaction's output is
        garbage past its count, so only the twin's slots are compared."""
        got_counts, got = view(sync(kernel(*args)))
        exp_counts, exp = view(sync(plain(*args)))
        err = max((abs(int(a) - int(b))
                   for a, b in zip(got_counts, exp_counts)), default=0)
        for g, (e, k) in zip((g for g, _ in got), exp):
            check(g.shape == e.shape and g.dtype == e.dtype,
                  f"{name} [{label}]: {g.shape}/{g.dtype} vs "
                  f"{e.shape}/{e.dtype}")
            if k:
                err = max(err, int((g[:k].to(torch.int64)
                                    - e[:k].to(torch.int64)).abs().max()))
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

    # -- the sparse scan's kernels (filter_sparse at 2^24, x < 5) --------
    def counted(cap):
        """View of (out, count) and (outs, count) results."""
        def view(res):
            outs, count = res
            outs = outs if isinstance(outs, tuple) else (outs,)
            return [count], [(o, min(int(count), cap)) for o in outs]
        return view

    def prefix(length):
        return lambda res: ([], [(res, length)])

    def tail(cap_single, cap_mc):
        def view(res):
            spos, sval, mids, mbase, ns, nm = res
            ks, km = min(int(ns), cap_single), min(int(nm), cap_mc)
            # spos is the sentinel past n_single: compared whole
            return [ns, nm], [(spos, cap_single), (sval, ks), (mids, km),
                              (mbase, km)]
        return view

    scan_n = 1 << 24
    scan_x = t(make_random(scan_n, seed=7))
    deep_x = make_random(1 << 20, seed=9)
    deep_x[rng.integers(0, 1 << 20, 1000)] = -700  # out-of-window singles

    f, fp = filter_cuda.filter, filter_cuda.filter_plain
    run("filter", "x<5 n=2^24", f, fp, scan_x, 5, scan_n,
        view=counted(scan_n), timed=True)
    run("filter", "x<5000 n=2^20 (sel50)", f, fp,
        t(make_random(1 << 20, seed=8)), 5000, 1 << 20,
        view=counted(1 << 20), timed=True)
    run("filter", "n=1", f, fp, t([4]), 5, 1, view=counted(1))
    run("filter", "nothing kept", f, fp, t(rng.integers(5, 10000, 70_001)),
        5, 70_001, view=counted(70_001))
    run("filter", "everything kept, unaligned n", f, fp,
        t(rng.integers(-100, 5, 100_003)), 5, 100_003,
        view=counted(100_003))
    run("filter", "count > capacity", f, fp,
        t(rng.integers(1, 10000, 1_000_003)), 5000, 4096,
        view=counted(4096))
    run("filter", "INT32_MIN and INT32_MAX", f, fp,
        t(rng.choice([i32min, i32max, 4, 5], 65_537)), 5, 65_537,
        view=counted(65_537))
    run("filter", "threshold INT32_MIN", f, fp, t([i32min, 0]), i32min, 2,
        view=counted(2))

    st, stp = scan_tail_cuda.scan_tail_streams, \
        scan_tail_cuda.scan_tail_streams_plain
    stat, base = chunk_stats(scan_x.view(-1, 128), 5)
    run("scan_tail_streams", "chunk_stats of the 2^24 scan", st, stp,
        stat, base, 5, 16384, 512, view=tail(16384, 512), timed=True)
    dstat, dbase = chunk_stats(t(deep_x).view(-1, 128), 5)
    run("scan_tail_streams", "out-of-window singles", st, stp,
        dstat, dbase, 5, 16384, 512, view=tail(16384, 512))
    run("scan_tail_streams", "counts > caps", st, stp,
        dstat, dbase, 5, 7, 3, view=tail(7, 3))
    run("scan_tail_streams", "nch=1", st, stp, t([512 + 3]), t([0]), 5,
        16384, 512, view=tail(16384, 512))

    cm, cmp = compact_cuda.compact_mask, compact_cuda.compact_mask_plain
    gm = torch.from_numpy(rng.random(65536) < 2 / 128).to(dev)
    run("compact_mask", "65536 rows x 2 cols, capacity 4096", cm, cmp, gm,
        (t(rng.integers(0, scan_n, 65536)), t(rng.integers(1, 5, 65536))),
        4096, view=counted(4096), timed=True)
    scan_mask = scan_x < 5
    run("compact_mask", "2^24 rows x 1 col", cm, cmp, scan_mask, (scan_x,),
        scan_n, view=counted(scan_n), timed=True)
    run("compact_mask", "2^24 rows x 3 cols", cm, cmp, scan_mask,
        (scan_x, scan_x + 1, scan_x - 1), scan_n, view=counted(scan_n),
        timed=True)
    def ones(n, keep):
        return torch.full((n,), keep, dtype=torch.bool, device=dev)

    run("compact_mask", "n=1", cm, cmp, ones(1, True), (t([i32min]),), 1,
        view=counted(1))
    run("compact_mask", "nothing kept", cm, cmp, ones(70_001, False),
        (t(rng.integers(0, 9, 70_001)),), 70_001, view=counted(70_001))
    run("compact_mask", "everything kept, count > capacity", cm, cmp,
        ones(100_003, True), (t(rng.integers(i32min, i32max, 100_003)),) * 3,
        4096, view=counted(4096))

    e, ep = compact_cuda.emit_prefix, compact_cuda.emit_prefix_plain
    run("emit_prefix", "L=20480 into 2^24", e, ep,
        t(rng.integers(i32min, i32max, 20480)), scan_n, view=prefix(20480),
        timed=True)
    run("emit_prefix", "L = capacity", e, ep, t(np.arange(128)), 128,
        view=prefix(128))
    run("emit_prefix", "L=37, capacity 40", e, ep,
        t(rng.integers(i32min, i32max, 37)), 40, view=prefix(37))
    run("emit_prefix", "L=0", e, ep, t([]), 16, view=prefix(0))

    # -- the bulk hash probe's kernels at the config-#4 shapes: 2^24 table
    #    rows and 2^24 probes merge into N = 2^25 ------------------------
    def columns(res):
        return [], [(c, c.numel()) for c in res]

    keys, vals, probes = config4_data()
    sk, sv = merge_lookup.sort_table(t(keys), t(vals))
    dp = t(probes)
    nq = probes.size
    in16 = merge_lookup.merge_columns(sk, sv, dp, 16)
    in32 = merge_lookup.merge_columns(sk, sv, dp, 32)
    inm = merge_lookup.merge_columns(sk, sv, dp, membership=True)
    mb, mbp = bitonic_cuda.merge_bitonic, bitonic_cuda.merge_bitonic_plain
    run("merge_bitonic", "N=2^25 x 2 cols (val16)", mb, mbp, in16, 2,
        view=columns, timed=True)
    run("merge_bitonic", "N=2^25 x 3 cols (val32)", mb, mbp, in32, 2,
        view=columns, timed=True)

    def bitonic(n, ncols, key_hi):
        """(key, aux) ascending then descending, ties included."""
        k = rng.integers(0, key_hi, n, dtype=np.uint64)
        a = rng.integers(0, 4, n, dtype=np.uint64)
        cut = n // 3
        o1, o2 = np.lexsort((a[:cut], k[:cut])), np.lexsort((a[cut:], k[cut:]))
        cols = [np.concatenate([k[:cut][o1], k[cut:][o2][::-1]]),
                np.concatenate([a[:cut][o1], a[cut:][o2][::-1]])]
        cols += [rng.integers(0, 2**32, n, dtype=np.uint64)
                 for _ in range(ncols - 2)]
        return tuple(t(c.astype(np.uint32).view(np.int32)) for c in cols)

    run("merge_bitonic", "N=1", mb, mbp, bitonic(1, 2, 2**32), 2,
        view=columns)
    run("merge_bitonic", "N=1024 < tile, ties", mb, mbp,
        bitonic(1024, 3, 20), 2, view=columns)
    run("merge_bitonic", "N=4096, one global stride", mb, mbp,
        bitonic(4096, 2, 2**32), 2, view=columns)
    run("merge_bitonic", "N=2^20 x 4 cols, keys >= 2^31, ties", mb, mbp,
        bitonic(1 << 20, 4, 2**32), 2, view=columns)
    run("merge_bitonic", "N=2^20 x 4 cols, num_cmp=1, ties", mb, mbp,
        bitonic(1 << 20, 4, 1000), 1, view=columns)

    mf, mfp = merge_fill_cuda.merge_fill, merge_fill_cuda.merge_fill_plain
    m16, m32, mm = (mb(c, 2) for c in (in16, in32, inm))
    run("merge_fill", "N=2^25 val32", mf, mfp, m32[0], m32[1], m32[2], nq,
        False, False, view=columns, timed=True)
    run("merge_fill", "N=2^25 val16", mf, mfp, m16[0], m16[1], None, nq,
        True, False, view=columns, timed=True)
    run("merge_fill", "N=2^25 membership", mf, mfp, mm[0], mm[1], None, nq,
        False, True, view=columns, timed=True)
    del in16, in32, inm, m16, m32, mm
    for n_any in (1, 1025, 1_000_003):
        cols = [t(rng.integers(i32min, i32max, n_any, endpoint=True))
                for _ in range(3)]
        for mode, flags in (("val32", (False, False)), ("val16", (True, False)),
                            ("membership", (False, True))):
            run("merge_fill", f"any length n={n_any} {mode}", mf, mfp,
                *cols, n_any // 2, *flags, view=columns)

    r, rp = reduce_cuda.reduce_sum, reduce_cuda.reduce_sum_plain

    def scalar(res):
        return [res], []

    run("reduce_sum", "n=2^24 in [1, 10000]", r, rp,
        t(make_random(1 << 24, seed=10)), view=scalar, timed=True)
    run("reduce_sum", "n=0", r, rp, t([]), view=scalar)
    run("reduce_sum", "n=1", r, rp, t([i32min]), view=scalar)
    run("reduce_sum", "sums wrap past 2^31 and 2^32", r, rp,
        t(np.full(4099, 1 << 30)), view=scalar)
    wide = t(rng.integers(i32min, i32max, 1_000_004, endpoint=True))
    run("reduce_sum", "n=1000003 random int32", r, rp, wide[:-1],
        view=scalar)
    run("reduce_sum", "misaligned start", r, rp, wide[1:], view=scalar)
    return stats


def config4_data():
    """BASELINE config #4 as bench.py run_hash2p24_extra sets it up, from a
    fresh ``default_rng(0)``: 2^24 distinct keys in [1, 2^25], values in
    [1, 10000], and 2^24 probes, the first half inserted keys, the second
    half absent keys past 4n."""
    n = 1 << 24
    rng = np.random.default_rng(0)
    keys = rng.permutation(2 * n)[:n].astype(np.uint32) + 1
    vals = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    probes = np.empty(n, np.uint32)
    probes[: n // 2] = keys[: n // 2]
    probes[n // 2:] = rng.integers(0, n, n // 2).astype(np.uint32) \
        + np.uint32(4 * n)
    return keys, vals, probes


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
        scan_ops(torch.device("cuda:0"))
        hash_ops(torch.device("cuda:0"))
        launches = dict(_build.LAUNCHES)
    print(f"launches in the dwarf phase: {launches}", flush=True)
    return launches


def scan_ops(dev):
    """filter_sparse called directly, where the dwarfs cannot reach:
    - the caps trip (2^20 rows, x < 5000: the data and predicate of bench.py
      run_scan_sel50_extra) with assume_sparse=False, so the general
      ``filter`` kernel runs, and the result must equal filter_oracle;
    - the dwarfs' assume_sparse=True call at 2^24 under CUDA's sync debug
      mode "error", which raises if anything reads the card back to the
      host between the input and the returned (out, count)."""
    from dwarf_bench_tpu_torch.common.datagen import make_random
    from dwarf_bench_tpu_torch.ops import _build, scan
    from dwarf_bench_tpu_torch.utils.timing import kernel_time

    x = make_random(1 << 20, seed=8)
    xd = torch.from_numpy(x).to(dev)
    before = _build.LAUNCHES["filter"]
    check(not scan.sparse_caps_ok(x, 5000), "sel50 data fits the sparse caps")
    out, count = scan.filter_sparse(xd, 5000)
    expected = scan.filter_oracle(x, 5000)
    check(int(count) == len(expected) and np.array_equal(
        out[: len(expected)].cpu().numpy(), expected),
        "filter_sparse 2^20 x<5000: differs from filter_oracle")
    check(_build.LAUNCHES["filter"] > before,
          "filter_sparse 2^20 x<5000: kernel filter was not launched")
    ms = kernel_time(scan.filter_sparse, xd, 5000) * 1e3
    print(f"filter_sparse 2^20 x<5000 (caps trip): valid, "
          f"kernel_time_ms={ms!r}", flush=True)

    x = make_random(1 << 24, seed=7)
    xd = torch.from_numpy(x).to(dev)
    check(scan.sparse_caps_ok(x), "scan data does not fit the sparse caps")
    scan.filter_sparse(xd, assume_sparse=True)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, count = scan.filter_sparse(xd, assume_sparse=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    expected = scan.filter_oracle(x)
    check(int(count) == len(expected) and np.array_equal(
        out[: len(expected)].cpu().numpy(), expected),
        "filter_sparse 2^24 x<5: differs from filter_oracle")
    print("filter_sparse 2^24 x<5 assume_sparse: valid, no host read",
          flush=True)


def hash_ops(dev):
    """The BASELINE config-#4 extra (bench.py:301-372) on the card: a slab
    build over 2^24 distinct keys and ``find(val_bits=16)`` over 2^24
    probes at 50 % hits (the only caller of the val16 fill), then a cuckoo
    build at 4n slots with bench.py's seeds and re-seed loop, and ``has``.
    Every answer is held to a numpy oracle (binary search in the sorted
    keys); the probes must launch the merge path's kernels."""
    from dwarf_bench_tpu_torch.ops import _build, bucket_hash, cuckoo
    from dwarf_bench_tpu_torch.utils.timing import kernel_time, sync

    keys, vals, probes = config4_data()
    n = keys.size
    order = np.argsort(keys)
    ks, vs = keys[order], vals[order]
    pos = np.minimum(np.searchsorted(ks, probes), n - 1)
    exp_found = ks[pos] == probes
    exp_val = np.where(exp_found, vs[pos], 0).astype(np.uint32)

    def put(a):
        return torch.from_numpy(a.view(np.int32)).to(dev)

    dk, dv, dp = put(keys), put(vals), put(probes)
    nb = bucket_hash.calculate_buckets_count(n)
    sync(bucket_hash.build(dk, dv, nb))  # warm
    t0 = time.perf_counter()
    tbl = sync(bucket_hash.build(dk, dv, nb))
    t_build = time.perf_counter() - t0
    before = dict(_build.LAUNCHES)
    found, val = sync(bucket_hash.find(tbl, dp, val_bits=16))
    for k in MERGE_KERNELS:
        check(_build.LAUNCHES[k] > before[k],
              f"slab find 2^24: kernel {k} was not launched")
    check(np.array_equal(found.cpu().numpy(), exp_found)
          and np.array_equal(val.cpu().numpy().view(np.uint32), exp_val),
          "slab find(val_bits=16) 2^24: differs from the numpy oracle")
    t_probe = kernel_time(lambda tb, q: bucket_hash.find(tb, q, val_bits=16),
                          tbl, dp, k=5)
    print(f"hash_ops slab 2^24: valid build_ms={t_build * 1e3!r} "
          f"probe_hit50_ms={t_probe * 1e3!r} "
          f"probe_rows_per_s={n / t_probe!r} "
          f"overflow={int(tbl.overflow_count)}", flush=True)
    del tbl, found, val

    t0 = time.perf_counter()
    for attempt in range(5):  # bench.py's host rebuild loop
        seeds = (0x9E3779B9 + attempt, 0x85EBCA6B + 2 * attempt)
        ct = sync(cuckoo.build(dk, 4 * n, *seeds, 256))
        if ct.success:
            break
    t_cuckoo = time.perf_counter() - t0
    check(ct.success, f"cuckoo build 2^24: no convergence in "
                      f"{attempt + 1} attempts")
    t0 = time.perf_counter()
    sync(cuckoo.build(dk, 4 * n, *seeds, 256))
    t_warm = time.perf_counter() - t0
    before = dict(_build.LAUNCHES)
    found = sync(cuckoo.has(ct, dp))
    for k in MERGE_KERNELS:
        check(_build.LAUNCHES[k] > before[k],
              f"cuckoo has 2^24: kernel {k} was not launched")
    check(np.array_equal(found.cpu().numpy(), exp_found),
          "cuckoo has 2^24: differs from the numpy oracle")
    t_has = kernel_time(cuckoo.has, ct, dp, k=5)
    print(f"hash_ops cuckoo 2^24: valid build_ms={t_cuckoo * 1e3!r} "
          f"warm_build_ms={t_warm * 1e3!r} rounds={ct.rounds} "
          f"attempts={attempt + 1} has_hit50_ms={t_has * 1e3!r} "
          f"has_rows_per_s={n / t_has!r}", flush=True)


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

    t1 = time.perf_counter()
    stats = phase_kernels(torch.device("cuda:0"))
    t2 = time.perf_counter()
    launches = phase_dwarfs("gpu")
    print(f"phase seconds: kernels {t2 - t1!r}, dwarfs and ops "
          f"{time.perf_counter() - t2!r}, whole script "
          f"{time.perf_counter() - t0!r}", flush=True)
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
