#!/usr/bin/env python3
"""Smoke run of dwarf_bench_tpu_torch on one CUDA GPU (an H100 for this port).

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels from ``csrc/``
with nvcc, then:

  1. prints the card (``nvidia-smi`` name and power limit), the torch, CUDA
     and nvcc versions, and the kernel build time;
  2. runs each kernel, under each JAX name it serves, against its plain
     PyTorch twin on the card, at the shapes the dwarfs and the library
     paths give it and on edge cases, and requires exact agreement (every
     output is an integer); prints both times, the time of one PyTorch
     library call of the same function where there is one (CUDA events and
     profiler device time), and the bound (the least time the card could
     take: bytes over 3.35 TB/s or operations over 67 TOP/s, whichever is
     larger; for the lock kernel, one L2 round trip of an atomic per
     serialized acquisition, measured on the card by a chain of dependent
     atomics and printed with the card); the count histogram under plans
     the card cannot hold at once (every block a merger), each in a
     subprocess under a time limit: the cooperative launch must be refused
     and the next call exact; emit_prefix with the scan's index (its
     gather folded in) and without; cumsum, histogram and weighted_histogram
     and their library
     calls are also timed with the L2 flushed before each call, and
     merge_bitonic, merge_fill, reduce_sum, vadd and histogram as replays
     of a captured CUDA graph; groupby_small both ways at G = 64 and at
     GroupByLocal's G = 4096 (64 executors x 64) over 2^22 rows, on one
     hot key and on a view off 4 bytes, and once under CUDA's sync debug
     mode;
     filter, compact_mask and scan_tail_streams both ways, compact_mask also
     at the merge probe's 2^25 rows x 2 columns and x 1 (membership) and at
     the CSR build's 2^20 x 2; a profiler time below the bound is flagged
     (every timed case is in its name's ``cases``); cumsum runs with an int
     carry under CUDA's sync debug mode, and both under a non-default
     stream; merge_bitonic at every N = 2^k up to 2^22 (2 and 4 columns,
     num_cmp 1 and 2); merge_fill at its tile boundaries, on misaligned
     views, five times back to back and on two streams; reduce_sum three
     times back to back on one stream and on two streams at once; vadd at
     its tile boundaries, aligned and misaligned; the CUDA kernels and
     memsets one call puts on the card, counted as the nodes of a captured
     CUDA graph, must be one a pass of the plan for merge_bitonic at 2^25
     (3), one kernel and no memset for merge_fill in each mode, reduce_sum,
     vadd (aligned or not), compact_mask (1-3 columns), filter,
     scan_tail_streams, the histogram (hi80 2^22, hi128 2^20),
     grid_accumulate (64 and 2^16 blocks, with the time an acquisition),
     groupby_small (G = 64, 2^22 rows) and gb_diag in each mode (also
     timed cold and as graph replays),
     and two
     kernels and no memset for the scan's phase A (chunk_stats, cumsum);
     the three compactions run back to back on one stream and three times
     on each of two streams;
     and, at the sweeps' largest size (2^27 rows), the hi80 histogram
     (whose plan must store 32-bit copies), Radix's run-expansion cumsum
     with an int carry, chunk_stats and scan_tail_streams over 2^20 chunks,
     each against its twin and timed beside it;
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
     then (``phase_cliffs``, with the launch counts set to 0) the adaptive
     engines' dispatch cliffs and the engine fuzz (``utils/cliffs.py``:
     every case of the JAX package's tests/test_cliffs_slow.py and
     tests/test_engine_fuzz.py at their sizes, and the filter caps' and
     sort spans' exact boundaries), one line a case with its branch,
     count, exactness, ms and reads back to the host; a case that is not
     exact, takes another branch than the host predicts, does not launch
     its branch's kernels, or reads back other than ``ops.trace.READS``
     documents fails the run;
  4. drives this slice's library paths with the launch counts set to 0:
     filter_sparse(stats_pallas=True and False) at 2^24 (x < 5) and 2^20
     (x < 5000, caps trip) against filter_oracle, timed beside
     stats_pallas=None, and stats_pallas=True with assume_sparse=True under
     the sync debug mode; the general CSR join at 2^20 (build + probe_merge,
     probe_merge_bitonic, probe, probe_sorted) against the exact
     validate_csr_join; and every opt-in JAX name once at its main-path
     shape, against its plain version;
  5. drives the library front end with the launch counts set to 0: the
     three examples (bench_usage, vadd, lock_add) as subprocesses on the
     card; GroupByLocal through the CLI at 2^22 rows (G=64 with 64
     executors: groupby_small; G=20 with 1024: weighted_histogram); the four
     Constant* dwarfs; ``DwarfBench.make_measurements`` on
     ApiDeviceType.GPU for each DwarfKind (Sort and GroupBy 2^22, Join
     2^20, Scan 2^24, three iterations); the vadd and lock_add examples in
     this process; and every measurement-script name once at its main's
     shape, against its plain version;
  6. runs the headline bench (``dwarf_bench_tpu_torch.bench``) in this
     process at the JAX bench's sizes with the launch counts set to 0:
     prints its JSON line, requires nothing skipped, every component
     checked against its oracle and positive, no cold share of the roofline
     above 1.0, and every kernel of its path launched; holds the bench's
     timer to ``graph_ms`` of the same call (``filter_sparse`` at 2^24 and
     the hi80 histogram, within 10 % or 3 us) and requires it to raise on a
     call that reads back to the host; runs ``entry()``'s forward on the
     card against the same forward on the CPU;
  7. drives the distributed layer (``dwarf_bench_tpu_torch.parallel``) as
     an NCCL world of one rank with the launch counts set to 0: every
     builder once at the headline bench's per-chip sizes on a (1,) and a
     (1, 1) mesh (the joins 2^20 x 2^20 in all their forms, the rows join,
     the group-bys at 2^22 and G = 64 and at 2^20 and G = 2^16, the filter at
     2^24 x < 5 and 2^20 x < 5000, the sample sort at 2^22), each checked
     against a host oracle with zero overflow, then timed (events and
     device time, beside the card); runs the dry run
     (``python -m dwarf_bench_tpu_torch.dryrun``) and Radix 2^22 through the
     CLI with ``--profile_dir``, whose trace must name the histogram kernel;
  8. runs the scripts of ``dwarf_bench_tpu_torch/scripts/`` on the card
     (``phase_scripts``): every sweep grid (``scripts/sweeps.py``, the
     JAX package's ``benchmark_*.sh``) at its largest size (2^27 rows for
     the large grids) and its smallest, 2 iterations, each size a CLI
     process that must exit 0 with every run valid, and ``report.py`` over
     each CSV listing every size; the 50 %-hit hash harness at 2^24 in this
     process; the scaling harness on a world of ``device_count()`` NCCL
     ranks at 2^18 and 2^20 rows; the scaling model at 2^20 from phase
     6's bench line, with the world of one's rates beside it; the release
     tar with the kernel library, whose entry must run unpacked with nvcc
     hidden; the launches of these runs (read from the CLI processes and
     the scaling ranks) are counted;
  9. prints the kernels whose profiler time fell below their bound, one
     JSON line with each kernel's launches, error and times, and last the
     JSON line ``{"ok": true, "device": {...}}``.

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

HIST_CU = "dwarf_bench_tpu_torch/csrc/hist.cu"
GROUPBY_CU = "dwarf_bench_tpu_torch/csrc/groupby.cu"

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
    # the sparse scan's phase A on its default path: the kernel of
    # chunk_stats_pallas where the JAX package fuses chunk_stats_xla
    "chunk_stats": ("dwarf_bench_tpu_torch/csrc/chunk_stats.cu",
                    "dwarf_bench_tpu/ops/chunk_stats_pallas.py:268"),
    # the JAX names this slice serves
    "chunk_stats_pallas": ("dwarf_bench_tpu_torch/csrc/chunk_stats.cu",
                           "dwarf_bench_tpu/ops/chunk_stats_pallas.py:268"),
    "chunk_stats_roll_pallas": (
        "dwarf_bench_tpu_torch/csrc/chunk_stats.cu",
        "dwarf_bench_tpu/ops/chunk_stats_pallas.py:54"),
    "chunk_stats_fused": ("dwarf_bench_tpu_torch/csrc/chunk_stats.cu",
                          "dwarf_bench_tpu/ops/chunk_stats_pallas.py:138"),
    "scan_tail_compact": ("dwarf_bench_tpu_torch/csrc/scan_tail.cu",
                          "dwarf_bench_tpu/ops/scan_tail_pallas.py:266"),
    "probe_dense_rel_pallas": ("dwarf_bench_tpu_torch/csrc/probe_dense.cu",
                               "dwarf_bench_tpu/ops/probe_pallas.py:174"),
    "probe_dense_cat_pallas": ("dwarf_bench_tpu_torch/csrc/probe_dense.cu",
                               "dwarf_bench_tpu/ops/probe_pallas.py:43"),
    "histogram_16k_pallas": ("dwarf_bench_tpu_torch/csrc/hist.cu",
                             "dwarf_bench_tpu/ops/hist_pallas.py:40"),
    "weighted_histogram_pallas": ("dwarf_bench_tpu_torch/csrc/hist.cu",
                                  "dwarf_bench_tpu/ops/hist_pallas.py:279"),
    "weighted_histogram_16k_pallas": (
        "dwarf_bench_tpu_torch/csrc/hist.cu",
        "dwarf_bench_tpu/ops/hist_pallas.py:476"),
    "groupby_small_swar_pallas": (
        "dwarf_bench_tpu_torch/csrc/groupby.cu",
        "dwarf_bench_tpu/ops/groupby_pallas.py:159"),
    "groupby_small_pallas_f32": ("dwarf_bench_tpu_torch/csrc/groupby.cu",
                                 "dwarf_bench_tpu/ops/groupby_pallas.py:59"),
    # the examples' kernels
    "vadd_pallas": ("dwarf_bench_tpu_torch/csrc/vadd.cu", "examples/vadd.py:21"),
    "grid_accumulate": ("dwarf_bench_tpu_torch/csrc/lock_add.cu",
                        "examples/lock_add.py:20"),
    # the measurement scripts' names (ops/measure_variants.py)
    "histogram_16k_i8cmp": (HIST_CU, "scripts/measure_r2.py:38"),
    "hist16k_bf16cmp": (HIST_CU, "scripts/measure_r2b.py:37"),
    "groupby_small_v2": (GROUPBY_CU, "scripts/measure_r2b.py:106"),
    "groupby_small_v3": (GROUPBY_CU, "scripts/measure_r2c.py:42"),
    "weighted_histogram_i8": (HIST_CU, "scripts/measure_r2c.py:146"),
    "dyn_store_probe": (HIST_CU, "scripts/measure_r2c.py:228"),
    "hist_variant": (HIST_CU, "scripts/measure_r3.py:60"),
    "whist_i8": (HIST_CU, "scripts/measure_r3.py:121"),
    "groupby_small_v5": (GROUPBY_CU, "scripts/measure_r3b.py:39"),
    "hist_rows": (HIST_CU, "scripts/measure_r3c.py:24"),
    "hist_swar": (HIST_CU, "scripts/measure_r4.py:70"),
    "groupby_small_stacked": (GROUPBY_CU, "scripts/measure_r4.py:574"),
    "_gb_diag_kernel_factory": ("dwarf_bench_tpu_torch/csrc/gb_diag.cu",
                                "scripts/measure_r5.py:485"),
    "_gb_dbuf_kernel": (GROUPBY_CU, "scripts/measure_r5.py:645"),
}

STATS_NAMES = ("chunk_stats_pallas", "chunk_stats_roll_pallas",
               "chunk_stats_fused")
GROUPBY_NAMES = ("groupby_small_swar_pallas", "groupby_small_pallas_f32")

# The bound of a kernel call: the bytes it must move (each input read once,
# each output written once) over the H100's HBM rate, or its operations over
# the card's 32-bit rate outside the tensor cores (the published float32
# peak; these kernels do 32-bit integer work), whichever takes longer.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

SCAN_KERNELS = ("chunk_stats", "cumsum", "scan_tail_streams",
                "compact_mask", "emit_prefix")
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


def bound(nbytes: float, ops: float, serial_s: float = 0.0):
    """(bound_ms, bound_by) of a call that moves ``nbytes`` and does
    ``ops`` operations, of which a chain that cannot overlap takes
    ``serial_s`` seconds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / OPS_PER_S, serial_s)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def busy_ms(fn, *args, k: int = 5):
    """Device time of one ``fn(*args)``: the CUDA kernels' time in a
    torch.profiler trace of ``k`` calls, over ``k`` (the host's dispatch
    gaps between kernels are not in it). None when the trace holds no
    kernel at all (the profiler lost the cycle): not measured, not 0."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(k):
            fn(*args)
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / k / 1e3 if total_us > 0 else None


def phase_kernels(dev):
    """Each kernel, under each name it serves, against its plain twin on
    ``dev``. Returns {name: {"max_abs_err", "ms", "plain_ms", "bound_ms",
    "bound_by", "library_ms"}} with the times taken at the name's first
    (main-path) case."""
    from dwarf_bench_tpu_torch.common.datagen import make_random
    from dwarf_bench_tpu_torch.ops import (
        bitonic_cuda,
        chunk_stats_cuda,
        compact_cuda,
        csr_join,
        cumsum_cuda,
        filter_cuda,
        groupby_cuda,
        hist_cuda,
        lock_add_cuda,
        measure_variants,
        merge_fill_cuda,
        merge_lookup,
        probe_cuda,
        reduce_cuda,
        scan_tail_cuda,
        vadd_cuda,
    )
    from dwarf_bench_tpu_torch.ops.chunk_stats import chunk_stats
    from dwarf_bench_tpu_torch.utils.kernel_times import (
        cold_ms,
        copy_if_bytes,
        csr_build_compaction,
        device_ops,
        graph_ms,
        mask_bytes,
    )
    from dwarf_bench_tpu_torch.utils.timing import kernel_time, sync

    rng = np.random.default_rng(20261016)
    stats = {name: {"max_abs_err": 0, "ms": None, "plain_ms": None,
                    "bound_ms": None, "bound_by": None, "library_ms": None,
                    "device_ms": None, "library_device_ms": None,
                    "cold_ms": None, "library_cold_ms": None,
                    "graph_ms": None, "library_graph_ms": None,
                    "device_below_bound": None, "cases": []}
             for name in KERNELS}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def whole(res):
        return [], [(res, res.numel())]

    def run(name, label, kernel, plain, *args, view=whole, timed=False,
            cost=None, library=None, cold=False, graph=False,
            library_graph=True):
        """Kernel against twin on ``args``. ``view`` maps a result to
        (counts, [(tensor, slots that hold data)]): a compaction's output is
        garbage past its count, so only the twin's slots are compared. A
        timed case also times ``library(*args)``, the one PyTorch call of
        the same function where there is one (events and device time), and
        takes the bound from ``cost(result) = (bytes, operations)``; a
        ``cold`` one also times kernel and library call with the L2 flushed
        before each bracket (``kernel_times.cold_ms``); a ``graph`` one
        (a call with no read back to the host) also times both as replays
        of a captured CUDA graph (``kernel_times.graph_ms``), which no
        trace can thin out (the library call too, unless
        ``library_graph`` is False: a call that reads back to the host
        cannot be captured). A profiler time below the bound is flagged:
        the trace lost kernels, or the inputs sat in the L2. Every timed
        case of a name is kept in its ``cases``."""
        res = sync(kernel(*args))
        got_counts, got = view(res)
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
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        line = f"kernel {name} [{label}]: max_abs_err={err}"
        if timed:
            ms = kernel_time(kernel, *args, k=20) * 1e3
            plain_ms = kernel_time(plain, *args, k=20) * 1e3
            lib_ms = lib_dev_ms = None
            if library is not None:
                lib_ms = kernel_time(library, *args, k=20) * 1e3
                lib_dev_ms = busy_ms(library, *args)
            dev_ms = busy_ms(kernel, *args)
            cold_k = cold_lib = None
            if cold:
                cold_k = cold_ms(kernel, *args)
                cold_lib = None if library is None else cold_ms(library, *args)
            graph_k = graph_lib = None
            if graph:
                graph_k = graph_ms(kernel, *args)
                if library is not None and library_graph:
                    graph_lib = graph_ms(library, *args)
            bound_ms, bound_by = bound(*cost(res))
            below = dev_ms is not None and dev_ms < bound_ms
            times = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         device_ms=dev_ms, library_device_ms=lib_dev_ms,
                         cold_ms=cold_k, library_cold_ms=cold_lib,
                         graph_ms=graph_k, library_graph_ms=graph_lib,
                         device_below_bound=below)
            if st["ms"] is None:
                st.update(times)
            st["cases"].append({"label": label, **times})
            line += (f" kernel_ms={ms!r} device_ms={dev_ms!r} "
                     f"plain_ms={plain_ms!r} library_ms={lib_ms!r} "
                     f"library_device_ms={lib_dev_ms!r} "
                     f"bound_ms={bound_ms!r} ({bound_by})")
            if cold:
                line += f" cold_ms={cold_k!r} library_cold_ms={cold_lib!r}"
            if graph:
                line += f" graph_ms={graph_k!r} library_graph_ms={graph_lib!r}"
            if below:
                line += " DEVICE_MS_BELOW_BOUND"
        print(line, flush=True)
        check(err == 0, f"{name} [{label}]: kernel and plain twin differ "
                        f"(max_abs_err {err})")

    def index_add(nbins):
        """The library call of a group-by sum into ``nbins`` bins."""
        return lambda k, v, *_: torch.zeros(
            nbins, dtype=torch.int32, device=dev).index_add_(0, k, v)

    def keyed(n, nbins, ncols=1):
        """Cost of a (weighted) histogram: keys (and values) read, bins
        written; a compare and an add a row."""
        return lambda res: (4 * (ncols * n + nbins), 2 * n)

    i32max, i32min = 2**31 - 1, -2**31
    # -- histogram (radix hi80 at 2^22, join build hi128 at 2^20) ------
    h, hp = hist_cuda.histogram, hist_cuda.histogram_plain
    radix_k = make_random(1 << 22, seed=1) - 1

    def bincount(k, hi_bins):
        return torch.bincount(k, minlength=hi_bins * 128)

    run("histogram", "radix hi80 n=2^22", h, hp, t(radix_k), 80, timed=True,
        cost=keyed(1 << 22, 80 * 128), library=bincount, cold=True,
        graph=True, library_graph=False)
    join_k = make_random(1 << 20, seed=2) - 1
    run("histogram", "join hi128 n=2^20", h, hp, t(join_k), 128, timed=True,
        cost=keyed(1 << 20, 128 * 128), library=bincount, cold=True,
        graph=True, library_graph=False)
    run("histogram", "radix hi80 n=2^22, one bin", h, hp,
        t(np.full(1 << 22, 77)), 80, timed=True,
        cost=keyed(1 << 22, 80 * 128), library=bincount, graph=True,
        library_graph=False)
    run("histogram", "radix hi80 n=2^22 - 1, view off 4 bytes", h, hp,
        t(radix_k)[1:], 80)
    run("histogram", "join hi128 n=2^20 - 3, view off 12 bytes", h, hp,
        t(join_k)[3:], 128)
    run("histogram", "all out of range", h, hp,
        t(np.full(5000, 80 * 128, np.int64)), 80)
    run("histogram", "negative keys", h, hp,
        t(rng.choice([-1, -7, i32min, i32max, 5], 100_003)), 128)
    run("histogram", "single bin", h, hp, t(np.full(77_777, 3)), 1)
    run("histogram", "n=1", h, hp, t([16383]), 128)
    run("histogram", "n=1000003 spread", h, hp,
        t(rng.integers(-100, 16384 + 100, 1_000_003)), 128)
    histogram_oversized_plans()

    # -- cumsum (radix run expansion at 2^22) ---------------------------
    c, cp = cumsum_cuda.cumsum, cumsum_cuda.cumsum_plain
    n = 1 << 22
    counts = np.bincount(radix_k, minlength=80 * 128)
    starts = np.cumsum(counts) - counts
    s = np.bincount(np.minimum(starts, n), minlength=n + 1)[:n]
    def torch_cumsum(x, _):
        return torch.cumsum(x, 0, dtype=torch.int32)

    run("cumsum", "radix expansion n=2^22", c, cp, t(s), -1, timed=True,
        cost=lambda res: (4 * (2 * n + 1), n), library=torch_cumsum,
        cold=True)
    run("cumsum", "radix expansion n=2^22, tensor carry", c, cp, t(s),
        t([-1]), timed=True, cost=lambda res: (4 * (2 * n + 1), n),
        library=torch_cumsum, cold=True)
    run("cumsum", "n=1", c, cp, t([7]), 0)
    run("cumsum", "n=1000003 random int32", c, cp,
        t(rng.integers(i32min, i32max, 1_000_003, endpoint=True)), 0)
    run("cumsum", "crosses 2^31 and 2^32", c, cp,
        t(np.full(4099, 1 << 30)), 0)
    run("cumsum", "carry_init near INT32_MAX", c, cp,
        t(rng.integers(0, 1000, 70_001)), i32max - 5)
    run("cumsum", "carry_init tensor", c, cp,
        t(rng.integers(-5, 5, 9_999)), t([i32min + 3]))
    tile = 8192  # values a block of csrc/cumsum.cu scans
    for n_edge in (tile - 1, tile, tile + 1, (1 << 24) + 3):
        x_edge = t(rng.integers(i32min, i32max, n_edge, endpoint=True))
        for carry in (i32min, i32max):
            run("cumsum", f"n={n_edge} int carry {carry}", c, cp, x_edge,
                carry)
            run("cumsum", f"n={n_edge} tensor carry {carry}", c, cp, x_edge,
                t([carry]))
    run("cumsum", "misaligned view", c, cp, x_edge[1:], 3)
    side = torch.cuda.Stream(dev)
    late_src = t(rng.integers(-1000, 1000, 1 << 20))

    def on_side_stream(x, carry):
        """The kernel under ``torch.cuda.stream(side)`` on a column written
        on that stream behind a sleep: a launch on any other stream would
        read it before it is written."""
        with torch.cuda.stream(side):
            torch.cuda._sleep(20_000_000)
            res = c(x + 0, carry)
        torch.cuda.current_stream(dev).wait_stream(side)
        return res

    run("cumsum", "under a non-default stream", on_side_stream, cp, late_src,
        -1)
    x_dbg = t(s)
    sync(c(x_dbg, -1))
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_dbg = c(x_dbg, -1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(torch.equal(got_dbg, cp(x_dbg, -1)),
          "cumsum int carry under sync debug mode: differs from its twin")
    print("kernel cumsum [int carry under sync debug mode error]: no host "
          "copy or sync, exact", flush=True)

    # -- groupby_small (G=64 at 2^22) -----------------------------------
    g, gp = groupby_cuda.groupby_small, groupby_cuda.groupby_small_plain
    gb_k, gb_v = (t(make_random(1 << 22, 0, 63, seed=3)),
                  t(make_random(1 << 22, seed=4)))
    run("groupby_small", "G=64 n=2^22", g, gp, gb_k, gb_v, 64, timed=True,
        cost=keyed(1 << 22, 64, 2), library=index_add(64), cold=True,
        graph=True)
    ops = device_ops(g, gb_k, gb_v, 64)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"kernel groupby_small [G=64 n=2^22]: kernels per call {ops[0]!r}, "
          f"memsets {ops[1]!r}, plan "
          f"{groupby_cuda.groupby_plan(64, 1 << 22, sms)}", flush=True)
    check(ops == (1, 0), f"groupby_small: {ops} kernels and memsets a call, "
                         "expected 1 and 0")
    sync(g(gb_k, gb_v, 64))
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_dbg = g(gb_k, gb_v, 64)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(torch.equal(got_dbg, gp(gb_k, gb_v, 64)),
          "groupby_small under sync debug mode: differs from its twin")
    print("kernel groupby_small [G=64 under sync debug mode error]: no host "
          "copy or sync, exact", flush=True)
    # GroupByLocal's 64 executors x G = 64: key (row // 2^16) * 64 + k
    local_k = t((np.arange(1 << 22) // (1 << 16)) * 64
                + make_random(1 << 22, 0, 63, seed=5))
    run("groupby_small", "G=4096 n=2^22 (GroupByLocal 64 x 64)", g, gp,
        local_k, gb_v, 4096, timed=True, cost=keyed(1 << 22, 4096, 2),
        library=index_add(4096), cold=True, graph=True)
    run("groupby_small", "G=64 n=2^22, one hot key", g, gp,
        t(np.full(1 << 22, 17)), gb_v, 64, timed=True,
        cost=keyed(1 << 22, 64, 2), library=index_add(64), cold=True,
        graph=True)
    run("groupby_small", "G=64 n=2^22 - 1, view off 4 bytes", g, gp,
        gb_k[1:], gb_v[1:], 64, timed=True, cost=keyed((1 << 22) - 1, 64, 2),
        cold=True, graph=True)
    run("groupby_small", "G=64 n=2^22 - 1, keys off 4 bytes, values not", g,
        gp, gb_k[1:], gb_v[:-1], 64)
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

    def on_side_stream_w(k, v, hb):
        with torch.cuda.stream(side):
            torch.cuda._sleep(20_000_000)
            res = w(k + 0, v, hb)
        torch.cuda.current_stream(dev).wait_stream(side)
        return res

    big_k, big_v = (t(make_random(1 << 20, 0, 65535, seed=5)),
                    t(make_random(1 << 20, seed=6)))
    run("weighted_histogram", "hi512 n=2^20", w, wp, big_k, big_v, 512,
        timed=True, cost=keyed(1 << 20, 1 << 16, 2),
        library=index_add(1 << 16), cold=True)
    run("weighted_histogram", "hi512 n=2^20, every row in one bin", w, wp,
        t(np.full(1 << 20, 40_000)), big_v, 512, timed=True,
        cost=keyed(1 << 20, 1 << 16, 2), library=index_add(1 << 16),
        cold=True)
    for hb in (1, 8, 64, 128, 256, 512):
        run("weighted_histogram", f"hi{hb} n=1000003, out-of-range keys", w,
            wp, t(rng.integers(-3, hb * 128 + 3, 1_000_003)),
            t(rng.integers(i32min, i32max, 1_000_003, endpoint=True)), hb)
    run("weighted_histogram", "hi512 n=100", w, wp,
        t(rng.integers(0, 65536, 100)), t(rng.integers(1, 10000, 100)), 512)
    run("weighted_histogram", "hi512, every key in one block's slice", w, wp,
        t(rng.integers(4096, 8192, 1 << 20)), big_v, 512)
    run("weighted_histogram", "hi512, every key out of range", w, wp,
        t(rng.choice([-1, i32min, 65536, i32max], 1 << 20)), big_v, 512)
    run("weighted_histogram", "hi512 under a non-default stream",
        lambda k, v, hb: on_side_stream_w(k, v, hb), wp, late_src,
        late_src, 512)
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

    def copy_if_cost(n):
        """Cost of the filter over n rows (kernel_times.copy_if_bytes); a
        compare and a scan step a row."""
        return lambda res: (copy_if_bytes(n, int(res[1])), 2 * n)

    def mask_cost(n, ncols):
        """Cost of compact_mask over n rows (kernel_times.mask_bytes: this
        run's data needs no column value but the kept rows', up to the
        capacity); a compare and a scan step a row."""
        return lambda res: (mask_bytes(n, ncols, min(int(res[1]),
                                                     res[0][0].numel())), 2 * n)

    f, fp = filter_cuda.filter, filter_cuda.filter_plain

    def masked_select(x, thr, _):
        return torch.masked_select(x, x < thr)

    # masked_select reads its count back to the host: no graph of it
    run("filter", "x<5 n=2^24", f, fp, scan_x, 5, scan_n,
        view=counted(scan_n), timed=True, cost=copy_if_cost(scan_n),
        library=masked_select, cold=True, graph=True, library_graph=False)
    run("filter", "x<5000 n=2^20 (sel50)", f, fp,
        t(make_random(1 << 20, seed=8)), 5000, 1 << 20,
        view=counted(1 << 20), timed=True, cost=copy_if_cost(1 << 20),
        library=masked_select, cold=True, graph=True, library_graph=False)
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

    def tail_cost(nch, cap_single):
        """(stat, base) read; spos whole, the singles' values and the
        multis' (id, base) and the two counts written."""
        return lambda res: (4 * (2 * nch + cap_single + int(res[4])
                                 + 2 * int(res[5]) + 2), 4 * nch)

    run("scan_tail_streams", "chunk_stats of the 2^24 scan", st, stp,
        stat, base, 5, 16384, 512, view=tail(16384, 512), timed=True,
        cost=tail_cost(scan_n // 128, 16384), cold=True, graph=True)
    dstat, dbase = chunk_stats(t(deep_x).view(-1, 128), 5)
    run("scan_tail_streams", "out-of-window singles", st, stp,
        dstat, dbase, 5, 16384, 512, view=tail(16384, 512))
    run("scan_tail_streams", "counts > caps", st, stp,
        dstat, dbase, 5, 7, 3, view=tail(7, 3))
    run("scan_tail_streams", "nch=1", st, stp, t([512 + 3]), t([0]), 5,
        16384, 512, view=tail(16384, 512))

    cm, cmp = compact_cuda.compact_mask, compact_cuda.compact_mask_plain
    gm = torch.from_numpy(rng.random(65536) < 2 / 128).to(dev)
    def masked_selects(mask, cols, _):
        return [torch.masked_select(c, mask) for c in cols]

    timed_mask = dict(timed=True, library=masked_selects, cold=True,
                      graph=True, library_graph=False)
    run("compact_mask", "65536 rows x 2 cols, capacity 4096", cm, cmp, gm,
        (t(rng.integers(0, scan_n, 65536)), t(rng.integers(1, 5, 65536))),
        4096, view=counted(4096), cost=mask_cost(65536, 2), **timed_mask)
    scan_mask = scan_x < 5
    run("compact_mask", "2^24 rows x 1 col", cm, cmp, scan_mask, (scan_x,),
        scan_n, view=counted(scan_n), cost=mask_cost(scan_n, 1),
        **timed_mask)
    run("compact_mask", "2^24 rows x 3 cols", cm, cmp, scan_mask,
        (scan_x, scan_x + 1, scan_x - 1), scan_n, view=counted(scan_n),
        cost=mask_cost(scan_n, 3), **timed_mask)
    # the general CSR join's build: the segment starts of 2^20 sorted keys
    csr_mask, csr_cols, csr_cap = csr_build_compaction(dev)
    run("compact_mask", "2^20 rows x 2 cols (CSR build)", cm, cmp, csr_mask,
        csr_cols, csr_cap, view=counted(csr_cap),
        cost=mask_cost(1 << 20, 2), **timed_mask)
    del csr_mask, csr_cols
    def ones(n, keep):
        return torch.full((n,), keep, dtype=torch.bool, device=dev)

    run("compact_mask", "n=1", cm, cmp, ones(1, True), (t([i32min]),), 1,
        view=counted(1))
    run("compact_mask", "nothing kept", cm, cmp, ones(70_001, False),
        (t(rng.integers(0, 9, 70_001)),), 70_001, view=counted(70_001))
    run("compact_mask", "everything kept, count > capacity", cm, cmp,
        ones(100_003, True), (t(rng.integers(i32min, i32max, 100_003)),) * 3,
        4096, view=counted(4096))
    compaction_checks(dev, rng, t, scan_x, stat, base)

    e, ep = compact_cuda.emit_prefix, compact_cuda.emit_prefix_plain
    def copy_prefix(v, capacity):
        out = torch.empty(capacity, dtype=torch.int32, device=dev)
        return out[: v.numel()].copy_(v)

    def gather_prefix(v, capacity, index):
        out = torch.empty(capacity, dtype=torch.int32, device=dev)
        torch.index_select(v, 0, index, out=out[: index.numel()])
        return out

    def gathered(v, capacity, index):
        return ep(v[index], capacity)

    # the scan's emit: its 20480 values (cap_single + cap_melems) gathered
    # by the sort's order; an int64 and two int32 moved a value
    emit_vals = t(rng.integers(i32min, i32max, 20480))
    emit_order = torch.from_numpy(rng.permutation(20480)).to(dev)
    run("emit_prefix", "L=20480 into 2^24 with the scan's index", e,
        gathered, emit_vals, scan_n, emit_order, view=prefix(20480),
        timed=True, cost=lambda res: (16 * 20480, 20480),
        library=gather_prefix, cold=True, graph=True)
    run("emit_prefix", "L=20480 into 2^24", e, ep, emit_vals, scan_n,
        view=prefix(20480), timed=True, cost=lambda res: (8 * 20480, 20480),
        library=copy_prefix, cold=True, graph=True)
    run("emit_prefix", "index into a longer view off 4 bytes", e, gathered,
        emit_vals[1:], 1000, torch.from_numpy(
            rng.integers(0, 20479, 999)).to(dev)[1:], view=prefix(998))
    run("emit_prefix", "L=1025, view off 8 bytes", e, ep, emit_vals[2:1027],
        1025, view=prefix(1025))
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

    def network_cost(res):
        """Every column read and written once; the network's N/2 compare-
        exchanges in each of its log2 N stages, about 4 operations each."""
        n_rows = res[0].numel()
        return (8 * n_rows * len(res),
                2 * n_rows * (n_rows.bit_length() - 1))

    # the library call sorts the (col0, col1) pairs packed into one int64
    # key (packed outside the timing: the sort is the call)
    packed16 = (((in16[0].to(torch.int64) & 0xFFFFFFFF) << 32)
                | (in16[1].to(torch.int64) & 0xFFFFFFFF)) ^ -(1 << 63)
    run("merge_bitonic", "N=2^25 x 2 cols (val16)", mb, mbp, in16, 2,
        view=columns, timed=True, cost=network_cost,
        library=lambda cols, _: torch.sort(packed16), graph=True)
    del packed16
    run("merge_bitonic", "N=2^25 x 3 cols (val32)", mb, mbp, in32, 2,
        view=columns, timed=True, cost=network_cost, graph=True)
    # one kernel a pass of the plan, 3 at 2^25 (15 before the tiled passes)
    for label, cols in (("2 cols", in16), ("3 cols", in32)):
        plan = bitonic_cuda.merge_plan(1 << 25, len(cols))
        ops = device_ops(mb, cols, 2)
        print(f"kernel merge_bitonic [N=2^25 x {label}]: kernels per call "
              f"{ops[0]!r}, memsets {ops[1]!r}, plan {plan}", flush=True)
        check(ops == (len(plan.passes), 0) and len(plan.passes) == 3,
              f"merge_bitonic at 2^25 x {label}: {ops} kernels and memsets "
              f"a call, expected 3 and 0")

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
    # every N = 2^k up to 2^22 meets every pass boundary of the plan
    for k in range(23):
        for ncols in (2, 4):
            cols = bitonic(1 << k, ncols, 1 << 12)
            for num_cmp in (1, 2):
                run("merge_bitonic", f"N=2^{k} x {ncols} cols, "
                    f"num_cmp={num_cmp}", mb, mbp, cols, num_cmp,
                    view=columns)

    mf, mfp = merge_fill_cuda.merge_fill, merge_fill_cuda.merge_fill_plain
    m16, m32, mm = (mb(c, 2) for c in (in16, in32, inm))

    def fill_cost(ncols):
        """ncols merged columns read; dest and val written; about 10
        operations a row (two scans and the fill)."""
        return lambda res: (4 * (ncols + 2) * res[0].numel(),
                            10 * res[0].numel())

    fill_modes = (("val32", (False, False)), ("val16", (True, False)),
                  ("membership", (False, True)))
    run("merge_fill", "N=2^25 val32", mf, mfp, m32[0], m32[1], m32[2], nq,
        False, False, view=columns, timed=True, cost=fill_cost(3), cold=True,
        graph=True)
    run("merge_fill", "N=2^25 val16", mf, mfp, m16[0], m16[1], None, nq,
        True, False, view=columns, timed=True, cost=fill_cost(2), graph=True)
    run("merge_fill", "N=2^25 membership", mf, mfp, mm[0], mm[1], None, nq,
        False, True, view=columns, timed=True, cost=fill_cost(2), graph=True)
    # one launch a call and no memset in every mode (3 launches before)
    for (mode, flags), cols in zip(fill_modes, (m32, m16, mm)):
        ops = device_ops(mf, cols[0], cols[1],
                         cols[2] if mode == "val32" else None, nq, *flags)
        print(f"kernel merge_fill [N=2^25 {mode}]: kernels per call "
              f"{ops[0]!r}, memsets {ops[1]!r}", flush=True)
        check(ops == (1, 0), f"merge_fill at 2^25 {mode}: {ops} kernels and "
                             "memsets a call, expected 1 and 0")
    # the probe's compaction before the unsort, as merge_lookup_bitonic
    # runs it: 2^25 merged rows, the 2^24 queries kept (half of them)
    for label, cols, membership in (("2^25 rows x 2 cols (probe)", m32, False),
                                    ("2^25 rows x 1 col (probe, membership)",
                                     mm, True)):
        dest, val = mf(cols[0], cols[1], None if membership else cols[2], nq,
                       False, membership)
        kept = (dest,) if membership else (dest, val)
        run("compact_mask", label, cm, cmp, dest != -1, kept, nq,
            view=counted(nq), cost=mask_cost(1 << 25, len(kept)),
            **timed_mask)
        del dest, val, kept
    del in16, in32, inm, m16, m32, mm
    # any length, the tile boundaries (8192 rows a block) and 2^25 + 3
    fill_tile = 8192
    for n_any in (1, 1023, 1025, fill_tile - 1, fill_tile, fill_tile + 1,
                  1_000_003, (1 << 25) + 3):
        cols = [t(rng.integers(i32min, i32max, n_any, endpoint=True))
                for _ in range(3)]
        for mode, flags in fill_modes:
            run("merge_fill", f"any length n={n_any} {mode}", mf, mfp,
                *cols, n_any // 2, *flags, view=columns)
    # columns off a 16-byte boundary; calls back to back on one stream, each
    # finding the scratch the one before left at 0; two streams at once
    wide = [t(rng.integers(i32min, i32max, 1_000_004, endpoint=True))
            for _ in range(3)]
    for mode, flags in fill_modes:
        run("merge_fill", f"views off 16 bytes {mode}", mf, mfp,
            *(c[1:] for c in wide), 500_000, *flags, view=columns)
    big = [t(rng.integers(i32min, i32max, (1 << 22) + 1, endpoint=True))
           for _ in range(3)]
    calls = [(big, fill_modes[0][1]), ([c[:3] for c in wide], fill_modes[1][1]),
             ([c[:-1] for c in wide], fill_modes[2][1]),
             ([c[:fill_tile] for c in wide], fill_modes[0][1]),
             ([c[1:] for c in wide], fill_modes[1][1])]
    torch.cuda.synchronize()
    outs = [mf(*cols, cols[0].numel() // 2, *flags) for cols, flags in calls]
    for got, (cols, flags) in zip(outs, calls):
        exp = mfp(*cols, cols[0].numel() // 2, *flags)
        check(all(torch.equal(g, e) for g, e in zip(got, exp)),
              "merge_fill: back-to-back calls on one stream differ from the "
              "twin")
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    pairs = [big, [c[:-1] for c in wide]]
    torch.cuda.synchronize()
    outs = [[], []]
    for rep, (_, flags) in enumerate(fill_modes):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                if rep == 0:
                    torch.cuda._sleep(5_000_000)
                outs[i].append(mf(*pairs[i], 1 << 19, *flags))
    torch.cuda.synchronize()
    for i in range(2):
        for got, (_, flags) in zip(outs[i], fill_modes):
            exp = mfp(*pairs[i], 1 << 19, *flags)
            check(all(torch.equal(g, e) for g, e in zip(got, exp)),
                  f"merge_fill on stream {i} differs from the twin")
    print("kernel merge_fill [back to back x 5, two streams x 3]: "
          "max_abs_err=0", flush=True)
    del wide, big, calls, pairs, outs

    r, rp = reduce_cuda.reduce_sum, reduce_cuda.reduce_sum_plain

    def scalar(res):
        return [res], []

    run("reduce_sum", "n=2^24 in [1, 10000]", r, rp,
        t(make_random(1 << 24, seed=10)), view=scalar, timed=True,
        cost=lambda res: (4 * (1 << 24) + 4, 1 << 24),
        library=lambda x: torch.sum(x, dtype=torch.int32), graph=True)
    run("reduce_sum", "n=0", r, rp, t([]), view=scalar)
    run("reduce_sum", "n=1", r, rp, t([i32min]), view=scalar)
    run("reduce_sum", "sums wrap past 2^31 and 2^32", r, rp,
        t(np.full(4099, 1 << 30)), view=scalar)
    wide = t(rng.integers(i32min, i32max, 1_000_004, endpoint=True))
    run("reduce_sum", "n=1000003 random int32", r, rp, wide[:-1],
        view=scalar)
    run("reduce_sum", "misaligned start", r, rp, wide[1:], view=scalar)
    big = t(make_random(1 << 24, seed=10))
    ops = device_ops(r, big)
    print(f"kernel reduce_sum [n=2^24]: kernels per call {ops[0]!r}, "
          f"memsets {ops[1]!r}", flush=True)
    check(ops == (1, 0), f"reduce_sum: {ops} kernels and memsets a call, "
                         "expected 1 and 0")
    got = r(big)
    check(got.shape == () and got._base is None,
          f"reduce_sum: {tuple(got.shape)} result, base {got._base is None}")
    # three calls back to back on one stream: the third finds the ticket the
    # second left at 0; then two streams at once, each with its own scratch
    exp = int(rp(big))
    sums = [r(big), r(wide[:-1]), r(big)]
    check([int(v) for v in sums] == [exp, int(rp(wide[:-1])), exp],
          "reduce_sum: back-to-back calls on one stream differ from the twin")
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    xs = (big, wide[1:])
    torch.cuda.synchronize()
    outs = [[], []]
    for rep in range(3):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                if rep == 0:
                    torch.cuda._sleep(5_000_000)
                outs[i].append(r(xs[i]))
    torch.cuda.synchronize()
    for i, x in enumerate(xs):
        check([int(v) for v in outs[i]] == [int(rp(x))] * 3,
              f"reduce_sum on stream {i} differs from the twin")
    print("kernel reduce_sum [back to back x 3, two streams x 3]: "
          "max_abs_err=0", flush=True)
    del big

    # -- the chunk-stats kernel: the scan's phase A, and under its three
    #    JAX names (the scan at 2^24, x < 5) ---------------------------
    def pair(res):
        return [], [(c, c.numel()) for c in res]

    nch = scan_n // 128
    x2 = scan_x.view(nch, 128)
    near_min = t(rng.integers(i32min, i32max, 3001 * 128, endpoint=True))
    for name in ("chunk_stats",) + STATS_NAMES:
        fn = getattr(chunk_stats_cuda, name)
        run(name, "nch=2^17 (2^24 rows, x<5)", fn, chunk_stats, x2, 5,
            view=pair,
            timed=True, cost=lambda res: (4 * (scan_n + 2 * nch),
                                          8 * scan_n))
        run(name, "threshold INT32_MIN+100", fn, chunk_stats,
            near_min.view(3001, 128), i32min + 100, view=pair)
        run(name, "nch=4097, a block part-filled", fn, chunk_stats,
            x2[:4097], 5000, view=pair)
        run(name, "misaligned view", fn, chunk_stats,
            scan_x[1: 1 + 4096 * 128].view(4096, 128), 5, view=pair)

    stc = scan_tail_cuda.scan_tail_compact
    run("scan_tail_compact", "chunk_stats of the 2^24 scan", stc, stp,
        stat, base, 5, 16384, 512, view=tail(16384, 512), timed=True,
        cost=tail_cost(nch, 16384))
    run("scan_tail_compact", "counts > caps", stc, stp, dstat, dbase, 5, 7,
        3, view=tail(7, 3))
    run("scan_tail_compact", "nch=1", stc, stp, t([512 + 3]), t([0]), 5,
        16384, 512, view=tail(16384, 512))

    # -- the dense join's lookup over a build_dense table of 2^20
    #    make_random keys, 2^20 queries with some out of range -----------
    table = csr_join.build_dense(t(make_random(1 << 20, seed=11)))
    check(bool(table.packed3_ok), "build_dense table: packed3_ok is False")
    ki = make_random(1 << 20, seed=12) - int(table.minv)
    ki[rng.integers(0, 1 << 20, 1000)] = -1  # EMPTY queries
    ki[:5] = [i32min, i32max, 1 << 14, 80 * 128, -7]
    dki = t(ki)

    def probe_cost(res):
        """Queries read, (pos, cnt) written, the 64 KB and 512 B tables
        read once."""
        n_q = res[0].numel()
        return 12 * n_q + 4 * ((1 << 14) + 128), 6 * n_q

    pp = probe_cuda.probe_dense_plain
    run("probe_dense_rel_pallas", "2^20 queries", probe_cuda.
        probe_dense_rel_pallas, pp, table.packed3, table.base128, dki,
        view=pair, timed=True, cost=probe_cost)
    for hi_rows in (80, 128, 1):
        run("probe_dense_cat_pallas", f"2^20 queries, hi_rows {hi_rows}",
            probe_cuda.probe_dense_cat_pallas, pp, table.packed3,
            table.base128, dki, hi_rows, view=pair, timed=hi_rows == 80,
            cost=probe_cost)
    wild = t(rng.integers(i32min, i32max, 1 << 14, endpoint=True))
    run("probe_dense_rel_pallas", "any table (past 2^24)",
        probe_cuda.probe_dense_rel_pallas, pp, wild, wild[:128], dki,
        view=pair)

    # -- the histogram and group-by variants ---------------------------
    h16 = hist_cuda.histogram_16k_pallas
    run("histogram_16k_pallas", "radix hi80 n=2^22", h16, hp, t(radix_k),
        80, timed=True, cost=keyed(1 << 22, 80 * 128), library=bincount)
    run("histogram_16k_pallas", "join hi128 n=2^20", h16, hp, t(join_k), 128,
        timed=True, cost=keyed(1 << 20, 128 * 128), library=bincount)
    run("histogram_16k_pallas", "negative and out-of-range keys", h16, hp,
        t(rng.integers(-100, 80 * 128 + 100, 100_003)), 80)
    k14 = t(make_random(1 << 20, 0, (1 << 14) - 1, seed=13))
    run("weighted_histogram_pallas", "hi128 n=2^20", hist_cuda.
        weighted_histogram_pallas, wp, k14, big_v, 128, timed=True,
        cost=keyed(1 << 20, 1 << 14, 2), library=index_add(1 << 14))
    run("weighted_histogram_pallas", "hi512 n=2^20 (G=2^16)", hist_cuda.
        weighted_histogram_pallas, wp, big_k, big_v, 512, timed=True,
        cost=keyed(1 << 20, 1 << 16, 2), library=index_add(1 << 16))
    run("weighted_histogram_16k_pallas", "n=2^20",
        hist_cuda.weighted_histogram_16k_pallas,
        lambda k, v: wp(k, v, 128), k14, big_v, timed=True,
        cost=keyed(1 << 20, 1 << 14, 2), library=index_add(1 << 14))
    g10k = t(rng.integers(-3, 10_000 + 200, 1 << 20))
    for name in GROUPBY_NAMES:
        fn, gdp = getattr(groupby_cuda, name), \
            groupby_cuda.groupby_digits_plain
        run(name, "G=64 n=2^22", fn, gdp, gb_k, gb_v, 64, timed=True,
            cost=keyed(1 << 22, 64, 2), library=index_add(64))
        run(name, "G=10000 n=2^20 (weighted route), out-of-range keys", fn,
            gdp, g10k, big_v, 10_000)
        run(name, "G=4096 n=1000003", fn, gdp,
            t(rng.integers(0, 4200, 1_000_003)),
            t(rng.integers(1, 10000, 1_000_003)), 4096)

    # -- the examples' kernels: vadd at the example's (8, 128) and timed
    #    at 2^24; the lock at the example's 64 blocks and at 2^16 ---------
    va, vap = vadd_cuda.vadd_pallas, vadd_cuda.vadd_plain

    def bits(res):
        """A float result compared by its bit patterns."""
        return [], [(res.reshape(-1).view(torch.int32), res.numel())]

    def f32(n):
        return torch.from_numpy(
            rng.standard_normal(n).astype(np.float32)).to(dev)

    run("vadd_pallas", "(8, 128) f32", va, vap, f32(1024).view(8, 128),
        f32(1024).view(8, 128), view=bits)
    fa, fb = f32(1 << 24), f32(1 << 24)
    run("vadd_pallas", "2^24 f32", va, vap, fa, fb, view=bits, timed=True,
        cost=lambda res: (12 * (1 << 24), 1 << 24), library=torch.add,
        cold=True, graph=True)
    run("vadd_pallas", "2^24 - 1 f32, misaligned", va, vap, fa[1:], fb[1:],
        view=bits)
    # the tile boundaries (2048 values a block), aligned and misaligned
    vadd_tile = 2048
    for n_v in (vadd_tile - 1, vadd_tile, vadd_tile + 1, 5 * vadd_tile + 3):
        run("vadd_pallas", f"n={n_v} f32", va, vap, fa[:n_v], fb[:n_v],
            view=bits)
        run("vadd_pallas", f"n={n_v} f32, misaligned", va, vap,
            fa[1: n_v + 1], fb[1: n_v + 1], view=bits)
    # one launch a call, misaligned inputs included (2 launches before for a
    # ragged aligned input)
    for label, x, y in (("2^24 f32", fa, fb),
                        ("2^24 - 5 f32, misaligned", fa[1:-4], fb[1:-4])):
        ops = device_ops(va, x, y)
        print(f"kernel vadd_pallas [{label}]: kernels per call {ops[0]!r}, "
              f"memsets {ops[1]!r}", flush=True)
        check(ops == (1, 0), f"vadd_pallas [{label}]: {ops} kernels and "
                             "memsets a call, expected 1 and 0")
    run("vadd_pallas", "int32 wrapping, n=1000003", va, vap,
        t(rng.integers(i32min, i32max, 1_000_003, endpoint=True)),
        t(rng.integers(i32min, i32max, 1_000_003, endpoint=True)))
    del fa, fb

    def acc(n_steps, anchor):
        """grid_accumulate on ``anchor``'s device (a tensor argument, so
        that kernel_time times it with CUDA events)."""
        return lock_add_cuda.grid_accumulate(n_steps, anchor.device)

    def acc_plain(n_steps, anchor):
        return lock_add_cuda.grid_accumulate_plain(n_steps, anchor.device)

    # one L2 round trip of an atomic, measured on this card: the least a
    # lock handoff between two blocks can take
    trips = [lock_add_cuda.l2_round_trip(dev) for _ in range(5)]
    rtt = sorted(trips)[2]
    print(f"L2 round trip of an atomic on {card_line()}: {rtt * 1e9!r} ns "
          f"(median of five chains of 2^14 dependent atomicAdds: "
          f"{[t * 1e9 for t in trips]!r} ns)", flush=True)

    def lock_cost(n_steps):
        """The counter written; n_steps acquisitions, each at least one
        measured L2 round trip after the last, none overlapping."""
        return lambda res: (4, 2 * n_steps, n_steps * rtt)

    anchor = torch.zeros(1, device=dev)
    run("grid_accumulate", "n_steps=64", acc, acc_plain, 64, anchor,
        timed=True, cost=lock_cost(64), graph=True)
    for n_steps in (1, 2):
        run("grid_accumulate", f"n_steps={n_steps}", acc, acc_plain, n_steps,
            anchor)
    run("grid_accumulate", "n_steps=2^16", acc, acc_plain, 1 << 16, anchor,
        timed=True, cost=lock_cost(1 << 16))
    for n_steps in (64, 1 << 16):
        per = kernel_time(acc, n_steps, anchor, k=5)
        ops = device_ops(acc, n_steps, anchor)
        print(f"grid_accumulate {n_steps}: {per / n_steps * 1e6!r} us per "
              f"lock acquisition (events; bound {rtt * 1e6!r} us), kernels "
              f"per call {ops[0]!r}, memsets {ops[1]!r}", flush=True)
        check(ops == (1, 0), f"grid_accumulate {n_steps}: {ops} kernels and "
                             "memsets a call, expected 1 and 0")

    # -- the measurement scripts' names at their mains' shapes (2^22 keys
    #    in [1, 10000]; G = 2^16 weighted at 2^20; 256 probe indices) and a
    #    part-filled block with out-of-range keys ------------------------
    mv = measure_variants
    x22 = t(make_random(1 << 22, seed=1))
    for name, fn, hb in (
            ("histogram_16k_i8cmp", mv.histogram_16k_i8cmp, 128),
            ("hist16k_bf16cmp", mv.hist16k_bf16cmp, 128),
            ("hist_variant", lambda k: mv.hist_variant(k, 128, i16=True),
             128),
            ("hist_rows", lambda k: mv.hist_rows(k, 128, rows=32), 128),
            ("hist_swar", lambda k: mv.hist_swar(k, 80, "f5"), 80)):
        plain = lambda k, hb=hb: hp(k, hb)
        run(name, f"hi{hb} n=2^22", fn, plain, x22, timed=True,
            cost=keyed(1 << 22, hb * 128),
            library=lambda k, hb=hb: bincount(k, hb))
        run(name, f"hi{hb} n=1000003, out-of-range keys", fn, plain,
            t(rng.integers(-100, hb * 128 + 100, 1_000_003)))
    probe_plain = lambda i: hp(i, 64).view(64, 128)
    run("dyn_store_probe", "256 indices", mv.dyn_store_probe, probe_plain,
        t(rng.integers(0, 64 * 128, 256)), timed=True,
        cost=keyed(256, 64 * 128), library=lambda i: bincount(i, 64))
    run("dyn_store_probe", "out-of-range indices", mv.dyn_store_probe,
        probe_plain, t(rng.choice([-1, i32min, 8192, 8191, 0], 1001)))
    for name in ("weighted_histogram_i8", "whist_i8"):
        run(name, "hi512 n=2^20", getattr(mv, name), wp, big_k, big_v, 512,
            timed=True, cost=keyed(1 << 20, 1 << 16, 2),
            library=index_add(1 << 16))
        run(name, "hi64 n=1000003, out-of-range keys", getattr(mv, name), wp,
            t(rng.integers(-3, 64 * 128 + 99, 1_000_003)),
            t(rng.integers(1, 10000, 1_000_003)), 64)
    for name, fn in (
            ("groupby_small_v2", mv.groupby_small_v2),
            ("groupby_small_v3", mv.groupby_small_v3),
            ("groupby_small_v5", lambda k, v, g: mv.groupby_small_v5(
                k, v, g, rows=32, w=4096)),
            ("groupby_small_stacked", mv.groupby_small_stacked)):
        run(name, "G=64 n=2^22", fn, gp, gb_k, gb_v, 64, timed=True,
            cost=keyed(1 << 22, 64, 2), library=index_add(64))
        run(name, "G=4096 n=1000003, out-of-range keys", fn, gp,
            t(rng.integers(-3, 4096 + 100, 1_000_003)),
            t(rng.integers(1, 10000, 1_000_003)), 4096)
    run("_gb_dbuf_kernel", "ga=gb=8 n=2^22", mv._gb_dbuf_kernel(),
        lambda k, v: gp(k, v, 64), gb_k, gb_v, timed=True,
        cost=keyed(1 << 22, 64, 2), library=index_add(64))

    def diag_cost(mode, n, rows=32, w=4096, gb=8):
        """The rows a mode reads (key and value), the 64 cells written."""
        read = {"full": n, "dotonly": -(-n // (rows * w)) * w,
                "nodot": -(-n // (rows * w)) * rows * gb}[mode]
        return lambda res: (8 * read + 4 * 64, 2 * read)

    odd = (1 << 18) + 777
    for mode in measure_variants.DIAG_MODES:
        fn = mv._gb_diag_kernel_factory(mode)
        plain = (lambda k, v, mode=mode:
                 mv.gb_diag_plain(k, v, mode, 8, 8, 32, 4096))
        run("_gb_diag_kernel_factory", f"{mode} n=2^22", fn, plain, gb_k,
            gb_v, timed=True, cost=diag_cost(mode, 1 << 22), cold=True,
            graph=True)
        ops = device_ops(fn, gb_k, gb_v)
        print(f"kernel _gb_diag_kernel_factory [{mode} n=2^22]: kernels "
              f"per call {ops[0]!r}, memsets {ops[1]!r}", flush=True)
        check(ops == (1, 0), f"_gb_diag_kernel_factory {mode}: {ops} "
                             "kernels and memsets a call, expected 1 and 0")
        run("_gb_diag_kernel_factory",
            f"{mode} n=2^18+777 (part-filled block), out-of-range keys",
            fn, plain, t(rng.integers(-5, 64 + 5, odd)),
            t(rng.integers(i32min, i32max, odd, endpoint=True)))

    # -- the sweeps' largest size, 2^27 rows (Radix and the scans at the
    #    top of their grids): the count histogram with 32-bit copies, the
    #    run-expansion cumsum, phase A and the scan tail over 2^20 chunks
    big = 1 << 27
    plan = hist_cuda.histogram_plan(80, big)
    check(not hist_cuda._narrow(hist_cuda.HIST_THREADS, plan[0], big // 4),
          f"histogram hi80 2^27: the plan {plan} keeps 16-bit copies")
    x27 = make_random(big, seed=27)
    k27 = t(x27 - 1)  # Radix's keys less their minimum
    run("histogram", f"radix hi80 n=2^27, plan {plan}, 32-bit copies", h,
        hp, k27, 80, timed=True, cost=keyed(big, 80 * 128), library=bincount,
        cold=True, graph=True, library_graph=False)
    del k27
    counts27 = np.bincount(x27 - 1, minlength=80 * 128)
    starts27 = np.cumsum(counts27) - counts27
    s27 = t(np.bincount(np.minimum(starts27, big), minlength=big + 1)[:big])
    run("cumsum", "radix expansion n=2^27, int carry", c, cp, s27, -1,
        timed=True, cost=lambda res: (4 * (2 * big + 1), big),
        library=torch_cumsum, cold=True, graph=True)
    del s27
    nch27 = big // 128
    x2_27 = t(x27).view(nch27, 128)
    del x27
    run("chunk_stats", "nch=2^20 (2^27 rows, x<5)",
        chunk_stats_cuda.chunk_stats, chunk_stats, x2_27, 5, view=pair,
        timed=True, cost=lambda res: (4 * (big + 2 * nch27), 8 * big),
        graph=True)
    stat27, base27 = chunk_stats(x2_27, 5)
    del x2_27
    caps27 = (max(16384, big >> 10), max(512, big >> 15))  # ops/scan.py
    run("scan_tail_streams", "nch=2^20 (2^27 x<5)",
        scan_tail_cuda.scan_tail_streams,
        scan_tail_cuda.scan_tail_streams_plain, stat27, base27, 5, *caps27,
        view=tail(*caps27), timed=True,
        cost=tail_cost(nch27, caps27[0]), cold=True, graph=True)
    del stat27, base27
    return stats


def histogram_oversized_plans():
    """The count histogram under plans the card cannot hold at once (every
    block a merger: 1024 at 8192 bins, 2048 at 2^14), each in a subprocess
    under a time limit, so that a hang fails here instead of holding the
    card: the cooperative launch must be refused and the next call on the
    stream exact."""
    root = os.path.dirname(os.path.abspath(__file__))
    for hi_bins, blocks in ((64, 1024), (128, 2048)):
        label = (f"histogram [{blocks} blocks, all mergers, "
                 f"{hi_bins * 128} bins]")
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "dwarf_bench_tpu_torch.utils.hist_plan",
                 str(hi_bins), str(blocks)], capture_output=True, text=True,
                timeout=180, cwd=root)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"{label}: did not end within 180 s")
        out = proc.stdout
        check(proc.returncode == 0, f"{label}: exit {proc.returncode}: "
                                    f"{proc.stderr[-2000:]}")
        check("refused:" in out and "cooperative launch" in out,
              f"{label}: not refused by the cooperative launch: {out!r}")
        check("next call exact: True" in out,
              f"{label}: the next call differs from the twin: {out!r}")
        refusal = out.split("refused:", 1)[1].splitlines()[0].strip()
        print(f"kernel {label}: the cooperative launch held (refused: "
              f"{refusal}); the next call exact", flush=True)


def compaction_checks(dev, rng, t, scan_x, stat, base):
    """The one-pass compaction (csrc/compact.cuh) behind compact_mask, the
    filter and the scan tail: the kernels and memsets a call puts on the
    card (one and none for compact_mask with 1-3 columns, the filter and
    the scan tail, whose last tile's block writes the sentinel; and for the
    count histogram at Radix's hi80 2^22 and the JoinOmnisci build's hi128
    2^20, two for the scan's phase A, the chunk-stats kernel and its
    cumsum); then calls
    of all three queued back to back on one stream, each finding the shared
    scratch the one before left at 0, and three on each of two streams
    behind a sleep, each stream with its own scratch; each held exactly to
    its twin."""
    from dwarf_bench_tpu_torch.common.datagen import make_random
    from dwarf_bench_tpu_torch.ops import chunk_stats_cuda, compact_cuda, \
        filter_cuda, hist_cuda, scan_tail_cuda
    from dwarf_bench_tpu_torch.utils.kernel_times import device_ops

    cm, f, st = (compact_cuda.compact_mask, filter_cuda.filter,
                 scan_tail_cuda.scan_tail_streams)
    scan_mask = scan_x < 5
    cases = [(f"compact_mask [2^24 x {k} cols]", cm, (scan_mask,
                                                       (scan_x,) * k), (1, 0))
             for k in (1, 2, 3)]
    cases += [("filter [2^24 x<5]", f, (scan_x, 5), (1, 0)),
              ("scan_tail_streams [2^17 chunks]", st,
               (stat, base, 5, 16384, 512), (1, 0)),
              ("chunk_stats [2^17 chunks]", chunk_stats_cuda.chunk_stats,
               (scan_x.view(-1, 128), 5), (2, 0)),
              ("histogram [hi80 2^22]", hist_cuda.histogram,
               (t(make_random(1 << 22, seed=1) - 1), 80), (1, 0)),
              ("histogram [hi128 2^20]", hist_cuda.histogram,
               (t(make_random(1 << 20, seed=2) - 1), 128), (1, 0))]
    for label, fn, args, want in cases:
        ops = device_ops(fn, *args)
        print(f"kernel {label}: kernels per call {ops[0]!r}, memsets "
              f"{ops[1]!r}", flush=True)
        check(ops == want, f"{label}: {ops} kernels and memsets a call, "
                           f"expected {want}")

    def same(label, got, exp, caps):
        """Counts equal, and every output in the slots below its count (spos
        whole: the sentinel past n_single)."""
        if len(got) == 6:  # the scan tail
            ns, nm = (int(v) for v in exp[4:])
            ks, km = min(ns, caps[0]), min(nm, caps[1])
            ok = [int(v) for v in got[4:]] == [ns, nm] and torch.equal(
                got[0], exp[0]) and all(torch.equal(g[:k], e[:k]) for g, e, k
                                        in zip(got[1:4], exp[1:4],
                                               (ks, km, km)))
        else:
            gouts, gcount = got
            eouts, ecount = exp
            gouts = gouts if isinstance(gouts, tuple) else (gouts,)
            eouts = eouts if isinstance(eouts, tuple) else (eouts,)
            k = min(int(ecount), caps[0])
            ok = int(gcount) == int(ecount) and all(
                torch.equal(g[:k], e[:k]) for g, e in zip(gouts, eouts))
        check(ok, f"{label}: differs from the twin")

    plain = {cm: compact_cuda.compact_mask_plain,
             f: filter_cuda.filter_plain,
             st: scan_tail_cuda.scan_tail_streams_plain}
    wide = t(rng.integers(1, 10000, (1 << 22) + 9, endpoint=True))
    calls = [(f, (scan_x, 5, 1 << 24), (1 << 24,)),
             (cm, (wide < 5000, (wide, wide + 1), 1000), (1000,)),
             (st, (stat, base, 5, 7, 3), (7, 3)),
             (f, (wide[1:8193], 5000, 8192), (8192,)),
             (cm, (wide[3:] < 9000, (wide[3:],), None), (wide.numel() - 3,))]
    torch.cuda.synchronize()
    outs = [fn(*args) for fn, args, _ in calls]
    for got, (fn, args, caps) in zip(outs, calls):
        same("back to back on one stream", got, plain[fn](*args), caps)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    xs = [wide, scan_x[:(1 << 22) + 5]]
    torch.cuda.synchronize()
    outs = [[], []]
    for i, s in enumerate(streams):
        with torch.cuda.stream(s):
            torch.cuda._sleep(5_000_000)
            outs[i] = [f(xs[i], 5000), st(stat, base, 5, 16384, 512),
                       cm(xs[i] < 7000, (xs[i], xs[i] - 1))]
    torch.cuda.synchronize()
    for i, x in enumerate(xs):
        n = x.numel()
        same(f"stream {i}", outs[i][0], filter_cuda.filter_plain(x, 5000),
             (n,))
        same(f"stream {i}", outs[i][1], plain[st](stat, base, 5, 16384, 512),
             (16384, 512))
        same(f"stream {i}", outs[i][2], compact_cuda.compact_mask_plain(
            x < 7000, (x, x - 1)), (n,))
    print("kernel filter, compact_mask, scan_tail_streams [back to back x 5, "
          "two streams x 3]: max_abs_err=0", flush=True)


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


def phase_cliffs(dev):
    """The adaptive engines' dispatch cliffs and the engine fuzz on the
    card (``dwarf_bench_tpu_torch/utils/cliffs.py``: every case of the JAX
    package's tests/test_cliffs_slow.py and tests/test_engine_fuzz.py at
    their sizes, and the filter caps' and the sort spans' exact
    boundaries), with the launch counts set to 0 before and read after:
    one line a case (the branch taken, the count, exact or not, the ms of
    one call, the reads back to the host). A case that is not exact
    against its host oracle, takes another branch than the host predicts,
    does not launch its branch's kernels, or reads back other than
    ``ops.trace.READS`` documents fails the run. Returns the counts."""
    from dwarf_bench_tpu_torch.ops import _build
    from dwarf_bench_tpu_torch.utils import cliffs

    _build.reset_launches()
    t0 = time.perf_counter()
    for case in cliffs.CASES:
        got = cliffs.run(case, dev)
        print(got.line(), flush=True)
        check(got.ok, got.line())
    launches = dict(_build.LAUNCHES)
    print(f"cliffs: {len(cliffs.CASES)} cases exact in "
          f"{time.perf_counter() - t0!r} s", flush=True)
    print(f"launches in the cliffs phase: {launches}", flush=True)
    return launches


def scan_ops(dev):
    """filter_sparse called directly, where the dwarfs cannot reach:
    - the caps trip (2^20 rows, x < 5000: the data and predicate of bench.py
      run_scan_sel50_extra) with assume_sparse=False, so the general
      ``filter`` kernel runs, and the result must equal filter_oracle;
    - the dwarfs' assume_sparse=True call at 2^24 under CUDA's sync debug
      mode "error", which raises if anything reads the card back to the
      host between the input and the returned (out, count); its phase A
      must launch the chunk-stats kernel once."""
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
    before = _build.LAUNCHES["chunk_stats"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, count = scan.filter_sparse(xd, assume_sparse=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(_build.LAUNCHES["chunk_stats"] == before + 1,
          "filter_sparse 2^24 x<5: phase A did not launch chunk_stats once")
    expected = scan.filter_oracle(x)
    check(int(count) == len(expected) and np.array_equal(
        out[: len(expected)].cpu().numpy(), expected),
        "filter_sparse 2^24 x<5: differs from filter_oracle")
    print("filter_sparse 2^24 x<5 assume_sparse: valid, no host read, "
          "phase A on the chunk_stats kernel once", flush=True)


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


def phase_library(dev):
    """This slice's paths through the library entry points, with the
    launch counts set to 0 before and read after. Returns the counts."""
    from dwarf_bench_tpu_torch.ops import _build

    _build.reset_launches()
    stats_pallas_paths(dev)
    csr_join_path(dev)
    opt_in_names(dev)
    launches = dict(_build.LAUNCHES)
    print(f"launches in the library phase: {launches}", flush=True)
    return launches


def _launched(before, kernels, label):
    from dwarf_bench_tpu_torch.ops import _build

    for k in kernels:
        check(_build.LAUNCHES[k] > before[k],
              f"{label}: kernel {k} was not launched")


def stats_pallas_paths(dev):
    """filter_sparse's round-2 path, stats_pallas=True (the chunk-stats
    kernel) and False (plain stats), at 2^24 x < 5 (bench.py run_scan) and
    2^20 x < 5000 (run_scan_sel50_extra: the caps trip, kernel filter),
    held to filter_oracle and timed beside stats_pallas=None, in the order
    None, False, True, True, False, None; then stats_pallas=True with
    assume_sparse=True under CUDA's sync debug mode "error"."""
    from dwarf_bench_tpu_torch.common.datagen import make_random
    from dwarf_bench_tpu_torch.ops import _build, scan
    from dwarf_bench_tpu_torch.utils.kernel_times import device_ops
    from dwarf_bench_tpu_torch.utils.timing import kernel_time

    for n, thr, seed, label in ((1 << 24, 5, 7, "2^24 x<5"),
                                (1 << 20, 5000, 8, "2^20 x<5000")):
        x = make_random(n, seed=seed)
        xd = torch.from_numpy(x).to(dev)
        expected = scan.filter_oracle(x, thr)
        sparse = scan.sparse_caps_ok(x, thr)
        times = {None: [], False: [], True: []}
        for sp in (None, False, True, True, False, None):
            before = dict(_build.LAUNCHES)
            out, count = scan.filter_sparse(xd, thr, stats_pallas=sp)
            check(int(count) == len(expected) and np.array_equal(
                out[: len(expected)].cpu().numpy(), expected),
                f"filter_sparse {label} stats_pallas={sp}: differs from "
                "filter_oracle")
            if sp:
                _launched(before, ("chunk_stats_pallas", "cumsum",
                                   "compact_mask")
                          + (("emit_prefix",) if sparse else ("filter",)),
                          f"filter_sparse {label} stats_pallas=True")
            if sp is None:
                _launched(before, ("chunk_stats", "cumsum",
                                   "scan_tail_streams")
                          + (("emit_prefix",) if sparse else ("filter",)),
                          f"filter_sparse {label} stats_pallas=None")
            call = (lambda v, sp=sp:
                    scan.filter_sparse(v, thr, stats_pallas=sp))
            times[sp].append((kernel_time(call, xd) * 1e3,
                              busy_ms(call, xd)))
        print(f"filter_sparse {label} ({'sparse' if sparse else 'caps trip'}"
              f"): valid; (kernel_time_ms, device_ms) stats_pallas=None "
              f"{times[None]!r} False {times[False]!r} True "
              f"{times[True]!r}", flush=True)

    x = make_random(1 << 24, seed=7)
    xd = torch.from_numpy(x).to(dev)
    check(scan.sparse_caps_ok(x), "scan data does not fit the sparse caps")
    scan.filter_sparse(xd, assume_sparse=True, stats_pallas=True)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, count = scan.filter_sparse(xd, assume_sparse=True,
                                        stats_pallas=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    expected = scan.filter_oracle(x)
    check(int(count) == len(expected) and np.array_equal(
        out[: len(expected)].cpu().numpy(), expected),
        "filter_sparse 2^24 x<5 stats_pallas assume_sparse: differs from "
        "filter_oracle")
    print("filter_sparse 2^24 x<5 stats_pallas=True assume_sparse: valid, "
          "no host read", flush=True)
    ops = device_ops(lambda v: scan.filter_sparse(v, assume_sparse=True), xd)
    print(f"filter_sparse 2^24 x<5 assume_sparse: kernels per call "
          f"{ops[0]!r}, memsets {ops[1]!r} (graph nodes; the emit gathers "
          f"by the sort's order)", flush=True)


def csr_join_path(dev):
    """The general CSR join at 2^20 rows a side: A keys drawn with
    duplicates from [1, 2^19), B from [1, 2^20) (half miss), spans far past
    the dense index's 2^14. build + probe_merge (JoinOmnisci's engine),
    probe_merge_bitonic, probe and probe_sorted, each held to the exact
    validate_csr_join; probe_merge_bitonic must merge 4 columns with
    merge_bitonic and compact with compact_mask."""
    from dwarf_bench_tpu_torch.dwarfs.join import validate_csr_join
    from dwarf_bench_tpu_torch.ops import _build, bitonic_cuda, csr_join
    from dwarf_bench_tpu_torch.utils.timing import kernel_time, sync

    n = 1 << 20
    rng = np.random.default_rng(20261017)
    a = rng.integers(1, 1 << 19, n).astype(np.uint32)
    b = rng.integers(1, 1 << 20, n).astype(np.uint32)
    distinct = len(np.unique(a))
    da, db = (torch.from_numpy(c.view(np.int32)).to(dev) for c in (a, b))

    def build(keys):
        return csr_join.build(keys, distinct, 2 * distinct)

    table = sync(build(da))
    ids = table.id_buffer.cpu().numpy()
    merged = []
    plain_merge = bitonic_cuda.merge_bitonic

    def spy(cols, num_cmp=2):
        merged.append((len(cols), cols[0].numel(), num_cmp))
        return plain_merge(cols, num_cmp)

    times = {"build": kernel_time(build, da) * 1e3}
    for name in ("probe_merge", "probe_merge_bitonic", "probe",
                 "probe_sorted"):
        fn = getattr(csr_join, name)
        before = dict(_build.LAUNCHES)
        bitonic_cuda.merge_bitonic = spy
        try:
            res = sync(fn(table, db))
        finally:
            bitonic_cuda.merge_bitonic = plain_merge
        check(validate_csr_join(a, b, ids, res.found.cpu().numpy(),
                                res.pos.cpu().numpy(),
                                res.counts.cpu().numpy()),
              f"csr_join {name} 2^20: differs from the oracle")
        if name == "probe_merge_bitonic":
            _launched(before, ("merge_bitonic", "compact_mask"),
                      "csr_join probe_merge_bitonic")
            n_pow2 = 1 << (distinct + n - 1).bit_length()
            check(merged == [(4, n_pow2, 2)],
                  f"probe_merge_bitonic merged {merged}, expected "
                  f"[(4, {n_pow2}, 2)]")
        times[name] = kernel_time(fn, table, db) * 1e3
    print(f"csr_join 2^20 x 2^20 ({distinct} distinct A keys): valid; "
          f"kernel_time_ms {times!r}; join (build + probe_merge) "
          f"{times['build'] + times['probe_merge']!r}; device_ms build "
          f"{busy_ms(build, da)!r} probe_merge_bitonic "
          f"{busy_ms(csr_join.probe_merge_bitonic, table, db)!r}",
          flush=True)


def opt_in_names(dev):
    """Every opt-in JAX name of this slice once, at the shape its path
    gives it, held to its plain version."""
    from dwarf_bench_tpu_torch.common.datagen import make_random
    from dwarf_bench_tpu_torch.ops import (
        chunk_stats_cuda,
        csr_join,
        groupby_cuda,
        hist_cuda,
        probe_cuda,
        scan_tail_cuda,
    )
    from dwarf_bench_tpu_torch.ops.chunk_stats import chunk_stats

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def same(label, got, exp):
        got = got if isinstance(got, tuple) else (got,)
        exp = exp if isinstance(exp, tuple) else (exp,)
        check(all(torch.equal(g, e) for g, e in zip(got, exp)),
              f"{label}: differs from its plain version")

    x2 = t(make_random(1 << 24, seed=7)).view(-1, 128)
    stat, base = chunk_stats(x2, 5)
    for name in STATS_NAMES:
        same(name, getattr(chunk_stats_cuda, name)(x2, 5), (stat, base))
    got = scan_tail_cuda.scan_tail_compact(stat, base, 5, 16384, 512)
    exp = scan_tail_cuda.scan_tail_streams_plain(stat, base, 5, 16384, 512)
    ks, km = min(int(exp[4]), 16384), min(int(exp[5]), 512)
    same("scan_tail_compact", (got[0], got[1][:ks], got[2][:km],
                               got[3][:km], got[4], got[5]),
         (exp[0], exp[1][:ks], exp[2][:km], exp[3][:km], exp[4], exp[5]))

    a, b = make_random(1 << 20, seed=11), make_random(1 << 20, seed=12)
    table = csr_join.build_dense(t(a))
    res = csr_join.probe_dense(table, t(b))
    ki = t(b - int(table.minv))
    for name, args in (("probe_dense_rel_pallas", ()),
                       ("probe_dense_cat_pallas", (80,))):
        pos, cnt = getattr(probe_cuda, name)(table.packed3, table.base128,
                                             ki, *args)
        same(name, (pos, cnt), (res.pos, res.counts))

    radix_k = t(make_random(1 << 22, seed=1) - 1)
    same("histogram_16k_pallas", hist_cuda.histogram_16k_pallas(radix_k, 80),
         hist_cuda.histogram_plain(radix_k, 80))
    k, v = t(make_random(1 << 20, 0, 65535, seed=5)), \
        t(make_random(1 << 20, seed=6))
    same("weighted_histogram_pallas",
         hist_cuda.weighted_histogram_pallas(k, v, 512),
         hist_cuda.weighted_histogram_plain(k, v, 512))
    k14 = t(make_random(1 << 20, 0, (1 << 14) - 1, seed=13))
    same("weighted_histogram_16k_pallas",
         hist_cuda.weighted_histogram_16k_pallas(k14, v),
         hist_cuda.weighted_histogram_plain(k14, v, 128))
    gk, gv = t(make_random(1 << 22, 0, 63, seed=3)), \
        t(make_random(1 << 22, seed=4))
    gk10k = t(make_random(1 << 20, 0, 9999, seed=14))
    for name in GROUPBY_NAMES:
        fn = getattr(groupby_cuda, name)
        same(f"{name} G=64", fn(gk, gv, 64),
             groupby_cuda.groupby_digits_plain(gk, gv, 64))
        same(f"{name} G=10000", fn(gk10k, v, 10_000),
             groupby_cuda.groupby_digits_plain(gk10k, v, 10_000))
    print("opt-in names: each equal to its plain version at its main-path "
          "shape", flush=True)


# GroupByLocal through the CLI: (rows, groups, executors, the kernel the
# executor-offset group-by must launch). 64 x 64 partial groups take the
# groupby_small kernel; 20 x 1024 (the API's GroupByRunOptions) take the
# weighted histogram.
GROUPBY_LOCAL_RUNS = [
    (1 << 22, 64, 64, "groupby_small"),
    (1 << 22, 20, 1024, "weighted_histogram"),
]
GROUPBY_LOCAL_HEADER = ("device_type,buf_size_bytes,total_time,"
                        "group_by_time,reduction_time")
CONSTANT_DWARFS = ("ConstantExample", "ConstantExampleCAPI",
                   "ConstantExampleDPCPP", "ConstantExampleDPCPPCuda")
# DwarfBench on ApiDeviceType.GPU: (kind, rows, the registry name it runs)
API_RUNS = [("Sort", 1 << 22, "RadixCuda"), ("GroupBy", 1 << 22, "GroupByCuda"),
            ("Join", 1 << 20, "JoinOmnisciCuda"),
            ("Scan", 1 << 24, "DPLScanCuda")]
# the examples as their users run them, and a line each must print
EXAMPLES = [("bench_usage", "GroupBy: dataSize=1024 microseconds="),
            ("vadd", "pallas vadd ok: True"), ("lock_add", "64 = 64")]


def phase_front_end(dev):
    """This slice's entry points with the launch counts set to 0 before and
    read after: the three examples as subprocesses on the card (started
    first, waited for last), GroupByLocal through the CLI, the Constant*
    dwarfs, ``DwarfBench.make_measurements`` on ApiDeviceType.GPU for each
    DwarfKind at the main-path sizes, the vadd and lock_add examples' main
    in this process, and every measurement-script name once at its main
    shape against its plain version. Returns the counts."""
    from dwarf_bench_tpu_torch.ops import _build

    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    try:
        for name, _ in EXAMPLES:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", f"dwarf_bench_tpu_torch.examples.{name}"],
                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        _build.reset_launches()
        groupby_local_runs()
        constant_runs()
        api_runs()
        examples_in_process()
        script_names(dev)
        launches = dict(_build.LAUNCHES)
        for (name, line), proc in zip(EXAMPLES, procs):
            out = proc.communicate(timeout=600)[0]
            check(proc.returncode == 0 and line in out,
                  f"example {name}: exit code {proc.returncode}, output "
                  f"{out[-2000:]!r}")
            print(f"example {name} (subprocess): exit 0, "
                  f"{len(out.splitlines())} lines", flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"launches in the front-end phase: {launches}", flush=True)
    return launches


def groupby_local_runs():
    from dwarf_bench_tpu_torch import cli, populate_registry
    from dwarf_bench_tpu_torch.ops import _build

    registry = populate_registry()
    with tempfile.TemporaryDirectory() as tmp:
        for rows, groups, executors, kernel in GROUPBY_LOCAL_RUNS:
            label = f"GroupByLocal {rows} G={groups} executors={executors}"
            before = _build.LAUNCHES[kernel]
            csv = os.path.join(tmp, f"{groups}_{executors}.csv")
            rc = cli.main(["GroupByLocal", "--device=gpu", "--input_size",
                           str(rows), "--iterations=3",
                           f"--groups_count={groups}",
                           f"--executors={executors}",
                           f"--report_path={csv}"])
            check(rc == 0, f"{label}: CLI exit code {rc}")
            results = [r.result for r in
                       registry.find("GroupByLocal").get_results()]
            check(len(results) == 3 and all(r.valid for r in results),
                  f"{label}: not valid 3/3")
            check(_build.LAUNCHES[kernel] > before,
                  f"{label}: kernel {kernel} was not launched")
            with open(csv) as f:
                header = f.readline().rstrip("\n")
            check(header == GROUPBY_LOCAL_HEADER,
                  f"{label}: CSV header {header!r}")
            print(f"dwarf {label}: valid 3/3 "
                  f"host_time_ms={[r.host_time * 1e3 for r in results]!r} "
                  f"group_by_time_ms="
                  f"{[r.group_by_time * 1e3 for r in results]!r} "
                  f"reduction_time_ms="
                  f"{[r.reduction_time * 1e3 for r in results]!r}",
                  flush=True)


def constant_runs():
    import contextlib
    import io

    from dwarf_bench_tpu_torch import cli, populate_registry

    registry = populate_registry()
    for name in CONSTANT_DWARFS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main([name, "--device=gpu", "--iterations=3"])
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("42")]
        check(rc == 0 and lines == ["42 = 42"] * 3,
              f"dwarf {name}: exit code {rc}, lines {lines!r}")
        check(len(registry.find(name).get_results()) == 0,
              f"dwarf {name}: recorded a result")
        print(f"dwarf {name}: printed 42 = 42 three times", flush=True)


def api_runs():
    from dwarf_bench_tpu_torch import (
        ApiDeviceType,
        DwarfBench,
        DwarfKind,
        RunConfig,
        populate_registry,
    )

    registry = populate_registry()
    for kind, rows, impl in API_RUNS:
        conf = RunConfig(device=ApiDeviceType.GPU, input_size=rows,
                         iterations=3, dwarf=DwarfKind[kind])
        ms = DwarfBench().make_measurements(conf)
        results = [r.result for r in registry.find(impl).get_results()]
        check(len(ms) == 3 and all(m.data_size == rows for m in ms),
              f"API {kind} {rows}: measurements {ms!r}")
        check(len(results) == 3 and all(r.valid for r in results),
              f"API {kind} {rows}: {impl} not valid 3/3")
        print(f"API {kind} {rows} ({impl}): valid 3/3 microseconds="
              f"{[m.microseconds for m in ms]!r}", flush=True)


def examples_in_process():
    from dwarf_bench_tpu_torch.examples import lock_add, vadd

    for name, example in (("vadd", vadd), ("lock_add", lock_add)):
        check(example.main([]) == 0, f"example {name}: main returned non-0")


def script_names(dev):
    """Each measurement-script name once at its main's shape, held to its
    plain version."""
    from dwarf_bench_tpu_torch.common.datagen import make_random
    from dwarf_bench_tpu_torch.ops import groupby_cuda, hist_cuda
    from dwarf_bench_tpu_torch.ops import measure_variants as mv

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def same(label, got, exp):
        check(torch.equal(got, exp), f"{label}: differs from its plain "
                                     "version")

    x22 = t(make_random(1 << 22, seed=1))
    h128 = hist_cuda.histogram_plain(x22, 128)
    same("histogram_16k_i8cmp", mv.histogram_16k_i8cmp(x22), h128)
    same("hist16k_bf16cmp", mv.hist16k_bf16cmp(x22), h128)
    same("hist_variant", mv.hist_variant(x22, 128, i16=True), h128)
    same("hist_rows", mv.hist_rows(x22, 128, rows=32), h128)
    same("hist_swar", mv.hist_swar(x22, 80, "f5"),
         hist_cuda.histogram_plain(x22, 80))
    idx = t(np.random.default_rng(0).integers(0, 64 * 128, 256))
    same("dyn_store_probe", mv.dyn_store_probe(idx),
         hist_cuda.histogram_plain(idx, 64).view(64, 128))
    k16, v = t(make_random(1 << 20, 0, 65535, seed=5)), \
        t(make_random(1 << 20, seed=6))
    w512 = hist_cuda.weighted_histogram_plain(k16, v, 512)
    same("weighted_histogram_i8", mv.weighted_histogram_i8(k16, v, 512), w512)
    same("whist_i8", mv.whist_i8(k16, v, 512), w512)
    gk, gv = t(make_random(1 << 22, 0, 63, seed=3)), \
        t(make_random(1 << 22, seed=4))
    g64 = groupby_cuda.groupby_small_plain(gk, gv, 64)
    same("groupby_small_v2", mv.groupby_small_v2(gk, gv, 64), g64)
    same("groupby_small_v3", mv.groupby_small_v3(gk, gv, 64, one_dot=True),
         g64)
    same("groupby_small_v5", mv.groupby_small_v5(gk, gv, 64, rows=32,
                                                 w=4096), g64)
    same("groupby_small_stacked", mv.groupby_small_stacked(gk, gv, 64), g64)
    same("_gb_dbuf_kernel", mv._gb_dbuf_kernel()(gk, gv), g64)
    for mode in mv.DIAG_MODES:
        same(f"_gb_diag_kernel_factory {mode}",
             mv._gb_diag_kernel_factory(mode)(gk, gv),
             mv.gb_diag_plain(gk, gv, mode, 8, 8, 32, 4096))
    print("measurement-script names: each equal to its plain version at its "
          "main's shape", flush=True)


# the kernels the headline bench's components and extras must launch
BENCH_KERNELS = ("histogram", "cumsum", "groupby_small", "weighted_histogram",
                 "chunk_stats", "scan_tail_streams", "compact_mask",
                 "emit_prefix", "filter", "reduce_sum", "merge_bitonic",
                 "merge_fill")


def phase_bench(dev):
    """The port's headline bench (``python -m dwarf_bench_tpu_torch.bench``)
    in this process at the JAX bench's sizes, with the launch counts set to
    0 before and read after: its line printed on a line of its own; nothing
    skipped and nothing raised (each component's call was checked once
    against its host oracle: the sorted column, the group sums, the join's
    id sets, the scan's rows, and the extras' rows, sum and probes); every
    component positive and no cold share of the roofline above 1.0; every
    kernel of its path launched. Returns the counts and the line."""
    from dwarf_bench_tpu_torch import bench
    from dwarf_bench_tpu_torch.ops import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    line, failed = bench.run(dev)
    launches = dict(_build.LAUNCHES)
    print(json.dumps(line), flush=True)
    print(f"bench: {time.perf_counter() - t0!r} s", flush=True)
    check(not failed and line["skipped"] == [],
          f"bench: skipped {line['skipped']}")
    comps = line["components_rows_per_s"]
    check(set(comps) == set(bench.COMPONENTS)
          and all(v > 0 for v in comps.values()),
          f"bench: components {comps}")
    for op, frac in line["components_roofline_frac"].items():
        check(0 < frac <= 1.0, f"bench: {op} reads {frac!r} of its "
                               "roofline, cold")
    for k in BENCH_KERNELS:
        check(launches[k] > 0, f"bench: kernel {k} was not launched")
    print(f"launches in the bench phase: {launches}", flush=True)
    return launches, line


def phase_timers(dev):
    """The bench's timer against ``graph_ms`` of the same call (within
    10 % or 3 us, whichever is larger): ``filter_sparse`` at 2^24 x < 5 and
    the count histogram at hi80 2^22, warm; and a call that reads back to
    the host must make the timer raise."""
    from dwarf_bench_tpu_torch.ops import hist_cuda, scan
    from dwarf_bench_tpu_torch.utils import timing

    rng = np.random.default_rng(20261018)
    x = torch.from_numpy(rng.integers(1, 10000, 1 << 24, endpoint=True)
                         .astype(np.int32)).to(dev)
    k = torch.from_numpy(rng.integers(0, 10000, 1 << 22)
                         .astype(np.int32)).to(dev)
    cases = (("filter_sparse 2^24 x<5",
              lambda v: scan.filter_sparse(v, assume_sparse=True), x),
             ("histogram hi80 2^22", lambda v: hist_cuda.histogram(v, 80), k))
    for label, fn, arg in cases:
        slope_ms = timing.time_device_looped_inplace(fn, arg) * 1e3
        cold_slope_ms = timing.time_device_looped_inplace(
            fn, arg, cold=True) * 1e3
        g = timing.graph_ms(fn, arg)
        print(f"timer {label}: time_device_looped_inplace {slope_ms!r} ms, "
              f"cold {cold_slope_ms!r} ms, graph_ms {g!r} ms", flush=True)
        check(abs(slope_ms - g) <= max(0.1 * g, 3e-3),
              f"timer {label}: {slope_ms!r} ms against graph_ms {g!r}")

    def reads_back(v):
        return v[: int(v[0].item()) + 1]

    try:
        timing.time_device_looped_inplace(reads_back, x)
    except RuntimeError as e:
        check("reads back to the host" in str(e), f"timer: {e}")
        print("timer: a call that reads back to the host raises", flush=True)
    else:
        check(False, "timer: a call that reads back to the host was timed")


def phase_entry(dev):
    """``dwarf_bench_tpu_torch.entry``'s forward on the card against the
    same forward on the CPU (both sorts stable: every output equal), and
    against the id-set oracle, with the launch counts set to 0 before and
    read after. Returns the counts."""
    from dwarf_bench_tpu_torch import entry
    from dwarf_bench_tpu_torch.ops import _build, csr_join

    fn, (a, b) = entry.entry()
    check(a.device == dev and b.device == dev, "entry: inputs not on card")
    _build.reset_launches()
    got = fn(a, b)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches["histogram"] > 0, "entry: histogram was not launched")
    exp = fn(a.cpu(), b.cpu())
    for name, g, e in zip(("found", "pos", "counts", "id_buffer"), got, exp):
        check(torch.equal(g.cpu(), e), f"entry: {name} differs from the CPU")
    sets = [set(exp[3][p: p + c].tolist()) for p, c in
            zip(exp[1].tolist(), exp[2].tolist())]
    check(sets == csr_join.oracle_id_sets(a.cpu().numpy(), b.cpu().numpy()),
          "entry: the id sets differ from the oracle")
    print(f"entry: forward on the card equals the CPU's "
          f"({int(got[0].sum())} of {a.numel()} probes found)", flush=True)
    return launches


# the kernels the distributed layer's builders launch on one rank: the
# dense joins' build (histogram), the filter's engine (phase A, the tail,
# the compactions, the emit, and filter where its caps trip), the group-bys
# (groupby_small) and the CSR build's and the rows join's compaction
PARALLEL_KERNELS = ("histogram", "chunk_stats", "cumsum", "scan_tail_streams",
                    "compact_mask", "emit_prefix", "filter", "groupby_small")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pair_counts(a: np.ndarray, b: np.ndarray):
    """(A's count of each B row's key, the total of matching pairs), both
    exact in 64 bits."""
    ca = np.bincount(a, minlength=1 << 14).astype(np.int64)
    cb = np.bincount(b, minlength=1 << 14).astype(np.int64)
    return ca[b], int(np.sum(ca[: cb.size] * cb[: ca.size]))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def parallel_calls(dev, mesh, mesh2):
    """Each builder of ``dwarf_bench_tpu_torch.parallel`` at the headline
    bench's per-chip sizes on this one-rank world, with its inputs on the
    card and a host check of its outputs: (label, fn, args, check)."""
    from dwarf_bench_tpu_torch import parallel as par
    from dwarf_bench_tpu_torch.common.datagen import make_unique_random
    from dwarf_bench_tpu_torch.ops.join import seq_join_oracle

    rng = np.random.default_rng(20261019)
    n = 1 << 20
    a = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    b = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    per_row, pairs = _pair_counts(a, b)
    # one key on 55 % of both sides: past the heavy threshold (capacity / 2)
    a_s, b_s = a.copy(), b.copy()
    a_s[rng.random(n) < 0.55] = 7
    b_s[rng.random(n) < 0.55] = 7
    _, pairs_s = _pair_counts(a_s, b_s)
    a7 = int((a_s == 7).sum())
    uk = [make_unique_random(n, seed=s) for s in (21, 22, 23, 24)]
    rows_oracle = seq_join_oracle(*uk)
    g64 = (rng.integers(0, 64, 1 << 22).astype(np.uint32),
           rng.integers(1, 10000, 1 << 22, endpoint=True).astype(np.uint32))
    g16 = (rng.integers(0, 1 << 16, n).astype(np.uint32),
           rng.integers(1, 10000, n, endpoint=True).astype(np.uint32))
    x24 = rng.integers(1, 10000, 1 << 24, endpoint=True).astype(np.int32)
    x20 = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    xs = rng.integers(1, 10000, 1 << 22, endpoint=True).astype(np.uint32)

    def put(*arrays):
        return par.shard_rows(mesh, *arrays) if len(arrays) > 1 else \
            (par.shard_rows(mesh, *arrays),)

    def group_sums(keys, vals, g):
        s = np.bincount(keys, weights=vals.astype(np.float64), minlength=g)
        return (s.astype(np.uint64) % (1 << 32)).astype(np.uint32)

    def join_check(out):
        counts, local, total, ov = out
        return (int(ov) == 0 and int(total) == pairs == int(local)
                and np.array_equal(counts.cpu().numpy(), per_row))

    def ring_check(out):
        acc, local, total = out
        return int(total) == pairs and np.array_equal(acc.cpu().numpy(),
                                                      per_row)

    def skew_check(out):
        light, heavy, total, ov = out
        h = heavy.cpu().numpy().astype(np.int64)
        return (int(ov) == 0
                and np.array_equal(h, np.where(b_s == 7, a7, 0))
                and int(light.sum(dtype=torch.int64)) + int(h.sum()) == pairs_s
                and int(total) % (1 << 32) == pairs_s % (1 << 32))

    def rows_check(out):
        k, av, bv, cnt, ov = out
        c = int(cnt)
        rows = np.stack([_u32(t[:c]).astype(np.uint64) for t in (k, av, bv)],
                        axis=1)
        rows = rows[np.lexsort(rows.T[::-1])]
        return int(ov) == 0 and np.array_equal(rows, rows_oracle)

    def dense_gb_check(keys, vals, g):
        exp = group_sums(keys, vals, g)
        return lambda out: np.array_equal(_u32(out), exp)

    def shuffle_gb_check(out):
        sums, ov = out
        return int(ov) == 0 and np.array_equal(_u32(sums), group_sums(*g64, 64))

    def filter_check(x, thr):
        hits = x[x < thr]

        def ok(out):
            vals, cnt, off, total = out
            c = int(cnt)
            return (c == int(total) == hits.size and int(off) == 0
                    and np.array_equal(vals[:c].cpu().numpy(), hits))
        return ok

    def sort_check(out):
        buf, valid, ov = out
        v = int(valid)
        return (int(ov) == 0 and v == xs.size
                and np.array_equal(_u32(buf[:v]), np.sort(xs)))

    join = dict(rows_per_chip=n, distinct_cap=1 << 14, ht_size=1 << 15)
    ring = dict(rows_per_chip=n, distinct_cap=1 << 14, ht_size=1 << 15)
    j2 = dict(rows_per_chip=n, distinct_cap=1 << 14, ht_size=1 << 15,
              cap_ici=n, cap_dcn=n)
    ab, ab2 = put(a, b), par.shard_rows(mesh2, a, b)
    return [
        ("dist_csr_join 2^20 x 2^20",
         par.dist_csr_join(mesh, **join, shuffle_capacity=n), ab, join_check),
        ("dist_csr_join dense 2^20 x 2^20",
         par.dist_csr_join(mesh, **join, shuffle_capacity=n, dense=True), ab,
         join_check),
        ("dist_csr_join_ring 2^20 x 2^20",
         par.dist_csr_join_ring(mesh, **ring), ab, ring_check),
        ("dist_csr_join_ring dense 2^20 x 2^20",
         par.dist_csr_join_ring(mesh, **ring, dense=True), ab, ring_check),
        ("dist_csr_join_skew 2^20 x 2^20, key 7 on 55 %",
         par.dist_csr_join_skew(mesh, **join, shuffle_capacity=n),
         put(a_s, b_s), skew_check),
        ("dist_csr_join_2d (1, 1) 2^20 x 2^20",
         par.dist_csr_join_2d(mesh2, **j2), ab2, join_check),
        ("dist_csr_join_ring_2d (1, 1) 2^20 x 2^20",
         par.dist_csr_join_ring_2d(mesh2, **ring), ab2, ring_check),
        ("dist_hash_join_rows 2^20 unique",
         par.dist_hash_join_rows(mesh, shuffle_capacity=n, ht_size=2 * n),
         put(*uk), rows_check),
        ("dist_groupby_dense 2^22 G=64", par.dist_groupby_dense(mesh, 64),
         put(*g64), dense_gb_check(*g64, 64)),
        ("dist_groupby_shuffle 2^22 G=64",
         par.dist_groupby_shuffle(mesh, 64, 1 << 22), put(*g64),
         shuffle_gb_check),
        ("dist_groupby_dense 2^20 G=2^16",
         par.dist_groupby_dense(mesh, 1 << 16), put(*g16),
         dense_gb_check(*g16, 1 << 16)),
        ("dist_filter 2^24 x<5", par.dist_filter(mesh, 5, 1 << 24),
         put(x24), filter_check(x24, 5)),
        ("dist_filter 2^20 x<5000", par.dist_filter(mesh, 5000, n),
         put(x20), filter_check(x20, 5000)),
        ("dist_sort 2^22", par.dist_sort(mesh, 1 << 22), put(xs),
         sort_check),
    ]


def phase_parallel(dev):
    """The distributed layer on the card as an NCCL world of one rank: every
    builder at the headline bench's per-chip sizes on a (1,) and a (1, 1)
    mesh, each checked once against a host oracle with zero overflow, with
    the launch counts set to 0 before and read after; then each call's
    median CUDA-event time of 10 calls and its profiler device time, beside
    the card; the dry run (``python -m dwarf_bench_tpu_torch.dryrun``) as a
    subprocess; and Radix 2^22 through the CLI with ``--profile_dir``,
    whose trace must name the histogram kernel. Returns the counts."""
    import torch.distributed as dist

    from dwarf_bench_tpu_torch import parallel as par
    from dwarf_bench_tpu_torch.ops import _build
    from dwarf_bench_tpu_torch.utils.timing import kernel_time, sync

    t0 = time.perf_counter()
    par.init_multihost(f"localhost:{_free_port()}", num_processes=1,
                       process_id=0)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"parallel: {dist.get_backend()} world of "
              f"{dist.get_world_size()}")
        mesh, mesh2 = par.make_mesh(), par.make_mesh_2d()
        check(tuple(mesh2.shape) == (1, 1), f"parallel: 2-D mesh "
                                            f"{tuple(mesh2.shape)}")
        calls = parallel_calls(dev, mesh, mesh2)
        _build.reset_launches()
        outs = [sync(fn(*args)) for _, fn, args, _ in calls]
        launches = dict(_build.LAUNCHES)
        for (label, _, _, ok), out in zip(calls, outs):
            check(ok(out), f"parallel {label}: differs from the host oracle")
        del outs
        card = card_line()
        for label, fn, args, _ in calls:
            print(f"parallel {label}: valid; events "
                  f"{kernel_time(fn, *args) * 1e3!r} ms, device "
                  f"{busy_ms(fn, *args)!r} ms ({card})", flush=True)
    finally:
        dist.destroy_process_group()
    for k in PARALLEL_KERNELS:
        check(launches[k] > 0, f"parallel: kernel {k} was not launched")
    print(f"launches in the parallel phase: {launches}", flush=True)

    proc = subprocess.run([sys.executable, "-m", "dwarf_bench_tpu_torch.dryrun"],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0 and "dryrun_multichip(1) OK" in proc.stdout,
          f"parallel: the dry run failed: {proc.stderr[-2000:]}")
    print(proc.stdout.strip(), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "dwarf_bench_tpu_torch", "Radix",
             "--device=gpu", "--input_size", str(1 << 22), "--iterations=3",
             f"--profile_dir={tmp}"],
            capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"--profile_dir: Radix failed: "
                                    f"{proc.stderr[-2000:]}")
        traces = os.listdir(tmp)
        check(len(traces) == 1, f"--profile_dir: {traces}")
        with open(os.path.join(tmp, traces[0])) as f:
            text = f.read()
        check("histogram_kernel" in text,
              "--profile_dir: the trace names no histogram kernel")
    print(f"--profile_dir: one trace ({len(text)} bytes) naming "
          "histogram_kernel", flush=True)
    print(f"parallel phase: {time.perf_counter() - t0!r} s", flush=True)
    return launches


# the kernels the scripts' runs must launch: Radix's (histogram, cumsum),
# the scans' (phase A, the tail, the compactions, the emit), the hash
# probes' merge (merge_bitonic, merge_fill, compact_mask), and the scaling
# harness's dense join (histogram) and group-by (groupby_small)
SCRIPT_KERNELS = ("histogram", "cumsum", "chunk_stats", "scan_tail_streams",
                  "compact_mask", "emit_prefix", "merge_bitonic",
                  "merge_fill", "groupby_small")


def _script(args, timeout, env=None, cwd=None):
    """Run ``python -m <args>``; the completed process (it must exit
    0)."""
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=cwd)
    check(proc.returncode == 0, f"{' '.join(args)}: exit code "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    return proc


def sweep_grids(tmp):
    """Every grid of ``scripts/sweeps.py`` on the card at its largest and
    its smallest size, 2 iterations, each grid into its own directory,
    three grids at a time (the times are not measurements: the grids share
    the card); then ``scripts/report.py`` over each CSV, which must list
    every size that ran. Returns the runs' launches."""
    import collections
    import contextlib
    import glob
    import io
    from concurrent.futures import ThreadPoolExecutor

    from dwarf_bench_tpu_torch.scripts import report, sweeps

    def one(name):
        grid = sweeps.GRIDS[name]
        t = time.perf_counter()
        done = sweeps.run_grid(name, os.path.join(tmp, name), ("gpu",),
                               sizes=(max(grid.sizes), min(grid.sizes)),
                               iterations=2, timeout=900)
        return name, done, time.perf_counter() - t

    launches = collections.Counter()
    # the hash grid, the longest, first
    order = sorted(sweeps.GRIDS, key=lambda g: g != "hash_large")
    with ThreadPoolExecutor(max_workers=3) as pool:
        runs = list(pool.map(one, order))
    for name, done, seconds in runs:
        grid = sweeps.GRIDS[name]
        want = {max(grid.sizes), min(grid.sizes)}
        for (dwarf, _), sweep in done.items():
            check(not sweep.failed, f"sweeps {name}: {sweep.failed}")
            check(set(sweep.ran) == want and not sweep.skipped,
                  f"sweeps {name} {dwarf}: ran {sweep.ran}, skipped "
                  f"{sweep.skipped}")
            launches.update(sweep.launches)
        for csv in sorted(glob.glob(os.path.join(tmp, name, "*.csv"))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = report.main([csv, "--column", "kernel_time_ms"])
            text = buf.getvalue()
            listed = {(line.split()[0], int(line.split()[1]))
                      for line in text.splitlines()[1:]}
            check(rc == 0 and listed == {("GPU", s * 4) for s in want},
                  f"report {name} {os.path.basename(csv)}: {text}")
            print(f"report {name} {os.path.basename(csv)}:\n{text}",
                  end="", flush=True)
        print(f"sweeps {name}: {seconds!r} s", flush=True)
    return launches


def phase_scripts(dev, bench_line):
    """The scripts of ``dwarf_bench_tpu_torch/scripts/`` on the card: every
    sweep grid at its largest and smallest size, with the report over each
    CSV; the 50 %-hit hash harness at 2^24 (both phases, 9 iterations,
    validated on the device) in this process; the scaling harness on a
    world of ``device_count()`` NCCL ranks at 2^18 and 2^20 rows (overflow
    0), which writes the card's world-of-one rates; the scaling model at
    2^20 from ``bench_line`` (``phase_bench``'s) with the world of one
    beside it (its byte tally on a gloo world of 8 CPU processes); and the
    release
    tar with the kernel library, unpacked, whose entry must run with nvcc
    hidden. Each step's seconds are printed; the launches of every step
    but the release's are returned."""
    import collections
    import tarfile

    from dwarf_bench_tpu_torch.ops import _build
    from dwarf_bench_tpu_torch.scripts import hash_hit50, scaling

    t0 = time.perf_counter()
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        launches = sweep_grids(tmp)
        t1 = time.perf_counter()
        print(f"scripts: the sweeps took {t1 - t0!r} s", flush=True)

        _build.reset_launches()
        try:
            found = hash_hit50.run(24, "all", dev, os.path.join(tmp, "h50"))
        except hash_hit50.Hit50Failure as e:
            raise SmokeFailure(f"hash_hit50: {e}") from e
        launches.update({k: v for k, v in _build.LAUNCHES.items() if v})
        check(set(found) == {"slab", "cuckoo"}, f"hash_hit50: {found}")
        with open(os.path.join(tmp, "h50", "report_hash_hit50.csv")) as f:
            rows = f.read().splitlines()[1:]
        check(len(rows) == 2 * hash_hit50.ITERATIONS,
              f"hash_hit50: {len(rows)} CSV rows")
        for phase, part in (("slab", rows[:9]), ("cuckoo", rows[9:])):
            kernel_ms = [float(r.split(",")[3]) for r in part]
            print(f"hash_hit50 2^24 {phase}: rows/s "
                  f"{[(1 << 24) / (t / 1e3) for t in kernel_ms]!r} ({card})",
                  flush=True)
        t2 = time.perf_counter()
        print(f"scripts: hash_hit50 took {t2 - t1!r} s", flush=True)

        rates = {}
        for lg in (18, 20):
            path = os.path.join(tmp, f"compute_{lg}.json")
            proc = _script(["dwarf_bench_tpu_torch.scripts.scaling",
                            "--device", "gpu", "--rows_per_chip",
                            str(1 << lg), "--compute_json", path], 900)
            lines = [json.loads(x) for x in proc.stdout.splitlines()
                     if x.startswith("{")]
            worlds = scaling.worlds_for(dev)
            check(len(lines) == 5 * len(worlds) + (5 if len(worlds) > 1
                                                   else 0),
                  f"scaling 2^{lg}: {proc.stdout}")
            with open(path) as f:
                rates[lg] = json.load(f)
            check(all(v > 0 for v in rates[lg]["rows_per_s"].values()),
                  f"scaling 2^{lg}: {rates[lg]['rows_per_s']}")
            launches.update(rates[lg]["launches"])
            print(proc.stdout, end="", flush=True)
            print(f"scaling 2^{lg} ({rates[lg]['card']}): world of one "
                  f"rows/s {rates[lg]['rows_per_s']!r}", flush=True)
        t3 = time.perf_counter()
        print(f"scripts: scaling took {t3 - t2!r} s", flush=True)

        bench_json = os.path.join(tmp, "bench.json")
        with open(bench_json, "w") as f:
            f.write(json.dumps(bench_line) + "\n")
        proc = _script(["dwarf_bench_tpu_torch.scripts.scaling_model",
                        "--rows-per-chip", str(1 << 20), "--bench_json",
                        bench_json, "--compute_json",
                        os.path.join(tmp, "compute_20.json"), "--out", tmp],
                       900)
        with open(os.path.join(tmp, "scaling_model.json")) as f:
            mod = json.load(f)
        check(len(mod["ops"]) == 6 and all(
            set(op[p]) == {"8", "32", "256"} for op in mod["ops"].values()
            for p in ("projection", "projection_world_of_one")),
            f"scaling_model: {mod}")
        print(proc.stdout, end="", flush=True)
        print(f"scaling_model: B_NVLINK {mod['B_NVLINK']!r}, B_IB "
              f"{mod['B_IB']!r}, band x{mod['band']!r}", flush=True)
        t4 = time.perf_counter()
        print(f"scripts: scaling_model took {t4 - t3!r} s", flush=True)

        dist_dir = os.path.join(tmp, "dist")
        _script(["dwarf_bench_tpu_torch.scripts.release", "--kernels",
                 "--out", dist_dir], 900)
        tars = os.listdir(dist_dir)
        check(len(tars) == 1, f"release: {tars}")
        unpacked = os.path.join(tmp, "unpacked")
        with tarfile.open(os.path.join(dist_dir, tars[0])) as tf:
            tf.extractall(unpacked, filter="data")
        root = os.path.join(unpacked, tars[0][: -len(".tar.gz")])
        build = os.path.join(root, "dwarf_bench_tpu_torch", "build")
        shipped = os.listdir(build)
        check(len(shipped) == 1 and shipped[0].startswith("libdbt_kernels_"),
              f"release: build/ holds {shipped}")
        env = dict(os.environ, CUDA_HOME=os.path.join(tmp, "no_cuda"))
        env["PATH"] = os.pathsep.join(
            p for p in env.get("PATH", "").split(os.pathsep)
            if p and not os.path.exists(os.path.join(p, "nvcc")))
        env.pop("PYTHONPATH", None)
        proc = subprocess.run([sys.executable, "-m",
                               "dwarf_bench_tpu_torch.entry"],
                              capture_output=True, text=True, timeout=300,
                              env=env, cwd=root)
        check(proc.returncode == 0 and "entry OK" in proc.stdout,
              f"release: the unpacked entry failed: {proc.stderr[-3000:]}")
        check(os.listdir(build) == shipped,
              f"release: the unpacked tree built again: {os.listdir(build)}")
        print(f"release: {tars[0]} unpacked, entry without nvcc: "
              f"{proc.stdout.strip()}", flush=True)
        print(f"scripts: release took {time.perf_counter() - t4!r} s",
              flush=True)
    for k in SCRIPT_KERNELS:
        check(launches[k] > 0, f"scripts: kernel {k} was not launched")
    print(f"launches in the scripts phase: {dict(launches)}", flush=True)
    print(f"scripts phase: {time.perf_counter() - t0!r} s", flush=True)
    return collections.Counter(launches)


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

    dev = torch.device("cuda:0")
    t1 = time.perf_counter()
    stats = phase_kernels(dev)
    t2 = time.perf_counter()
    dwarf_launches = phase_dwarfs("gpu")
    t_cliffs = time.perf_counter()
    cliff_launches = phase_cliffs(dev)
    t3 = time.perf_counter()
    library_launches = phase_library(dev)
    t4 = time.perf_counter()
    front_launches = phase_front_end(dev)
    t5 = time.perf_counter()
    bench_launches, bench_line = phase_bench(dev)
    t6 = time.perf_counter()
    phase_timers(dev)
    entry_launches = phase_entry(dev)
    t7 = time.perf_counter()
    parallel_launches = phase_parallel(dev)
    t8 = time.perf_counter()
    script_launches = phase_scripts(dev, bench_line)
    print(f"phase seconds: kernels {t2 - t1!r}, dwarfs and ops "
          f"{t_cliffs - t2!r}, cliffs {t3 - t_cliffs!r}, library paths {t4 - t3!r}, front end "
          f"{t5 - t4!r}, bench {t6 - t5!r}, timers and entry "
          f"{t7 - t6!r}, parallel {t8 - t7!r}, scripts "
          f"{time.perf_counter() - t8!r}, whole script "
          f"{time.perf_counter() - t0!r}", flush=True)
    launches = {name: dwarf_launches[name] + cliff_launches[name]
                + library_launches[name]
                + front_launches[name] + bench_launches[name]
                + entry_launches[name] + parallel_launches[name]
                + script_launches[name]
                for name in KERNELS}
    for name in KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "dwarfs, the cliffs, the library paths, "
                                  "the front end, the bench, the entry, "
                                  "the distributed layer or the scripts")
        check(stats[name]["ms"] is not None, f"kernel {name} was not timed")

    print("device_ms below bound_ms (a trace lost kernels, or the inputs sat "
          "in the L2): " + json.dumps(
              [f"{name} [{case['label']}]" for name in KERNELS
               for case in stats[name]["cases"]
               if case["device_below_bound"]]), flush=True)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **stats[name]}
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
