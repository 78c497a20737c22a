"""Times of the cumsum, histogram, weighted-histogram, bitonic-merge, sum,
merge-fill, vadd, compaction, sparse-scan, prefix-emit, lock and gb_diag
kernels, their library calls, and the host cost of a kernel launch, on one
CUDA card.

    python dwarf_bench_tpu_torch/utils/kernel_times.py [--root DIR] [--sweep]
        [--host] [--label NAME] [--only GROUP,...]

``--root`` names the checkout whose ``dwarf_bench_tpu_torch`` is timed
(default: the one holding this file), so that two commits can be compared on
one card in one run: run this file from the newer checkout with
``--root`` pointing at the older one, in turns. The cases use only the
wrappers ``cumsum_cuda.cumsum``, ``hist_cuda.weighted_histogram``,
``bitonic_cuda.merge_bitonic``, ``reduce_cuda.reduce_sum``,
``merge_fill_cuda.merge_fill``, ``vadd_cuda.vadd_pallas``,
``filter_cuda.filter``, ``compact_cuda.compact_mask`` and
``scan_tail_cuda.scan_tail_streams``, which both have: cumsum at 2^22, the
weighted histogram at 2^20, the merge at 2^25 x 2 and x 3 columns (the
config-#4 probe) and 2^21 x 4 (``probe_merge_bitonic`` of the CSR join at
2^20), the sum at 2^24, the fill at 2^25 in its three modes, vadd at 2^24
float32, the filter at 2^24 (x < 5) and 2^20 (x < 5000), compact_mask at
the scan's 65536 x 2, at 2^24 x 1 and x 3, at the probe's 2^25 x 2 and x 1
(membership) and at the CSR build's 2^20 x 2 (group ``core``, then
``compaction``); (group ``histogram``) ``hist_cuda.histogram`` at Radix's
hi80 2^22, the JoinOmnisci build's hi128 2^20 and every key in one bin,
against ``torch.bincount``, and the histogram's seven other names at their
mains' shapes; and (group ``scan``) the scan tail at 2^17 chunks (2^24
rows, x < 5) and 2^13 (2^20 rows, x < 5000) under its two names, phase A of
``scan.filter_sparse``'s default path (``chunk_stats_cuda.chunk_stats``
where the checkout has it, else the eager ``chunk_stats``) and
``chunk_stats_pallas`` at both and ``filter_sparse`` itself at 2^24 x < 5
and 2^20 x < 5000; (group ``emit``) ``compact_cuda.emit_prefix`` of the
sparse scan's 20480 values into 2^24 slots, plain and, where the checkout
takes one, with the sort's int64 index, against ``out[:L].copy_`` and
against the gather before the emit, and ``filter_sparse`` at 2^24 x < 5;
(group ``lock``) the card's L2 round trip of an atomic (global timer and
CUDA events) and ``grid_accumulate`` at 64, 2^12 and 2^16 blocks with the
time an acquisition; (group ``diag``) ``_gb_diag_kernel_factory`` in its
three modes at 2^22 rows; each with the kernels and memsets a call puts on
the card (``device_ops``). ``--only`` runs the named groups (none: ``--only
""``).
``--sweep`` times the weighted histogram under every (cluster, copies) plan
and the count histogram under every (blocks, mergers) plan at the
main-path shapes and ``--host`` breaks one launch's host time down over
10^4 calls; ``--sweep`` needs the newer checkout. Prints one JSON object a
line, each with the card's name and power limit.

Per case: ``events_ms``, the median of CUDA-event brackets around single
calls (the host's dispatch shows when it is slower than the card);
``device_ms``, the CUDA kernels' time per call in a torch.profiler trace;
``graph_ms`` (the merge, the sum, the fill, vadd, the compactions), CUDA
events around replays of a CUDA graph of several calls, which no trace can
thin out (``utils/timing.graph_ms``, this checkout's also under
``--root``); ``kernels_ms`` (the merge, the fill, vadd, the compactions), each
kernel of one call in launch order; ``bound_ms`` (the compactions, the
histogram, the scan), the bytes a call must move at 3.35 TB/s
(``copy_if_bytes``, ``mask_bytes``); ``copies_bytes`` (the histogram), the
bytes its copies add, beside the bound and not in it;
``cold_ms`` (``utils/timing.cold_ms``), the median event bracket with
``timing.FLUSH_BYTES`` written and then half of them read back just before
it, outside the bracket: the inputs are
no longer in the 50 MB L2, the lines it holds are clean (a write alone
leaves them dirty, and the call would pay for writing them back), and the
host queues the call while the card is still flushing, so the bracket holds
the call's device time and its own gaps only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if __package__:
    from .timing import capture, cold_ms, graph_ms
else:  # run as a script: this file's directory is sys.path[0], and this
    # checkout's timers time another checkout's package under --root
    from timing import capture, cold_ms, graph_ms


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
        else "nvidia-smi failed"


def events_ms(fn, *args, k: int = 50) -> float:
    fn(*args)
    pairs = []
    for _ in range(k):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn(*args)
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(fn, *args, k: int = 10):
    """CUDA kernel time per call in a torch.profiler trace of ``k`` calls
    (memsets included); None when the trace holds no kernel."""
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


def traced_kernels(fn, *args, k: int = 3) -> list:
    """The CUDA events (kernels, memsets, copies) of ``k`` calls of
    ``fn(*args)``, in launch order, from a torch.profiler trace taken after a
    warm-up call: the first kernel after tracing starts can be missing from
    a trace, so the warm-up step is not kept and the active steps' events
    are read in on_trace_ready."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn(*args)
    torch.cuda.synchronize()
    traced = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=k),
                 on_trace_ready=lambda p: traced.extend(p.events())) as prof:
        for _ in range(1 + k):
            fn(*args)
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in traced
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(events, key=lambda e: e.time_range.start)


# CUgraphNodeType of the driver API (cudaGraphNodeType has the same values)
_KERNEL_NODE, _MEMSET_NODE = 0, 2


def device_ops(fn, *args):
    """(kernels, memsets) one call of ``fn(*args)`` puts on the card: the
    kernel and memset nodes of a CUDA graph captured around the call, read
    through the driver API (a cudaGraph_t is a CUgraph). A profiler trace
    can lose kernels, more of them the longer a process has run, so the
    count does not come from one."""
    import ctypes

    driver = ctypes.CDLL("libcuda.so.1")

    def call(name, *argv):
        rc = getattr(driver, name)(*argv)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA driver error {rc}")

    graph, _ = capture(fn, *args)
    try:
        raw = ctypes.c_void_p(graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", raw, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        if n.value:
            call("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
        types = []
        for node in nodes:
            t = ctypes.c_int()
            call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(t))
            types.append(t.value)
    finally:
        graph.reset()
    return types.count(_KERNEL_NODE), types.count(_MEMSET_NODE)


def kernels_ms(fn, *args, traces: int = 3) -> list:
    """Device ms of each CUDA kernel of one call, in launch order: the
    longest list of ``traces`` traces of one call, since a trace can drop a
    kernel (never add one)."""
    return max(([e.time_range.elapsed_us() / 1e3
                 for e in traced_kernels(fn, *args, k=1)]
                for _ in range(traces)), key=len)


def times(fn, *args, graph: bool = False) -> dict:
    """Events, profiler and cold times of ``fn(*args)``, and with ``graph``
    (a call that does not read back to the host) its graph-replay time."""
    out = {"events_ms": events_ms(fn, *args),
           "device_ms": device_ms(fn, *args), "cold_ms": cold_ms(fn, *args)}
    if graph:
        out["graph_ms"] = graph_ms(fn, *args)
    return out


def inputs(dev):
    """The main-path inputs: the counting sort's run-expansion column at
    2^22 (Radix, 2^22 keys in [1, 10000] over 80·128 bins), the G = 2^16
    group-by at 2^20 (keys in [0, 65535], values in [1, 10000]), G = 2^14
    at 2^20, and every row in one bin at 2^20."""
    rng = np.random.default_rng(1)
    n = 1 << 22
    radix_k = rng.integers(1, 10000, n, endpoint=True) - 1
    counts = np.bincount(radix_k, minlength=80 * 128)
    starts = np.cumsum(counts) - counts
    s = np.bincount(np.minimum(starts, n), minlength=n + 1)[:n]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    m = 1 << 20
    return {
        "scan": t(s),
        "k16": t(rng.integers(0, 65535, m, endpoint=True)),
        "k14": t(rng.integers(0, 16383, m, endpoint=True)),
        "hot": t(np.full(m, 12345)),
        "v": t(rng.integers(1, 10000, m, endpoint=True)),
    }


def bitonic_columns(n: int, ncols: int, dev, seed: int = 3):
    """A bitonic input of n rows: (key, aux) ascending over the first half,
    descending over the second, as a sorted table and sorted queries are
    merged; random payload columns past the second."""
    rng = np.random.default_rng(seed)
    halves = []
    for flip in (False, True):
        k = rng.integers(0, 2**32, n // 2, dtype=np.uint64)
        a = rng.integers(0, 2**16, n // 2, dtype=np.uint64)
        p = np.sort((k << np.uint64(32)) | a)
        halves.append(p[::-1] if flip else p)
    packed = np.concatenate(halves)
    cols = [packed >> np.uint64(32), packed & np.uint64(0xFFFFFFFF)]
    cols += [rng.integers(0, 2**32, n, dtype=np.uint64)
             for _ in range(ncols - 2)]
    return tuple(torch.from_numpy(c.astype(np.uint32).view(np.int32)).to(dev)
                 for c in cols)


def packed_sort(cols):
    """The library call of the merge: torch.sort of the (col0, col1) pairs
    packed into one int64 key, biased so that signed order is unsigned."""
    key = (((cols[0].to(torch.int64) & 0xFFFFFFFF) << 32)
           | (cols[1].to(torch.int64) & 0xFFFFFFFF)) ^ -(1 << 63)
    return lambda *_: torch.sort(key)


MERGE_SHAPES = ((1 << 25, 2), (1 << 25, 3), (1 << 21, 4))
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's device-memory rate


def copy_if_bytes(n: int, count: int) -> int:
    """Bytes the filter of n rows must move: x read, the kept values and the
    count written."""
    return 4 * n + 4 * count + 4


def mask_bytes(n: int, ncols: int, count: int) -> int:
    """Bytes compact_mask of n rows must move: the bool mask read, and the
    kept rows of each column read and written (no other column value is
    needed)."""
    return n + 8 * ncols * count + 4


def probe_compaction(dev, membership: bool, seed: int = 0):
    """The merge probe's compaction at the config-#4 scale (2^24 distinct
    table keys in [1, 2^25], 2^24 probes, half of them hits), built as
    ``merge_lookup_bitonic`` builds it: the merged columns, the fill, and
    (mask, columns, capacity) = (dest != -1, (dest, val) or (dest,) in
    membership mode, 2^24). 2^25 rows, half of them kept."""
    from dwarf_bench_tpu_torch.ops import (
        bitonic_cuda,
        merge_fill_cuda,
        merge_lookup,
    )

    n = 1 << 24
    rng = np.random.default_rng(seed)
    keys = rng.permutation(2 * n)[:n].astype(np.uint32) + 1
    vals = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    probes = np.concatenate([keys[: n // 2], rng.integers(
        0, n, n // 2).astype(np.uint32) + np.uint32(4 * n)])

    def t(a):
        return torch.from_numpy(a.view(np.int32)).to(dev)

    sk, sv = merge_lookup.sort_table(t(keys), t(vals))
    cols = merge_lookup.merge_columns(sk, sv, t(probes), 32, membership)
    merged = bitonic_cuda.merge_bitonic(cols, num_cmp=2)
    dest, val = merge_fill_cuda.merge_fill(
        merged[0], merged[1], None if membership else merged[2], n,
        membership=membership)
    return dest != -1, (dest,) if membership else (dest, val), n


def csr_build_compaction(dev, seed: int = 20261017):
    """The general CSR join's build compaction at 2^20 rows (A keys drawn
    with duplicates from [1, 2^19), as chip_smoke's CSR join): the segment
    starts of the sorted keys, compacting (row index, key) into as many
    slots as there are distinct keys."""
    from dwarf_bench_tpu_torch.ops.primitives import sort_by_key

    n = 1 << 20
    a = np.random.default_rng(seed).integers(1, 1 << 19, n).astype(np.int32)
    sk = sort_by_key(torch.from_numpy(a).to(dev), unsigned=True)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sk[1:] != sk[:-1]
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    return is_start, (iota, sk), len(np.unique(a))
FILL_MODES = (("val32", False, False), ("val16", True, False),
              ("membership", False, True))


def fill_columns(n: int, dev, seed: int = 4):
    """(sk, sa, dv) of n rows: random bit patterns, half of the rows
    queries (bit 31 of sa). The fill's work does not depend on the order."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)
        for _ in range(3))


def f32_pair(n: int, dev, seed: int = 5):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                 .to(dev) for _ in range(2))


def compaction_lines(root_label: str, dev, emit) -> None:
    """The filter, compact_mask and the scan tail at the shapes their paths
    give them, against ``masked_select`` (one a column)."""
    from dwarf_bench_tpu_torch.ops import (
        compact_cuda,
        filter_cuda,
        scan_tail_cuda,
    )
    from dwarf_bench_tpu_torch.ops.chunk_stats import chunk_stats

    rng = np.random.default_rng(6)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def case(label, fn, args, library, nbytes):
        emit({"root": root_label, "case": label,
              **times(fn, *args, graph=True), "kernels_ms": kernels_ms(
                  fn, *args), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        # masked_select reads its count back to the host: no graph
        emit({"root": root_label, "case": f"masked_select {label}",
              **times(library, *args)})

    def selects(mask, cols, _):
        return [torch.masked_select(c, mask) for c in cols]

    scan_x = t(rng.integers(1, 10000, 1 << 24, endpoint=True))
    for label, x, thr in (("filter 2^24 x<5", scan_x, 5),
                          ("filter 2^20 x<5000", scan_x[: 1 << 20], 5000)):
        count = int((x < thr).sum())
        case(label, filter_cuda.filter, (x, thr, x.numel()),
             lambda v, th, _: torch.masked_select(v, v < th),
             copy_if_bytes(x.numel(), count))
    gm = torch.from_numpy(rng.random(65536) < 2 / 128).to(dev)
    shapes = [("65536 x 2, capacity 4096", gm,
               (t(rng.integers(0, 1 << 24, 65536)),
                t(rng.integers(1, 5, 65536))), 4096)]
    scan_mask = scan_x < 5
    shapes += [("2^24 x 1", scan_mask, (scan_x,), 1 << 24),
               ("2^24 x 3", scan_mask, (scan_x, scan_x + 1, scan_x - 1),
                1 << 24)]
    shapes.append(("2^20 x 2 (CSR build)", *csr_build_compaction(dev)))
    for label, mask, cols, cap in shapes:
        count = int(mask.sum())
        case(f"compact_mask {label}", compact_cuda.compact_mask,
             (mask, cols, cap), selects,
             mask_bytes(mask.numel(), len(cols), min(count, cap)))
    del shapes, scan_mask
    for membership in (False, True):
        mask, cols, cap = probe_compaction(dev, membership)
        label = ("2^25 x 1 (probe, membership)" if membership
                 else "2^25 x 2 (probe)")
        case(f"compact_mask {label}", compact_cuda.compact_mask,
             (mask, cols, cap), selects,
             mask_bytes(mask.numel(), len(cols), min(int(mask.sum()), cap)))
        del mask, cols
    stat, base = chunk_stats(scan_x.view(-1, 128), 5)
    emit({"root": root_label, "case": "scan_tail_streams 2^17 chunks",
          **times(scan_tail_cuda.scan_tail_streams, stat, base, 5, 16384,
                  512, graph=True),
          "kernels_ms": kernels_ms(scan_tail_cuda.scan_tail_streams, stat,
                                   base, 5, 16384, 512)})


def _case(root_label, emit, label, fn, args, nbytes=None, graph=True,
          **extra) -> None:
    """One case's line: its times, the kernels and memsets a call (with
    ``graph``) and the bound of ``nbytes`` moved."""
    line = {"root": root_label, "case": label,
            **times(fn, *args, graph=graph)}
    if graph:
        line["kernels"], line["memsets"] = device_ops(fn, *args)
    if nbytes is not None:
        line["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    emit({**line, **extra})


def histogram_lines(root_label: str, dev, emit) -> None:
    """The count histogram at the shapes its paths give it and under its
    JAX names, with the kernels and memsets a call, the bound of the keys
    read and the bins written, and apart from it the bytes of the copies
    that the wrapper's plan writes and reads back (mostly in the L2)."""
    from dwarf_bench_tpu_torch.ops import hist_cuda, measure_variants

    rng = np.random.default_rng(7)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def case(label, fn, args, nbytes=None, graph=True, **extra):
        _case(root_label, emit, label, fn, args, nbytes, graph, **extra)

    radix_k = t(rng.integers(1, 10000, 1 << 22, endpoint=True) - 1)
    join_k = t(rng.integers(1, 10000, 1 << 20, endpoint=True) - 1)
    for label, k, hb in (("hi80 2^22 (Radix)", radix_k, 80),
                         ("hi128 2^20 (JoinOmnisci build)", join_k, 128),
                         ("hi80 2^22, one bin", torch.full_like(radix_k, 77),
                          80)):
        nbins = hb * 128
        extra = {}
        if hasattr(hist_cuda, "merge_bytes"):  # a checkout with copies
            extra["copies_bytes"] = hist_cuda.merge_bytes(hb, k.numel())
        case(f"histogram {label}", hist_cuda.histogram, (k, hb),
             4 * (k.numel() + nbins), **extra)
        # torch.bincount reads its size back to the host: no graph
        case(f"torch.bincount {label}",
             lambda v, nb=nbins: torch.bincount(v, minlength=nb), (k,),
             graph=False)
    # the JAX names the histogram kernel serves, at their mains' shapes
    mv = measure_variants
    x22 = t(rng.integers(1, 10000, 1 << 22, endpoint=True))
    for name, fn in (
            ("histogram_16k_pallas hi80", lambda k: hist_cuda.
             histogram_16k_pallas(k, 80)),
            ("histogram_16k_i8cmp hi128", mv.histogram_16k_i8cmp),
            ("hist16k_bf16cmp hi128", mv.hist16k_bf16cmp),
            ("hist_variant hi128 i16", lambda k: mv.hist_variant(
                k, 128, i16=True)),
            ("hist_rows hi128 rows 32", lambda k: mv.hist_rows(
                k, 128, rows=32)),
            ("hist_swar hi80 f5", lambda k: mv.hist_swar(k, 80, "f5"))):
        case(f"{name} 2^22", fn, (x22,))
    case("dyn_store_probe 256 indices", mv.dyn_store_probe,
         (t(rng.integers(0, 64 * 128, 256)),))


def scan_lines(root_label: str, dev, emit) -> None:
    """The scan tail, phase A and ``filter_sparse`` at the shapes their
    paths give them, with the kernels and memsets a call and the bound of
    the bytes it must move."""
    from dwarf_bench_tpu_torch.ops import (
        chunk_stats_cuda,
        scan,
        scan_tail_cuda,
    )
    from dwarf_bench_tpu_torch.ops.chunk_stats import chunk_stats

    rng = np.random.default_rng(7)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def case(label, fn, args, nbytes=None, graph=True):
        _case(root_label, emit, label, fn, args, nbytes, graph)

    x24 = rng.integers(1, 10000, 1 << 24, endpoint=True).astype(np.int32)
    x20 = rng.integers(1, 10000, 1 << 20, endpoint=True).astype(np.int32)
    phase_a = getattr(chunk_stats_cuda, "chunk_stats", chunk_stats)
    for label, x, thr in (("2^24 x<5", x24, 5), ("2^20 x<5000", x20, 5000)):
        xd = t(x)
        n, nch = x.size, x.size // 128
        x2 = xd.view(nch, 128)
        case(f"phase A {label}", phase_a, (x2, thr), 4 * (n + 2 * nch))
        case(f"chunk_stats_pallas {label}", chunk_stats_cuda.
             chunk_stats_pallas, (x2, thr), 4 * (n + 2 * nch))
        stat, base = chunk_stats(x2, thr)
        caps = (max(16384, n >> 10), max(512, n >> 15))
        res = scan_tail_cuda.scan_tail_streams_plain(stat, base, thr, *caps)
        nbytes = 4 * (2 * nch + caps[0] + int(res[4]) + 2 * int(res[5]) + 2)
        case(f"scan_tail_streams {nch} chunks ({label})",
             scan_tail_cuda.scan_tail_streams, (stat, base, thr, *caps),
             nbytes)
        case(f"scan_tail_compact {nch} chunks ({label})",
             scan_tail_cuda.scan_tail_compact, (stat, base, thr, *caps),
             nbytes)
        # the caps trip at 2^20 x < 5000: a host read picks the branch
        sparse = scan.sparse_caps_ok(x, thr)
        case(f"filter_sparse {label}",
             lambda v, th=thr, a=sparse: scan.filter_sparse(
                 v, th, assume_sparse=a), (xd,), graph=sparse)
        del xd, x2, stat, base


def _takes_index(emit_prefix) -> bool:
    """Whether a checkout's emit_prefix gathers by an index."""
    import inspect

    return "index" in inspect.signature(emit_prefix).parameters


def emit_lines(root_label: str, dev, emit) -> None:
    """The prefix emit at the sparse scan's shape (20480 values into a
    2^24 buffer): a plain copy against ``out[:L].copy_``; the scan's
    gather by the sort's order folded into the emit, where the checkout's
    emit takes an index, against the gather before the emit; and
    ``filter_sparse`` at 2^24 x < 5 with the kernels and memsets a call."""
    from dwarf_bench_tpu_torch.ops import compact_cuda, scan

    rng = np.random.default_rng(11)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    length, capacity = 20480, 1 << 24
    vals = t(rng.integers(-(2**31), 2**31, length))
    order = torch.from_numpy(rng.permutation(length)).to(dev)
    ep = compact_cuda.emit_prefix

    def copy_prefix(v, cap):
        out = torch.empty(cap, dtype=torch.int32, device=dev)
        out[: v.numel()].copy_(v)
        return out

    _case(root_label, emit, "emit_prefix L=20480 into 2^24", ep,
          (vals, capacity), 8 * length)
    _case(root_label, emit, "out[:L].copy_ L=20480 into 2^24", copy_prefix,
          (vals, capacity))
    # an int64 index and the values read, the values written
    nbytes = 16 * length
    if _takes_index(ep):
        _case(root_label, emit, "emit_prefix with the index, L=20480", ep,
              (vals, capacity, order), nbytes)
    _case(root_label, emit, "vals[index] then emit_prefix, L=20480",
          lambda v, cap, i: ep(v[i], cap), (vals, capacity, order), nbytes)
    x = t(rng.integers(1, 10000, 1 << 24, endpoint=True))
    _case(root_label, emit, "filter_sparse 2^24 x<5",
          lambda v: scan.filter_sparse(v, assume_sparse=True), (x,))


def diag_lines(root_label: str, dev, emit) -> None:
    """``_gb_diag_kernel_factory`` in its three modes at its main's shape
    (2^22 rows, keys in [0, 64), values in [1, 10000], ga = gb = 8, rows
    32, w 4096), with the kernels and memsets a call and the bound of the
    rows the mode reads (key and value) and the 64 cells written."""
    from dwarf_bench_tpu_torch.ops import measure_variants as mv

    rng = np.random.default_rng(8)
    n, rows, w, gb = 1 << 22, 32, 4096, 8
    k = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.integers(1, 10000, n, endpoint=True)
                         .astype(np.int32)).to(dev)
    blocks = -(-n // (rows * w))
    for mode, read in (("full", n), ("dotonly", blocks * w),
                       ("nodot", blocks * rows * gb)):
        _case(root_label, emit, f"gb_diag {mode} 2^22",
              mv._gb_diag_kernel_factory(mode), (k, v), 8 * read + 4 * 64)


LOCK_STEPS = (64, 1 << 12, 1 << 16)


def lock_lines(root_label: str, dev, emit) -> None:
    """The L2 round trip of an atomic, where the checkout measures it (five
    chains of 2^14), and grid_accumulate at the example's 64 blocks, 2^12
    and 2^16: events, and for 64 blocks profiler, cold and graph times,
    with the kernels and memsets a call, whether the count is exact, and
    the microseconds an acquisition. A variant that drops the lock is
    timed all the same, with ``exact`` false."""
    from dwarf_bench_tpu_torch.ops import lock_add_cuda

    rtt = None
    if hasattr(lock_add_cuda, "l2_round_trip"):
        from dwarf_bench_tpu_torch.ops import _build

        trips = [lock_add_cuda.l2_round_trip(dev) for _ in range(5)]
        rtt = statistics.median(trips)
        # the same chains timed by CUDA events instead of the global timer:
        # the difference of 2^14 and 2^10 atomics over 2^14 - 2^10
        word = torch.zeros(1, dtype=torch.int32, device=dev)
        out = torch.empty(2, dtype=torch.int64, device=dev)

        def chain(length, _):
            _build.launch("dbt_l2_round_trip", dev, word.data_ptr(), length,
                          out.data_ptr())

        long_ms, short_ms = (events_ms(chain, c, word, k=20)
                             for c in (1 << 14, 1 << 10))
        per_add_s = (long_ms - short_ms) * 1e-3 / ((1 << 14) - (1 << 10))
        emit({"root": root_label, "case": "l2_round_trip chain 2^14",
              "seconds": trips, "median_s": rtt, "events_s": per_add_s})
    anchor = torch.zeros(1, device=dev)

    def acc(n_steps, _):
        return lock_add_cuda.grid_accumulate(n_steps, dev)

    for n_steps in LOCK_STEPS:
        exact = int(acc(n_steps, anchor)[0, 0]) == n_steps
        line = {"root": root_label, "case": f"grid_accumulate {n_steps}",
                "exact": exact}
        if n_steps == 64:
            line.update(times(acc, n_steps, anchor, graph=True))
        else:  # a second or more a call before the ticket lock
            line["events_ms"] = events_ms(acc, n_steps, anchor, k=3)
        line["kernels"], line["memsets"] = device_ops(acc, n_steps, anchor)
        line["us_per_acquisition"] = line["events_ms"] * 1e3 / n_steps
        if rtt is not None:
            line["bound_ms"] = n_steps * rtt * 1e3
        emit(line)


def case_lines(root_label: str, dev, emit) -> None:
    from dwarf_bench_tpu_torch.ops import (
        bitonic_cuda,
        cumsum_cuda,
        hist_cuda,
        merge_fill_cuda,
        reduce_cuda,
        vadd_cuda,
    )

    d = inputs(dev)
    carry = torch.full((1,), -1, dtype=torch.int32, device=dev)
    cases = [
        ("cumsum 2^22 int carry", cumsum_cuda.cumsum, (d["scan"], -1)),
        ("cumsum 2^22 tensor carry", cumsum_cuda.cumsum, (d["scan"], carry)),
        ("torch.cumsum 2^22", lambda x: torch.cumsum(x, 0, dtype=torch.int32),
         (d["scan"],)),
    ]
    for label, key, hb in (("hi512 2^20", "k16", 512),
                           ("hi128 2^20", "k14", 128),
                           ("hot key hi512 2^20", "hot", 512)):
        nbins = hb * 128
        cases.append((f"weighted_histogram {label}",
                      hist_cuda.weighted_histogram, (d[key], d["v"], hb)))
        cases.append((f"index_add_ {label}",
                      lambda k, v, nb=nbins: torch.zeros(
                          nb, dtype=torch.int32, device=dev).index_add_(0, k, v),
                      (d[key], d["v"])))
    for label, fn, args in cases:
        emit({"root": root_label, "case": label, **times(fn, *args)})
    for n, ncols in MERGE_SHAPES:
        cols = bitonic_columns(n, ncols, dev)
        label = f"2^{n.bit_length() - 1} x {ncols} cols"
        emit({"root": root_label, "case": f"merge_bitonic {label}",
              **times(bitonic_cuda.merge_bitonic, cols, graph=True),
              "kernels_ms": kernels_ms(bitonic_cuda.merge_bitonic, cols)})
        emit({"root": root_label, "case": f"torch.sort packed key {label}",
              **times(packed_sort(cols), graph=True)})
        del cols
    x = d["v"].repeat(16)  # 2^24 values in [1, 10000]
    emit({"root": root_label, "case": "reduce_sum 2^24",
          **times(reduce_cuda.reduce_sum, x, graph=True)})
    emit({"root": root_label, "case": "torch.sum 2^24",
          **times(lambda v: torch.sum(v, dtype=torch.int32), x,
                   graph=True)})
    del x
    cols = fill_columns(1 << 25, dev)
    for mode, val16, membership in FILL_MODES:
        args = (*cols, 1 << 24, val16, membership)
        emit({"root": root_label, "case": f"merge_fill 2^25 {mode}",
              **times(merge_fill_cuda.merge_fill, *args, graph=True),
              "kernels_ms": kernels_ms(merge_fill_cuda.merge_fill, *args)})
    del cols
    a, b = f32_pair(1 << 24, dev)
    emit({"root": root_label, "case": "vadd 2^24 f32",
          **times(vadd_cuda.vadd_pallas, a, b, graph=True),
          "kernels_ms": kernels_ms(vadd_cuda.vadd_pallas, a, b)})
    emit({"root": root_label, "case": "vadd 2^24 - 1 f32, off 16 bytes",
          **times(vadd_cuda.vadd_pallas, a[1:], b[1:], graph=True),
          "kernels_ms": kernels_ms(vadd_cuda.vadd_pallas, a[1:], b[1:])})
    emit({"root": root_label, "case": "torch.add 2^24 f32",
          **times(torch.add, a, b, graph=True)})
    del a, b


def histogram_sweep_lines(dev, emit) -> None:
    """The count histogram under each (blocks, mergers) plan at the
    main-path shapes; the wrapper's own plan is marked."""
    from dwarf_bench_tpu_torch.ops import hist_cuda

    rng = np.random.default_rng(3)
    shapes = [("hi80 2^22", 80, rng.integers(0, 10000, 1 << 22)),
              ("hi128 2^20", 128, rng.integers(0, 10000, 1 << 20))]
    for label, hb, keys in shapes:
        nbins = hb * 128
        n = keys.size
        k = torch.from_numpy(keys.astype(np.int32)).to(dev)
        exp = hist_cuda.histogram_plain(k, hb)
        plan = hist_cuda.histogram_plan(hb, n)
        for blocks in (32, 64, 128, 132, 256):
            for mergers in (16, 32, 64):
                if mergers > blocks or blocks * nbins > max(n, nbins):
                    continue
                p = (blocks, mergers)
                fn = (lambda a, p=p: hist_cuda.launch_histogram(a, nbins, *p))
                ok = torch.equal(fn(k), exp)
                emit({"sweep": f"histogram {label}", "blocks": blocks,
                      "mergers": mergers, "ok": ok,
                      "wrapper_plan": p == plan, "graph_ms": graph_ms(fn, k),
                      "cold_ms": cold_ms(fn, k, k=10)})


def sweep_lines(dev, emit) -> None:
    """The weighted histogram under each (cluster, copies) plan at the
    main-path shapes; the wrapper's own plan is marked."""
    from dwarf_bench_tpu_torch.ops import _build, hist_cuda

    rng = np.random.default_rng(2)
    lib = _build.library()
    for cluster in (2, 4, 8, 16):
        for hb in (128, 160, 256, 512):
            emit({"max_active_clusters": lib.
                  dbt_weighted_histogram_max_clusters(hb * 128, cluster),
                  "cluster": cluster, "hi_bins": hb})
    shapes = [("hi512 2^20", 512, 1 << 20, False),
              ("hot key hi512 2^20", 512, 1 << 20, True),
              ("hi160 2^22 (GroupByLocal 20 x 1024)", 160, 1 << 22, False),
              ("hi256 2^20", 256, 1 << 20, False),
              ("hi128 2^20", 128, 1 << 20, False),
              ("hi64 1000003", 64, 1_000_003, False),
              ("hi8 1000003", 8, 1_000_003, False)]
    for label, hb, n, hot in shapes:
        nbins = hb * 128
        k = torch.from_numpy((np.full(n, 77) if hot else rng.integers(
            0, nbins, n)).astype(np.int32)).to(dev)
        v = torch.from_numpy(rng.integers(1, 10000, n).astype(np.int32)).to(dev)
        exp = hist_cuda.weighted_histogram_plain(k, v, hb)
        plan = hist_cuda.weighted_plan(hb, n)
        for cluster in (1, 2, 4, 8, 16):
            if nbins * 4 // cluster > 200 * 1024:
                continue
            for copies in (1, 2, 4, 8, 16, 32, 64, 128, 256):
                if copies * cluster > 1024 or copies * nbins > max(n, nbins):
                    continue
                fn = (lambda a, b, c=cluster, p=copies:
                      hist_cuda.launch_weighted(a, b, nbins, c, p))
                ok = torch.equal(fn(k, v), exp)
                emit({"sweep": label, "cluster": cluster, "copies": copies,
                      "ok": ok, "wrapper_plan": (cluster, copies) == plan,
                      "device_ms": device_ms(fn, k, v),
                      "cold_ms": cold_ms(fn, k, v, k=10)})


def host_lines(dev, emit) -> None:
    """Host seconds of one call of each piece of a launch, over 10^4 calls
    at 4096 rows (so the card keeps up with the host)."""
    from dwarf_bench_tpu_torch.ops import (
        _build,
        chunk_stats_cuda,
        compact_cuda,
        cumsum_cuda,
        filter_cuda,
        hist_cuda,
        lock_add_cuda,
        reduce_cuda,
        scan,
        scan_tail_cuda,
    )
    from dwarf_bench_tpu_torch.ops.chunk_stats import chunk_stats

    calls = 10_000
    n = 4096
    x = torch.ones(n, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    # zero, as dbt_cumsum needs it (and leaves it)
    scratch = torch.zeros(_build.cumsum_scratch_words(n), dtype=torch.int32,
                          device=dev)
    lib = _build.library()
    fn = lib.dbt_cumsum
    xp, op, sp = x.data_ptr(), out.data_ptr(), scratch.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def old_launch():
        # the launch path before: device context and a Stream object a call
        with torch.cuda.device(dev):
            s = torch.cuda.current_stream(dev).cuda_stream
            fn(xp, n, None, -1, op, sp, s)

    def enter_device():
        with torch.cuda.device(dev):
            pass

    k = torch.from_numpy(np.arange(n, dtype=np.int32) % 65536).to(dev)
    carry = torch.full((1,), -1, dtype=torch.int32, device=dev)
    rscratch = _build.stream_scratch("reduce_sum", dev,
                                     reduce_cuda.SCRATCH_WORDS)
    rs, rwords = rscratch.data_ptr(), rscratch.numel()
    mask = x > 0
    order = torch.arange(n - 1, -1, -1, device=dev)
    phase_a = getattr(chunk_stats_cuda, "chunk_stats", chunk_stats)
    x2 = torch.full((n, 128), 9, dtype=torch.int32, device=dev)
    x19 = x2.view(-1)[: 1 << 19]
    pieces = [
        ("ctypes call, n = 0 (returns before any CUDA call)",
         lambda: fn(xp, 0, None, -1, op, sp, stream)),
        ("bare C call dbt_cumsum (one launch)",
         lambda: fn(xp, n, None, -1, op, sp, stream)),
        ("launch()", lambda: _build.launch("dbt_cumsum", dev, xp, n, None, -1,
                                           op, sp)),
        ("launch before: torch.cuda.device + current_stream + call",
         old_launch),
        ("torch.cuda.device enter and exit", enter_device),
        ("torch.cuda.current_stream().cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("torch._C._cuda_getCurrentRawStream",
         lambda: torch._C._cuda_getCurrentRawStream(0)),
        ("torch._C._cuda_getDevice", torch._C._cuda_getDevice),
        ("check_vectors(x)", lambda: _build.check_vectors("cumsum", x)),
        ("check_vectors(k, v)", lambda: _build.check_vectors("w", k, x)),
        ("torch.empty(4096)",
         lambda: torch.empty(n, dtype=torch.int32, device=dev)),
        ("torch.zeros(65536)",
         lambda: torch.zeros(65536, dtype=torch.int32, device=dev)),
        ("dbt_cumsum_scratch ctypes", lambda: lib.dbt_cumsum_scratch(n)),
        ("cumsum_scratch_words (cached)",
         lambda: _build.cumsum_scratch_words(n)),
        ("cumsum wrapper, int carry", lambda: cumsum_cuda.cumsum(x, -1)),
        ("cumsum wrapper, tensor carry", lambda: cumsum_cuda.cumsum(x, carry)),
        ("torch.cumsum(dtype=int32)",
         lambda: torch.cumsum(x, 0, dtype=torch.int32)),
        ("weighted_histogram wrapper hi512",
         lambda: hist_cuda.weighted_histogram(k, x, 512)),
        ("zeros + index_add_ 65536 bins",
         lambda: torch.zeros(65536, dtype=torch.int32, device=dev)
         .index_add_(0, k, x)),
        ("reduce_sum wrapper", lambda: reduce_cuda.reduce_sum(x)),
        ("torch.sum(dtype=int32)", lambda: torch.sum(x, dtype=torch.int32)),
        ("torch.empty(()) int32",
         lambda: torch.empty((), dtype=torch.int32, device=dev)),
        ("x.new_empty(())", lambda: x.new_empty(())),
        ("stream_scratch lookup",
         lambda: _build.stream_scratch("reduce_sum", dev,
                                       reduce_cuda.SCRATCH_WORDS)),
        ("bare C call dbt_reduce_sum",
         lambda: lib.dbt_reduce_sum(xp, n, op, rs, rwords, stream)),
        ("launch('dbt_reduce_sum')",
         lambda: _build.launch("dbt_reduce_sum", dev, xp, n, op, rs, rwords)),
        ("histogram wrapper hi80", lambda: hist_cuda.histogram(k, 80)),
        ("grid_accumulate wrapper, 64 blocks",
         lambda: lock_add_cuda.grid_accumulate(64, dev)),
        ("x[index] then emit_prefix wrapper, 4096",
         lambda: compact_cuda.emit_prefix(x[order], n)),
        ("scan_tail_streams wrapper",
         lambda: scan_tail_cuda.scan_tail_streams(x, x, 5, 16384, 512)),
        ("phase A of filter_sparse (4096 x 128)",
         lambda: phase_a(x2, 5)),
        ("filter_sparse(assume_sparse=True), 2^19 rows",
         lambda: scan.filter_sparse(x19, assume_sparse=True)),
        ("filter wrapper", lambda: filter_cuda.filter(x, 5)),
        ("compact_mask wrapper, 2 cols",
         lambda: compact_cuda.compact_mask(mask, (x, x), 1024)),
        ("masked_select(x, x < 5)",
         lambda: torch.masked_select(x, x < 5)),
    ]
    if _takes_index(compact_cuda.emit_prefix):
        pieces.append(("emit_prefix wrapper with an index, 4096",
                       lambda: compact_cuda.emit_prefix(x, n, order)))
    for label, piece in pieces:
        for _ in range(100):
            piece()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            piece()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        emit({"host_piece": label, "us_per_call": (t1 - t0) / calls * 1e6,
              "us_per_call_with_sync": (t2 - t0) / calls * 1e6})


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    parser.add_argument("--label", default=None)
    parser.add_argument("--sweep", nargs="?", const="histogram,weighted",
                        default="", help="plan sweeps, of histogram and "
                        "weighted")
    parser.add_argument("--host", action="store_true")
    parser.add_argument("--only", default="core,compaction,histogram,scan",
                        help="case groups, of core, compaction, histogram, "
                        "scan, emit, lock and diag")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    if sys.path and os.path.abspath(sys.path[0]) == here:
        sys.path.pop(0)
    sys.path.insert(0, os.path.abspath(args.root))
    dev = torch.device("cuda:0")
    card = card_line()

    def emit(line):
        print(json.dumps({"card": card, **line}), flush=True)

    label = args.label or args.root
    groups = {"core": case_lines, "compaction": compaction_lines,
              "histogram": histogram_lines, "scan": scan_lines,
              "emit": emit_lines, "lock": lock_lines, "diag": diag_lines}
    for group in filter(None, args.only.split(",")):
        groups[group](label, dev, emit)
    sweeps = {"histogram": histogram_sweep_lines, "weighted": sweep_lines}
    for name in filter(None, args.sweep.split(",")):
        sweeps[name](dev, emit)
    if args.host:
        host_lines(dev, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
