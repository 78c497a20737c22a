"""Times of the cumsum and weighted-histogram kernels, their library calls,
and the host cost of a kernel launch, on one CUDA card.

    python dwarf_bench_tpu_torch/utils/kernel_times.py [--root DIR] [--sweep]
        [--host] [--label NAME]

``--root`` names the checkout whose ``dwarf_bench_tpu_torch`` is timed
(default: the one holding this file), so that two commits can be compared on
one card in one run: run this file from the newer checkout with
``--root`` pointing at the older one, in turns. The cases use only the
wrappers ``cumsum_cuda.cumsum`` and ``hist_cuda.weighted_histogram``, which
both have. ``--sweep`` times the weighted histogram under every (cluster,
copies) plan at the main-path shapes, and ``--host`` breaks one launch's host
time down over 10^4 calls; both need the newer checkout. Prints one JSON
object a line, each with the card's name and power limit.

Per case: ``events_ms``, the median of CUDA-event brackets around single
calls (the host's dispatch shows when it is slower than the card);
``device_ms``, the CUDA kernels' time per call in a torch.profiler trace;
``cold_ms``, the median event bracket with ``FLUSH_BYTES`` written and then
half of them read back just before it, outside the bracket: the inputs are
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

FLUSH_BYTES = 256 << 20
_flush = None


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


def cold_ms(fn, *args, k: int = 20) -> float:
    """Median event bracket of one call with FLUSH_BYTES written, and half
    of them read back, on the stream just before it, outside the bracket."""
    global _flush
    if _flush is None:
        _flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn(*args)
    pairs = []
    for i in range(k):
        _flush.fill_(i & 0x7F)
        _flush[: FLUSH_BYTES // 2].view(torch.int64).sum()
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


def times(fn, *args) -> dict:
    return {"events_ms": events_ms(fn, *args), "device_ms": device_ms(fn, *args),
            "cold_ms": cold_ms(fn, *args)}


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


def case_lines(root_label: str, dev, emit) -> None:
    from dwarf_bench_tpu_torch.ops import cumsum_cuda, hist_cuda

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
    from dwarf_bench_tpu_torch.ops import _build, cumsum_cuda, hist_cuda

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
    ]
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
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--host", action="store_true")
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

    case_lines(args.label or args.root, dev, emit)
    if args.sweep:
        sweep_lines(dev, emit)
    if args.host:
        host_lines(dev, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
