"""Synchronisation and kernel timing.

PyTorch returns from a CUDA call before the card has finished it, so a host
clock is read only after ``sync``. ``kernel_time`` is the analog of the JAX
package's queue-k ``kernel_timed`` (dwarf_bench_tpu/dwarfs/base.py:80-93)
and of the reference's OpenCL event profiling (scan/scan.cpp:142-154): the
median over K runs of ``fn`` on device-resident inputs, each bracketed by a
pair of ``torch.cuda.Event``s, so host dispatch between runs is not
counted. On the CPU it is the median host time of K runs.

A per-call event bracket still holds the host's dispatch whenever the host
takes longer to issue a call than the card takes to run it, which is the
case for most calls of this package under a millisecond. The timers of the
headline bench read the card alone:

  * ``time_device_looped`` and ``time_device_looped_inplace``, the analogs
    of the JAX package's device loops (dwarf_bench_tpu/utils/timing.py:
    70-141), replay CUDA graphs of ``k + 1`` calls and of one call between
    CUDA events and take the slope (``cold=True`` evicts the L2 before each
    call);
  * ``time_amortized`` (timing.py:144-190) is the queue-k slope on the host
    clock, for calls that read back to the host and cannot be captured;
  * ``capture``, ``graph_ms`` and ``cold_ms`` are the graph and eviction
    machinery that ``utils/kernel_times.py`` reads too.
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Any, Callable, Optional

import torch

# bytes written, and half of them read back, to push a call's inputs out of
# the 50 MB L2 and leave the lines it holds clean (a write alone leaves
# them dirty, and the call would pay for writing them back)
FLUSH_BYTES = 256 << 20
_flush: dict = {}


def _first_device(tree: Any) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, (tuple, list)):
        for leaf in tree:
            dev = _first_device(leaf)
            if dev is not None:
                return dev
    return None


def sync(tree: Any) -> Any:
    """Wait for the card to finish the work that produced ``tree`` (one
    stream runs its work in order, so a device-wide synchronise fences it).
    Returns ``tree``."""
    dev = _first_device(tree)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return tree


def timed(fn: Callable, *args):
    """(result, seconds) with a real execution fence."""
    t0 = time.perf_counter()
    res = sync(fn(*args))
    return res, time.perf_counter() - t0


def kernel_time(fn: Callable, *args, k: int = 10, warmup: int = 1) -> float:
    """Median seconds of one ``fn(*args)`` over ``k`` runs (after
    ``warmup`` runs), from CUDA events on the card, from the host clock on
    the CPU."""
    dev = _first_device(args)
    for _ in range(warmup):
        sync(fn(*args))
    if dev is None or dev.type != "cuda":
        times = []
        for _ in range(k):
            times.append(timed(fn, *args)[1])
        return statistics.median(times)
    events = []
    for _ in range(k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(dev)
    return statistics.median(s.elapsed_time(e) for s, e in events) / 1e3


# -- graphs and the L2 --------------------------------------------------------


def evict_l2() -> None:
    """Write FLUSH_BYTES on the current device's current stream, then read
    half of them back: what the L2 held before is gone, and the lines it
    holds now are clean."""
    index = torch.cuda.current_device()
    buf = _flush.get(index)
    if buf is None:
        buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                          device=torch.device("cuda", index))
        _flush[index] = buf
    buf.fill_(0x5A)
    buf[: FLUSH_BYTES // 2].view(torch.int64).sum()


def check_sync_free(fn: Callable, *args) -> None:
    """Run ``fn(*args)`` once under ``torch.cuda.set_sync_debug_mode
    ("error")``: a call that reads back to the host (``.item()``, ``int()``
    of a CUDA tensor, a copy to the host, a synchronise) raises here, with
    the operation in the traceback, instead of breaking a capture later."""
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(*args)
    except RuntimeError as e:
        name = getattr(fn, "__qualname__", repr(fn))
        raise RuntimeError(f"{name} reads back to the host, so its calls "
                           f"cannot be replayed as a CUDA graph: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(old)


def capture(fn: Callable, *args, k: int = 1, cold: bool = False):
    """(graph, stream): a CUDA graph of ``k`` calls of ``fn(*args)``, each
    after an L2 eviction when ``cold``, captured on a stream that a first
    call warmed (a wrapper's per-stream scratch is made outside the
    capture). The calls must not read back to the host. ``fn=None``
    captures the evictions alone."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        if cold:
            evict_l2()
        if fn is not None:
            fn(*args)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(k):
            if cold:
                evict_l2()
            if fn is not None:
                fn(*args)
    return graph, stream


def _replay_s(graph, stream, reps: int) -> list:
    """Seconds of each of ``reps`` replays of ``graph`` on ``stream``,
    between CUDA events, after one replay that is not kept."""
    pairs = []
    with torch.cuda.stream(stream):
        graph.replay()
        for _ in range(reps):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            graph.replay()
            e.record()
            pairs.append((s, e))
    stream.synchronize()
    return [s.elapsed_time(e) / 1e3 for s, e in pairs]


def graph_ms(fn: Callable, *args, k: int = 10, reps: int = 5) -> float:
    """Device ms of one call of ``fn(*args)``: the median of CUDA-event
    brackets around ``reps`` replays of a CUDA graph of ``k`` calls, over
    ``k``. Unlike a profiler trace it cannot lose a kernel; it holds the
    gaps between the graph's kernels (no host dispatch), which a trace's
    kernel sum leaves out, and 1/k of the replay's own launch."""
    graph, stream = capture(fn, *args, k=k)
    try:
        return statistics.median(_replay_s(graph, stream, reps)) * 1e3 / k
    finally:
        graph.reset()


def cold_ms(fn: Callable, *args, k: int = 20) -> float:
    """Median event bracket of one call with FLUSH_BYTES written, and half
    of them read back, on the stream just before it, outside the bracket:
    the inputs are no longer in the L2, and the host queues the call while
    the card is still flushing, so the bracket holds the call's device time
    and its own gaps only."""
    fn(*args)
    pairs = []
    for _ in range(k):
        evict_l2()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn(*args)
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _graph_slope_s(fn, args, k: int, repeats: int, cold: bool) -> float:
    """min over ``repeats`` of the replay time of a graph of ``k + 1`` calls,
    less that of a graph of one call, over ``k``; less the same slope of
    the evictions alone when ``cold``."""

    def slope(f):
        g1, s1 = capture(f, *args, k=1, cold=cold)
        gk, sk = capture(f, *args, k=k + 1, cold=cold)
        try:
            t1 = min(min(_replay_s(g1, s1, 3)) for _ in range(repeats))
            tk = min(min(_replay_s(gk, sk, 3)) for _ in range(repeats))
        finally:
            g1.reset()
            gk.reset()
        return (tk - t1) / k

    t = slope(fn)
    if cold:
        t -= slope(None)
    return t


def _host_slope_s(fn, args, k: int, repeats: int) -> float:
    dev = _first_device(args)
    fn(*args)
    t1 = min(_queue_k(fn, args, 1, dev) for _ in range(repeats))
    tk = min(_queue_k(fn, args, k + 1, dev) for _ in range(repeats))
    return (tk - t1) / k


def time_device_looped(fn: Callable, *args, k: int = 16, repeats: int = 2,
                       cold: bool = False) -> float:
    """Device seconds of one ``fn(*args)`` with no host dispatch in it: the
    CUDA-graph analog of the JAX package's device loop
    (dwarf_bench_tpu/utils/timing.py:105-141). Graphs of ``k + 1`` calls and
    of one call are captured and each replayed between CUDA events; the
    slope ``(T_{k+1} - T_1) / k`` (min of each over ``repeats``) cancels the
    replay's own launch as the JAX slope cancels the jit call's.

    The JAX loop couples its iterations (``perturb``/``update`` and
    ``fold``) only because XLA would otherwise hoist or drop a
    loop-invariant body. A CUDA graph replays every kernel it captured, so
    nothing couples the calls here, and no per-iteration launch of a
    coupling op (1.2-1.6 µs each on the card) is added to the reading.

    ``cold=True`` puts an L2 eviction (``evict_l2``) before each captured
    call and subtracts the same slope of the evictions alone: every call
    finds its inputs in device memory, as a query does that reads a column
    once. Without it, inputs under 50 MB stay in the L2 between calls.

    Before capturing, ``fn`` runs once under CUDA's sync debug mode and
    raises if it reads back to the host (``check_sync_free``); nothing falls
    back to another timer. On the CPU it is the host-clock slope of ``k +
    1`` calls against one (``cold`` has no meaning there). The floor of
    1e-9 s keeps a reading lost in jitter positive, as in the JAX timer."""
    dev = _first_device(args)
    if dev is None or dev.type != "cuda":
        return max(_host_slope_s(fn, args, k, repeats), 1e-9)
    check_sync_free(fn, *args)
    torch.cuda.synchronize(dev)
    with torch.cuda.device(dev):
        return max(_graph_slope_s(fn, args, k, repeats, cold), 1e-9)


def time_device_looped_inplace(fn: Callable, *args, k: int = 16,
                               repeats: int = 2, cold: bool = False) -> float:
    """The JAX package's ``time_device_looped_inplace``
    (dwarf_bench_tpu/utils/timing.py:70-102). Its one-element in-place
    update existed to couple the device loop's iterations at O(1) cost; a
    graph replay needs no coupling, so this is ``time_device_looped``."""
    return time_device_looped(fn, *args, k=k, repeats=repeats, cold=cold)


def _fence(dev) -> None:
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _queue_k(fn, args, k, dev) -> float:
    """Host seconds of ``k`` calls queued back to back and one fence."""
    t0 = time.perf_counter()
    for _ in range(k):
        fn(*args)
    _fence(dev)
    return time.perf_counter() - t0


_MIN_DIFF_S = 0.2  # exec-time spread between depths must dwarf jitter
_MAX_DEPTH = 100_000


def time_amortized(fn: Callable, *args, k: int = 8, warmup: int = 1) -> float:
    """Per-execution seconds by the queue-k slope (the JAX package's
    ``time_amortized``, dwarf_bench_tpu/utils/timing.py:144-190): ``k1`` and
    ``k2`` calls are queued back to back and fenced once
    (``torch.cuda.synchronize``); the slope between the two depths cancels
    the fence's round trip. For calls that read back to the host, which no
    graph can hold (the hash probes of the bench).

    The depths deepen until the implied spread between them is at least
    0.2 s (2 ms on the CPU), or until ``DBT_TIMING_BUDGET_S`` (default 6 s)
    of wall time is spent; the best slope so far is returned then."""
    dev = _first_device(args)
    for _ in range(max(warmup, 1)):
        _queue_k(fn, args, 1, dev)
    on_cpu = dev is None or dev.type != "cuda"
    min_diff = 0.002 if on_cpu else _MIN_DIFF_S
    t_budget = float(os.environ.get("DBT_TIMING_BUDGET_S", "6"))
    t_begin = time.perf_counter()
    k1, k2 = k, 5 * k
    slope = None
    for _ in range(6):
        t1 = min(_queue_k(fn, args, k1, dev) for _ in range(2))
        t2 = min(_queue_k(fn, args, k2, dev) for _ in range(2))
        slope = (t2 - t1) / (k2 - k1)
        if slope >= 1e-7 and slope * (k2 - k1) >= min_diff:
            return slope
        if k2 >= _MAX_DEPTH:
            break
        if time.perf_counter() - t_begin > t_budget:
            break
        # t2 / k2 bounds one call from above (one fence / k2 in it), a
        # degenerate slope from below: size the next depths by the larger
        est = max(slope, t2 / k2 / 4, 1e-6)
        diff = min(int(min_diff / est) + 1, _MAX_DEPTH)
        k1 = max(k, diff // 4)
        k2 = min(k1 + diff, _MAX_DEPTH)
    return max(slope if slope and slope > 0 else t2 / k2, 1e-9)
