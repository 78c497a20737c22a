"""Synchronisation and kernel timing.

PyTorch returns from a CUDA call before the card has finished it, so a host
clock is read only after ``sync``. ``kernel_time`` is the analog of the JAX
package's queue-k ``kernel_timed`` (dwarf_bench_tpu/dwarfs/base.py:80-93)
and of the reference's OpenCL event profiling (scan/scan.cpp:142-154): the
median over K runs of ``fn`` on device-resident inputs, each bracketed by a
pair of ``torch.cuda.Event``s, so host dispatch between runs is not
counted. On the CPU it is the median host time of K runs.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Optional

import torch


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
