"""copy_if(x, x < threshold): CUDA kernel (``csrc/filter.cu``) and its plain
PyTorch twin.

The contract of ``dwarf_bench_tpu/ops/scan_pallas.py`` ``filter_pallas``:
``(out, count)`` with the kept values of the int32 column ``x`` in input
order in ``capacity`` slots (default ``len(x)``), garbage past ``count``, and
``count`` the full number of matches as a 0-d int32 tensor on ``x``'s
device. The TPU kernel's ``tile`` argument is a TPU blocking knob and has no
counterpart. The kernel takes int32 only; a CUDA tensor of another dtype
raises ValueError.

A wrapper takes the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel, one launch a call with no memset, or raises.
``_lookback_filter`` runs the kernel's schedule in plain PyTorch
(``compact_cuda._lookback_compact``) for the tests.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, compact_cuda, trace
from .primitives import compact

DEFAULT_THRESHOLD = 5


def filter_plain(x: torch.Tensor, threshold: int = DEFAULT_THRESHOLD,
                 capacity: Optional[int] = None):
    return compact(x, x < threshold, capacity)


def filter(x: torch.Tensor, threshold: int = DEFAULT_THRESHOLD,
           capacity: Optional[int] = None):
    sp = trace.begin("kernel.filter")
    try:
        device = _build.check_vectors("filter", x)
        thr = _build.check_int32("filter", "threshold", threshold)
        n = x.numel()
        cap = _build.check_capacity("filter", capacity, n)
        if device.type == "cpu":
            return filter_plain(x, thr, cap)
        # two counters and the status words: zero when made, left zero
        scratch = _build.stream_scratch("compact", device,
                                        _build.compact_scratch_words(n, 1))
        out = x.new_empty(cap)
        count = x.new_empty(())
        _build.launch("dbt_filter", device, x.data_ptr(), n, thr,
                      out.data_ptr(), cap, count.data_ptr(),
                      scratch.data_ptr())
        _build.LAUNCHES["filter"] += 1
        return out, count
    finally:
        if sp:
            sp.close()


def _lookback_filter(x: torch.Tensor, threshold: int = DEFAULT_THRESHOLD,
                     capacity: Optional[int] = None, **schedule):
    """``filter`` by the kernel's schedule (8 runs a lane: 16384-row tiles,
    unless ``schedule`` says otherwise): ``(out, count, reads)``."""
    schedule.setdefault("vecs", 8)
    _build.check_vectors("filter", x)
    thr = _build.check_int32("filter", "threshold", threshold)
    cap = _build.check_capacity("filter", capacity, x.numel())
    ((out,),), (count,), reads = compact_cuda._lookback_compact(
        (x < thr)[None], ((x,),), (cap,), **schedule)
    return out, count, reads
