"""The counting sort's run expansion: CUDA kernel (``csrc/expand_runs.cu``)
and its plain PyTorch twin.

The contract of ``dwarf_bench_tpu/ops/sort.py`` ``_expand_runs``: the sorted
column of a histogram, ``out[i] = shift + b`` for the ``b`` with
``C[b] <= i < C[b + 1]``, ``C`` the exclusive cumsum of ``counts``, wrapping
mod 2^32. ``counts`` is an int32 vector of 1 to ``MAX_BINS`` bins summing to
``n``; empty bins, leading and trailing ones included, hold no row.

``shift`` is a Python int or a one-element int32 tensor on the counts'
device: a tensor is read on the card (the counting sort's min needs no trip
to the host), an int is passed by value (``_build.pack_int32``). The kernel
stores each row once, in one launch with no scratch and no memset; the twin
repeats ``arange(nbins)`` by the counts. A wrapper takes the twin only for a
CPU tensor; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build, trace
from .primitives import wrap_i32

MAX_BINS = 1 << 14  # the starts of 2^14 bins fit a block's shared memory


def _check(counts: torch.Tensor, n: int) -> torch.device:
    device = _build.check_vectors("expand_runs", counts)
    if not 1 <= counts.numel() <= MAX_BINS:
        raise ValueError(f"expand_runs: 1 to {MAX_BINS} bins, got "
                         f"{counts.numel()}")
    if not 0 <= n < 2**31:
        raise ValueError(f"expand_runs: n {n} is not in [0, 2^31)")
    return device


def expand_runs_plain(counts: torch.Tensor, n: int,
                      shift: _build.Int32 = 0) -> torch.Tensor:
    """The twin; raises ValueError where the counts do not sum to ``n``."""
    _check(counts, n)
    reps = counts.to(torch.int64)
    if int(reps.sum()) != n:
        raise ValueError(f"expand_runs: the counts sum to {int(reps.sum())}, "
                         f"not n = {n}")
    bins = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), reps)
    base = _build.int32_tensor("expand_runs", "shift", shift, counts.device)
    return wrap_i32(bins + base.to(torch.int64))


def expand_runs(counts: torch.Tensor, n: int,
                shift: _build.Int32 = 0) -> torch.Tensor:
    sp = trace.begin("kernel.expand_runs")
    try:
        device = _check(counts, n)
        if device.type == "cpu":
            return expand_runs_plain(counts, n, shift)
        return launch_expand_runs(counts, n, shift)
    finally:
        if sp:
            sp.close()


def launch_expand_runs(counts: torch.Tensor, n: int, shift: _build.Int32 = 0,
                       blocks: int = 0) -> torch.Tensor:
    """The kernel on checked CUDA counts; ``blocks`` > 0 fixes its grid
    (the plan sweep of ``utils/kernel_times.py``), 0 takes the kernel's
    own plan."""
    shift_t, shift_val = _build.pack_int32("expand_runs", "shift", shift,
                                           counts.device)
    out = torch.empty(n, dtype=torch.int32, device=counts.device)
    _build.launch("dbt_expand_runs", counts.device, counts.data_ptr(),
                  counts.numel(), n,
                  None if shift_t is None else shift_t.data_ptr(), shift_val,
                  out.data_ptr(), blocks)
    _build.LAUNCHES["expand_runs"] += 1
    return out
