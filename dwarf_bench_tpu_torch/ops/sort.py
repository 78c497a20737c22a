"""Full sort of int32 columns (the port of ``dwarf_bench_tpu/ops/sort.py``).

Reference behaviour: ascending full sort of an int32 column
(sort/radix.cpp:34 delegates to the vendor sort).

Engines:

  * the counting sort (``sort_counting``, ``_sort_counting_shifted``) for
    columns whose span after a min-shift is below 2^14 (the benchmark's
    uniform [1, 10000] columns): a histogram kernel (``hist_cuda``) that
    subtracts the min as it loads each key and one kernel that writes each
    sorted row from the bin starts (``expand_runs_cuda``), both reading the
    min on the card. The input is never moved or copied.
  * ``torch.sort`` where the JAX package leaves the sort to XLA
    (``sort_auto``'s wide-span branch).

The JAX package short-circuits the CPU backend to ``lax.sort`` because its
one-hot-matmul histogram is slow there. The port's CPU twins are
``bincount`` and ``repeat_interleave``, so every device runs the same
pipeline.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from . import expand_runs_cuda, hist_cuda, trace

_RANGE_BITS = 14
_NARROW_BINS = 80 * 128  # the benchmark's [1, 10000] spans land here


def histogram_dispatch(k: torch.Tensor, hi_bins: int = 128) -> torch.Tensor:
    """``histogram_16k`` semantics: the CUDA kernel for a CUDA tensor, its
    plain twin for a CPU tensor."""
    return hist_cuda.histogram(k, hi_bins=hi_bins)


def _expand_runs(
    counts: torch.Tensor, n: int, shift: Union[int, torch.Tensor] = 0
) -> torch.Tensor:
    """Sorted bin-index column (plus ``shift``) from a histogram:
    out[i] = shift + the b such that C[b] <= i < C[b+1], C the exclusive
    cumsum of counts. The JAX package scatters the bin starts into an n-row
    column and expands it with a TPU scan; the card writes each row once
    from the starts (``expand_runs_cuda``)."""
    if isinstance(shift, torch.Tensor):
        shift = shift.to(torch.int32)
    return expand_runs_cuda.expand_runs(counts, n, shift)


def _shifted_histogram(
    x: torch.Tensor, minv: torch.Tensor, hi_bins: int = 128
) -> torch.Tensor:
    """The histogram of ``x - minv``: the kernel subtracts the min, read on
    the card, as it loads each key, so no shifted column is written."""
    return hist_cuda.histogram(x, hi_bins=hi_bins, shift=minv)


def _sort_counting_shifted(
    x: torch.Tensor, minv: torch.Tensor, hi_bins: int = 128
) -> torch.Tensor:
    counts = _shifted_histogram(x, minv, hi_bins=hi_bins)
    return _expand_runs(counts, x.shape[0], shift=minv).to(x.dtype)


def sort_counting(x: torch.Tensor) -> torch.Tensor:
    """Distribution sort of an int32 column. PRECONDITION: max(x) - min(x)
    < 2^14. Use ``sort_auto`` when the range is not known."""
    return _sort_counting_shifted(x, torch.min(x))


def sort_auto(x: torch.Tensor) -> torch.Tensor:
    """Range-adaptive sort: the counting sort when the span fits 80·128 or
    2^14 bins, ``torch.sort`` otherwise. The JAX package decides on the
    device with ``lax.cond``; eager PyTorch reads the span on the host,
    which costs one synchronisation. Its phases are spans
    (``ops/trace.py``): ``sort_auto.span`` (min, max and the two reads),
    then ``sort_auto.histogram`` and ``sort_auto.expand``, or
    ``sort_auto.torch_sort``."""
    if x.shape[0] == 0:
        return x
    sp = trace.begin("sort_auto")
    try:
        if sp:
            sp.next("sort_auto.span")
        minv = torch.min(x)
        span = (trace.read(torch.max(x), "sort_auto.max")
                - trace.read(minv, "sort_auto.min"))
        if span < (1 << _RANGE_BITS):
            if span < _NARROW_BINS:
                trace.take("sort_auto", "hi80")
                hi_bins = 80
            else:
                trace.take("sort_auto", "hi128")
                hi_bins = 128
            if sp:
                sp.next("sort_auto.histogram")
            counts = _shifted_histogram(x, minv, hi_bins=hi_bins)
            if sp:
                sp.next("sort_auto.expand")
            return _expand_runs(counts, x.shape[0], shift=minv).to(x.dtype)
        trace.take("sort_auto", "torch.sort")
        if sp:
            sp.next("sort_auto.torch_sort")
        return torch.sort(x).values
    finally:
        if sp:
            sp.close()


def _counting_engine(hi_bins: int) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda x: _sort_counting_shifted(x, torch.min(x), hi_bins=hi_bins)


def sort_host_dispatch(host_vals) -> Callable[[torch.Tensor], torch.Tensor]:
    """Engine pick from the host column the caller holds (the dwarfs
    generate it): the range check ``sort_auto`` makes per call runs once
    here, and the counting pipeline is returned directly."""
    v = np.asarray(host_vals)
    if v.size == 0:
        return sort_auto
    span = int(v.astype(np.uint32).max()) - int(v.astype(np.uint32).min())
    if v.dtype == np.int32:  # span as the true int32 difference
        span = int(v.max()) - int(v.min())
    if span < _NARROW_BINS:
        return _counting_engine(80)
    if span < (1 << _RANGE_BITS):
        return _counting_engine(128)
    return sort_auto


def sort_oracle(x) -> np.ndarray:
    """std::sort oracle (sort/radix.cpp:8-13)."""
    return np.sort(np.asarray(x), kind="stable")
