"""Phase-A chunk statistics for the sparsity-adaptive filter.

The contract of ``dwarf_bench_tpu/ops/chunk_stats.py`` ``chunk_stats_xla``:
over ``x`` viewed as (nch, 128) int32 chunk rows, per chunk

  * ``cnt``  — matches (x < threshold) in the chunk;
  * ``vsum`` — sum of the window encodings
    d = clip(threshold - max(x, threshold - 512), 0, 256), clamped to 511.
    A chunk with exactly one match in (threshold - 256, threshold) has
    1 <= vsum <= 255 and that match's value is ``threshold - vsum``; a match
    at or below threshold - 256 adds 256, so such a single shows as
    vsum == 256 and takes the gather path;
  * ``base`` — exclusive cumsum of cnt, each chunk's output offset.

Returns ``stat = cnt * 512 + min(vsum, 511)`` and ``base``, (nch,) int32
each. All arithmetic is int32 and wraps as the JAX function's does: for a
threshold at or below INT32_MIN + 512 ``threshold - 512`` wraps and the
classification is garbage, which ``filter_sparse`` routes away.

The JAX package computes this with XLA's fused row reductions, not a Pallas
kernel. Eager PyTorch has no such fusion, so the port computes it with the
kernel ``csrc/chunk_stats.cu`` on the card (``ops/chunk_stats_cuda.py``, the
default path of ``scan.filter_sparse`` and the opt-in Pallas variants of
the same contract, ``chunk_stats_pallas.py``); this function is that
kernel's plain version, which the CPU and the tests take.
"""

from __future__ import annotations

import torch

from .primitives import exclusive_cumsum

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _wrap(v: int) -> int:
    return (v - _I32_MIN) % (1 << 32) + _I32_MIN


def chunk_stats(x2: torch.Tensor, threshold: int):
    """x2: (nch, 128) int32. Returns (stat, base), (nch,) int32 each."""
    thr = int(threshold)
    if not _I32_MIN <= thr <= _I32_MAX:
        raise ValueError(f"chunk_stats: threshold {thr} is not an int32")
    cnt = (x2 < thr).sum(1, dtype=torch.int32)
    d = thr - x2.clamp_min(_wrap(thr - 512))  # int32, wraps like XLA's
    vs = d.clamp_(0, 256).sum(1, dtype=torch.int32).clamp_max_(511)
    return cnt * 512 + vs, exclusive_cumsum(cnt)


def chunk_stats_xla(x2: torch.Tensor, threshold: int):
    """The JAX package's name of this contract (its phase A, fused by
    XLA): ``chunk_stats_cuda.chunk_stats``, the kernel on a CUDA tensor and
    ``chunk_stats`` above on a CPU tensor."""
    from . import chunk_stats_cuda

    return chunk_stats_cuda.chunk_stats(x2, threshold)
