"""Phase-A chunk statistics: CUDA kernel (``csrc/chunk_stats.cu``) for the
sparse filter's default path and under the three JAX names that compute
them, and the plain PyTorch version (``ops/chunk_stats.chunk_stats``).

``chunk_stats`` (``filter_sparse``'s phase A, the contract of the JAX
package's ``chunk_stats_xla``), ``chunk_stats_pallas``,
``chunk_stats_roll_pallas`` and ``chunk_stats_fused``
(``dwarf_bench_tpu/ops/chunk_stats_pallas.py:268, 54, 138``) share one
contract: over ``x2``, (nch, 128) int32, per chunk
``stat = cnt * 512 + min(vsum, 511)`` and ``base``, the exclusive cumsum of
the counts, (nch,) int32 each. One kernel serves the four names: it writes
``stat`` and the counts one slot late (a 0 first), and ``base`` comes from
the cumsum kernel (``csrc/cumsum.cu``) over those, the way
``chunk_stats_roll_pallas`` takes it from ``cumsum_pallas``: two launches a
call. Each name counts its own launches.

``x2`` must have rows of 128 contiguous int32 (a row-major view, which may
start at any offset: a view that is not 16-byte aligned takes the kernel's
scalar loads). A wrapper takes the plain version only for a CPU tensor; for
a CUDA tensor it launches the kernel or raises. Nothing is read back to the
host.
"""

from __future__ import annotations

import torch

from . import _build, cumsum_cuda, trace
from .chunk_stats import chunk_stats as chunk_stats_plain

__all__ = ["chunk_stats", "chunk_stats_pallas", "chunk_stats_roll_pallas",
           "chunk_stats_fused", "chunk_stats_plain"]


def _check(op: str, x2, threshold):
    if not isinstance(x2, torch.Tensor):
        raise TypeError(f"{op}: expected a tensor, got {type(x2).__name__}")
    if x2.dtype != torch.int32 or x2.dim() != 2 or x2.shape[1] != 128:
        raise ValueError(f"{op}: expected (nch, 128) int32, got "
                         f"{tuple(x2.shape)} {x2.dtype}")
    if x2.shape[0] > 0 and x2.stride() != (128, 1):
        raise ValueError(f"{op}: rows of 128 contiguous int32 expected, got "
                         f"strides {x2.stride()}")
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {x2.device}")
    return _build.check_int32(op, "threshold", threshold)


def _stats(op: str, x2: torch.Tensor, threshold):
    thr = _check(op, x2, threshold)
    if x2.device.type == "cpu":
        return chunk_stats_plain(x2, thr)
    return _launch(op, x2, thr)


def _launch(op: str, x2: torch.Tensor, thr: int):
    device = x2.device
    nch = x2.shape[0]
    stat = torch.empty(nch, dtype=torch.int32, device=device)
    cnt = torch.empty(nch + 1, dtype=torch.int32, device=device)
    _build.launch("dbt_chunk_stats", device, x2.data_ptr(), nch, thr,
                  stat.data_ptr(), cnt.data_ptr())
    _build.LAUNCHES[op] += 1
    # cnt[0] = 0 and cnt[c + 1] the count of chunk c: the inclusive cumsum
    # of cnt[:nch] is the exclusive one of the counts. The int carry goes by
    # value: no host-to-device copy on this path.
    return stat, cumsum_cuda.cumsum(cnt[:nch], 0)


def chunk_stats(x2: torch.Tensor, threshold: int):
    """(stat, base) of ``x2``: ``filter_sparse``'s phase A on its default
    path."""
    sp = trace.begin("kernel.chunk_stats")
    try:
        return _stats("chunk_stats", x2, threshold)
    finally:
        if sp:
            sp.close()


def chunk_stats_pallas(x2: torch.Tensor, threshold: int):
    """(stat, base) of ``x2``; the round-2 kernel's name, which
    ``scan.filter_sparse(stats_pallas=True)`` calls."""
    return _stats("chunk_stats_pallas", x2, threshold)


def chunk_stats_roll_pallas(x2: torch.Tensor, threshold: int):
    """(stat, base) of ``x2``; the lane-roll kernel's name."""
    return _stats("chunk_stats_roll_pallas", x2, threshold)


def chunk_stats_fused(x2: torch.Tensor, threshold: int):
    """(stat, base) of ``x2``; the name of the kernel that also yields
    ``base``."""
    return _stats("chunk_stats_fused", x2, threshold)
