"""Histograms of int32 keys: CUDA kernels (``csrc/hist.cu``) and their plain
PyTorch twins.

``histogram`` is the contract of ``dwarf_bench_tpu/ops/hist_pallas.py``
``histogram_16k_swar_pallas`` (and ``ops/sort.histogram_16k``): a
(hi_bins·128,) int32 count of keys, where a key whose uint32 value is at or
above hi_bins·128 (negatives, EMPTY, padding) counts nowhere.

``weighted_histogram`` is the contract of ``weighted_histogram_i8_swar_pallas``
(hi_bins 256 and 512) and ``weighted_histogram_i8_pallas`` (hi_bins below
256): (hi_bins·128,) int32 sums of v per bin, wrapping mod 2^32, with
out-of-range keys dropped. The card's kernel has no v < 2^14 precondition.

A wrapper takes the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .primitives import as_u32, wrap_i32

MAX_HIST_HI_BINS = 128  # 2^14 bins: 64 KB of shared memory per block
MAX_WEIGHTED_HI_BINS = 512  # 2^16 bins, the G = 2^16 group-by


def _check_hi_bins(op: str, hi_bins: int, most: int) -> int:
    if not 1 <= hi_bins <= most:
        raise ValueError(f"{op}: hi_bins must be in [1, {most}], got {hi_bins}")
    return hi_bins * 128


def histogram_plain(k: torch.Tensor, hi_bins: int = 128) -> torch.Tensor:
    nbins = _check_hi_bins("histogram", hi_bins, MAX_HIST_HI_BINS)
    ku = as_u32(k)
    ku = ku[ku < nbins]
    return torch.bincount(ku, minlength=nbins).to(torch.int32)


def histogram(k: torch.Tensor, hi_bins: int = 128) -> torch.Tensor:
    nbins = _check_hi_bins("histogram", hi_bins, MAX_HIST_HI_BINS)
    device = _build.check_vectors("histogram", k)
    if device.type == "cpu":
        return histogram_plain(k, hi_bins)
    out = torch.zeros(nbins, dtype=torch.int32, device=device)
    _build.launch("dbt_histogram", device, k.data_ptr(), k.numel(),
                  out.data_ptr(), nbins)
    _build.LAUNCHES["histogram"] += 1
    return out


def weighted_histogram_plain(
    k: torch.Tensor, v: torch.Tensor, hi_bins: int = 512
) -> torch.Tensor:
    nbins = _check_hi_bins("weighted_histogram", hi_bins, MAX_WEIGHTED_HI_BINS)
    ku = as_u32(k)
    keep = ku < nbins
    out = torch.zeros(nbins, dtype=torch.int64, device=k.device)
    out.index_add_(0, ku[keep], v[keep].to(torch.int64))
    return wrap_i32(out)


def weighted_histogram(
    k: torch.Tensor, v: torch.Tensor, hi_bins: int = 512
) -> torch.Tensor:
    nbins = _check_hi_bins("weighted_histogram", hi_bins, MAX_WEIGHTED_HI_BINS)
    device = _build.check_vectors("weighted_histogram", k, v)
    if k.numel() != v.numel():
        raise ValueError(
            f"weighted_histogram: {k.numel()} keys but {v.numel()} values"
        )
    if device.type == "cpu":
        return weighted_histogram_plain(k, v, hi_bins)
    out = torch.zeros(nbins, dtype=torch.int32, device=device)
    _build.launch("dbt_weighted_histogram", device, k.data_ptr(),
                  v.data_ptr(), k.numel(), out.data_ptr(), nbins)
    _build.LAUNCHES["weighted_histogram"] += 1
    return out
