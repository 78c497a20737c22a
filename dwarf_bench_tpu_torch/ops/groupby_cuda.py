"""Group-by sum over a small dense key space: CUDA kernel
(``csrc/groupby.cu``) and its plain PyTorch twin.

The contract of ``dwarf_bench_tpu/ops/groupby_pallas.py``
``groupby_small_pallas``: (G,) sums of v per key in [0, G), G <= 4096, keys
outside [0, G) as uint32 dropped, sums wrapping mod 2^32. The sums are
uint32 in the JAX package and int32 bit patterns here. The TPU kernel's
v < 2^14 precondition (bf16 value planes) does not apply on the card.

``groupby_small_swar_pallas`` and ``groupby_small_pallas_f32``
(``groupby_pallas.py:159, 59``) are the same contract for up to 2^14 groups:
G <= 4096 runs the ``groupby_small`` kernel, larger G the
``weighted_histogram`` kernel (``csrc/hist.cu``).

A wrapper takes the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .hist_cuda import weighted_histogram
from .primitives import as_u32, wrap_i32

MAX_GROUPS = 4096


def _check_groups(num_groups: int) -> None:
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(
            f"groupby_small: num_groups must be in [1, {MAX_GROUPS}], "
            f"got {num_groups}"
        )


def _sums_plain(k: torch.Tensor, v: torch.Tensor,
                num_groups: int) -> torch.Tensor:
    ku = as_u32(k)
    keep = ku < num_groups
    out = torch.zeros(num_groups, dtype=torch.int64, device=k.device)
    out.index_add_(0, ku[keep], v[keep].to(torch.int64))
    return wrap_i32(out)


def groupby_small_plain(
    k: torch.Tensor, v: torch.Tensor, num_groups: int
) -> torch.Tensor:
    _check_groups(num_groups)
    return _sums_plain(k, v, num_groups)


def groupby_small(
    k: torch.Tensor, v: torch.Tensor, num_groups: int
) -> torch.Tensor:
    _check_groups(num_groups)
    device = _build.check_vectors("groupby_small", k, v)
    if k.numel() != v.numel():
        raise ValueError(
            f"groupby_small: {k.numel()} keys but {v.numel()} values"
        )
    if device.type == "cpu":
        return groupby_small_plain(k, v, num_groups)
    out = torch.zeros(num_groups, dtype=torch.int32, device=device)
    _build.launch("dbt_groupby_small", device, k.data_ptr(), v.data_ptr(),
                  k.numel(), out.data_ptr(), num_groups)
    _build.LAUNCHES["groupby_small"] += 1
    return out


# -- the JAX package's balanced-digit variants (groupby_pallas.py:59, 159) --

MAX_DIGIT_GROUPS = 1 << 14


def _digit_split(num_groups: int):
    """(ga, gb) of ``dwarf_bench_tpu/ops/groupby_pallas.py:42``
    ``_digit_split``: gb a power of two in [8, 128], ga a multiple of 8,
    ga * gb >= num_groups, ga + gb least. The kernels here do not use the
    digits; the split only decides which group counts the JAX kernels
    accept."""
    best = None
    gb = 8
    while gb <= 128:
        ga = max(8, -(-num_groups // gb))
        ga = (ga + 7) // 8 * 8
        if ga <= 1024 and (best is None or ga + gb < best[0] + best[1]):
            best = (ga, gb)
        gb *= 2
    return best


def _check_digit_groups(op: str, num_groups: int, swar: bool) -> int:
    num_groups = int(num_groups)
    if not 1 <= num_groups <= MAX_DIGIT_GROUPS:
        raise ValueError(f"{op}: num_groups must be in [1, "
                         f"{MAX_DIGIT_GROUPS}], got {num_groups}")
    # the SWAR kernel routes bad keys to hi byte 127: ga <= 120
    # (groupby_pallas.py:202)
    if swar and _digit_split(num_groups)[0] > 120:
        raise ValueError(f"{op}: num_groups {num_groups} needs a hi digit "
                         "above 120")
    return num_groups


def groupby_digits_plain(k: torch.Tensor, v: torch.Tensor,
                         num_groups: int) -> torch.Tensor:
    """Plain version of the two variants: (G,) int32 bit patterns of the
    uint32 sums of v per key in [0, G), G <= 2^14, other keys dropped."""
    _check_digit_groups("groupby_digits", num_groups, False)
    return _sums_plain(k, v, num_groups)


def _digits(op: str, k, v, num_groups: int, swar: bool) -> torch.Tensor:
    num_groups = _check_digit_groups(op, num_groups, swar)
    device = _build.check_vectors(op, k, v)
    if k.numel() != v.numel():
        raise ValueError(f"{op}: {k.numel()} keys but {v.numel()} values")
    if device.type == "cpu":
        return _sums_plain(k, v, num_groups)
    if num_groups <= MAX_GROUPS:
        out = groupby_small(k, v, num_groups)
    else:
        # keys in [G, hi_bins * 128) land past G and are dropped with the
        # tail, as the contract drops keys out of range
        out = weighted_histogram(k, v, -(-num_groups // 128))[:num_groups]
    _build.LAUNCHES[op] += 1
    return out


def groupby_small_swar_pallas(k: torch.Tensor, v: torch.Tensor,
                              num_groups: int) -> torch.Tensor:
    """``groupby_pallas.py:159``: ``groupby_small``'s contract for the group
    counts the SWAR kernel takes (G <= 2^14 with a hi digit <= 120).
    G <= 4096 runs the ``groupby_small`` kernel, larger G the
    ``weighted_histogram`` kernel over ceil(G / 128) * 128 bins."""
    return _digits("groupby_small_swar_pallas", k, v, num_groups, True)


def groupby_small_pallas_f32(k: torch.Tensor, v: torch.Tensor,
                             num_groups: int) -> torch.Tensor:
    """``groupby_pallas.py:59``: as ``groupby_small_swar_pallas`` for
    G <= 2^14."""
    return _digits("groupby_small_pallas_f32", k, v, num_groups, False)
