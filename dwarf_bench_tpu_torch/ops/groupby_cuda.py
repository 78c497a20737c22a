"""Group-by sum over a small dense key space: CUDA kernel
(``csrc/groupby.cu``) and its plain PyTorch twin.

The contract of ``dwarf_bench_tpu/ops/groupby_pallas.py``
``groupby_small_pallas``: (G,) sums of v per key in [0, G), G <= 4096, keys
outside [0, G) as uint32 dropped, sums wrapping mod 2^32. The sums are
uint32 in the JAX package and int32 bit patterns here. The TPU kernel's
v < 2^14 precondition (bf16 value planes) does not apply on the card.

A wrapper takes the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .primitives import as_u32, wrap_i32

MAX_GROUPS = 4096


def _check_groups(num_groups: int) -> None:
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(
            f"groupby_small: num_groups must be in [1, {MAX_GROUPS}], "
            f"got {num_groups}"
        )


def groupby_small_plain(
    k: torch.Tensor, v: torch.Tensor, num_groups: int
) -> torch.Tensor:
    _check_groups(num_groups)
    ku = as_u32(k)
    keep = ku < num_groups
    out = torch.zeros(num_groups, dtype=torch.int64, device=k.device)
    out.index_add_(0, ku[keep], v[keep].to(torch.int64))
    return wrap_i32(out)


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
