"""Inclusive int32 cumsum plus a carry: CUDA kernel (``csrc/cumsum.cu``) and
its plain PyTorch twin.

The contract of ``dwarf_bench_tpu/ops/cumsum_pallas.py`` ``cumsum_pallas``:
``out[i] = carry_init + x[0] + ... + x[i]``, wrapping mod 2^32. The TPU
kernel's preconditions (|x| < 2^15, block sums < 2^24) are limits of its f32
matmuls; the card's scan adds in uint32 and is exact for every input.

``carry_init`` is a Python int or a one-element int32 tensor on the input's
device, so that a carry computed on the card (the counting sort's min - 1)
needs no trip to the host. A wrapper takes the twin only for a CPU tensor;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Union

import torch

from . import _build
from .primitives import wrap_i32

Carry = Union[int, torch.Tensor]


def _carry_tensor(carry_init: Carry, device: torch.device) -> torch.Tensor:
    if isinstance(carry_init, torch.Tensor):
        if carry_init.numel() != 1 or carry_init.dtype != torch.int32:
            raise ValueError(
                "cumsum: carry_init must be an int or a one-element int32 "
                f"tensor, got {carry_init.dtype} of shape "
                f"{tuple(carry_init.shape)}"
            )
        if carry_init.device != device:
            raise ValueError(
                f"cumsum: carry_init on {carry_init.device}, input on {device}"
            )
        return carry_init.reshape(1).contiguous()
    return wrap_i32(torch.tensor([int(carry_init)], dtype=torch.int64)).to(device)


def cumsum_plain(x: torch.Tensor, carry_init: Carry = 0) -> torch.Tensor:
    carry = _carry_tensor(carry_init, x.device).to(torch.int64)
    return wrap_i32(torch.cumsum(x.to(torch.int64), 0) + carry)


def cumsum(x: torch.Tensor, carry_init: Carry = 0) -> torch.Tensor:
    device = _build.check_vectors("cumsum", x)
    if device.type == "cpu":
        return cumsum_plain(x, carry_init)
    carry = _carry_tensor(carry_init, device)
    n = x.numel()
    out = torch.empty(n, dtype=torch.int32, device=device)
    scratch = torch.empty(max(_build.scratch_words(n), 1), dtype=torch.int32,
                          device=device)
    _build.launch("dbt_cumsum", device, x.data_ptr(), n, carry.data_ptr(),
                  out.data_ptr(), scratch.data_ptr())
    _build.LAUNCHES["cumsum"] += 1
    return out
