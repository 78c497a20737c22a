"""Inclusive int32 cumsum plus a carry: CUDA kernel (``csrc/cumsum.cu``) and
its plain PyTorch twin.

The contract of ``dwarf_bench_tpu/ops/cumsum_pallas.py`` ``cumsum_pallas``:
``out[i] = carry_init + x[0] + ... + x[i]``, wrapping mod 2^32. The TPU
kernel's preconditions (|x| < 2^15, block sums < 2^24) are limits of its f32
matmuls; the card's scan adds in uint32 and is exact for every input.

``carry_init`` is a Python int or a one-element int32 tensor on the input's
device, so that a carry computed on the card (the counting sort's min - 1)
needs no trip to the host. The kernel takes an int carry by value, wrapped to
int32 on the host (``pack_carry``), so no call copies anything to the card
or waits for it. A wrapper takes the twin only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import _build, trace
from .primitives import wrap_i32

Carry = Union[int, torch.Tensor]


def _check_carry_tensor(carry_init: torch.Tensor, device: torch.device):
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


def _carry_tensor(carry_init: Carry, device: torch.device) -> torch.Tensor:
    if isinstance(carry_init, torch.Tensor):
        _check_carry_tensor(carry_init, device)
        return carry_init.reshape(1).contiguous()
    return wrap_i32(torch.tensor([int(carry_init)], dtype=torch.int64)).to(device)


def pack_carry(carry_init: Carry,
               device: torch.device) -> Tuple[Optional[torch.Tensor], int]:
    """The kernel's (carry tensor, carry value): a tensor carry is read on
    the card (value 0 unused); an int carry is wrapped mod 2^32 to an int32,
    as ``wrap_i32`` does, and passed by value (tensor None)."""
    if isinstance(carry_init, torch.Tensor):
        _check_carry_tensor(carry_init, device)
        return carry_init.reshape(1).contiguous(), 0
    return None, (int(carry_init) + (1 << 31)) % (1 << 32) - (1 << 31)


def cumsum_plain(x: torch.Tensor, carry_init: Carry = 0) -> torch.Tensor:
    carry = _carry_tensor(carry_init, x.device).to(torch.int64)
    return wrap_i32(torch.cumsum(x.to(torch.int64), 0) + carry)


def cumsum(x: torch.Tensor, carry_init: Carry = 0) -> torch.Tensor:
    sp = trace.begin("kernel.cumsum")
    try:
        device = _build.check_vectors("cumsum", x)
        if device.type == "cpu":
            return cumsum_plain(x, carry_init)
        carry, carry_val = pack_carry(carry_init, device)
        n = x.numel()
        out = torch.empty(n, dtype=torch.int32, device=device)
        scratch = _build.stream_scratch("cumsum", device,
                                        _build.cumsum_scratch_words(n))
        _build.launch("dbt_cumsum", device, x.data_ptr(), n,
                      None if carry is None else carry.data_ptr(), carry_val,
                      out.data_ptr(), scratch.data_ptr())
        _build.LAUNCHES["cumsum"] += 1
        return out
    finally:
        if sp:
            sp.close()
