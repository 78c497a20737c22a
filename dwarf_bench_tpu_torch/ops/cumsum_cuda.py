"""Inclusive int32 cumsum plus a carry: CUDA kernel (``csrc/cumsum.cu``) and
its plain PyTorch twin.

The contract of ``dwarf_bench_tpu/ops/cumsum_pallas.py`` ``cumsum_pallas``:
``out[i] = carry_init + x[0] + ... + x[i]``, wrapping mod 2^32. The TPU
kernel's preconditions (|x| < 2^15, block sums < 2^24) are limits of its f32
matmuls; the card's scan adds in uint32 and is exact for every input.

``carry_init`` is a Python int or a one-element int32 tensor on the input's
device, so that a carry computed on the card (the counting sort's min - 1)
needs no trip to the host. The kernel takes an int carry by value, wrapped to
int32 on the host (``_build.pack_int32``), so no call copies anything to the
card or waits for it. A wrapper takes the twin only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build, trace
from .primitives import wrap_i32

Carry = _build.Int32


def cumsum_plain(x: torch.Tensor, carry_init: Carry = 0) -> torch.Tensor:
    carry = _build.int32_tensor("cumsum", "carry_init", carry_init,
                                x.device).to(torch.int64)
    return wrap_i32(torch.cumsum(x.to(torch.int64), 0) + carry)


def cumsum(x: torch.Tensor, carry_init: Carry = 0) -> torch.Tensor:
    sp = trace.begin("kernel.cumsum")
    try:
        device = _build.check_vectors("cumsum", x)
        if device.type == "cpu":
            return cumsum_plain(x, carry_init)
        carry, carry_val = _build.pack_int32("cumsum", "carry_init",
                                             carry_init, device)
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
