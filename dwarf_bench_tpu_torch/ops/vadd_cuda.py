"""Elementwise add: CUDA kernel (``csrc/vadd.cu``) and its plain PyTorch
twin.

The contract of ``examples/vadd.py`` ``vadd_pallas``: ``a + b`` of two
tensors of one shape and dtype, returned in that shape and dtype. The card's
kernel takes float32 (added with round-to-nearest, never fused, so equal to
XLA's add bit for bit) and int32 (wrapping mod 2^32), on contiguous tensors;
any other dtype raises ValueError (the Pallas kernel takes any dtype its
VMEM block holds). A wrapper takes the twin only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.int32: 1}


def _check(a: torch.Tensor, b: torch.Tensor) -> torch.device:
    for t in (a, b):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"vadd: expected a tensor, got {type(t).__name__}")
    if a.dtype not in _DTYPES:
        raise ValueError(f"vadd: float32 or int32 only, got {a.dtype}")
    if b.dtype != a.dtype or b.shape != a.shape:
        raise ValueError(f"vadd: {tuple(a.shape)}/{a.dtype} and "
                         f"{tuple(b.shape)}/{b.dtype} differ")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vadd: tensors on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("vadd: expected contiguous tensors")
    return a.device


def vadd_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    return a + b


def vadd_pallas(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``examples/vadd.py:21`` ``vadd_pallas``: ``a + b``."""
    device = _check(a, b)
    if device.type == "cpu":
        return vadd_plain(a, b)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    _build.launch("dbt_vadd", device, a.data_ptr(), b.data_ptr(),
                  out.data_ptr(), a.numel(), _DTYPES[a.dtype])
    _build.LAUNCHES["vadd_pallas"] += 1
    return out
