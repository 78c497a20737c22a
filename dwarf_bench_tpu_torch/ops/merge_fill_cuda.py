"""Fused fill pass of the bitonic merge probe: CUDA kernel
(``csrc/merge_fill.cu``) and its plain PyTorch twin.

The contract of ``dwarf_bench_tpu/ops/merge_fill_pallas.py``
``merge_fill_pallas`` (18-20, 86-128), over the merged order of int32
bit-pattern columns ``sk`` (keys), ``sa`` (aux: bit 31 set on query rows,
which carry their index in the low bits) and, in 32-bit mode, ``dv`` (the
table rows' value deltas):

- carry = running unsigned max of key+1 over source rows (EMPTY+1 wraps to
  0, "none"); found = query row & carry == key+1 & key != EMPTY;
- fill = running uint32 sum of the source rows' deltas (``sa & 0xFFFF`` with
  ``val16``, ``dv`` otherwise, none with ``membership``), mod 2^16 with
  ``val16``;
- dest = (qidx << 1) | found for a query row with qidx < nq, -1
  (0xFFFFFFFF) elsewhere; val = fill where found, else 0 (always 0 with
  ``membership``).

Returns ``(dest, val)`` as int32 bit patterns. N is any length. A wrapper
takes the twin only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .primitives import wrap_i32

_M32 = 0xFFFFFFFF


def _mode(val16: bool, membership: bool) -> int:
    if membership:
        return 2
    return 1 if val16 else 0


def _check(sk, sa, dv, nq, val16, membership):
    mode = _mode(val16, membership)
    cols = (sk, sa) if mode else (sk, sa, dv)
    if mode == 0 and dv is None:
        raise ValueError("merge_fill: 32-bit mode needs the dv column")
    device = _build.check_vectors("merge_fill", *cols)
    if any(c.numel() != sk.numel() for c in cols):
        raise ValueError("merge_fill: columns of different lengths")
    if not 0 <= int(nq) < 2**30:
        raise ValueError(f"merge_fill: nq {nq} is not in [0, 2^30)")
    return device, mode


def merge_fill_plain(sk: torch.Tensor, sa: torch.Tensor,
                     dv: Optional[torch.Tensor], nq: int,
                     val16: bool = False, membership: bool = False):
    _, mode = _check(sk, sa, dv, nq, val16, membership)
    is_src = sa >= 0  # bit 31 clear
    kp1 = (sk.to(torch.int64) + 1) & _M32
    carry = torch.cummax(torch.where(is_src, kp1, 0), 0).values \
        if sk.numel() else kp1
    found = ~is_src & (carry == kp1) & (sk != -1)
    if mode == 2:
        val = torch.zeros_like(sk)
    else:
        delta = (sa & 0xFFFF) if mode == 1 else dv
        fill = torch.cumsum(torch.where(is_src, delta, 0), 0,
                            dtype=torch.int64)
        fill = fill & (0xFFFF if mode == 1 else _M32)
        val = torch.where(found, wrap_i32(fill), 0)
    qp = (sa & 0x7FFFFFFF).to(torch.int64)
    is_real = ~is_src & (qp < int(nq))
    dest = torch.where(is_real, (qp << 1) | found.to(torch.int64), -1)
    return dest.to(torch.int32), val


def merge_fill(sk: torch.Tensor, sa: torch.Tensor, dv: Optional[torch.Tensor],
               nq: int, val16: bool = False, membership: bool = False):
    device, mode = _check(sk, sa, dv, nq, val16, membership)
    if device.type == "cpu":
        return merge_fill_plain(sk, sa, dv, nq, val16, membership)
    n = sk.numel()
    dest = torch.empty(n, dtype=torch.int32, device=device)
    val = torch.empty(n, dtype=torch.int32, device=device)
    scratch = torch.empty(max(int(_build.library().dbt_merge_fill_scratch(n)),
                              1), dtype=torch.int32, device=device)
    _build.launch("dbt_merge_fill", device, sk.data_ptr(), sa.data_ptr(),
                  dv.data_ptr() if mode == 0 else None, n, int(nq), mode,
                  dest.data_ptr(), val.data_ptr(), scratch.data_ptr())
    _build.LAUNCHES["merge_fill"] += 1
    return dest, val
