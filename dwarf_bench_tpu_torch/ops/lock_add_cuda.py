"""A counter incremented under a device-wide lock: CUDA kernel
(``csrc/lock_add.cu``) and its plain PyTorch twin.

The contract of ``examples/lock_add.py`` ``grid_accumulate``: a (1, 1) int32
holding ``n_steps``, after ``n_steps`` serialized increments of one counter
(one per grid step on the TPU, one per block under a spin lock on the card).
The function has no input tensor, so ``device`` says where it runs: the card
unless the caller asks for the CPU, where the twin sums ``n_steps`` ones.
Nothing is read back to the host.
"""

from __future__ import annotations

import torch

from ..common.device import resolve_device
from ..common.options import DeviceType
from . import _build

_MAX_STEPS = 2**31 - 1  # the grid's x dimension


def _check(n_steps) -> int:
    n_steps = int(n_steps)
    if not 1 <= n_steps <= _MAX_STEPS:
        raise ValueError(f"grid_accumulate: n_steps must be in [1, "
                         f"{_MAX_STEPS}], got {n_steps}")
    return n_steps


def _device(device) -> torch.device:
    if device is None:
        return resolve_device(DeviceType.DEFAULT)
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"grid_accumulate: unsupported device {device}")
    return device


def grid_accumulate_plain(n_steps: int = 64, device="cpu") -> torch.Tensor:
    n_steps = _check(n_steps)
    ones = torch.ones(n_steps, dtype=torch.int32, device=_device(device))
    return ones.sum(dtype=torch.int32).view(1, 1)


def grid_accumulate(n_steps: int = 64, device=None) -> torch.Tensor:
    """``examples/lock_add.py:20`` ``grid_accumulate``: ``n_steps`` blocks
    each add one to a counter under a global spin lock. ``device`` is the
    card (``cuda:0``) unless given."""
    n_steps = _check(n_steps)
    device = _device(device)
    if device.type == "cpu":
        return grid_accumulate_plain(n_steps, device)
    lock = torch.empty(1, dtype=torch.int32, device=device)
    out = torch.empty((1, 1), dtype=torch.int32, device=device)
    _build.launch("dbt_lock_add", device, lock.data_ptr(), out.data_ptr(),
                  n_steps)
    _build.LAUNCHES["grid_accumulate"] += 1
    return out
