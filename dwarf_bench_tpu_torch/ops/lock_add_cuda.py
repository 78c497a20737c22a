"""A counter incremented under a device-wide lock: CUDA kernel
(``csrc/lock_add.cu``) and its plain PyTorch twin.

The contract of ``examples/lock_add.py`` ``grid_accumulate``: a (1, 1) int32
holding ``n_steps``, after ``n_steps`` serialized increments of one counter
(one per grid step on the TPU, one per block under a ticket lock on the
card). The function has no input tensor, so ``device`` says where it runs:
the card unless the caller asks for the CPU, where the twin sums ``n_steps``
ones. Nothing is read back to the host. On the card it is one launch and no
memset: the lock's ticket counter and its (counter, ticket served) word live
in a lasting scratch a stream (``LOCK_SCRATCH_WORDS`` int32), which the last
ticket puts back to zero. ``_ticket_schedule`` renders the lock's order in
plain Python for the tests; ``l2_round_trip`` measures the card's atomic
round trip, the bound of one handoff.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..common.device import resolve_device
from ..common.options import DeviceType
from . import _build

_MAX_STEPS = 2**31 - 1  # the grid's x dimension
# csrc/lock_add.cu: the ticket counter, then 128 bytes on, on an L2 line of
# its own, the 8-byte (counter, ticket served) word
LOCK_SCRATCH_WORDS = 64


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
    each add one to a counter under a device-wide ticket lock. ``device``
    is the card (``cuda:0``) unless given."""
    n_steps = _check(n_steps)
    device = _device(device)
    if device.type == "cpu":
        return grid_accumulate_plain(n_steps, device)
    # zero when made, and left zero by the last ticket
    scratch = _build.stream_scratch("grid_accumulate", device,
                                    LOCK_SCRATCH_WORDS)
    out = torch.empty((1, 1), dtype=torch.int32, device=device)
    _build.launch("dbt_lock_add", device, scratch.data_ptr(), out.data_ptr(),
                  n_steps)
    _build.LAUNCHES["grid_accumulate"] += 1
    return out


def _ticket_schedule(n_steps: int, seed: int = 0,
                     resident: Optional[int] = None):
    """The kernel's ticket lock in plain Python, for the tests: blocks start
    in an order drawn from ``seed``, at most ``resident`` at once (None:
    all), each taking the next ticket as it starts; the lock serves tickets
    in order, and the holder of ticket t reads the (counter, served) word,
    adds one to the counter and stores (counter, t + 1); the last ticket
    writes the counter out and zeroes the scratch. Returns (out, the counter
    each holder read in ticket order, the scratch after the call: next,
    served, counter). A block waits only on lower tickets, which blocks
    already started hold, so the schedule always ends."""
    n_steps = _check(n_steps)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_steps)
    resident = n_steps if resident is None else max(int(resident), 1)
    nxt, served, counter = 0, 0, 0
    waiting = {}  # ticket -> block
    seen: List[int] = []
    out = None
    started = 0
    while started < n_steps or waiting:
        # blocks start while the context has room
        while started < n_steps and len(waiting) < resident:
            waiting[nxt] = int(order[started])
            nxt += 1
            started += 1
        # the head of the line takes the lock: it has started
        assert served in waiting, "the ticket served is not held"
        waiting.pop(served)
        seen.append(counter)
        counter += 1
        if served + 1 == n_steps:
            out = counter
            nxt, served, counter = 0, 0, 0
        else:
            served += 1
    return out, seen, (nxt, served, counter)


def l2_round_trip(device=None, chain: int = 1 << 14) -> float:
    """Seconds of one L2 round trip of an atomic on the card: one thread's
    ``chain`` dependent atomicAdds on one word, timed on the global timer,
    over ``chain``. Reads the result back to the host."""
    device = _device(device)
    if device.type != "cuda":
        raise ValueError("l2_round_trip measures a CUDA device")
    word = torch.zeros(1, dtype=torch.int32, device=device)
    out = torch.empty(2, dtype=torch.int64, device=device)
    _build.launch("dbt_l2_round_trip", device, word.data_ptr(), int(chain),
                  out.data_ptr())
    ns, last = (int(v) for v in out.cpu())
    if last != chain - 1:
        raise RuntimeError(f"l2_round_trip: the chain ended at {last}, "
                           f"expected {chain - 1}")
    return ns * 1e-9 / chain
