"""Plain reference of the ``join`` query: HeavyDB's one-to-many CSR join as
the reference's JoinOmnisci checks it (``join/join_omnisci.cpp:15-45``
builds the same structure on the host), computed without the program. It
imports nothing of the program.

``expected`` gives each probe row's view (found, pos, counts): the build
keys sorted, and two ``searchsorted`` calls a probe key (its first and its
past-the-last place among them). ``id_buffer_faults`` checks an
``id_buffer`` on its own: whether it is a permutation of the build rows,
and how often the build keys descend along it. Keys compare as the uint32
values of their bit patterns; EMPTY (-1, uint32 0xFFFFFFFF) rows are
padding, left out of the build side and never found.

``control`` is the reference with the exactness guarantee broken: views
and an ``id_buffer`` computed from bfloat16-rounded keys on both sides (8
significant bits, so keys above 256 come back rounded and merge), in the
program's output shape. It stands in the program's place to show that the
comparison fails it.
"""

from __future__ import annotations

import torch

EMPTY = -1
_U32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 value of each int32 bit pattern, as int64."""
    return x.reshape(-1).to(torch.int64) & _U32


def _views(build_u: torch.Tensor, probe_u: torch.Tensor,
           probe_valid: torch.Tensor):
    ordered = torch.sort(build_u).values
    lo = torch.searchsorted(ordered, probe_u)
    cnt = torch.searchsorted(ordered, probe_u, right=True) - lo
    found = (cnt > 0) & probe_valid
    zero = torch.zeros_like(lo)
    return (found, torch.where(found, lo, zero).to(torch.int32),
            torch.where(found, cnt, zero).to(torch.int32))


def expected(build: torch.Tensor, probe: torch.Tensor, params: dict):
    """(found, pos, counts) of each probe row: found where its key occurs
    among the valid build rows, pos the number of them with a smaller key,
    counts the number with an equal key (both 0 where not found)."""
    build, probe = build.reshape(-1), probe.reshape(-1)
    return _views(_u32(build[build != EMPTY]), _u32(probe), probe != EMPTY)


def id_buffer_faults(build: torch.Tensor, id_buffer: torch.Tensor):
    """(1 where ``id_buffer`` is not a permutation of [0, n) else 0, the
    number of places where the build key descends along it)."""
    keys = _u32(build)
    n = keys.numel()
    ids = id_buffer.reshape(-1).to(torch.int64)
    inside = (ids >= 0) & (ids < n)
    perm = ids.numel() == n and bool(inside.all()) and bool(
        (torch.bincount(ids, minlength=n) == 1).all())
    if n == 0 or ids.numel() < 2:
        return int(not perm), 0
    along = keys[ids.clamp(0, n - 1)]
    return int(not perm), int((along[1:] < along[:-1]).sum())


def control(build: torch.Tensor, probe: torch.Tensor, params: dict):
    """``(found, pos, counts, id_buffer)`` from bfloat16-rounded keys."""
    b = build.reshape(-1)
    rb = b.to(torch.bfloat16).to(torch.int32)
    rp = probe.reshape(-1).to(torch.bfloat16).to(torch.int32)
    found, pos, counts = _views(_u32(rb[b != EMPTY]), _u32(rp),
                                probe.reshape(-1) != EMPTY)
    id_buffer = torch.sort(_u32(rb), stable=True).indices.to(torch.int32)
    return found, pos, counts, id_buffer
