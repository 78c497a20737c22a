"""The JAX collectives of ``parallel/`` over torch.distributed, on the
process group of one mesh dimension (``mesh.get_group(name)``).

  * ``all_to_all``: ``lax.all_to_all(tiled=False)`` over the leading axis,
    ``all_to_all_single`` on a contiguous (n, ...) buffer: row j goes to
    the group's rank j, and row i of the result came from rank i;
  * ``all_gather``: ``lax.all_gather``, a new leading axis by group rank;
  * ``psum``: ``lax.psum``, ``all_reduce(SUM)``; int32 sums wrap mod 2^32
    on gloo and NCCL, the JAX uint32 ``psum``'s result. ``group=None`` is
    the world, which every mesh spans (all of a mesh's dimensions);
  * ``ring_next``: ``lax.ppermute`` with the permutation i -> i + 1 mod n,
    ``batch_isend_irecv``. A group of one rank sends nothing: the
    permutation of one is the identity, and gloo cannot send to its own
    rank (NCCL can).

``record_collectives()`` tallies the bytes of these calls: each call inside
it notes (kind, bytes), the kind by the HLO name of the JAX collective it
stands for (``all-to-all``, ``all-gather``, ``all-reduce``,
``collective-permute``) and the bytes those of its result on this rank (for
``all_gather`` the stacked result), the measure the JAX package's scaling
model reads from compiled HLO (scripts/scaling_model.py ``_shape_bytes``).
Outside a recorder a call checks one name for None and notes nothing.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

# the open recorder's list, None when no recorder is open
_tally: Optional[List[Tuple[str, int]]] = None


@contextlib.contextmanager
def record_collectives() -> Iterator[List[Tuple[str, int]]]:
    """A list that gathers (kind, result bytes) of every collective this
    process calls until the block ends, in call order. One recorder is open
    at a time."""
    global _tally
    if _tally is not None:
        raise RuntimeError("record_collectives: a recorder is already open")
    _tally = []
    try:
        yield _tally
    finally:
        _tally = None


def _note(kind: str, result: torch.Tensor) -> None:
    if _tally is not None:
        _tally.append((kind, result.numel() * result.element_size()))


def all_to_all(buf: torch.Tensor, group) -> torch.Tensor:
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    _note("all-to-all", out)
    return out


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.stack(parts)
    _note("all-gather", out)
    return out


def psum(t: torch.Tensor, group=None) -> torch.Tensor:
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    _note("all-reduce", out)
    return out


def ring_next(t: torch.Tensor, group) -> torch.Tensor:
    """Each rank's ``t`` moves to the next rank of ``group``: the result is
    the previous rank's."""
    n = dist.get_world_size(group)
    _note("collective-permute", t)
    if n == 1:
        return t
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    t = t.contiguous()
    out = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, nxt, group),
                                   dist.P2POp(dist.irecv, out, prv, group)])
    for r in reqs:
        r.wait()
    return out
