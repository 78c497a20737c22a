"""Hash-partition shuffle: the distributed exchange of join and group-by
keys (the port of ``dwarf_bench_tpu/parallel/shuffle.py``).

The exchange is the fixed-capacity + count pattern: each rank sorts its
rows stably by destination chip (``murmur3(key) % n_chips``), places each
destination's rows, in their local order, into a ``capacity`` slot of a
(n_chips, capacity) send buffer, and one ``all_to_all`` swaps slots. Keys
and payload columns (int32 bit patterns of the JAX package's uint32
columns) and the per-slot counts travel in one buffer, one collective an
exchange. Receivers get (n_chips, capacity) columns and per-source counts;
padding keys are EMPTY, padding payloads 0. Rows past a slot's capacity are
dropped and counted in the returned overflow, so correctness is checkable.

``partition_for_shuffle_2d`` is the two-hop exchange of a (dcn, ici) mesh:
first over the chips of a host to the chip whose ici index matches the
destination's, then between hosts; every row crosses hosts once.
"""

from __future__ import annotations

import torch

from ..ops.hashing import murmur3_32_u32
from ..ops.hashtable import EMPTY
from .collectives import all_to_all

SHUFFLE_SEED = 0x9747B28C


def _bucket_exchange(keys, payloads, dest, n_buckets, capacity, group):
    """Compact local rows into fixed-capacity per-destination slots and
    swap slot j of rank i with slot i of rank j over ``group``.

    ``dest`` values outside [0, n_buckets) mark dropped rows (padding,
    caller-excluded keys): they enter no slot and count toward no overflow.

    Returns (recv_keys (n_buckets, capacity), recv_payloads tuple of the
    same shape, recv_counts (n_buckets,), send_overflow 0-d), int32."""
    n = keys.shape[0]
    device = keys.device
    cols = torch.stack([c.to(torch.int32) for c in (keys, *payloads)])
    ncols = cols.shape[0]
    # stable by destination: a slot holds its rows in their local order
    sd, order = torch.sort(dest.to(torch.int32), stable=True)
    cols = cols[:, order]
    # dropped rows sort after every bucket
    bounds = torch.searchsorted(
        sd, torch.arange(n_buckets + 1, dtype=torch.int32, device=device))
    starts = bounds[:-1]
    counts = (bounds[1:] - starts).to(torch.int32)
    dropped = sd >= n_buckets
    sd_safe = torch.where(dropped, 0, sd).to(torch.int64)
    rank = torch.arange(n, device=device) - starts[sd_safe]
    spare = n_buckets * capacity
    flat = torch.where((rank < capacity) & ~dropped,
                       sd_safe * capacity + rank, spare)
    body = torch.zeros((ncols, spare + 1), dtype=torch.int32, device=device)
    body[0] = EMPTY
    body[:, flat] = cols
    send_counts = torch.clamp(counts, max=capacity)
    overflow = (counts - send_counts).sum(dtype=torch.int32)
    send = torch.cat(
        [send_counts.view(n_buckets, 1),
         body[:, :spare].view(ncols, n_buckets, capacity).transpose(0, 1)
         .reshape(n_buckets, ncols * capacity)], dim=1)
    recv = all_to_all(send, group)
    rbody = recv[:, 1:].view(n_buckets, ncols, capacity)
    rcols = tuple(rbody[:, c].contiguous() for c in range(ncols))
    return rcols[0], rcols[1:], recv[:, 0].contiguous(), overflow


def shuffle_dest(keys, n_chips):
    """Destination chip of each key: murmur3(key) % n_chips, int32."""
    return (murmur3_32_u32(keys, SHUFFLE_SEED) % int(n_chips)).to(torch.int32)


def partition_for_shuffle(keys, payloads, n_chips: int, capacity: int, group,
                          drop=None):
    """On each rank of ``group`` (a mesh dimension's process group): bucket
    the local rows by destination chip and exchange.

    ``payloads``: a tuple of int32 columns riding with the keys (values,
    global row ids, ...); a single bare tensor is taken as a 1-tuple.
    ``drop`` (bool) marks rows that enter no slot (the skew-aware join
    keeps heavy keys out of the hash shuffle this way).

    Returns ``(recv_keys, recv_payloads, recv_counts, send_overflow)``:
    (n_chips, capacity) columns, slot i holding the rows rank i sent, and
    recv_counts[i] its valid rows. ``recv_payloads`` is a tuple matching
    ``payloads``, or a bare tensor when one was passed."""
    bare = not isinstance(payloads, (tuple, list))
    cols = (payloads,) if bare else tuple(payloads)
    dest = shuffle_dest(keys, n_chips)
    if drop is not None:
        dest = torch.where(drop, n_chips, dest)
    rk, rcols, rcnt, ov = _bucket_exchange(keys, cols, dest, n_chips,
                                           capacity, group)
    return rk, (rcols[0] if bare else rcols), rcnt, ov


def partition_for_shuffle_2d(keys, payloads, n_dcn: int, n_ici: int,
                             cap_ici: int, cap_dcn: int, dcn_group,
                             ici_group, drop=None):
    """Two-hop exchange on a (dcn, ici) mesh. The destination chip of key k
    is ``d* x n_ici + i*`` with ``dest = hash(k) % (n_dcn * n_ici)``. Hop 1
    buckets by ``i*`` over ``ici_group``; hop 2 derives ``d*`` from the
    received keys again, buckets by it, and exchanges over ``dcn_group``
    between chips of the same ici index.

    Returns ``(recv_keys (n_dcn, cap_dcn), recv_payloads, recv_counts,
    overflow)``, the overflow summed over both hops."""
    bare = not isinstance(payloads, (tuple, list))
    cols = (payloads,) if bare else tuple(payloads)
    n_total = n_dcn * n_ici
    i_star = shuffle_dest(keys, n_total) % n_ici
    if drop is not None:
        i_star = torch.where(drop, n_ici, i_star)
    rk1, rcols1, _, ov1 = _bucket_exchange(keys, cols, i_star, n_ici,
                                           cap_ici, ici_group)
    k1 = rk1.reshape(-1)
    cols1 = tuple(c.reshape(-1) for c in rcols1)
    # hop-1 padding (EMPTY keys) routes past the last host
    d_star = torch.where(k1 == EMPTY, n_dcn,
                         shuffle_dest(k1, n_total) // n_ici)
    rk2, rcols2, rcnt2, ov2 = _bucket_exchange(k1, cols1, d_star, n_dcn,
                                               cap_dcn, dcn_group)
    return rk2, (rcols2[0] if bare else rcols2), rcnt2, ov1 + ov2
