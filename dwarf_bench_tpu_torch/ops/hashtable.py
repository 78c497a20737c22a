"""Open-addressing hash tables without atomics
(``dwarf_bench_tpu/ops/hashtable.py``; reference common/dpcpp/hashtable.hpp).

**Parking construction.** Keys sorted by home bucket ``h`` take, under
first-come-first-served linear probing, slot ``s_i = max(h_i, s_{i-1}+1)``,
whose closed form is ``s_i = i + cummax(h_i - i)``: one sort and one scan
replace the reference's CAS loop. Wraparound runs the scan over two
concatenated copies (the second shifted by ``size``) and keeps the second.
The occupied-slot set of FCFS linear probing does not depend on insertion
order, so ``probe`` finds every inserted key and rejects absent keys at the
first empty slot, as hashtable.hpp:23-58 does.

**Probe.** A vectorized chain walk: every query gathers its current slot,
compares and advances, until each found its key or hit EMPTY, or
``max_steps`` steps ran. The JAX package's ``lax.while_loop`` becomes a
Python loop over device tensors.

Keys are int32 bit patterns of the reference's uint32 keys; EMPTY
(0xFFFFFFFF) is -1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .primitives import sort_by_key

EMPTY = -1  # 0xFFFFFFFF, reference EMPTY_ELEMENT (hashtable.hpp:96)
_NEG_INF = -(2**30)
_M32 = 0xFFFFFFFF
_WINDOW_SLOTS = 1 << 24  # slots the probe examines per host iteration


class HashTable(NamedTuple):
    """Open-addressing table: slot-indexed columns. ``keys[i] == EMPTY``
    marks a free slot; ``payload`` columns are aligned with ``keys``."""

    keys: torch.Tensor  # (size,) int32
    payload: Tuple[torch.Tensor, ...]  # each (size,) aligned with keys
    max_probe: torch.Tensor  # 0-d int32: longest probe chain + 1

    @property
    def size(self) -> int:
        return self.keys.shape[0]


def parking_positions(h_sorted: torch.Tensor, size: int) -> torch.Tensor:
    """Circular FCFS linear-probe slots (int64) for keys already sorted by
    home bucket ``h_sorted`` (invalid entries carry h == size, sort last and
    get slot ``size``). The recurrence runs over the rank among valid rows
    only: padding rows must not advance the cascade."""
    n = h_sorted.shape[0]
    h = h_sorted.to(torch.int64)
    valid = h < size
    v = valid.to(torch.int64)
    rank = torch.cumsum(v, 0) - v  # exclusive rank among valid rows
    nvalid = v.sum()
    d1 = torch.where(valid, h - rank, _NEG_INF)
    d2 = torch.where(valid, h + size - (rank + nvalid), _NEG_INF)
    m = torch.cummax(torch.cat([d1, d2]), 0).values
    s2 = (rank + nvalid) + m[n:]
    slots = torch.remainder(s2 - size, size)
    return torch.where(valid, slots, size)


def _scatter(size: int, slots: torch.Tensor, col: torch.Tensor, fill: int):
    """``full(size, fill).at[slots].set(col, mode="drop")``: slot ``size``
    is one spare slot past the end that takes the dropped rows."""
    buf = torch.full((size + 1,), fill, dtype=col.dtype, device=col.device)
    buf[slots] = col
    return buf[:size]


def build(
    keys: torch.Tensor,
    home: torch.Tensor,
    size: int,
    payload: Tuple[torch.Tensor, ...] = (),
    valid: Optional[torch.Tensor] = None,
) -> HashTable:
    """Build an open-addressing table of ``size`` slots from int32 ``keys``
    with home buckets ``home`` (already reduced mod size). ``valid`` masks
    out padding rows. Duplicate keys take a slot each, as the bitmask
    table's inserts do (hashtable.hpp:70-92)."""
    h = home.to(torch.int64)
    if valid is not None:
        h = torch.where(valid, h, size)
    cols = sort_by_key(h, keys, *payload)
    h_sorted, keys_sorted, payload_sorted = cols[0], cols[1], cols[2:]
    slots = parking_positions(h_sorted, size)
    table_keys = _scatter(size, slots, keys_sorted, EMPTY)
    table_payload = tuple(_scatter(size, slots, c, 0) for c in payload_sorted)
    displacement = torch.where(
        h_sorted < size, torch.remainder(slots - h_sorted, size), 0)
    max_probe = (displacement.max() if displacement.numel() else
                 torch.zeros((), dtype=torch.int64, device=keys.device)) + 1
    return HashTable(table_keys, table_payload, max_probe.to(torch.int32))


def _probe_loop(table_keys, queries, home, max_steps: int):
    """Shared vectorized chain walk. Returns (found, slot) with slot int64
    and -1 for misses: a lane stops at the first slot of its chain, within
    ``max_steps`` slots of its home, that holds its key (found) or EMPTY.

    The JAX package runs one step for every lane per ``while_loop``
    iteration. Here each host iteration examines a window of the next
    ``k`` slots of every active lane at once and drops the lanes that
    stopped, with ``k`` growing as lanes finish (one read back per
    iteration), and lanes with equal (query, home) walk once: HashBuild's
    keys repeat about 1677 times at 2^24 rows and their chains run to
    about 9000 slots. Each lane's answer is the JAX walk's."""
    size = table_keys.shape[0]
    dev = queries.device
    pair = (home.to(torch.int64) << 32) | (queries.to(torch.int64) & _M32)
    uniq, inverse = torch.unique(pair, return_inverse=True)
    q = (uniq & _M32).to(torch.int32)  # wraps back to the bit pattern
    pos0 = uniq >> 32
    found = torch.zeros(uniq.shape[0], dtype=torch.bool, device=dev)
    slot = torch.full((uniq.shape[0],), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(uniq.shape[0], device=dev)
    step = 0
    while step < max_steps and lanes.numel() > 0:
        k = min(max_steps - step, max(1, _WINDOW_SLOTS // lanes.numel()))
        offs = torch.arange(step, step + k, device=dev)
        pos = torch.remainder(pos0[lanes, None] + offs, size)  # (lanes, k)
        cur = table_keys[pos]
        hit = cur == q[lanes, None]
        stop = hit | (cur == EMPTY)
        stopped = stop.any(dim=1)
        first = torch.argmax(stop.to(torch.uint8), dim=1, keepdim=True)
        first_hit = hit.gather(1, first).squeeze(1) & stopped
        done = lanes[first_hit]
        found[done] = True
        slot[done] = pos.gather(1, first).squeeze(1)[first_hit]
        lanes = lanes[~stopped]
        step += k
    return found[inverse], slot[inverse]


def probe(table: HashTable, queries: torch.Tensor, home: torch.Tensor,
          max_steps=None):
    """``has``-style probe (reference: hashtable.hpp:23-58): walk the chain
    from the home bucket; stop on key match or EMPTY. Returns
    ``(found, slot)`` with slot == -1 for misses. ``max_steps`` defaults to
    the table's ``max_probe`` (read back to the host once)."""
    if max_steps is None:
        max_steps = table.max_probe
    return _probe_loop(table.keys, queries, home, int(max_steps))


def lookup(table: HashTable, queries: torch.Tensor, home: torch.Tensor,
           payload_index: int = 0, default: int = 0, max_steps=None):
    """Probe and gather one payload column: ``(found, value)`` (reference
    ``at``: hashtable.hpp:44-58)."""
    found, slot = probe(table, queries, home, max_steps)
    col = table.payload[payload_index]
    val = torch.where(found, col[torch.where(found, slot, 0)], default)
    return found, val
