"""Dense CSR join index (the port of the dense path of
``dwarf_bench_tpu/ops/csr_join.py``).

The reference's OmniSci-style join table (common/dpcpp/omnisci_hashtable.hpp)
keeps per-key counts, exclusive-scan positions and the A row ids grouped by
key (``id_buffer``); a probe returns a (position, count) view per query
(omnisci_hashtable.hpp:80-192). For narrow key ranges (span < 2^14 after a
min-shift, the benchmark's uniform [1, 10000] columns) pos and counts are
dense by key: the build is the histogram kernel plus one pair sort, and the
probe is a lookup into two tables of 2^14 entries.

Keys are uint32 in the JAX package and int32 bit patterns here; EMPTY
(0xFFFFFFFF, padding) is -1.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .primitives import as_u32, sort_by_key, wrap_i32
from .sort import histogram_dispatch

EMPTY = -1  # uint32 0xFFFFFFFF as an int32 bit pattern
_RANGE = 1 << 14


class DenseCsrTable(NamedTuple):
    """The JAX package's ``DenseCsrTable``, field for field.

    ``packed``/``packed3``/``base128`` and their ``*_ok`` flags are the TPU
    layouts its MXU lookups read; all three lookups return the same (pos,
    count), so the port's probe indexes ``pos`` and ``counts`` directly.
    They are filled in all the same, so that the two packages' tables can be
    compared field by field."""

    minv: torch.Tensor  # int32 scalar: min valid key (uint32 bit pattern)
    counts: torch.Tensor  # (16384,) int32 rows per key
    pos: torch.Tensor  # (16384,) int32 start offset per key
    id_buffer: torch.Tensor  # (n,) int32 A row ids grouped by key
    num_distinct: torch.Tensor  # int32 scalar
    packed: torch.Tensor  # (16384,) int32: (pos << 12) | min(cnt, 4095)
    packed_ok: torch.Tensor  # bool scalar: all counts < 2^12
    base128: torch.Tensor  # (128,) int32 bucket base positions
    packed3: torch.Tensor  # (16384,) int32: (rel << 10) | min(cnt, 1023)
    packed3_ok: torch.Tensor  # bool: all rel < 2^14 and all counts < 2^10


class CsrProbeResult(NamedTuple):
    found: torch.Tensor  # (nb,) bool
    pos: torch.Tensor  # (nb,) int32 start into id_buffer
    counts: torch.Tensor  # (nb,) int32 match count


def build_dense(a_keys: torch.Tensor) -> DenseCsrTable:
    """One-to-many CSR index: counts from the histogram kernel, pos their
    exclusive cumsum, and one pair sort for the id_buffer. PRECONDITION
    (checked on the host by ``dense_applicable``): valid keys span < 2^14
    as uint32. Rows with key EMPTY are padding and are left out.

    The sort is stable, so ids are ascending within a key. That is the
    order the JAX package's packed one-word sort gives for n < 2^18; above
    it, its pair sort is unstable and only the id sets per key agree."""
    n = a_keys.shape[0]
    device = a_keys.device
    ak = as_u32(a_keys)
    valid = a_keys != EMPTY
    minv = torch.min(torch.where(valid, ak, 0xFFFFFFFE))
    rel_key = ak - minv
    k = torch.where(valid, rel_key, -1).to(torch.int32)
    counts = histogram_dispatch(k)
    pos = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    # EMPTY rows take the key 0xFFFF, past every valid (< 2^14) key
    k16 = torch.where(valid, rel_key, 0xFFFF).to(torch.int32)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    _, sid = sort_by_key(k16, ids, stable=True)
    num_distinct = (counts > 0).sum(dtype=torch.int32)
    # pos of any non-empty key is <= n - cnt; keys with cnt == 0 may wrap
    # in the shift, and the probe masks them through found == False
    pos64 = pos.to(torch.int64)
    packed = wrap_i32((pos64 << 12) | counts.clamp(max=4095).to(torch.int64))
    packed_ok = (counts.max() < 4096) & (n <= (1 << 20))
    bucket_sums = counts.reshape(128, 128).sum(dim=1, dtype=torch.int32)
    base128 = torch.cumsum(bucket_sums, 0, dtype=torch.int32) - bucket_sums
    rel = pos - base128.repeat_interleave(128)
    packed3 = wrap_i32(
        (rel.to(torch.int64) << 10) | counts.clamp(max=1023).to(torch.int64)
    )
    packed3_ok = (
        (rel.max() < (1 << 14)) & (counts.max() < 1024) & (n <= (1 << 24))
    )
    return DenseCsrTable(
        wrap_i32(minv), counts, pos, sid, num_distinct, packed, packed_ok,
        base128, packed3, packed3_ok,
    )


def probe_dense(
    t: DenseCsrTable, b_keys: torch.Tensor, hi_rows: int = 128
) -> CsrProbeResult:
    """lookup() per B row against the dense index. ``hi_rows`` < 128 is the
    JAX package's range-aware precondition (both columns' valid keys span
    < hi_rows·128 after the min-shift); queries past it are not found."""
    q = as_u32(b_keys)
    k = (q - as_u32(t.minv)) & 0xFFFFFFFF
    in_range = (k < hi_rows * 128) & (b_keys != EMPTY)
    ki = torch.where(in_range, k, 0)
    pos = t.pos[ki]
    cnt = t.counts[ki]
    found = in_range & (cnt > 0)
    zero = torch.zeros_like(pos)
    return CsrProbeResult(
        found, torch.where(found, pos, zero), torch.where(found, cnt, zero)
    )


def table_from_numpy(fields: Sequence) -> DenseCsrTable:
    """A ``DenseCsrTable`` from the JAX package's table as numpy arrays, in
    field order (``table_from_numpy(jax_table)`` works, since a NamedTuple
    is a sequence), on the CPU. uint32 fields become int32 bit patterns."""
    if len(fields) != len(DenseCsrTable._fields):
        raise ValueError(
            f"table_from_numpy: {len(fields)} fields, expected "
            f"{len(DenseCsrTable._fields)}"
        )
    out = []
    for f in fields:
        a = np.array(f, copy=True)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a))
    return DenseCsrTable(*out)


def dense_hi_rows(a_keys, b_keys) -> int:
    """Host-side: the smallest hi-digit row count (multiple of 8, <= 128)
    covering both columns' valid key span — the ``probe_dense(hi_rows=)``
    precondition helper."""
    ks = np.concatenate(
        [np.asarray(a_keys, np.uint32), np.asarray(b_keys, np.uint32)]
    )
    ks = ks[ks != np.uint32(0xFFFFFFFF)]
    if ks.size == 0:
        return 8
    span = int(ks.max()) - int(ks.min()) + 1
    rows = -(-span // 128)
    return min(128, max(8, (rows + 7) // 8 * 8))


def dense_applicable(a_keys, b_keys) -> bool:
    """Host-side applicability check (the reference sizes its table from
    the same host knowledge, join_omnisci.cpp:55-58): both columns' valid
    keys must live in one < 2^14 uint32 window."""
    ks = np.concatenate(
        [np.asarray(a_keys, np.uint32), np.asarray(b_keys, np.uint32)]
    )
    ks = ks[ks != np.uint32(0xFFFFFFFF)]
    if ks.size == 0:
        return True
    return int(ks.max()) - int(ks.min()) < _RANGE


def oracle_id_sets(a_keys, b_keys):
    """Host oracle: for each B row, the set of A row ids with equal key
    (join_omnisci.cpp:15-45, without the O(n²) scan)."""
    a_keys = np.asarray(a_keys)
    by_key = {}
    for i, k in enumerate(a_keys):
        by_key.setdefault(int(k), set()).add(i)
    return [by_key.get(int(k), set()) for k in np.asarray(b_keys)]
