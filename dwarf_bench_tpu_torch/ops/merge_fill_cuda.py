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
kernel, one launch a call, or raises. ``_lookback_fill`` renders the
kernel's schedule (tiles, the in-tile scan, the look-back over the tiles'
status words) in plain PyTorch for the tests.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Optional

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


_AGGREGATE, _PREFIX = 1, 2  # status flags of csrc/merge_fill.cu


def _combine(a: torch.Tensor, b: torch.Tensor, half: int) -> torch.Tensor:
    """One half of the pair: 0 the uint32 sum, 1 the unsigned max."""
    return (a + b) & _M32 if half == 0 else torch.maximum(a, b)


def _inclusive(x: torch.Tensor, dim: int, half: int) -> torch.Tensor:
    return torch.cumsum(x, dim) & _M32 if half == 0 \
        else torch.cummax(x, dim).values


def _below(inc: torch.Tensor, dim: int) -> torch.Tensor:
    """Exclusive values from inclusive ones: each slot takes the inclusive
    value of the slot below and slot 0 the identity (the max has no
    inverse)."""
    first = torch.zeros_like(inc.narrow(dim, 0, 1))
    return torch.cat([first, inc.narrow(dim, 0, inc.shape[dim] - 1)], dim)


def _in_tile(half_rows: torch.Tensor, half: int):
    """The kernel's in-tile scan of one half over rows shaped (tiles, warps,
    vecs, lanes, 4): within each lane's vector, across lanes, down the
    chain of a warp's vectors, across warps. Returns (each row's inclusive
    value within its tile, each tile's aggregate)."""
    own = _inclusive(half_rows, 4, half)
    lane_inc = _inclusive(own[..., -1], 3, half)
    vec_inc = _inclusive(lane_inc[..., -1], 2, half)
    excl = _combine(_below(vec_inc, 2)[..., None], _below(lane_inc, 3), half)
    warp_inc = _inclusive(vec_inc[..., -1], 1, half)
    before = _combine(_below(warp_inc, 1)[:, :, None, None], excl, half)
    return _combine(before[..., None], own, half), warp_inc[:, -1]


def _status_words(state: str, agg, inc):
    """The (sum, max) status words of a tile as a reader sees them:
    unpublished, its aggregate, its inclusive prefix, or torn (the sum word
    of its prefix beside the max word of its aggregate)."""
    def word(flag, value):
        return flag << 32 | value

    if state == "none":
        return 0, 0
    if state == "torn":
        return word(_PREFIX, inc[0]), word(_AGGREGATE, agg[1])
    flag, pair = (_AGGREGATE, agg) if state == "aggregate" else (_PREFIX, inc)
    return word(flag, pair[0]), word(flag, pair[1])


def _look_back(tile, agg, inc, window, seen, reads):
    """The exclusive prefix of ``tile`` (> 0) as warp 0 of the kernel reads
    it: ``window`` lanes, lane l at tile last - l; the window is read again
    while a lane sees no flag or two different flags, and moves back while
    no lane sees a prefix."""
    before = [0, 0]
    last = tile - 1
    while True:
        attempt = 0
        while True:
            words = []
            for lane in range(window):
                pred = last - lane
                if pred < 0:  # before tile 0: the identity, as a prefix
                    words.append((_PREFIX << 32, _PREFIX << 32))
                    continue
                state = seen(tile, pred, attempt)
                reads[state] += 1
                words.append(_status_words(state, agg[pred], inc[pred]))
            if all(s >> 32 and s >> 32 == m >> 32 for s, m in words):
                break
            attempt += 1
        flags = [s >> 32 for s, _ in words]
        stop = flags.index(_PREFIX) if _PREFIX in flags else window - 1
        for s, m in words[: stop + 1]:
            before = [(before[0] + (s & _M32)) & _M32,
                      max(before[1], m & _M32)]
        if _PREFIX in flags:
            return before
        last -= window


def _lookback_fill(sk: torch.Tensor, sa: torch.Tensor,
                   dv: Optional[torch.Tensor], nq: int, val16: bool = False,
                   membership: bool = False, *, warps: int = 16,
                   vecs: int = 4, lanes: int = 32, window: int = 32,
                   seen: Optional[Callable[[int, int, int], str]] = None):
    """``merge_fill`` by the schedule of ``csrc/merge_fill.cu``, for the
    tests: tiles of warps x vecs x lanes x 4 rows (the kernel's 16 x 4 x 32
    x 4), taken in order; each tile's in-tile scan of the (sum, max) pair
    and aggregate; the look-back of ``window`` lanes (32 in the kernel)
    over the predecessors' status words. ``seen(tile, pred, attempt)`` says
    in which state ("none", "aggregate", "prefix", "torn") the look-back
    of ``tile`` finds ``pred`` at its attempt-th read of the window (default:
    every predecessor a prefix); it must end in "aggregate" or "prefix".
    Returns ``(dest, val, reads)``, ``reads`` counting the states read."""
    _, mode = _check(sk, sa, dv, nq, val16, membership)
    seen = seen or (lambda tile, pred, attempt: "prefix")
    n = sk.numel()
    tile_rows = warps * vecs * lanes * 4
    ntiles = -(-n // tile_rows)
    is_src = sa >= 0
    delta = torch.zeros_like(sk) if mode == 2 else \
        (sa & 0xFFFF) if mode == 1 else dv
    halves = [torch.where(is_src, delta.to(torch.int64) & _M32, 0),
              torch.where(is_src, (sk.to(torch.int64) + 1) & _M32, 0)]
    rows, aggs = [], []
    for h, x in enumerate(halves):  # padded with the identity
        x = torch.cat([x, x.new_zeros(ntiles * tile_rows - n)])
        r, a = _in_tile(x.view(ntiles, warps, vecs, lanes, 4), h)
        rows.append(r.reshape(ntiles, tile_rows))
        aggs.append(a.tolist())
    agg = list(zip(*aggs))
    inc, before = [], []
    reads = collections.Counter()
    for t in range(ntiles):  # tickets in order
        b = _look_back(t, agg, inc, window, seen, reads) if t else [0, 0]
        before.append(b)
        inc.append(((b[0] + agg[t][0]) & _M32, max(b[1], agg[t][1])))
    b = torch.tensor(before, dtype=torch.int64).reshape(ntiles, 2)
    fill, carry = (_combine(b[:, h, None], rows[h], h).reshape(-1)[:n]
                   for h in range(2))
    kp1 = (sk.to(torch.int64) + 1) & _M32
    found = ~is_src & (carry == kp1) & (sk != -1)
    val = torch.where(found, wrap_i32(fill & (0xFFFF if mode == 1 else _M32)),
                      0)
    qp = (sa & 0x7FFFFFFF).to(torch.int64)
    is_real = ~is_src & (qp < int(nq))
    dest = torch.where(is_real, (qp << 1) | found.to(torch.int64), -1)
    return dest.to(torch.int32), val, reads


@functools.lru_cache(maxsize=256)
def _scratch_words(n: int) -> int:
    return max(int(_build.library().dbt_merge_fill_scratch(n)), 1)


def merge_fill(sk: torch.Tensor, sa: torch.Tensor, dv: Optional[torch.Tensor],
               nq: int, val16: bool = False, membership: bool = False):
    device, mode = _check(sk, sa, dv, nq, val16, membership)
    if device.type == "cpu":
        return merge_fill_plain(sk, sa, dv, nq, val16, membership)
    n = sk.numel()
    dest = torch.empty(n, dtype=torch.int32, device=device)
    val = torch.empty(n, dtype=torch.int32, device=device)
    # a tile counter, a finished-block counter and the status words: zero
    # when made, left zero by the kernel
    scratch = _build.stream_scratch("merge_fill", device, _scratch_words(n))
    _build.launch("dbt_merge_fill", device, sk.data_ptr(), sa.data_ptr(),
                  dv.data_ptr() if mode == 0 else None, n, int(nq), mode,
                  dest.data_ptr(), val.data_ptr(), scratch.data_ptr())
    _build.LAUNCHES["merge_fill"] += 1
    return dest, val
