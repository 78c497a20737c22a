"""Group-by sum over a small dense key space: CUDA kernel
(``csrc/groupby.cu``) and its plain PyTorch twin.

The contract of ``dwarf_bench_tpu/ops/groupby_pallas.py``
``groupby_small_pallas``: (G,) sums of v per key in [0, G), G <= 4096, keys
outside [0, G) as uint32 dropped, sums wrapping mod 2^32. The sums are
uint32 in the JAX package and int32 bit patterns here. The TPU kernel's
v < 2^14 precondition (bf16 value planes) does not apply on the card.

``groupby_small_swar_pallas`` and ``groupby_small_pallas_f32``
(``groupby_pallas.py:159, 59``) are the same contract for up to 2^14 groups:
G <= 4096 runs the ``groupby_small`` kernel, larger G the
``weighted_histogram`` kernel (``csrc/hist.cu``).

``groupby_plan`` computes the kernel's launch plan (loop, blocks, tables,
loads a thread, shared bytes, head rows) from the group count, the rows,
the card's SMs and the columns' offsets from 16 bytes; ``launch_groupby``
runs any plan. A wrapper takes the twin only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from .hist_cuda import weighted_histogram
from .primitives import as_u32, wrap_i32

MAX_GROUPS = 4096


def _check_groups(num_groups: int) -> None:
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(
            f"groupby_small: num_groups must be in [1, {MAX_GROUPS}], "
            f"got {num_groups}"
        )


# The kernel's launch plan (csrc/groupby.cu), chosen by the plan sweep of
# ``utils/kernel_times.py --sweep groupby`` on an H100 (PERF.md §6 #3):
# blocks of GROUPBY_THREADS threads, each warp adding into one of the
# block's tables of G sums in shared memory. A block's shared memory:
# SMEM_OPTIN at most (the H100's 227 KB, dynamic above SMEM_DEFAULT after
# cudaFuncSetAttribute), and an SM's SMEM_SM shared by its blocks, less
# SMEM_RESERVED a block for the runtime and SMEM_STATIC for the kernel's
# own variables.
DESIGNS = ("scalar", "vector")
GROUPBY_THREADS = 512
GROUPBY_WARPS = GROUPBY_THREADS // 32
SMEM_OPTIN = 232448
SMEM_DEFAULT = 48 * 1024
SMEM_SM = 233472
SMEM_RESERVED = 1024
SMEM_STATIC = 256
# scratch words: a ticket and padding, then an accumulator of G words
SCRATCH_WORDS = 32 + MAX_GROUPS
# int4 of keys and of values a thread holds before it adds (vector), rows
# (scalar); the kernel builds the vector loop at VECTOR_DEPTHS
VECTOR_DEPTH = 2
VECTOR_DEPTHS = (1, 2, 4)
SCALAR_DEPTH = 8
# Two blocks an SM, or one where two would make more global reductions
# (G a block) than n / REDUCTION_ROWS; and as many tables as keep a block's
# table words (zeroed, then folded) within its rows / TABLE_ROWS, at least
# one, at most one a warp. At 2^22 rows G = 64 takes 264 blocks of 16
# tables, G = 4096 132 blocks of one (7 tables a block were 9 % slower
# cold).
REDUCTION_ROWS = 8
TABLE_ROWS = 8


class GroupbyPlan(NamedTuple):
    """A launch of ``dbt_groupby_small``: the loop (``DESIGNS``), the grid,
    the tables a block, the loads a thread holds before it adds (int4 for
    the vector loop, rows for the scalar), the dynamic shared bytes a block,
    and the rows before the first key and value on 16 bytes (taken with
    scalar loads)."""
    design: str
    blocks: int
    tables: int
    depth: int
    smem: int
    head: int


def shared_budget(blocks_per_sm: int) -> int:
    """Dynamic shared bytes a block can take with ``blocks_per_sm`` blocks
    resident on an SM."""
    return min(SMEM_OPTIN, SMEM_SM // blocks_per_sm - SMEM_RESERVED) \
        - SMEM_STATIC


def groupby_plan(num_groups: int, n: int, sms: int, k_offset: int = 0,
                 v_offset: int = 0, design: str = "vector",
                 blocks_per_sm: Optional[int] = None,
                 depth: Optional[int] = None,
                 tables: Optional[int] = None) -> GroupbyPlan:
    """The plan of a group-by of ``n`` rows into ``num_groups`` sums on a
    card of ``sms`` SMs, with keys and values ``k_offset`` and ``v_offset``
    int32 past a 16-byte boundary. The vector loop starts at the first row
    on 16 bytes; keys and values that differ mod 16 bytes take the scalar
    loop. Unset choices take the wrapper's (see REDUCTION_ROWS); ``tables``
    is capped by the shared budget. The grid covers the rows with ``depth``
    loads a thread, at least one block, at most ``blocks_per_sm`` an SM."""
    _check_groups(num_groups)
    if design not in DESIGNS:
        raise ValueError(f"groupby_plan: design {design!r} not in {DESIGNS}")
    if k_offset % 4 != v_offset % 4:
        design = "scalar"
    head = 0 if design == "scalar" else (4 - k_offset % 4) % 4
    if depth is None:
        depth = SCALAR_DEPTH if design == "scalar" else VECTOR_DEPTH
    if depth not in ((SCALAR_DEPTH,) if design == "scalar" else VECTOR_DEPTHS):
        raise ValueError(f"groupby_plan: no {design} loop of depth {depth}")
    if blocks_per_sm is None:
        few = 2 * sms * num_groups * REDUCTION_ROWS > n
        blocks_per_sm = 1 if few else 2
    rows_a_load = 4 * depth if design == "vector" else depth
    work = -(-max(n - head, 0) // (GROUPBY_THREADS * rows_a_load))
    blocks = max(1, min(work, blocks_per_sm * sms))
    most = min(GROUPBY_WARPS,
               shared_budget(blocks_per_sm) // (4 * num_groups))
    if tables is None:
        tables = -(-n // blocks) // (TABLE_ROWS * num_groups)
    tables = max(1, min(int(tables), most))
    return GroupbyPlan(design, blocks, tables, depth,
                       4 * tables * num_groups, head)


@functools.lru_cache(maxsize=64)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _offset(t: torch.Tensor) -> int:
    """int32 elements past the last 16-byte boundary."""
    return (t.data_ptr() // 4) % 4


def _sums_plain(k: torch.Tensor, v: torch.Tensor,
                num_groups: int) -> torch.Tensor:
    ku = as_u32(k)
    keep = ku < num_groups
    out = torch.zeros(num_groups, dtype=torch.int64, device=k.device)
    out.index_add_(0, ku[keep], v[keep].to(torch.int64))
    return wrap_i32(out)


def groupby_small_plain(
    k: torch.Tensor, v: torch.Tensor, num_groups: int
) -> torch.Tensor:
    _check_groups(num_groups)
    return _sums_plain(k, v, num_groups)


def groupby_small(
    k: torch.Tensor, v: torch.Tensor, num_groups: int
) -> torch.Tensor:
    _check_groups(num_groups)
    device = _build.check_vectors("groupby_small", k, v)
    if k.numel() != v.numel():
        raise ValueError(
            f"groupby_small: {k.numel()} keys but {v.numel()} values"
        )
    if device.type == "cpu":
        return groupby_small_plain(k, v, num_groups)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    plan = _wrapper_plan(num_groups, k.numel(), _sms(index), _offset(k),
                         _offset(v))
    return launch_groupby(k, v, num_groups, plan)


@functools.lru_cache(maxsize=1024)
def _wrapper_plan(num_groups: int, n: int, sms: int, k_offset: int,
                  v_offset: int) -> GroupbyPlan:
    """``groupby_plan`` once a shape: a call's host time goes to the
    launch."""
    return groupby_plan(num_groups, n, sms, k_offset, v_offset)


def launch_groupby(k: torch.Tensor, v: torch.Tensor, num_groups: int,
                   plan: GroupbyPlan) -> torch.Tensor:
    """The group-by kernel on checked CUDA vectors under an explicit plan
    (``groupby_plan`` gives the wrapper's)."""
    out = torch.empty(num_groups, dtype=torch.int32, device=k.device)
    # a ticket and an accumulator, zero on entry and left zero
    scratch = _build.stream_scratch("groupby_small", k.device, SCRATCH_WORDS)
    _build.launch("dbt_groupby_small", k.device, k.data_ptr(), v.data_ptr(),
                  k.numel(), out.data_ptr(), num_groups,
                  DESIGNS.index(plan.design), plan.blocks, plan.tables,
                  plan.depth, plan.smem, plan.head,
                  scratch.data_ptr(), scratch.numel())
    _build.LAUNCHES["groupby_small"] += 1
    return out


# -- the JAX package's balanced-digit variants (groupby_pallas.py:59, 159) --

MAX_DIGIT_GROUPS = 1 << 14


def _digit_split(num_groups: int):
    """(ga, gb) of ``dwarf_bench_tpu/ops/groupby_pallas.py:42``
    ``_digit_split``: gb a power of two in [8, 128], ga a multiple of 8,
    ga * gb >= num_groups, ga + gb least. The kernels here do not use the
    digits; the split only decides which group counts the JAX kernels
    accept."""
    best = None
    gb = 8
    while gb <= 128:
        ga = max(8, -(-num_groups // gb))
        ga = (ga + 7) // 8 * 8
        if ga <= 1024 and (best is None or ga + gb < best[0] + best[1]):
            best = (ga, gb)
        gb *= 2
    return best


def _check_digit_groups(op: str, num_groups: int, swar: bool) -> int:
    num_groups = int(num_groups)
    if not 1 <= num_groups <= MAX_DIGIT_GROUPS:
        raise ValueError(f"{op}: num_groups must be in [1, "
                         f"{MAX_DIGIT_GROUPS}], got {num_groups}")
    # the SWAR kernel routes bad keys to hi byte 127: ga <= 120
    # (groupby_pallas.py:202)
    if swar and _digit_split(num_groups)[0] > 120:
        raise ValueError(f"{op}: num_groups {num_groups} needs a hi digit "
                         "above 120")
    return num_groups


def groupby_digits_plain(k: torch.Tensor, v: torch.Tensor,
                         num_groups: int) -> torch.Tensor:
    """Plain version of the two variants: (G,) int32 bit patterns of the
    uint32 sums of v per key in [0, G), G <= 2^14, other keys dropped."""
    _check_digit_groups("groupby_digits", num_groups, False)
    return _sums_plain(k, v, num_groups)


def _digits(op: str, k, v, num_groups: int, swar: bool) -> torch.Tensor:
    num_groups = _check_digit_groups(op, num_groups, swar)
    device = _build.check_vectors(op, k, v)
    if k.numel() != v.numel():
        raise ValueError(f"{op}: {k.numel()} keys but {v.numel()} values")
    if device.type == "cpu":
        return _sums_plain(k, v, num_groups)
    if num_groups <= MAX_GROUPS:
        out = groupby_small(k, v, num_groups)
    else:
        # keys in [G, hi_bins * 128) land past G and are dropped with the
        # tail, as the contract drops keys out of range
        out = weighted_histogram(k, v, -(-num_groups // 128))[:num_groups]
    _build.LAUNCHES[op] += 1
    return out


def groupby_small_swar_pallas(k: torch.Tensor, v: torch.Tensor,
                              num_groups: int) -> torch.Tensor:
    """``groupby_pallas.py:159``: ``groupby_small``'s contract for the group
    counts the SWAR kernel takes (G <= 2^14 with a hi digit <= 120).
    G <= 4096 runs the ``groupby_small`` kernel, larger G the
    ``weighted_histogram`` kernel over ceil(G / 128) * 128 bins."""
    return _digits("groupby_small_swar_pallas", k, v, num_groups, True)


def groupby_small_pallas_f32(k: torch.Tensor, v: torch.Tensor,
                             num_groups: int) -> torch.Tensor:
    """``groupby_pallas.py:59``: as ``groupby_small_swar_pallas`` for
    G <= 2^14."""
    return _digits("groupby_small_pallas_f32", k, v, num_groups, False)
