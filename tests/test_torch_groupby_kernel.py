"""Port parity: dwarf_bench_tpu_torch.ops.groupby_cuda against the JAX
Pallas groupby_small_pallas (interpret mode on the CPU). Sums are uint32 in
the JAX package and int32 bit patterns in the port; the tolerance is exact
equality of the bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwarf_bench_tpu.ops.groupby import groupby_oracle
from dwarf_bench_tpu.ops.groupby_pallas import groupby_small_pallas
from dwarf_bench_tpu_torch.ops import groupby_cuda


def _t(a):
    return torch.from_numpy(np.array(a).astype(np.int64).astype(np.int32))


def _bits(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("num_groups", [1, 20, 64, 1000, 4096])
def test_matches_pallas(rng, num_groups):
    n = 1 << 14
    k = rng.integers(0, num_groups + 7, n).astype(np.uint32)  # some OOR
    v = rng.integers(0, 1 << 14, n).astype(np.uint32)
    ref = np.asarray(groupby_small_pallas(
        jnp.asarray(k), jnp.asarray(v), num_groups, interpret=True))
    got = groupby_cuda.groupby_small(_t(k), _t(v), num_groups)
    assert got.dtype == torch.int32
    assert np.array_equal(_bits(got), ref)


# the degenerate inputs of tests/test_hist_pallas.py::test_groupby_small_swar_degenerate
@pytest.mark.parametrize("k,v,G", [
    (np.zeros(5000, np.uint32), np.full(5000, (1 << 14) - 1, np.uint32), 64),
    (np.array([0, 63, 64, 127], np.uint32),
     np.array([1, 2, 3, 4], np.uint32), 64),
    (np.array([7], np.uint32), np.array([0], np.uint32), 20),
    (np.array([0xFFFFFFFF, 0x80000000, 3], np.uint32),
     np.array([5, 6, 7], np.uint32), 4),
])
def test_degenerate(k, v, G):
    ref = np.asarray(groupby_small_pallas(
        jnp.asarray(k), jnp.asarray(v), G, interpret=True))
    got = groupby_cuda.groupby_small(_t(k), _t(v), G)
    assert np.array_equal(_bits(got), ref)


def test_sums_wrap_without_value_bound(rng):
    """v >= 2^14 is outside the TPU kernel's precondition (bf16 planes);
    the port's contract is the uint32 oracle's mod-2^32 sum."""
    n, G = 20_000, 64
    k = rng.integers(0, G, n).astype(np.uint32)
    v = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    got = groupby_cuda.groupby_small(_t(k), _t(v), G)
    assert np.array_equal(_bits(got), groupby_oracle(k, v, G))


@pytest.mark.parametrize("G", [0, 4097])
def test_rejects_group_count(G):
    with pytest.raises(ValueError):
        groupby_cuda.groupby_small(torch.zeros(3, dtype=torch.int32),
                                   torch.zeros(3, dtype=torch.int32), G)



# -- the launch plan (groupby_cuda.groupby_plan), which the card's launches
#    take as arguments: its choices checked without a card -----------------

GROUP_COUNTS = [1, 20, 64, 1000, 4096]
ROW_COUNTS = [0, 1, 3, 4096, 4097, 1_000_003, 1 << 22, (1 << 22) + 3]
H100_SMS = 132


@pytest.mark.parametrize("num_groups", GROUP_COUNTS)
def test_plan_shared_bytes_fit_the_card(num_groups):
    """A block's tables fit the 227 KB a block may opt in to, the blocks an
    SM holds fit its shared memory together, and up to G = 64 the tables
    fit the 48 KB a kernel gets without opting in."""
    for n in ROW_COUNTS:
        for design in groupby_cuda.DESIGNS:
            plan = groupby_cuda.groupby_plan(num_groups, n, H100_SMS,
                                             design=design)
            assert plan.smem == 4 * plan.tables * num_groups
            assert plan.smem <= groupby_cuda.SMEM_OPTIN
            per_sm = -(-plan.blocks // H100_SMS)
            assert per_sm * (plan.smem + groupby_cuda.SMEM_RESERVED
                             + groupby_cuda.SMEM_STATIC) \
                <= groupby_cuda.SMEM_SM
            if num_groups <= 64:
                assert plan.smem <= groupby_cuda.SMEM_DEFAULT


@pytest.mark.parametrize("num_groups", GROUP_COUNTS)
def test_plan_tables(num_groups):
    """At least one table, at most one a warp; the shared budget admits
    more than 3 tables at every G (the opt-in lifts the 48 KB cap, which
    held 3 at G = 4096)."""
    for n in ROW_COUNTS:
        plan = groupby_cuda.groupby_plan(num_groups, n, H100_SMS)
        assert 1 <= plan.tables <= groupby_cuda.GROUPBY_WARPS
        most = groupby_cuda.groupby_plan(num_groups, n, H100_SMS,
                                         tables=groupby_cuda.GROUPBY_WARPS)
        assert most.tables > 3
    if num_groups == 4096:
        assert groupby_cuda.SMEM_DEFAULT // (4 * num_groups) == 3
        assert most.smem > groupby_cuda.SMEM_DEFAULT


def test_plan_main_path_shapes():
    """The plans the sweep chose at 2^22 rows (PERF.md §6 #3): G = 64 two
    blocks an SM with one table a warp; G = 4096 (GroupByLocal's 64 x 64)
    one block an SM with one table; both 2 int4 a thread."""
    n = 1 << 22
    assert groupby_cuda.groupby_plan(64, n, H100_SMS) == \
        groupby_cuda.GroupbyPlan("vector", 264, 16, 2, 4096, 0)
    assert groupby_cuda.groupby_plan(4096, n, H100_SMS) == \
        groupby_cuda.GroupbyPlan("vector", 132, 1, 2, 16384, 0)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 1000, 4096])
@pytest.mark.parametrize("num_groups", [1, 64, 4096])
def test_plan_one_block_for_few_rows(n, num_groups):
    for design in groupby_cuda.DESIGNS:
        assert groupby_cuda.groupby_plan(num_groups, n, H100_SMS,
                                         design=design).blocks == 1


@pytest.mark.parametrize("num_groups", GROUP_COUNTS)
def test_plan_grid_covers_the_rows(num_groups):
    """At most two blocks an SM (one where G words a block would make more
    than one global reduction a REDUCTION_ROWS rows), and enough blocks for
    every row at the plan's loads a thread and trip."""
    for n in ROW_COUNTS:
        plan = groupby_cuda.groupby_plan(num_groups, n, H100_SMS)
        assert 1 <= plan.blocks <= 2 * H100_SMS
        if plan.blocks > H100_SMS:
            assert plan.blocks * num_groups * \
                groupby_cuda.REDUCTION_ROWS <= n
        rows_a_load = 4 * plan.depth if plan.design == "vector" \
            else plan.depth
        trips = -(-n // (plan.blocks * groupby_cuda.GROUPBY_THREADS
                         * rows_a_load))
        assert trips <= 1 or plan.blocks in (H100_SMS, 2 * H100_SMS)


@pytest.mark.parametrize("k_off", [0, 1, 2, 3])
@pytest.mark.parametrize("v_off", [0, 1, 2, 3])
def test_plan_alignment_peel_or_route(k_off, v_off):
    """Keys and values the same int32 count past 16 bytes: the vector loop
    starts at the first row on 16 bytes and the head rows before it are
    peeled; different counts: the scalar loop from row 0."""
    plan = groupby_cuda.groupby_plan(64, 1 << 20, H100_SMS, k_off, v_off)
    if k_off == v_off:
        assert plan.design == "vector"
        assert plan.head == (4 - k_off) % 4
        assert (k_off + plan.head) % 4 == 0
    else:
        assert plan.design == "scalar"
        assert plan.head == 0
        assert plan.depth == groupby_cuda.SCALAR_DEPTH


@pytest.mark.parametrize("design,depth", [("vector", 3), ("vector", 8),
                                          ("scalar", 2), ("ring", 4)])
def test_plan_refuses_a_loop_the_kernel_lacks(design, depth):
    with pytest.raises(ValueError):
        groupby_cuda.groupby_plan(64, 1 << 20, H100_SMS, design=design,
                                  depth=depth)


def test_wrapper_takes_the_plain_twin_only_on_the_cpu(monkeypatch):
    """On a CPU tensor the wrapper returns the twin and never reaches the
    plan or a launch."""
    def boom(*a, **k):
        raise AssertionError("a launch on the CPU")

    monkeypatch.setattr(groupby_cuda, "launch_groupby", boom)
    monkeypatch.setattr(groupby_cuda, "groupby_plan", boom)
    k = torch.tensor([0, 5, 64, -1, 5], dtype=torch.int32)
    v = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32)
    got = groupby_cuda.groupby_small(k, v, 64)
    assert got.tolist()[:6] == [1, 0, 0, 0, 0, 7]
