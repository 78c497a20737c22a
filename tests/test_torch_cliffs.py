"""The dispatch cliffs and the engine fuzz on the CPU: every case of
``dwarf_bench_tpu_torch/utils/cliffs.py`` (the port's counterparts of
``tests/test_cliffs_slow.py`` and ``tests/test_engine_fuzz.py``, on their
data) through the port's engine, held to its host oracle and to the JAX
function on the same numpy input: the outputs up to their count, the
join table's flags and tables, and the branch taken against the one the
JAX dispatch takes (``sparse_caps_ok``, the span in uint32).

The JAX functions run as their own tests run them on the CPU:
``filter_sparse`` and the dense join as called there, ``sort_auto`` with
``force_dispatch=True`` where the JAX test exercises the dispatch (the
cliffs, the fuzz's dispatch trials and the span wrap) and plainly in the
fuzz's range trials, and ``groupby_sum`` with the case's
``vals_below_2p14`` (its uint32 sums compared as int32 bit patterns). The
sort's cliffs run at 2^20 rows, and the hot-key and 2000-count joins and
the group-by's boundaries at 2^16 (the JAX functions take seconds a call
at the JAX file's sizes on the CPU; each case's branch, which
``cliffs.run`` checks, is the same there); the two-gather join at 2^21 is
held to the host oracle only.
The card runs every case at its own size (``tests/test_torch_cliffs_gpu.py``).
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from dwarf_bench_tpu.ops import csr_join as jax_join
from dwarf_bench_tpu.ops import groupby as jax_groupby
from dwarf_bench_tpu.ops import scan as jax_scan
from dwarf_bench_tpu.ops import sort as jax_sort
from dwarf_bench_tpu_torch.ops import scan, trace
from dwarf_bench_tpu_torch.utils import cliffs

CPU = torch.device("cpu")
# held to the host oracle only (n > 2^20)
HOST_ONLY = {"join_two_gather_2p21"}
# the same branch at fewer rows than the JAX file's (the JAX join takes
# 2-3 s a call at 2^20 on the CPU, its counting sort 3-4 s at 2^22)
CPU_N = {"join_hot_key_5000_rows_2p20": 1 << 16,
         "join_count_2000_2p20": 1 << 16,
         **{c.name: 1 << 16 for c in cliffs.CASES
            if c.engine == "groupby_sum"}}
JAX_SORT_N = 1 << 20


def _case(name):
    case = cliffs.BY_NAME[name]
    if case.engine == "sort_auto" and case.n == cliffs.SORT_N:
        case = case._replace(n=JAX_SORT_N)
    return case._replace(n=CPU_N.get(name, case.n))


def _canonical_ids(A, id_buffer):
    """``id_buffer`` with each key's ids in ascending order: the JAX pair
    sort is unstable, so only each key's id set is its contract."""
    idb = np.asarray(id_buffer).astype(np.int64)
    return np.sort((A[idb].astype(np.int64) << 32) | idb)


def _jax_sort_branch(x):
    """The JAX dispatch's pick: max - min in uint32 against its bounds."""
    diff = (int(x.max()) - int(x.min())) & 0xFFFFFFFF
    if diff < jax_sort._NARROW_BINS:
        return "hi80"
    return "hi128" if diff < (1 << jax_sort._RANGE_BITS) else "torch.sort"


@pytest.mark.parametrize("name", [c.name for c in cliffs.CASES])
def test_cliff_case_matches_jax(name):
    case = _case(name)
    got = cliffs.run(case, CPU)
    assert got.ok, got.line()
    if name in HOST_ONLY:
        return
    data = cliffs.inputs(case)
    if case.engine == "filter_sparse":
        x, thr, caps = data["x"], data["threshold"], data["caps"]
        ref, rcount = jax_scan.filter_sparse(jnp.asarray(x), thr, **caps)
        out, count = got.out
        assert int(rcount) == int(count) == got.count
        assert np.array_equal(np.asarray(ref)[: got.count],
                              out.numpy()[: got.count])
        jax_sparse = jax_scan.sparse_caps_ok(x, thr, **caps)
        assert got.branch == ("sparse" if jax_sparse else "general")
    elif case.engine == "dense_join":
        A, B = data["A"], data["B"]
        assert jax_join.dense_applicable(A, B)
        jt = jax_join.build_dense(jnp.asarray(A))
        jr = jax_join.probe_dense(jt, jnp.asarray(B))
        t, r = got.out
        assert bool(t.packed_ok) == bool(jt.packed_ok)
        assert bool(t.packed3_ok) == bool(jt.packed3_ok)
        for field in ("counts", "pos"):
            assert np.array_equal(getattr(t, field).numpy(),
                                  np.asarray(getattr(jt, field))), field
        found = np.asarray(jr.found)
        assert np.array_equal(r.found.numpy(), found)
        for field in ("counts", "pos"):
            assert np.array_equal(getattr(r, field).numpy()[found],
                                  np.asarray(getattr(jr, field))[found])
        assert np.array_equal(_canonical_ids(A, t.id_buffer.numpy()),
                              _canonical_ids(A, jt.id_buffer))
        if name.startswith("fuzz_"):
            assert jax_join.join_id_sets(jt, jr) == \
                jax_join.oracle_id_sets(A, B)
    elif case.engine == "groupby_sum":
        ref = jax_groupby.groupby_sum(
            jnp.asarray(data["keys"]), jnp.asarray(data["vals"]),
            data["groups"], vals_below_2p14=data["flag"])
        assert np.array_equal(got.out.numpy(),
                              np.asarray(ref).view(np.int32))
    else:
        x = data["x"]
        force = not name.startswith("fuzz_sort_ranges_")
        ref = np.asarray(jax_sort.sort_auto(jnp.asarray(x),
                                            force_dispatch=force))
        assert np.array_equal(got.out.numpy(), ref)
        assert got.branch == _jax_sort_branch(x)


def test_every_jax_case_has_a_counterpart():
    """The JAX files' cases, by count: 7 filter and 4 join cliffs, 3 sort
    cliffs; 12 + 12 sort trials, the span wrap, 10 filter and 8 join
    trials; the group-by's 5 boundaries; and the cliffs cross every branch
    of every engine."""
    names = [c.name for c in cliffs.CASES]
    assert len(names) == len(set(names))
    assert sum(n.startswith("filter_2p22_x_lt_") for n in names) == 6
    assert "filter_2p22_thr_near_int32_min" in names
    assert sum(n.startswith("join_") for n in names) == 4
    assert sum(n.startswith("sort_") for n in names) == 3 + 3
    assert sum(n.startswith("fuzz_sort_ranges_") for n in names) == 12
    assert sum(n.startswith("fuzz_sort_dispatch_") for n in names) == 12
    assert sum(n.startswith("fuzz_filter_") for n in names) == 10
    assert sum(n.startswith("fuzz_join_") for n in names) == 8
    assert sum(n.startswith("groupby_") for n in names) == 5
    crossed = {f"{c.engine}:{c.branch}" for c in cliffs.CASES
               if c.branch is not None and not c.name.startswith("fuzz_")}
    assert crossed == set(cliffs.BRANCH_KERNELS)


def test_cap_boundaries_hold_then_trip():
    """At 2^22 rows and x < 40, the caps set to the counts they bound
    hold (the sparse branch), and each one below trips to the general one,
    as the JAX predicate says."""
    for name, branch in (("filter_2p22_caps_at_counts", "sparse"),
                         ("filter_2p22_cap_single_one_below", "general"),
                         ("filter_2p22_cap_mc_one_below", "general"),
                         ("filter_2p22_cap_melems_one_below", "general")):
        data = cliffs.inputs(cliffs.BY_NAME[name])
        assert jax_scan.sparse_caps_ok(data["x"], 40, **data["caps"]) == \
            (branch == "sparse"), name
        assert scan.sparse_caps_ok(data["x"], 40, **data["caps"]) == \
            (branch == "sparse"), name


def test_branch_counter_counts_each_call():
    trace.TAKEN.clear()
    x = torch.arange(1000, dtype=torch.int32)
    scan.filter_sparse(x, 5)
    scan.filter_sparse(x, 5, cap_mc=0)
    scan.filter_sparse(x.to(torch.int64), 5)
    assert trace.TAKEN == {"filter_sparse:sparse": 1,
                           "filter_sparse:general": 2}
