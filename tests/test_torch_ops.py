"""Port parity of the operator modules: dwarf_bench_tpu_torch.ops.{sort,
groupby, csr_join} against the JAX package's functions of the same names,
on the same numpy inputs. Outputs are integers: the tolerance is exact
equality, except that the id_buffer is compared by id sets per key where
the JAX sort is unstable (n >= 2^18) and nothing past the valid rows is
compared."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops import csr_join as jcsr
from dwarf_bench_tpu.ops import groupby as jgroupby
from dwarf_bench_tpu.ops import join as jjoin
from dwarf_bench_tpu.ops import sort as jsort
from dwarf_bench_tpu.ops.chunk_stats import chunk_stats_xla as jchunk_stats_xla
from dwarf_bench_tpu_torch.ops import csr_join, groupby, join, sort
from dwarf_bench_tpu_torch.ops.chunk_stats import chunk_stats_xla


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


# -- sort -----------------------------------------------------------------

SPANS = [(1, 10000), (-5000, 4000), (0, 12000), (-(2**31), 2**31 - 1)]


@pytest.mark.parametrize("lo,hi", SPANS[:3])
def test_sort_counting(rng, lo, hi):
    x = rng.integers(lo, hi, 10_000, endpoint=True).astype(np.int32)
    ref = np.asarray(jsort.sort_counting(jnp.asarray(x)))
    assert np.array_equal(sort.sort_counting(_t(x)).numpy(), ref)


@pytest.mark.parametrize("lo,hi", SPANS)
def test_sort_host_dispatch(rng, lo, hi):
    """The engine picked from the host column (hi80, hi128, or sort_auto
    past 2^14) against the JAX accelerator dispatch of the same column."""
    x = rng.integers(lo, hi, 20_000, endpoint=True).astype(np.int32)
    ref = np.asarray(
        jsort.sort_host_dispatch(x, platform="gpu")(jnp.asarray(x)))
    got = sort.sort_host_dispatch(x)(_t(x)).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(got, jsort.sort_oracle(x))


@pytest.mark.parametrize("lo,hi", SPANS)
@pytest.mark.parametrize("n", [1, 777])
def test_sort_auto(rng, lo, hi, n):
    x = rng.integers(lo, hi, n, endpoint=True).astype(np.int32)
    ref = np.asarray(jsort.sort_auto(jnp.asarray(x), force_dispatch=True))
    assert np.array_equal(sort.sort_auto(_t(x)).numpy(), ref)


# -- groupby --------------------------------------------------------------

@pytest.mark.parametrize("G,vals_below_2p14,vmax", [
    (1, True, 10000),
    (64, True, 10000),
    (4096, True, 10000),
    (5000, True, 10000),
    (1 << 16, True, 10000),
    (5000, False, 10000),       # sorted branch (no value bound vouched)
    (64, False, 1 << 16),       # vals >= 2^14: the JAX f32 one-hot branch
    (70_000, True, 10000),      # past 2^16: sorted branch
])
def test_groupby_sum_branches(rng, G, vals_below_2p14, vmax):
    n = 1 << 14
    k = rng.integers(0, G, n).astype(np.uint32)
    v = rng.integers(1, vmax, n, endpoint=True).astype(np.uint32)
    ref = np.asarray(jgroupby.groupby_sum(
        jnp.asarray(k), jnp.asarray(v), G, vals_below_2p14=vals_below_2p14))
    got = groupby.groupby_sum(_t(k), _t(v), G,
                              vals_below_2p14=vals_below_2p14)
    assert np.array_equal(_u32(got), ref)
    assert np.array_equal(ref, jgroupby.groupby_oracle(k, v, G))


@pytest.mark.parametrize("G", [5000, 1 << 16])
def test_groupby_2level_and_sorted_agree(rng, G):
    k = rng.integers(0, G, 3000).astype(np.uint32)
    v = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    exp = jgroupby.groupby_oracle(k, v, G)
    assert np.array_equal(_u32(groupby.groupby_sum_2level(_t(k), _t(v), G)), exp)
    assert np.array_equal(_u32(groupby.groupby_sum_sorted(_t(k), _t(v), G)), exp)


@pytest.mark.parametrize("keys,vals,jax_out,port_out", [
    ([0xFFFFFFFE, 1], [5, 7], [0, 7, 0, 0, 0, 0, 0, 5],
     [0, 7, 0, 0, 0, 0, 0, 0]),
    ([-9 & 0xFFFFFFFF, 3, 3], [5, 7, 11], [5, 0, 0, 18, 0, 0, 0, 0],
     [0, 0, 0, 18, 0, 0, 0, 0]),
])
def test_groupby_sorted_drops_keys_outside_range(keys, vals, jax_out,
                                                 port_out):
    """A deliberate difference: jnp ``.at[]`` wraps a negative key -k into
    group G + 1 - k before ``mode="drop"`` applies, so the JAX
    ``groupby_sum_sorted`` adds it there; the port drops every key outside
    [0, G), as every other group-by engine of both packages does. Both
    outputs are recorded, so a change on either side shows."""
    k = np.array(keys, np.uint32)
    v = np.array(vals, np.uint32)
    ref = np.asarray(jgroupby.groupby_sum_sorted(jnp.asarray(k),
                                                 jnp.asarray(v), 8))
    assert ref.tolist() == jax_out
    got = _u32(groupby.groupby_sum_sorted(_t(k), _t(v), 8))
    assert got.tolist() == port_out
    keep = k < 8
    assert np.array_equal(got, jgroupby.groupby_oracle(k[keep], v[keep], 8))


# -- dense CSR join -------------------------------------------------------

def _a_keys(rng, n, empty):
    """A join build column; ``empty`` makes a tenth of it EMPTY padding."""
    a = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    if empty:
        a[rng.choice(n, size=n // 10, replace=False)] = 0xFFFFFFFF
    return a


@pytest.mark.parametrize("n,empty", [(1000, False), (4096, True),
                                     (1 << 16, False), (1 << 18, True)])
def test_build_dense_field_by_field(rng, n, empty):
    a = _a_keys(rng, n, empty)
    ref = jcsr.build_dense(jnp.asarray(a))
    got = csr_join.build_dense(_t(a))
    for name in csr_join.DenseCsrTable._fields:
        if name == "id_buffer":
            continue
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        if r.dtype == np.uint32:
            g = g.view(np.uint32)
        assert r.shape == g.shape, name
        assert np.array_equal(r, g), name
    n_eff = int((a != 0xFFFFFFFF).sum())
    r_ids = np.asarray(ref.id_buffer)[:n_eff].astype(np.int64)
    g_ids = got.id_buffer.numpy()[:n_eff].astype(np.int64)
    if n < (1 << 18):
        # the JAX packed one-word sort fixes ids ascending within a key
        assert np.array_equal(g_ids, r_ids)
    else:
        # unstable JAX pair sort: same id set per key segment
        keys = a[r_ids]
        assert np.array_equal(a[g_ids], keys)
        order_r = np.lexsort((r_ids, keys))
        order_g = np.lexsort((g_ids, a[g_ids]))
        assert np.array_equal(r_ids[order_r], g_ids[order_g])


def _probe_columns(rng, n=4096):
    a = _a_keys(rng, n, True)
    b = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    b[:5] = [0xFFFFFFFF, 0, 20000, 10000, 1]  # EMPTY, below/above the range
    return a, b


@pytest.mark.parametrize("hi_rows", [128, 80])
def test_probe_dense_on_the_same_table(rng, hi_rows):
    a, b = _probe_columns(rng)
    jtable = jcsr.build_dense(jnp.asarray(a))
    ref = jcsr.probe_dense(jtable, jnp.asarray(b), hi_rows=hi_rows)
    table = csr_join.table_from_numpy(jtable)
    got = csr_join.probe_dense(table, _t(b), hi_rows=hi_rows)
    for name in csr_join.CsrProbeResult._fields:
        assert np.array_equal(np.asarray(getattr(ref, name)),
                              getattr(got, name).numpy()), name


def test_probe_dense_matches_id_set_oracle(rng):
    a, b = _probe_columns(rng)
    own = csr_join.build_dense(_t(a))
    res = csr_join.probe_dense(own, _t(b))
    ids = own.id_buffer.numpy()
    sets = [set(ids[p:p + c].tolist()) if f else set() for f, p, c in
            zip(res.found.numpy(), res.pos.numpy(), res.counts.numpy())]
    a_valid = np.where(a == 0xFFFFFFFF, -1, a.astype(np.int64))
    assert sets == csr_join.oracle_id_sets(a_valid, b)


def test_table_from_numpy_matches_port_build(rng):
    a = _a_keys(rng, 2048, False)
    conv = csr_join.table_from_numpy(jcsr.build_dense(jnp.asarray(a)))
    own = csr_join.build_dense(_t(a))
    for name in csr_join.DenseCsrTable._fields:
        c, o = getattr(conv, name), getattr(own, name)
        assert c.dtype == o.dtype and torch.equal(c, o), name


@pytest.mark.parametrize("a,b", [
    ([1, 10000], [5]),
    ([1, 20000], [5]),
    ([0xFFFFFFFF, 7], [0xFFFFFFFF]),
    ([], []),
])
def test_dense_host_checks(a, b):
    a = np.array(a, np.uint32)
    b = np.array(b, np.uint32)
    assert csr_join.dense_applicable(a, b) == jcsr.dense_applicable(a, b)
    assert csr_join.dense_hi_rows(a, b) == jcsr.dense_hi_rows(a, b)


# -- the JAX package's names that parallel/ and its call sites use ---------

# the values each JAX engine is exact for: f32 one-hot tiles of 1024 rows
# below 2^24 a partial, bf16 planes below 2^14, the scatter for any
_ENGINE_VMAX = {"groupby_sum_matmul": 10000, "groupby_sum_matmul_bf16":
                (1 << 14) - 1, "groupby_sum_scatter": (1 << 32) - 1}


@pytest.mark.parametrize("name", sorted(_ENGINE_VMAX))
@pytest.mark.parametrize("G", [64, 4096, 5000])
def test_groupby_engine_names(rng, name, G):
    n = 4096
    keys = rng.integers(0, G, n).astype(np.uint32)
    vals = rng.integers(0, _ENGINE_VMAX[name], n, endpoint=True
                        ).astype(np.uint32)
    ref = np.asarray(getattr(jgroupby, name)(jnp.asarray(keys),
                                            jnp.asarray(vals), G))
    got = getattr(groupby, name)(_t(keys), _t(vals), G)
    assert np.array_equal(_u32(got), ref)


@pytest.mark.parametrize("G,khi", [(64, 64), (5000, 5100), (1 << 16, 1 << 16),
                                   (1, 1)])
def test_groupby_sum_packed_sort(rng, G, khi):
    """Keys and values below 2^16; keys past G (5000 with keys to 5099)
    drop out of the compaction's G slots or the scatter in both."""
    n = 30000
    keys = rng.integers(0, khi, n).astype(np.uint32)
    vals = rng.integers(0, 1 << 16, n).astype(np.uint32)
    ref = np.asarray(jgroupby.groupby_sum_packed_sort(
        jnp.asarray(keys), jnp.asarray(vals), G))
    got = groupby.groupby_sum_packed_sort(_t(keys), _t(vals), G)
    assert np.array_equal(_u32(got), ref)
    ok = keys < G
    assert np.array_equal(ref, jgroupby.groupby_oracle(keys[ok], vals[ok], G))


def test_columns_to_rows_and_back(rng):
    cols = [rng.integers(0, 1 << 32, 257, dtype=np.uint64).astype(np.uint32)
            for _ in range(3)]
    ref = jjoin.columns_to_rows(*cols)
    assert join.columns_to_rows(*(_t(c) for c in cols)) == ref
    assert join.columns_to_rows(*cols) == ref
    for g, r in zip(join.rows_to_columns(ref, 3),
                    jjoin.rows_to_columns(ref, 3)):
        assert g.dtype == torch.int32 and np.array_equal(_u32(g), r)
    empty = join.rows_to_columns([], 2)
    assert [tuple(c.shape) for c in empty] == [(0,), (0,)]
    assert [c.shape for c in jjoin.rows_to_columns([], 2)] == [(0,), (0,)]


@pytest.mark.parametrize("thr", [5, 5000, -(2**31) + 100, 2**31 - 1])
def test_chunk_stats_xla(rng, thr):
    x2 = rng.integers(-(2**31), 2**31, (300, 128), dtype=np.int64
                      ).astype(np.int32)
    x2[::7] = rng.integers(1, 10000, (x2[::7].shape), endpoint=True)
    es, eb = jchunk_stats_xla(jnp.asarray(x2), thr)
    gs, gb = chunk_stats_xla(torch.from_numpy(x2), thr)
    assert np.array_equal(gs.numpy(), np.asarray(es))
    assert np.array_equal(gb.numpy(), np.asarray(eb))


@pytest.mark.parametrize("n,empty", [(4096, True), (1 << 16, False)])
def test_build_dense_with_row_ids(rng, n, empty):
    """Global row ids (as the distributed join passes them, and past 2^31
    as uint32) in the id_buffer: every other field exact, and each key's
    ids the same set (the JAX pair sort is unstable)."""
    a = _a_keys(rng, n, empty)
    ids = (np.uint64(3 << 30) + rng.permutation(n).astype(np.uint64)
           ).astype(np.uint32)
    ref = jcsr.build_dense(jnp.asarray(a), row_ids=jnp.asarray(ids))
    got = csr_join.build_dense(_t(a), row_ids=_t(ids))
    for name in csr_join.DenseCsrTable._fields:
        if name == "id_buffer":
            continue
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        if r.dtype == np.uint32:
            g = g.view(np.uint32)
        assert np.array_equal(r, g), name
    r_ids, g_ids = np.asarray(ref.id_buffer), _u32(got.id_buffer)
    counts, pos = np.asarray(ref.counts), np.asarray(ref.pos)
    for k in np.flatnonzero(counts):
        seg = slice(pos[k], pos[k] + counts[k])
        assert np.array_equal(np.sort(g_ids[seg]), np.sort(r_ids[seg]))
    # the port's sort is stable: ids in row order within a key
    valid = a != 0xFFFFFFFF
    order = np.argsort(np.where(valid, a, 0xFFFFFFFF), kind="stable")
    assert np.array_equal(g_ids[: valid.sum()], ids[order][: valid.sum()])
