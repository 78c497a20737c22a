"""Port parity of the distributed layer: every builder of
``dwarf_bench_tpu_torch.parallel`` against its JAX counterpart, on the same
numpy inputs (``test_torch_parallel_worker.inputs``).

The JAX side runs on conftest's 8 virtual devices; the port's side runs once
for the module in a gloo world of 8 spawned processes (each rank one chip),
with a 1-D ``("x",)`` mesh and a 2-D ``(2, 4)`` ``("dcn", "ici")`` mesh over
the same world. Chip c of the JAX mesh is rank c. Every output is an
integer: shuffles compare bit-exactly by slot up to each slot's count, the
sort's buffers, counts, group sums, join counts and totals exactly, and the
materialised join rows as sorted row sets.
"""

from __future__ import annotations

import multiprocessing
import socket
from collections import Counter

import jax
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import dwarf_bench_tpu.parallel as jpar
import dwarf_bench_tpu_torch.parallel as tpar
import test_torch_parallel_worker as W
from dwarf_bench_tpu.ops.groupby import groupby_oracle
from dwarf_bench_tpu.ops.join import seq_join_oracle
from dwarf_bench_tpu.parallel.shuffle import (
    partition_for_shuffle,
    partition_for_shuffle_2d,
)

N_DEV = W.N_DEV


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's outputs of every case: ``ranks[r]["<case>/<i>"]``."""
    out_dir = tmp_path_factory.mktemp("ranks")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=W.run_rank, args=(r, N_DEV, port,
                                                  str(out_dir)))
             for r in range(N_DEV)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=240)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * N_DEV, f"rank exit codes {codes}"
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(N_DEV)]


def port(ranks, case, i):
    """Output ``i`` of ``case`` on every rank, stacked, as the JAX
    package's dtype would read it (int32 bit patterns as uint32)."""
    return np.stack([r[f"{case}/{i}"] for r in ranks])


@pytest.fixture(scope="module")
def mesh():
    return jpar.make_mesh(N_DEV)


@pytest.fixture(scope="module")
def mesh2d():
    return jpar.make_mesh_2d(2, 4)


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _i32(a):
    return np.asarray(a).view(np.int32)


def _pairs(A, B):
    ca, cb = Counter(A.tolist()), Counter(B.tolist())
    return sum(ca[k] * cb.get(k, 0) for k in ca)


def _slots_equal(got_k, got_cols, got_cnt, exp_k, exp_cols, exp_cnt):
    """Shuffle outputs of one chip, (n, cap) each: equal counts, and equal
    keys and payloads in every slot up to its count."""
    assert np.array_equal(_i32(got_cnt), _i32(exp_cnt))
    for s, c in enumerate(np.asarray(exp_cnt).astype(np.int64)):
        assert np.array_equal(_u32(got_k[s][:c]), _u32(exp_k[s][:c]))
        for g, e in zip(got_cols, exp_cols):
            assert np.array_equal(_u32(g[s][:c]), _u32(e[s][:c]))


def test_world_and_names():
    """The port exports the JAX package's 21 names."""
    assert tpar.__all__ == jpar.__all__
    assert len(tpar.__all__) == 21
    assert (tpar.ROW_AXIS, tpar.DCN_AXIS, tpar.ICI_AXIS) == \
        (jpar.ROW_AXIS, jpar.DCN_AXIS, jpar.ICI_AXIS)


class TestDistGroupBy:
    @pytest.mark.parametrize("case", ["groupby_dense",
                                      "groupby_dense_sorted"])
    def test_dense(self, ranks, mesh, case):
        """G = 64 (groupby_sum_matmul) and 8192 (groupby_sum_sorted), with
        EMPTY padding keys: the replicated sums on every rank."""
        p = W.inputs(case)
        keys, vals = p["arrays"]
        exp = np.asarray(jpar.dist_groupby_dense(mesh, p["G"])(
            *jpar.shard_rows(mesh, keys, vals)))
        got = _u32(port(ranks, case, 0))
        assert all(np.array_equal(g, exp) for g in got)
        ok = keys != W.EMPTY
        assert np.array_equal(exp, groupby_oracle(keys[ok], vals[ok], p["G"]))

    def test_shuffle(self, ranks, mesh):
        p = W.inputs("groupby_shuffle")
        keys, vals = p["arrays"]
        out, ov = jpar.dist_groupby_shuffle(mesh, p["G"], p["cap"])(
            *jpar.shard_rows(mesh, keys, vals))
        assert np.array_equal(_u32(port(ranks, "groupby_shuffle", 0)),
                              np.asarray(out))
        assert np.array_equal(port(ranks, "groupby_shuffle", 1),
                              np.asarray(ov))
        assert int(np.sum(np.asarray(ov))) == 0


class TestDistJoin:
    @pytest.mark.parametrize("case", ["join", "join_dense"])
    def test_total(self, ranks, mesh, case):
        p = W.inputs(case)
        A, B = p["arrays"]
        fn = jpar.dist_csr_join(mesh, **W._join_sizes(p),
                                dense=case == "join_dense")
        counts, local, total, ov = map(np.asarray,
                                       fn(*jpar.shard_rows(mesh, A, B)))
        assert np.array_equal(port(ranks, case, 0), _i32(counts))
        assert np.array_equal(port(ranks, case, 1), local)
        assert np.all(port(ranks, case, 2) == total)
        assert np.array_equal(port(ranks, case, 3), ov)
        assert int(ov.sum()) == 0 and int(total) == _pairs(A, B)

    @pytest.mark.parametrize("case", ["ring", "ring_dense", "ring_skew"])
    def test_ring(self, ranks, mesh, case):
        """Per-B-row counts are global and in row order; the skew case puts
        one key in half of A."""
        p = W.inputs(case)
        A, B = p["arrays"]
        fn = jpar.dist_csr_join_ring(mesh, **W._ring_sizes(p),
                                     dense=case == "ring_dense")
        counts, local, total = map(np.asarray,
                                   fn(*jpar.shard_rows(mesh, A, B)))
        assert np.array_equal(port(ranks, case, 0), counts)
        assert np.array_equal(port(ranks, case, 1), local)
        assert np.all(port(ranks, case, 2) == total)
        ca = Counter(A.tolist())
        exp = np.array([ca.get(int(k), 0) for k in B], np.int32)
        assert np.array_equal(counts.reshape(-1), exp)


def _jax_shuffle(mesh, keys, cols, cap):
    multi = len(cols) > 1

    def local(k, *c):
        rk, rc, rcnt, ov = partition_for_shuffle(
            k, tuple(c) if multi else c[0], N_DEV, cap, "x")
        rc = rc if multi else (rc,)
        return (rk[None], *(x[None] for x in rc), rcnt[None], ov.reshape(1))

    n_out = 3 + len(cols)
    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(P("x"),) * (1 + len(cols)),
                           out_specs=(P("x"),) * n_out))
    return [np.asarray(o) for o in fn(*jpar.shard_rows(mesh, keys, *cols))]


class TestShuffle:
    @pytest.mark.parametrize("case", ["shuffle", "shuffle_multi"])
    def test_partition_by_slot(self, ranks, mesh, case):
        """One payload column, and three (a 64-bit value as two columns and
        the row ids): bit-exact by slot up to its count."""
        p = W.inputs(case)
        keys, *cols = p["arrays"]
        exp = _jax_shuffle(mesh, keys, cols, p["cap"])
        got = [port(ranks, case, i) for i in range(len(exp))]
        for c in range(N_DEV):
            _slots_equal(got[0][c], [g[c] for g in got[1:-2]], got[-2][c],
                         exp[0][c], [e[c] for e in exp[1:-2]], exp[-2][c])
        assert np.array_equal(got[-1], exp[-1])
        assert int(exp[-1].sum()) == 0
        # every row arrives, with its payloads
        m = got[0].reshape(-1) != _i32(W.EMPTY)
        delivered = sorted(zip(*(_u32(g).reshape(-1)[m] for g in got[:-2])))
        assert delivered == sorted(zip(keys, *cols))


class TestDistFilter:
    @pytest.mark.parametrize("case", ["filter", "filter_sparse"])
    def test_matches_jax(self, ranks, mesh, case):
        """x < 5000 (the caps trip: the filter kernel's path) and x < 5
        over 2^14 rows a rank (the sparse path)."""
        p = W.inputs(case)
        (x,) = p["arrays"]
        outs, counts, offsets, total = map(np.asarray, jpar.dist_filter(
            mesh, p["threshold"], p["cap"])(jpar.shard_rows(mesh, x)))
        assert np.array_equal(port(ranks, case, 1), counts)
        assert np.array_equal(port(ranks, case, 2), offsets)
        assert np.all(port(ranks, case, 3) == total)
        got = port(ranks, case, 0)
        for c in range(N_DEV):
            assert np.array_equal(got[c][:counts[c]], outs[c][:counts[c]])
        assert int(total) == int((x < p["threshold"]).sum())


class TestDistSort:
    def test_buffers_and_counts(self, ranks, mesh):
        p = W.inputs("sort")
        (x,) = p["arrays"]
        out, valid, ov = map(np.asarray, jpar.dist_sort(mesh, p["cap"])(
            jpar.shard_rows(mesh, x)))
        assert np.array_equal(_u32(port(ranks, "sort", 0)), out)
        assert np.array_equal(port(ranks, "sort", 1), valid)
        assert np.array_equal(port(ranks, "sort", 2), ov)
        got = np.concatenate([out[c][: valid[c]] for c in range(N_DEV)])
        assert np.array_equal(got, np.sort(x)) and int(ov.sum()) == 0


def _check_skew(ranks, case, exp, base=0):
    light, heavy, total, ov = map(np.asarray, exp)
    assert np.array_equal(port(ranks, case, base), light)
    assert np.array_equal(port(ranks, case, base + 1), heavy)
    assert np.all(port(ranks, case, base + 2) == total)
    assert np.array_equal(port(ranks, case, base + 3), ov)
    assert int(ov.sum()) == 0
    return heavy, int(total)


class TestSkewJoin:
    @pytest.mark.parametrize("case", ["skew_heavy", "skew_uniform"])
    def test_matches_jax(self, ranks, mesh, case):
        """Half the rows on one key: the plain hash shuffle overflows (the
        same count in both packages) and the skew join is exact. Uniform
        keys: no heavy key, the same result."""
        p = W.inputs(case)
        da, db = jpar.shard_rows(mesh, *p["arrays"])
        exp = jpar.dist_csr_join_skew(mesh, **W._join_sizes(p))(da, db)
        _, total = _check_skew(ranks, case, exp)
        assert total == _pairs(*p["arrays"])
        plain_ov = np.asarray(jpar.dist_csr_join(
            mesh, **W._join_sizes(p))(da, db)[3])
        assert np.array_equal(port(ranks, case, 4), plain_ov)
        assert (int(plain_ov.sum()) > 0) == (case == "skew_heavy")


class TestSkewJoinZipf:
    def test_zipf_keys_exact(self, ranks, mesh):
        p = W.inputs("skew_zipf")
        fn = jpar.dist_csr_join_skew(mesh, **W._join_sizes(p), heavy_cap=32,
                                     candidates_per_chip=16)
        exp = fn(*jpar.shard_rows(mesh, *p["arrays"]))
        _, total = _check_skew(ranks, "skew_zipf", exp)
        assert total == _pairs(*p["arrays"])

    def test_threshold_boundary(self, ranks, mesh):
        """A key just above the threshold rides the broadcast, one just
        below the shuffle; the planted probes answer by the heavy path only
        for the key above."""
        p = W.inputs("skew_threshold")
        A, B, B2 = p["arrays"]
        fn = jpar.dist_csr_join_skew(mesh, **W._join_sizes(p))
        _, total = _check_skew(ranks, "skew_threshold",
                               fn(*jpar.shard_rows(mesh, A, B)))
        assert total == _pairs(A, B)
        heavy2, total2 = _check_skew(ranks, "skew_threshold",
                                     fn(*jpar.shard_rows(mesh, A, B2)),
                                     base=4)
        assert total2 == _pairs(A, B2)
        thr = p["cap"] // 2
        hc = heavy2.reshape(-1)
        assert np.all(hc[:4] == thr + 8) and np.all(hc[4:8] == 0)


class TestDistJoinRows:
    def test_rows_match_jax_and_oracle(self, ranks, mesh):
        p = W.inputs("rows")
        ak, av, bk, bv = p["arrays"]
        fn = jpar.dist_hash_join_rows(mesh, shuffle_capacity=p["cap"],
                                      ht_size=2 * N_DEV * p["cap"])
        k, a, b, cnt, ov = map(np.asarray,
                               fn(*jpar.shard_rows(mesh, ak, av, bk, bv)))
        got = [_u32(port(ranks, "rows", i)) for i in range(3)]
        assert np.array_equal(port(ranks, "rows", 3), cnt)
        assert np.array_equal(port(ranks, "rows", 4), ov)
        everyone = []
        for c in range(N_DEV):
            m = int(cnt[c])
            exp_rows = sorted(zip(k[c][:m], a[c][:m], b[c][:m]))
            rows = sorted(zip(*(g[c][:m] for g in got)))
            assert rows == exp_rows
            everyone += rows
        assert np.array_equal(
            np.array(sorted(everyone), np.uint64).reshape(-1, 3),
            seq_join_oracle(ak, av, bk, bv))


class TestDist2D:
    def test_shuffle_2d_by_slot(self, ranks, mesh2d):
        p = W.inputs("shuffle_2d")
        keys, vals = p["arrays"]

        def local(k, v):
            rk, rv, rcnt, ov = partition_for_shuffle_2d(
                k, v, 2, 4, p["cap1"], p["cap2"], "dcn", "ici")
            return (rk[None, None], rv[None, None], rcnt[None, None],
                    ov.reshape(1, 1))

        sh = P(("dcn", "ici"))
        fn = jax.jit(shard_map(local, mesh=mesh2d, in_specs=(sh, sh),
                               out_specs=(P("dcn", "ici"),) * 4))
        rk, rv, rcnt, ov = (np.asarray(o).reshape(N_DEV, *o.shape[2:])
                            for o in fn(*jpar.shard_rows(mesh2d, keys,
                                                         vals)))
        got = [port(ranks, "shuffle_2d", i) for i in range(4)]
        for c in range(N_DEV):
            _slots_equal(got[0][c], [got[1][c]], got[2][c], rk[c], [rv[c]],
                         rcnt[c])
        assert np.array_equal(got[3], ov.reshape(-1))
        assert int(ov.sum()) == 0

    @pytest.mark.parametrize("case", ["join_2d", "join_2d_dense"])
    def test_join_2d(self, ranks, mesh2d, case):
        p = W.inputs(case)
        A, B = p["arrays"]
        fn = jpar.dist_csr_join_2d(mesh2d, **W._2d_sizes(p),
                                   dense=case == "join_2d_dense")
        counts, local, total, ov = (np.asarray(o) for o in
                                    fn(*jpar.shard_rows(mesh2d, A, B)))
        assert np.array_equal(port(ranks, case, 0),
                              _i32(counts).reshape(N_DEV, -1))
        assert np.array_equal(port(ranks, case, 1), local.reshape(-1))
        assert np.all(port(ranks, case, 2) == total)
        assert np.array_equal(port(ranks, case, 3), ov.reshape(-1))
        assert int(ov.sum()) == 0 and int(total) == _pairs(A, B)

    def test_ring_2d(self, ranks, mesh2d):
        p = W.inputs("ring_2d")
        A, B = p["arrays"]
        fn = jpar.dist_csr_join_ring_2d(mesh2d, **W._ring_sizes(p))
        counts, local, total = (np.asarray(o) for o in
                                fn(*jpar.shard_rows(mesh2d, A, B)))
        assert np.array_equal(port(ranks, "ring_2d", 0),
                              counts.reshape(N_DEV, -1))
        assert np.array_equal(port(ranks, "ring_2d", 1), local.reshape(-1))
        assert np.all(port(ranks, "ring_2d", 2) == total)
        assert int(total) == _pairs(A, B)


class TestDistJoinAtScale:
    """The at-scale checks of the JAX tests (capacity at 2x the uniform
    expectation; 12 % of both sides on one key) at 2^13 rows a chip."""

    def test_hash_shuffle_join(self, ranks, mesh):
        p = W.inputs("scale_join")
        A, B = p["arrays"]
        fn = jpar.dist_csr_join(mesh, **W._scale_sizes(p))
        counts, local, total, ov = map(np.asarray,
                                       fn(*jpar.shard_rows(mesh, A, B)))
        for i, e in enumerate((_i32(counts), local, None, ov)):
            if e is not None:
                assert np.array_equal(port(ranks, "scale_join", i), e)
        assert np.all(port(ranks, "scale_join", 2) == total)
        assert int(ov.sum()) == 0 and int(total) == _pairs(A, B)

    def test_skew_join(self, ranks, mesh):
        p = W.inputs("scale_skew")
        A, B = p["arrays"]
        fn = jpar.dist_csr_join_skew(mesh, **W._scale_sizes(p))
        heavy, total = _check_skew(ranks, "scale_skew",
                                   fn(*jpar.shard_rows(mesh, A, B)))
        ca = np.bincount(A, minlength=1 << 14).astype(np.uint64)
        exp_heavy = np.where(B == 7, ca[7], 0)
        assert np.array_equal(heavy.reshape(-1).astype(np.uint64), exp_heavy)
        assert total % (1 << 32) == _pairs(A, B) % (1 << 32)
