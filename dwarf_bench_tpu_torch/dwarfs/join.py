"""Join dwarfs: Join, NestedLoopJoin, JoinOmnisci (+Cuda alias), SlabJoin.

Reference:
  * Join (join/join.cpp): 1:1 hash join over unique keys; build/probe time
    split (join.cpp:111-113); order-insensitive compare against the
    seq_join oracle.
  * NestedLoopJoin (join/nested_join.cpp): O(n^2) dense compare.
  * JoinOmnisci (join/join_omnisci.cpp): one-to-many CSR-index join over
    duplicate keys; build = table + id buffer, probe = lookup views. Keys
    within one 2^14 window (the benchmark's [1, 10000]) take the dense
    index, wider keys the general one (``csr_join.build`` +
    ``probe_merge``), as in the JAX dwarf.
  * SlabJoin (join/slab_join.cpp): hash join through the slab (bucketized)
    table; unique keys; build/probe split.

Validation is exact at every size: the result rows, sorted, must equal the
oracle's. Join and SlabJoin also fill kernel_time (build and probe on
device-resident columns), which the JAX dwarfs leave at 0, as the port's
JoinOmnisci does.
"""

from __future__ import annotations

import time

import numpy as np

from .. import native
from ..common.datagen import derive_seed, make_random, make_unique_random
from ..common.device import resolve_device
from ..common.options import DeviceType
from ..common.result import HashJoinResult
from ..ops import bucket_hash, csr_join
from ..ops import join as join_ops
from ..ops.primitives import compact_multi
from ..utils.timing import sync
from .base import TorchDwarf


def _unique_tables(opts, buf_size: int):
    """Tables A and B of the 1:1 joins: four unique-key columns."""
    return tuple(
        make_unique_random(buf_size, seed=derive_seed(opts.seed, buf_size, i))
        for i in range(4)
    )


def _rows_valid(res: join_ops.JoinResult, expected: np.ndarray) -> bool:
    got = join_ops.join_rows_sorted(res)
    return bool(np.array_equal(got, expected.astype(np.uint64)))


class Join(TorchDwarf):
    def __init__(self):
        super().__init__("Join")

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        a_keys, a_vals, b_keys, b_vals = _unique_tables(opts, buf_size)
        expected = native.seq_join_sorted(a_keys, a_vals, b_keys, b_vals)
        device = self.device(opts)
        ht_size = 2 * buf_size  # join.cpp:28
        hseed = derive_seed(opts.seed, buf_size, 4) & 0xFFFFFFFF

        def join(ak, av, bk, bv):
            table = join_ops.hash_join_build(ak, av, ht_size, hseed)
            return join_ops.hash_join_probe(table, bk, bv, hseed)

        for _ in range(opts.iterations):
            t0 = time.perf_counter()
            da_k, da_v, db_k, db_v = self.put(
                device, a_keys, a_vals, b_keys, b_vals)
            table = sync(join_ops.hash_join_build(da_k, da_v, ht_size, hseed))
            t_build = time.perf_counter()
            res = sync(join_ops.hash_join_probe(table, db_k, db_v, hseed))
            t_end = time.perf_counter()
            result = HashJoinResult(
                host_time=t_end - t0,
                kernel_time=self.kernel_timed(buf_size, join, da_k, da_v,
                                              db_k, db_v),
                build_time=t_build - t0,
                probe_time=t_end - t_build,
            )
            result.valid = _rows_valid(res, expected)
            meter.add_result({"buf_size": str(buf_size)}, result)


class NestedLoopJoin(TorchDwarf):
    def __init__(self):
        super().__init__("NestedLoopJoin")

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        tables = _unique_tables(opts, buf_size)
        expected = native.seq_join_sorted(*tables)
        device = self.device(opts)

        for _ in range(opts.iterations):
            res, dev, host_time = self.timed_with_transfer(
                device, join_ops.nested_loop_join, tables)
            kernel_time = self.kernel_timed(
                buf_size, join_ops.nested_loop_join, *dev)
            result = HashJoinResult(host_time=host_time,
                                    kernel_time=kernel_time)
            result.valid = _rows_valid(res, expected)
            meter.add_result({"buf_size": str(buf_size)}, result)


def validate_csr_join(a_keys, b_keys, id_buffer, found, pos, cnt) -> bool:
    """Exact, vectorized form of the id-set oracle (join_omnisci.cpp:15-45):
    id_buffer is a permutation of [0, n) with A's keys non-decreasing along
    it, so it lists A's rows grouped by key in key order; every query's count
    is its key's count in A and, where non-zero, its position is the number
    of A keys below it. Then id_buffer[pos : pos + cnt] is exactly the set
    of A rows with the query's key."""
    a = np.asarray(a_keys, np.uint32)
    b = np.asarray(b_keys, np.uint32)
    ids = np.asarray(id_buffer).astype(np.int64)
    if not np.array_equal(np.sort(ids), np.arange(len(a))):
        return False
    along = a[ids]
    if not bool(np.all(along[1:] >= along[:-1])):
        return False
    a_sorted = np.sort(a)
    lo = np.searchsorted(a_sorted, b, side="left")
    hi = np.searchsorted(a_sorted, b, side="right")
    exp_cnt = hi - lo
    got_cnt = np.where(np.asarray(found), np.asarray(cnt, np.int64), 0)
    if not np.array_equal(got_cnt, exp_cnt):
        return False
    m = exp_cnt > 0
    return bool(np.array_equal(np.asarray(pos, np.int64)[m], lo[m]))


class JoinOmnisci(TorchDwarf):
    def __init__(self, name: str = "JoinOmnisci"):
        super().__init__(name)

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        s = lambda i: derive_seed(opts.seed, buf_size, i)
        a_keys = make_random(buf_size, seed=s(0), dtype=np.uint32)
        b_keys = make_random(buf_size, seed=s(1), dtype=np.uint32)
        if csr_join.dense_applicable(a_keys, b_keys):
            # hi_rows pinned to 128, as the JAX dwarf pins it
            def build(da):
                return csr_join.build_dense(da)

            def probe(table, db):
                return csr_join.probe_dense(table, db, hi_rows=128)
        else:
            # the host's distinct count sizes the table
            # (join_omnisci.cpp:55-69)
            unique_keys = len(np.unique(a_keys))

            def build(da):
                return csr_join.build(da, unique_keys, 2 * unique_keys)

            probe = csr_join.probe_merge
        device = self.device(opts)

        def join(da, db):
            table = build(da)
            return table, probe(table, db)

        for _ in range(opts.iterations):
            t0 = time.perf_counter()
            da_k, db_k = self.put(device, a_keys, b_keys)
            table = sync(build(da_k))
            t_build = time.perf_counter()
            res = sync(probe(table, db_k))
            t_end = time.perf_counter()
            kernel_time = self.kernel_timed(buf_size, join, da_k, db_k)
            result = HashJoinResult(
                host_time=t_end - t0,
                kernel_time=kernel_time,
                build_time=t_build - t0,
                probe_time=t_end - t_build,
            )
            result.valid = validate_csr_join(
                a_keys, b_keys,
                table.id_buffer.cpu().numpy(),
                res.found.cpu().numpy(),
                res.pos.cpu().numpy(),
                res.counts.cpu().numpy(),
            )
            meter.add_result({"buf_size": str(buf_size)}, result)


class JoinOmnisciCuda(JoinOmnisci):
    """Accelerator-pinned alias (join/join_omnisci_cuda.cpp)."""

    def __init__(self):
        super().__init__("JoinOmnisciCuda")

    def device(self, opts):
        return resolve_device(DeviceType.GPU)


def _slab_probe_join(table, b_keys, b_vals) -> join_ops.JoinResult:
    found, a_val = bucket_hash.find(table, b_keys)
    (k, av, bv), count = compact_multi((b_keys, a_val, b_vals), found)
    return join_ops.JoinResult(k, av, bv, count)


class SlabJoin(TorchDwarf):
    def __init__(self):
        super().__init__("SlabJoin")

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        a_keys, a_vals, b_keys, b_vals = _unique_tables(opts, buf_size)
        expected = native.seq_join_sorted(a_keys, a_vals, b_keys, b_vals)
        device = self.device(opts)
        # fixed bucket count like the reference's BUCKETS_COUNT=1024
        # (slab_hash.hpp:24-26)
        nb = 1024

        def join(ak, av, bk, bv):
            return _slab_probe_join(bucket_hash.build(ak, av, nb), bk, bv)

        for _ in range(opts.iterations):
            t0 = time.perf_counter()
            da_k, da_v, db_k, db_v = self.put(
                device, a_keys, a_vals, b_keys, b_vals)
            table = sync(bucket_hash.build(da_k, da_v, nb))
            t_build = time.perf_counter()
            res = sync(_slab_probe_join(table, db_k, db_v))
            t_end = time.perf_counter()
            result = HashJoinResult(
                host_time=t_end - t0,
                kernel_time=self.kernel_timed(buf_size, join, da_k, da_v,
                                              db_k, db_v),
                build_time=t_build - t0,
                probe_time=t_end - t_build,
            )
            result.valid = _rows_valid(res, expected)
            meter.add_result({"buf_size": str(buf_size)}, result)
