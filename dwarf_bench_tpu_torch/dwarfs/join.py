"""Join dwarfs: JoinOmnisci (+Cuda alias).

Reference: join/join_omnisci.cpp, a one-to-many CSR-index join over
duplicate keys; build = table + id buffer, probe = lookup views. The
benchmark's [1, 10000] keys always take the dense index. The general
(hash) path, Join, NestedLoopJoin and SlabJoin are not ported yet.
"""

from __future__ import annotations

import time

import numpy as np

from ..common.datagen import derive_seed, make_random
from ..common.device import resolve_device
from ..common.options import DeviceType
from ..common.result import HashJoinResult
from ..ops import csr_join
from ..utils.timing import sync
from .base import TorchDwarf


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
        if not csr_join.dense_applicable(a_keys, b_keys):
            raise NotImplementedError(
                "JoinOmnisci: keys span 2^14 or more and need the general "
                "CSR join (hash build + merge probe), which is not ported "
                "yet (ROADMAP queue 1 #9)"
            )
        # hi_rows pinned to 128, as the JAX dwarf pins it
        hi_rows = 128
        device = self.device(opts)

        def join(da, db):
            table = csr_join.build_dense(da)
            return table, csr_join.probe_dense(table, db, hi_rows=hi_rows)

        for _ in range(opts.iterations):
            t0 = time.perf_counter()
            da_k, db_k = self.put(device, a_keys, b_keys)
            table = sync(csr_join.build_dense(da_k))
            t_build = time.perf_counter()
            res = sync(csr_join.probe_dense(table, db_k, hi_rows=hi_rows))
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
