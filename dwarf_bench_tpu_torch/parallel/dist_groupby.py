"""Distributed group-by sum over a device mesh (the port of
``dwarf_bench_tpu/parallel/dist_groupby.py``), the reference's
GroupByLocal partition + merge (groupby/groupby_local.cpp:58-112) from
work-items to chips:

  * ``dist_groupby_dense``: every rank sums its row shard into a private
    dense partial, and one all-reduce merges the partials;
  * ``dist_groupby_shuffle``: rows are hash-partitioned by key across the
    ranks (all-to-all) and each rank sums only the keys it owns.

Sums are uint32 in the JAX package and int32 bit patterns here; they wrap
mod 2^32.
"""

from __future__ import annotations

from ..ops.groupby import (
    groupby_sum_matmul,
    groupby_sum_scatter,
    groupby_sum_sorted,
)
from .collectives import psum
from .mesh import ROW_AXIS, axis_size
from .shuffle import partition_for_shuffle


def dist_groupby_dense(mesh, num_groups: int):
    """Returns fn(keys, vals) of this rank's row shards -> the dense
    (num_groups,) sums, the same on every rank."""
    group = mesh.get_group(ROW_AXIS)

    def local(keys, vals):
        if num_groups <= 4096:
            partial = groupby_sum_matmul(keys, vals, num_groups)
        else:
            partial = groupby_sum_sorted(keys, vals, num_groups)
        return psum(partial, group)

    return local


def dist_groupby_shuffle(mesh, num_groups: int, capacity: int):
    """Shuffle group-by: key k is owned by rank ``hash(k) % n``. Returns
    fn(keys, vals) -> (this rank's dense (num_groups,) partial, with sums
    only for the keys it owns and zeros elsewhere, its shuffle overflow
    0-d). Summing the ranks' partials gives the dense result."""
    group = mesh.get_group(ROW_AXIS)

    def local(keys, vals):
        rk, rv, _, overflow = partition_for_shuffle(
            keys, vals, axis_size(mesh, ROW_AXIS), capacity, group)
        # padding keys (EMPTY) lie outside [0, G) and add nothing
        sums = groupby_sum_scatter(rk.reshape(-1), rv.reshape(-1),
                                   num_groups)
        return sums, overflow

    return local
