"""Distributed filter over a device mesh (the port of
``dwarf_bench_tpu/parallel/dist_scan.py``): each rank compacts its row
shard with the single-chip engine (``ops/scan.filter_sparse``); the global
offsets come from an all-gather of the counts and the total from an
all-reduce, so no row moves between ranks.
"""

from __future__ import annotations

import torch

from ..ops.scan import filter_sparse
from .collectives import all_gather, psum
from .mesh import ROW_AXIS


def dist_filter(mesh, threshold: int, capacity_per_chip: int):
    """Returns fn(x) of this rank's row shard -> (its compacted buffer of
    ``capacity_per_chip`` slots, its count, its global exclusive offset,
    the global total), the last three 0-d int32; the total is the same on
    every rank."""
    group = mesh.get_group(ROW_AXIS)

    def local(x):
        out, cnt = filter_sparse(x, threshold, capacity=capacity_per_chip)
        all_counts = all_gather(cnt, group)  # (n_chips,)
        offsets = torch.cumsum(all_counts, 0, dtype=torch.int32) - all_counts
        total = psum(cnt, group)
        return out, cnt, offsets[mesh.get_local_rank(ROW_AXIS)], total

    return local
