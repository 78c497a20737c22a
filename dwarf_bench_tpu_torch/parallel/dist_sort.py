"""Distributed sample sort over a device mesh (the port of
``dwarf_bench_tpu/parallel/dist_sort.py``): local sort, splitters from
gathered samples, partition into chip ranges, fixed-capacity all-to-all,
local sort of the received rows. Keys are uint32 as int32 bit patterns and
compare unsigned (``primitives.bias_u32``), so EMPTY padding sorts last.
"""

from __future__ import annotations

import torch

from ..ops.hashtable import EMPTY
from ..ops.primitives import bias_u32, sort_by_key
from .collectives import all_gather, all_to_all
from .mesh import ROW_AXIS, axis_size

_SAMPLES_PER_CHIP = 64


def dist_sort(mesh, capacity_per_chip: int):
    """Returns fn(x) of this rank's row shard -> (this rank's sorted buffer
    (n_chips * capacity_per_chip,) with EMPTY padding, its valid count,
    its send overflow), the last two 0-d int32. Concatenating the ranks'
    valid prefixes in rank order gives the sorted column."""
    group = mesh.get_group(ROW_AXIS)
    cap = int(capacity_per_chip)

    def local(x):
        n = x.shape[0]
        n_chips = axis_size(mesh, ROW_AXIS)
        device = x.device
        xs = sort_by_key(x, unsigned=True)
        # evenly spaced local samples -> global splitters
        step = max(n // _SAMPLES_PER_CHIP, 1)
        samples = xs[::step][:_SAMPLES_PER_CHIP]
        all_samples = sort_by_key(all_gather(samples, group).reshape(-1),
                                  unsigned=True)
        m = all_samples.shape[0]
        # n_chips - 1 splitters at even quantiles, ascending
        idx = torch.arange(1, n_chips, device=device) * m // n_chips
        splitters = all_samples[idx]
        # destination = number of splitters <= value; non-decreasing in xs
        dest = torch.searchsorted(bias_u32(splitters), bias_u32(xs),
                                  right=True)
        bounds = torch.searchsorted(
            dest, torch.arange(n_chips + 1, device=device))
        starts = bounds[:-1]
        counts = (bounds[1:] - starts).to(torch.int32)
        rank = torch.arange(n, device=device) - starts[dest]
        flat = torch.where(rank < cap, dest * cap + rank, n_chips * cap)
        send = torch.full((n_chips * cap + 1,), EMPTY, dtype=torch.int32,
                          device=device)
        send[flat] = xs
        overflow = (counts - counts.clamp(max=cap)).sum(dtype=torch.int32)
        recv = all_to_all(send[:-1].view(n_chips, cap), group).reshape(-1)
        out = sort_by_key(recv, unsigned=True)
        valid = (out != EMPTY).sum(dtype=torch.int32)
        return out, valid, overflow

    return local
