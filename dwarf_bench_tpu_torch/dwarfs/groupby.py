"""GroupBy dwarfs: GroupBy (+Cuda alias).

Reference: groupby/groupby.cpp, a CAS+fetch_add hash aggregate then a
readback kernel scattering sums to a dense output (groupby.cpp:58-93); keys
uniform in [0, groups_count) (groupby.cpp:31-32). GroupByLocal is not
ported yet.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..common.datagen import derive_seed, make_random
from ..common.device import resolve_device
from ..common.options import DeviceType, GroupByRunOptions
from ..common.result import Result
from ..ops import groupby as gops
from .base import TorchDwarf


class GroupBy(TorchDwarf):
    def __init__(self, name: str = "GroupBy"):
        super().__init__(name)

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        if not isinstance(opts, GroupByRunOptions):
            raise TypeError("GroupBy needs GroupByRunOptions")
        groups_count = int(opts.groups_count)
        s = lambda i: derive_seed(opts.seed, buf_size, i)
        vals = make_random(buf_size, seed=s(0), dtype=np.uint32)
        keys = make_random(
            buf_size, 0, groups_count - 1, seed=s(1), dtype=np.uint32
        )
        expected = native.groupby_sum(keys, vals, groups_count)
        device = self.device(opts)
        # benchmark values are uniform [1, 10000] < 2^14
        fn = lambda k, v: gops.groupby_sum(
            k, v, groups_count, vals_below_2p14=True
        )

        for _ in range(opts.iterations):
            out, dev, host_time = self.timed_with_transfer(
                device, fn, (keys, vals)
            )
            kernel_time = self.kernel_timed(buf_size, fn, *dev)
            result = Result(host_time=host_time, kernel_time=kernel_time)
            got = out.cpu().numpy().view(np.uint32)
            result.valid = bool(np.array_equal(got, expected))
            meter.add_result({"buf_size": str(buf_size)}, result)


class GroupByCuda(GroupBy):
    """Accelerator-pinned alias (groupby/groupby_cuda.cpp)."""

    def __init__(self):
        super().__init__("GroupByCuda")

    def device(self, opts):
        return resolve_device(DeviceType.GPU)
