"""Reduce dwarf.

Reference: reduce/reduce.cpp, a work-group tree sum validated against
std::accumulate (reduce.cpp:10-22). The int32 sum wraps mod 2^32, so every
engine agrees bit for bit with the oracle.
"""

from __future__ import annotations

import numpy as np

from ..common.datagen import derive_seed, make_random
from ..common.result import Result
from ..ops.reduce import reduce_oracle, reduce_sum
from .base import TorchDwarf


class ReduceDPCPP(TorchDwarf):
    def __init__(self):
        super().__init__("ReduceDPCPP")

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        host_src = make_random(
            buf_size, seed=derive_seed(opts.seed, buf_size, 0), dtype=np.int32
        )
        expected = reduce_oracle(host_src)
        device = self.device(opts)

        for _ in range(opts.iterations):
            out, dev, host_time = self.timed_with_transfer(
                device, reduce_sum, (host_src,)
            )
            kernel_time = self.kernel_timed(buf_size, reduce_sum, *dev)
            result = Result(host_time=host_time, kernel_time=kernel_time)
            result.valid = int(out) == expected
            meter.add_result({"buf_size": str(buf_size)}, result)
