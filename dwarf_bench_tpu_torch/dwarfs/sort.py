"""Sort dwarfs: Radix (+Cuda alias), TBBSort.

Reference: sort/radix.cpp (oneDPL device sort), sort/tbbsort.cpp (TBB
parallel host sort baseline).
"""

from __future__ import annotations

import time

import numpy as np

from ..common.datagen import derive_seed, make_random
from ..common.device import resolve_device
from ..common.options import DeviceType
from ..common.result import Result
from ..ops.sort import sort_host_dispatch, sort_oracle
from .base import TorchDwarf


class Radix(TorchDwarf):
    def __init__(self, name: str = "Radix"):
        super().__init__(name)

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        host_src = make_random(
            buf_size, seed=derive_seed(opts.seed, buf_size, 0), dtype=np.int32
        )
        expected = sort_oracle(host_src)
        device = self.device(opts)
        # the dwarf holds the host column, so the engine pick happens here
        engine = sort_host_dispatch(host_src)

        for _ in range(opts.iterations):
            out, dev, host_time = self.timed_with_transfer(
                device, engine, (host_src,)
            )
            kernel_time = self.kernel_timed(buf_size, engine, *dev)
            result = Result(host_time=host_time, kernel_time=kernel_time)
            result.valid = bool(np.array_equal(out.cpu().numpy(), expected))
            meter.add_result({"buf_size": str(buf_size)}, result)


class RadixCuda(Radix):
    """Accelerator-pinned alias (sort/radix_cuda.cpp)."""

    def __init__(self):
        super().__init__("RadixCuda")

    def device(self, opts):
        return resolve_device(DeviceType.GPU)


class TBBSort(TorchDwarf):
    """Host-parallel sort baseline. The reference sorts the SAME vector in
    place every iteration, so iterations >= 1 sort already-sorted data
    (tbbsort.cpp:17-22), mirrored here deliberately."""

    def __init__(self):
        super().__init__("TBBSort")

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        host_src = make_random(
            buf_size, seed=derive_seed(opts.seed, buf_size, 0), dtype=np.int32
        )
        expected = sort_oracle(host_src)

        for _ in range(opts.iterations):
            t0 = time.perf_counter()
            host_src.sort()  # in-place, like tbb::parallel_sort
            host_time = time.perf_counter() - t0
            result = Result(host_time=host_time)
            # always-on validation (tbbsort.cpp:40-45)
            result.valid = bool(np.array_equal(host_src, expected))
            meter.add_result({"buf_size": str(buf_size)}, result)
