"""Shared dwarf machinery: device placement, timing, size iteration.

Timing follows the JAX package (dwarf_bench_tpu/dwarfs/base.py) and the
reference: ``host_time`` is wall time from the host->device transfer of the
inputs to the finished result (steady_clock around submit->wait, e.g.
sort/radix.cpp:33-35). ``kernel_time`` is a compute-only measurement on
device-resident inputs (utils/timing.kernel_time), measured once per
(dwarf, size) and reported on every iteration row: the kernel time of a
fixed program on fixed shapes does not depend on the iteration.

Validation is exact at every size: on the card a full readback is cheap,
so the checksum shortcuts the JAX package takes above 2^16 rows over its
TPU link are not needed.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..common.device import resolve_device
from ..common.dwarf import Dwarf
from ..common.options import RunOptions, to_string
from ..utils.timing import kernel_time, sync


class TorchDwarf(Dwarf):
    """Base for all dwarfs: standard init (meter params) and the per-size
    run loop (e.g. sort/radix.cpp:71-81)."""

    def init(self, opts: RunOptions) -> None:
        self.meter().set_opts(opts)
        self.meter().set_params({"device_type": to_string(opts.device_ty)})
        # kernel times hold for one set of options (device, group count)
        self._kt_cache = {}

    def run(self, opts: RunOptions) -> None:
        # reference dwarfs announce the device per run (e.g. join.cpp:24-25)
        print(f"Selected device: {self.device(opts)}")
        for size in opts.input_size:
            self._run(int(size), self.meter())

    def _run(self, buf_size: int, meter) -> None:  # pragma: no cover
        raise NotImplementedError

    # -- helpers -------------------------------------------------------

    def device(self, opts: RunOptions) -> torch.device:
        return resolve_device(opts.device_ty)

    @staticmethod
    def put(device: torch.device, *arrays: np.ndarray):
        """Host columns to ``device`` as a tuple of int32 tensors (uint32
        columns as their bit patterns)."""
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)
            for a in arrays
        )

    def timed_with_transfer(self, device: torch.device, fn: Callable,
                            host_arrays):
        """(result, device inputs, seconds); the timed region includes the
        host->device transfer, like the reference's lazy SYCL buffers."""
        t0 = time.perf_counter()
        dev = self.put(device, *host_arrays)
        res = sync(fn(*dev))
        return res, dev, time.perf_counter() - t0

    def kernel_timed(self, cache_key, fn: Callable, *args) -> float:
        """Device seconds of ``fn(*args)`` for the CSV kernel_time column,
        measured once per ``cache_key`` (the size) after each ``init``."""
        if cache_key not in self._kt_cache:
            self._kt_cache[cache_key] = kernel_time(fn, *args)
        return self._kt_cache[cache_key]
