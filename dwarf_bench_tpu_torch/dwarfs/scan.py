"""Scan/filter dwarfs: TwoPassScan, DPLScan (+Cuda alias).

Reference: scan/scan.{hpp,cpp} + scan/scan.cl (two-pass OpenCL kernel),
scan/dplscan.cpp + scan/dplscan_cuda.cpp (oneDPL copy_if). Both filter
``x < 5`` over ints in [1, 10000] (selectivity about 4/10000).
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ..common.datagen import derive_seed, make_random
from ..common.device import resolve_device
from ..common.options import DeviceType
from ..common.result import Result
from ..ops.scan import (
    filter_oracle,
    filter_sparse,
    filter_two_pass,
    sparse_caps_ok,
)
from .base import TorchDwarf


def _sparse_engine(host_src, device):
    """Host-checked engine pick (the radix host-range-check convention):
    when the host column fits the sparse pipeline's caps, filter_sparse
    runs without reading its cap predicate back from the card; data that
    could trip a cap keeps the checked dispatch."""
    if device.type != "cpu" and sparse_caps_ok(host_src):
        return partial(filter_sparse, assume_sparse=True)
    return filter_sparse


class _ScanBase(TorchDwarf):
    def pick_engine(self, host_src, device):  # pragma: no cover
        raise NotImplementedError

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        host_src = make_random(
            buf_size, seed=derive_seed(opts.seed, buf_size, 0), dtype=np.int32
        )
        expected = filter_oracle(host_src)
        device = self.device(opts)
        fn = self.pick_engine(host_src, device)

        for _ in range(opts.iterations):
            (out, cnt), dev, host_time = self.timed_with_transfer(
                device, fn, (host_src,)
            )
            kernel_time = self.kernel_timed(buf_size, fn, *dev)
            result = Result(host_time=host_time, kernel_time=kernel_time)
            c = int(cnt)
            # oracle compare (scan.cpp:157-164), exact at every size
            result.valid = c == len(expected) and bool(
                np.array_equal(out[:c].cpu().numpy(), expected)
            )
            meter.add_result({"buf_size": str(buf_size)}, result)


class TwoPassScan(_ScanBase):
    """Explicit two-pass filter (the kernel structure of scan/scan.cl:3-42:
    per-chunk counts, prefix over chunk counts, placement). On the card it
    runs the sparsity-adaptive engine (ops/scan.filter_sparse), the same
    count/prefix/place structure with the general ``filter`` kernel as its
    any-selectivity fallback; on the CPU the two-pass formulation."""

    def __init__(self):
        super().__init__("TwoPassScan")

    def pick_engine(self, host_src, device):
        if device.type != "cpu":
            return _sparse_engine(host_src, device)
        return filter_two_pass


class DPLScan(_ScanBase):
    """Vendor-algorithm filter (oneDPL copy_if, dplscan.cpp:43-44): the
    sparsity-adaptive filter (ops/scan.filter_sparse), with the general
    kernel as its fallback at higher selectivity."""

    def __init__(self, name: str = "DPLScan"):
        super().__init__(name)

    def pick_engine(self, host_src, device):
        return _sparse_engine(host_src, device)


class DPLScanCuda(DPLScan):
    """Accelerator-pinned alias (scan/dplscan_cuda.cpp)."""

    def __init__(self):
        super().__init__("DPLScanCuda")

    def device(self, opts):
        return resolve_device(DeviceType.GPU)
