"""Kernel-launch overhead baselines: the ConstantExample family.

Reference: constant/constant.cpp + constant.cl (``out[0] = 42`` single-task
kernel, via C++ and the raw C API) and constant/constant_dpcpp.cpp (a
16-wide parallel_for writing 42). None of them records a meter result: they
print the output for a visual check. Here the store is one ``torch.full``
on the resolved device (the JAX package's is a jitted ``jnp.full``; neither
is a hand-written kernel).
"""

from __future__ import annotations

import torch

from ..common.device import resolve_device
from ..common.options import DeviceType
from ..utils.timing import sync
from .base import TorchDwarf


class _ConstantBase(TorchDwarf):
    width = 1

    def _run(self, buf_size: int, meter) -> None:
        opts = meter.opts
        device = self.device(opts)
        for _ in range(opts.iterations):
            out = sync(torch.full((self.width,), 42, dtype=torch.int32,
                                  device=device))
            print(f"42 = {int(out[0])}")
            # no meter.add_result, as the reference (constant.cpp)


class ConstantExample(_ConstantBase):
    def __init__(self):
        super().__init__("ConstantExample")


class ConstantExampleCAPI(_ConstantBase):
    def __init__(self):
        super().__init__("ConstantExampleCAPI")


class ConstantExampleDPCPP(_ConstantBase):
    width = 16  # constant_dpcpp.cpp:25-29

    def __init__(self, name: str = "ConstantExampleDPCPP"):
        super().__init__(name)


class ConstantExampleDPCPPCuda(ConstantExampleDPCPP):
    """Pinned to the GPU; raises without CUDA."""

    def __init__(self):
        super().__init__("ConstantExampleDPCPPCuda")

    def device(self, opts):
        return resolve_device(DeviceType.GPU)
