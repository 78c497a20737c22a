"""Device selection: map DeviceType to a ``torch.device``.

Replacement for the reference's SYCL device selector
(common/dpcpp/dpcpp_common.hpp:5-8). ``GPU`` and ``DEFAULT`` are ``cuda:0``
and raise when CUDA is not available: a run that did not ask for the CPU
never carries on there (the CSV would otherwise report a GPU row measured on
the CPU). Only ``CPU`` selects the CPU.
"""

from __future__ import annotations

import torch

from .options import DeviceType


def resolve_device(device_ty: DeviceType) -> torch.device:
    if device_ty == DeviceType.CPU:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device_ty.value.lower()} requested but CUDA is not "
            "available (torch.cuda.is_available() is False); pass "
            "--device=cpu to run on the CPU"
        )
    return torch.device("cuda:0")
