"""Device selection: map DeviceType to a ``torch.device``.

Replacement for the reference's SYCL device selector
(common/dpcpp/dpcpp_common.hpp:5-8). ``GPU`` is ``cuda:0`` and raises when
CUDA is not available: a run asked for the card never carries on on the
CPU. ``DEFAULT`` keeps the reference's default-selector fallback to the CPU.
"""

from __future__ import annotations

import torch

from .options import DeviceType


def resolve_device(device_ty: DeviceType) -> torch.device:
    if device_ty == DeviceType.CPU:
        return torch.device("cpu")
    if device_ty == DeviceType.GPU:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device gpu requested but CUDA is not available "
                "(torch.cuda.is_available() is False)"
            )
        return torch.device("cuda:0")
    if torch.cuda.is_available():
        return torch.device("cuda:0")
    return torch.device("cpu")

